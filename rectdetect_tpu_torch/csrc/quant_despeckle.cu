// Kernel #5 quant_despeckle: quantize the packed-Lab plane to n levels per
// channel (quantize, oclrect.cl:207-216), then give every on-edge pixel the
// nearest-colour off-edge 3x3 neighbour of the quantized plane (despeckle,
// oclrect.cl:218-244).
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
// _quant_despeckle_kernel (quant_despeckle_pallas).
//
// Bound: device memory, 8 B read (packed + edge magnitude) and 4 B written
// per pixel (11.1 MB at 720p).  Each block owns a kTileRows x kTileCols
// output tile and loads its window, the tile and a one-pixel halo, once,
// so the quantized plane never goes to device memory.  Each window pixel
// is quantized once (1.19 times a pixel) into a shared int32 code beside
// a one-byte off-edge flag: its three levels index a per-block table of
// the level codes, built while the loads are in flight (one division per
// level and block; more than kMaxLevels levels, or a negative count,
// divide per pixel instead).  After a barrier an off-edge pixel keeps its
// own code and an on-edge one goes on the block's list; after another,
// the block's threads share the list, so no lane idles beside an
// off-edge one, and each listed pixel scans its 9 window candidates.  A
// candidate's squared distance comes from integer lattice differences
// (sq_dist, exactly the plain version's float) and its sqrt only where
// the square is below the best one's.  Results meet in shared memory for
// one coalesced store; no thread leaves before a barrier.
//
// The batch form takes b frames of (h, w) one after the other: grid z is
// the frame, and a block reads and writes its own frame's planes only, at
// the offset z h w, so a window pixel beyond the frame's border is outside
// the frame, never a pixel of the next one.
//
// Floats as the jitted JAX composition (ops/regions.py): the lattice snap
// floor(fma(v, n, 0.5)) / n with a correctly rounded division; the distance
// sqrtf((dL*dL + da*da) + db*db) with no fused multiply-add and a
// correctly rounded sqrt.  Ties keep the first neighbour in (dy, dx) scan
// order: strict <.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// output tile of a block: kTileRows x kTileCols pixels, kRowsPerPass rows
// of kTileCols threads, each thread kTileRows / kRowsPerPass pixels
constexpr int kTileRows = 16;
constexpr int kTileCols = 32;
constexpr int kRowsPerPass = 8;
constexpr int kThreads = kTileCols * kRowsPerPass;
// levels a channel may have for the quantizer's per-block table; more take
// one division per channel and pixel
constexpr int kMaxLevels = 255;

__device__ __forceinline__ int floor_clamp(float v, float hi) {
  return (int)fminf(fmaxf(floorf(v), 0.0f), hi);
}

// the level of a channel value v in (0, 1) at n levels: floor(v n + 1/2)
// with one rounding, an integer-valued float in [0, n]
__device__ __forceinline__ float level(float v, float n) {
  return floorf(__fmaf_rn(v, n, 0.5f));
}

// the lattice code of level k of channel ch (0 = L, bits 0-11; 1 = a,
// bits 12-21; 2 = b, bits 22-31): floor(k / n * 2^bits), the division
// correctly rounded
__device__ __forceinline__ unsigned level_code(int ch, float k, float n) {
  const float q = k / n;
  return ch == 0 ? (unsigned)floor_clamp(q * 4096.0f, 4095.0f)
                 : (unsigned)floor_clamp(q * 1024.0f, 1023.0f)
                       << (ch == 1 ? 12 : 22);
}

// the channel values of a packed code at their lattice centres
__device__ __forceinline__ void lab_of(int p, float* l, float* a, float* b) {
  *l = ((float)(p & 4095) + 0.5f) * (1.0f / 4096.0f);
  *a = ((float)((p >> 12) & 1023) + 0.5f) * (1.0f / 1024.0f);
  *b = ((float)((p >> 22) & 1023) + 0.5f) * (1.0f / 1024.0f);
}

// The distance's square as the plain version rounds it,
// (dl*dl + da*da) + db*db on floats, from the lattice differences: with
// l = (code + 0.5) / 4096 the float difference of two l is exactly
// dl / 4096 and its square exactly dl^2 / 2^24 (dl^2 < 2^24), a and b
// likewise over 1024, so in units of 2^-24 the squares are the integers
// dl^2, 16 da^2 and 16 db^2 and only the two sums round, as here (the
// scale is a power of 4, so the sqrt of either is the other's times 2^12).
__device__ __forceinline__ float sq_dist(int dl, int da, int db) {
  return (float)(dl * dl + 16 * da * da) + (float)(16 * db * db);
}

// window of a kTileRows x kTileCols output tile: one pixel of halo
constexpr int kWinRows = kTileRows + 2;
constexpr int kWinCols = kTileCols + 2;
constexpr int kWin = kWinRows * kWinCols;
constexpr int kLoads = (kWin + kThreads - 1) / kThreads;

__global__ void __launch_bounds__(kThreads)
    quant_despeckle_kernel(const int* __restrict__ packed,
                           const float* __restrict__ emag,
                           int* __restrict__ out, int h, int w, float n0,
                           float n1, float n2) {
  __shared__ int s_code[kWinRows][kWinCols];
  __shared__ unsigned char s_off[kWinRows][kWinCols];
  __shared__ int s_res[kTileRows][kTileCols];
  __shared__ short s_list[kTileRows * kTileCols];
  __shared__ unsigned s_tab[3][kMaxLevels + 1];
  __shared__ int s_n;
  const size_t plane = (size_t)blockIdx.z * h * w;
  packed += plane;
  emag += plane;
  out += plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTileCols + tx;
  const int y0 = blockIdx.y * kTileRows - 1, x0 = blockIdx.x * kTileCols - 1;
  if (t == 0) s_n = 0;

  // load the window; a pixel outside the frame is never a candidate, as
  // an on-edge one
  int p[kLoads];
  float e[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = t + j * kThreads;
    const int y = y0 + i / kWinCols, x = x0 + i % kWinCols;
    const bool in = i < kWin && y >= 0 && y < h && x >= 0 && x < w;
    p[j] = in ? packed[y * w + x] : 0;
    e[j] = in ? emag[y * w + x] : 1.0f;
  }
  // meanwhile, the code of every level of each channel, if they fit (a
  // negative count, whose levels are negative, divides)
  const float n_max = fmaxf(n0, fmaxf(n1, n2));
  const bool table =
      n_max <= (float)kMaxLevels && fminf(n0, fminf(n1, n2)) >= 0.0f;
  if (table) {
    const int n_tab = (int)n_max + 1;
    for (int i = t; i < 3 * n_tab; i += kThreads) {
      const int ch = i / n_tab, k = i % n_tab;
      const float n = ch == 0 ? n0 : (ch == 1 ? n1 : n2);
      if ((float)k <= n) s_tab[ch][k] = level_code(ch, (float)k, n);
    }
  }
  __syncthreads();

  // quantize each window pixel once, by the table or by dividing
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = t + j * kThreads;
    if (i < kWin) {
      float l, a, b;
      lab_of(p[j], &l, &a, &b);
      const float kl = level(l, n0), ka = level(a, n1), kb = level(b, n2);
      const unsigned code =
          table ? s_tab[0][(int)kl] | s_tab[1][(int)ka] | s_tab[2][(int)kb]
                : level_code(0, kl, n0) | level_code(1, ka, n1) |
                      level_code(2, kb, n2);
      s_code[i / kWinCols][i % kWinCols] = (int)code;
      s_off[i / kWinCols][i % kWinCols] = !(e[j] >= 1e-6f);
    }
  }
  __syncthreads();

  // an off-edge pixel keeps its own code; an on-edge one in the frame goes
  // on the block's list (warp-aggregated: one shared atomic per warp)
#pragma unroll
  for (int k = 0; k < kTileRows / kRowsPerPass; ++k) {
    const int r = ty + k * kRowsPerPass;
    s_res[r][tx] = s_code[r + 1][tx + 1];
    const bool on = !s_off[r + 1][tx + 1] && y0 + 1 + r < h &&
                    x0 + 1 + tx < w;
    const unsigned m = __ballot_sync(kFull, on);
    int base = 0;
    if (tx == __ffs(m) - 1) base = atomicAdd(&s_n, __popc(m));
    base = __shfl_sync(kFull, base, m ? __ffs(m) - 1 : 0);
    if (on) s_list[base + __popc(m & ((1u << tx) - 1u))] = r * kTileCols + tx;
  }
  __syncthreads();

  // despeckle the listed pixels, all lanes busy: the nearest off-edge 3x3
  // neighbour, candidates in (dy, dx) scan order, strict <
  const int n_on = s_n;
  for (int i = t; i < n_on; i += kThreads) {
    const int r = s_list[i] / kTileCols, c = s_list[i] % kTileCols;
    const int self = s_code[r + 1][c + 1];
    const int l0 = self & 4095, a0 = (self >> 12) & 1023,
              b0 = (self >> 22) & 1023;
    float best_s = __int_as_float(0x7f800000), best_d = 1e10f;
    int best = self;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (!s_off[r + dy][c + dx]) continue;
        const int cand = s_code[r + dy][c + dx];
        const int dl = (cand & 4095) - l0, da = ((cand >> 12) & 1023) - a0,
                  db = ((cand >> 22) & 1023) - b0;
        // sq_dist is the float (dl*dl + da*da) + db*db in units of 2^-24;
        // sqrt is monotone, so only a smaller sq_dist can win
        const float s = sq_dist(dl, da, db);
        if (s < best_s) {
          const float d = sqrtf(s);
          if (d < best_d) {
            best_d = d;
            best_s = s;
            best = cand;
          }
        }
      }
    }
    s_res[r][c] = best;
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kTileRows / kRowsPerPass; ++k) {
    const int r = ty + k * kRowsPerPass;
    const int y = y0 + 1 + r, x = x0 + 1 + tx;
    if (y < h && x < w) out[y * w + x] = s_res[r][tx];
  }
}

}  // namespace

// packed, emag, out: (b, h, w), 1 <= b <= 65535 (gridDim.z)
extern "C" int rd_quant_despeckle(const void* packed, const void* emag,
                                  void* out, int h,
                                  int w, int b, int n0, int n1, int n2,
                                  void* stream) {
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileCols - 1) / kTileCols,
                  (h + kTileRows - 1) / kTileRows, b);
  quant_despeckle_kernel<<<grid, dim3(kTileCols, kRowsPerPass), 0,
                           (cudaStream_t)stream>>>(
      (const int*)packed, (const float*)emag, (int*)out, h, w, (float)n0,
      (float)n1, (float)n2);
  rd::count_launch();
  return (int)cudaGetLastError();
}

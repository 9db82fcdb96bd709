// Kernel #7 distinct_bids: up to 4 distinct positive boundary ids in each
// pixel's 7x7 window, in scan order (dy outer, dx inner, -3..3), for the
// reduceLS slot scan (oclrect.cl:441-447): an id joins the first free slot
// unless a slot holds it already.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
// _distinct_bids_kernel (distinct_bids_pallas).
//
// Bound: device memory, 4 B read and 16 B written per pixel.  The TPU kernel
// rolled padded VMEM slabs 49 times and kept the slots as four slab-sized
// arrays.  A thread a pixel walking the 49 taps was bound by issue (~400
// instructions a pixel), the same whether the window held an id or not,
// and the boundary marks are sparse (1.5% of a 720p frame).  Here a block
// stages a kTileRows x kTileCols tile with a 3-pixel halo in shared memory
// (background -1 and pixels outside the frame read 0, which no slot takes)
// and runs three steps; a tile whose window holds no id (most tiles)
// writes its zeros after the loads and is done:
//   bits:  per staged row and 32-pixel output word, one warp ballots
//          "id > 0" over the word and the 6 columns after it and ORs the
//          7 funnel shifts of that pair: bit l says that the row's 7 taps
//          dx = -3..3 around pixel l hold an id;
//   lists: where that bit is set, the row list: the first <= 4 distinct
//          ids of the 7 taps in dx order, once per staged (row, column);
//   merge: per output word, the OR of the 7 rows' bit words says which
//          windows hold an id.  A warp whose 32 windows are all empty
//          writes zeros; a pixel whose window holds one merges the row
//          lists of its rows that hold one, in dy order, into its slots.
// The merge equals the 49-tap scan: that scan is the 7 row scans one
// after the other, and an id cut from its row list has 4 other distinct
// ids before it in its row, so the whole scan has at least 4 distinct ids
// before it and all 4 slots are taken when it comes; repeats inside a
// row change nothing.  The slots of a word go out as int4 stores, 4
// pixels of one plane a lane, through a per-warp shared buffer (where the
// width is a multiple of 4; else one int a lane and plane).

#include "common.cuh"

namespace {

constexpr int kTileRows = 8;
constexpr int kTileCols = 32;
constexpr int kThreads = 256;
// 1: the slot planes are written with __stcs (streaming, evict first)
constexpr int kStreamStores = 0;
constexpr int kHalo = 3;
constexpr int kTaps = 2 * kHalo + 1;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kTileCols / 32;
constexpr int kRows = kTileRows + 2 * kHalo;
constexpr int kCols = kTileCols + 2 * kHalo;
constexpr int kRowsPerWarp = (kRows + kWarps - 1) / kWarps;
constexpr int kChunks = (kCols + 31) / 32;
static_assert(kTileCols % 32 == 0, "a tile is whole 32-pixel words");

// b joins the first free slot unless a slot holds it already; the slots
// fill in order, so the first free one is the free one after a taken one
// (each test below reads the slot before it as it was), and no branch
__device__ __forceinline__ void insert(int b, int& s0, int& s1, int& s2,
                                       int& s3) {
  const bool f = (b > 0) & (b != s0) & (b != s1) & (b != s2) & (b != s3);
  s3 = f & (s2 != 0) & (s3 == 0) ? b : s3;
  s2 = f & (s1 != 0) & (s2 == 0) ? b : s2;
  s1 = f & (s0 != 0) & (s1 == 0) ? b : s1;
  s0 = f & (s0 == 0) ? b : s0;
}

__device__ __forceinline__ void put4(int* p, int4 v) {
  if (kStreamStores) {
    __stcs(reinterpret_cast<int4*>(p), v);
  } else {
    *reinterpret_cast<int4*>(p) = v;
  }
}

// Stores of one output word (32 pixels from dst, `room` of them inside
// the frame, planes n ints apart).  Where vec4, lane l writes pixels
// 4 (l % 8) .. 4 (l % 8) + 3 of plane l / 8 as one int4; else pixel l of
// each plane.
__device__ __forceinline__ void store_zeros(int* dst, size_t n, int room,
                                            int vec4, int lane) {
  if (vec4) {
    const int c = 4 * (lane & 7);
    if (c < room) put4(dst + (lane >> 3) * n + c, make_int4(0, 0, 0, 0));
  } else if (lane < room) {
    for (int p = 0; p < 4; ++p) dst[p * n + lane] = 0;
  }
}

// lane l holds pixel l's slots; buf: the warp's 4 x 32 ints of shared
// memory, to turn them into int4 rows of a plane
__device__ __forceinline__ void store_slots(int* dst, size_t n, int room,
                                            int vec4, int lane,
                                            int (*buf)[32], int s0, int s1,
                                            int s2, int s3) {
  if (vec4) {
    buf[0][lane] = s0;
    buf[1][lane] = s1;
    buf[2][lane] = s2;
    buf[3][lane] = s3;
    __syncwarp();
    const int p = lane >> 3, c = 4 * (lane & 7);
    const int4 v = *reinterpret_cast<const int4*>(&buf[p][c]);
    __syncwarp();
    if (c < room) put4(dst + p * n + c, v);
  } else if (lane < room) {
    dst[lane] = s0;
    dst[n + lane] = s1;
    dst[2 * n + lane] = s2;
    dst[3 * n + lane] = s3;
  }
}

__global__ void __launch_bounds__(kThreads)
    distinct_bids_kernel(const int* __restrict__ bnd, int* __restrict__ out,
                         int h, int w, int vec4) {
  __shared__ int ids[kRows][kCols];
  __shared__ unsigned bits[kRows][kWords];
  __shared__ int4 lists[kRows][kTileCols];
  __shared__ __align__(16) int slots[kWarps][4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = blockIdx.y * kTileRows, x0 = blockIdx.x * kTileCols;
  const size_t n = (size_t)h * w;

  // stage: a warp a row, the ids > 0 and 0 elsewhere; every load of a
  // warp in flight before the first store
  int v[kRowsPerWarp][kChunks];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps, gy = y0 - kHalo + r;
    const bool row_in = r < kRows && gy >= 0 && gy < h;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int gx = x0 - kHalo + lane + 32 * q;
      v[k][q] = row_in && gx >= 0 && gx < w ? bnd[(size_t)gy * w + gx] : 0;
    }
  }
  int any = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = lane + 32 * q;
      if (r < kRows && c < kCols) ids[r][c] = max(v[k][q], 0);
      any |= v[k][q] > 0;
    }
  }
  // a window with no id at all (most tiles): every slot stays 0
  if (!__syncthreads_or(any)) {
    for (int u = warp; u < kTileRows * kWords; u += kWarps) {
      const int gy = y0 + u / kWords, gx0 = x0 + 32 * (u % kWords);
      if (gy >= h) break;
      store_zeros(out + (size_t)gy * w + gx0, n, w - gx0, vec4, lane);
    }
    return;
  }

  // bits and row lists: a warp a (staged row, output word)
  for (int u = warp; u < kRows * kWords; u += kWarps) {
    const int r = u / kWords, j = u % kWords;
    const int* row = ids[r] + 32 * j;
    const bool here = row[lane] > 0;
    const bool after = lane < kTaps - 1 && row[32 + lane] > 0;
    const unsigned a = __ballot_sync(0xffffffffu, here);
    const unsigned b = __ballot_sync(0xffffffffu, after);
    unsigned d = a;
#pragma unroll
    for (int k = 1; k < kTaps; ++k) d |= __funnelshift_r(a, b, k);
    if (lane == 0) bits[r][j] = d;
    // this lane's taps that hold an id (bit k: dx = k - 3)
    const unsigned taps = __funnelshift_r(a, b, lane) & ((1u << kTaps) - 1);
    if (taps) {
      // the 7 loads first, then the inserts (0 takes no slot)
      int got[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) got[k] = row[lane + k];
      int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) insert(got[k], s0, s1, s2, s3);
      lists[r][32 * j + lane] = make_int4(s0, s1, s2, s3);
    }
  }
  __syncthreads();

  // merge and store: a warp an output word
  for (int u = warp; u < kTileRows * kWords; u += kWarps) {
    const int ly = u / kWords, j = u % kWords;
    const int gy = y0 + ly, gx0 = x0 + 32 * j;
    if (gy >= h) break;
    int* dst = out + (size_t)gy * w + gx0;
    unsigned rows[kTaps];
    unsigned m = 0;
#pragma unroll
    for (int dy = 0; dy < kTaps; ++dy) {
      rows[dy] = bits[ly + dy][j];
      m |= rows[dy];
    }
    if (m == 0) {
      store_zeros(dst, n, w - gx0, vec4, lane);
      continue;
    }
    // the row lists of this pixel's rows that hold an id, all loads
    // first, then merged in dy order; a row list is packed from its
    // front, so a 0 ends it
    int4 l[kTaps];
#pragma unroll
    for (int dy = 0; dy < kTaps; ++dy) {
      l[dy] = (rows[dy] >> lane) & 1u ? lists[ly + dy][32 * j + lane]
                                       : make_int4(0, 0, 0, 0);
    }
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
    for (int dy = 0; dy < kTaps; ++dy) {
      insert(l[dy].x, s0, s1, s2, s3);
      if (l[dy].y) {
        insert(l[dy].y, s0, s1, s2, s3);
        if (l[dy].z) {
          insert(l[dy].z, s0, s1, s2, s3);
          insert(l[dy].w, s0, s1, s2, s3);
        }
      }
    }
    store_slots(dst, n, w - gx0, vec4, lane, slots[warp], s0, s1, s2, s3);
  }
}

}  // namespace

// out: (4, h, w) int32, slot-major
extern "C" int rd_distinct_bids(const void* bnd, void* out, int h, int w,
                                void* stream) {
  const dim3 grid((w + kTileCols - 1) / kTileCols,
                  (h + kTileRows - 1) / kTileRows);
  const int vec4 = w % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  distinct_bids_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)bnd, (int*)out, h, w, vec4);
  rd::count_launch();
  return (int)cudaGetLastError();
}

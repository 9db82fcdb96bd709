// Kernel #6 merge_mask: the positive simpleJunction of the strong-edge
// labels (oclrect.cl:74-95) and the merge mask built on it (mkMergeMask0/1,
// oclrect.cl:246-287): the ring 16 <= d^2 < 36 around every junction pixel,
// cleared inside the d^2 < 64 disk around line ends (jn == 2) and the
// d^2 < 16 disk around junction cores (jn > 2).
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
// _merge_mask_kernel (merge_mask_pallas).
//
// Bound: device memory, 4 B read and 4 B written per pixel (7.4 MB at
// 720p).  Each block owns a kTileRows x kTileWords*32 output tile and works
// on 32-pixel bit words in shared memory (bit i of a word = pixel x0 + i,
// x0 a multiple of 32), as K3 does (csrc/morph.cu), over a window of kHalo
// rows above and below the tile and one word on each side:
//   load      one coalesced 128-byte warp read per window word, turned into
//             the word of "label > 0" by __ballot_sync; pixels outside the
//             frame read 0;
//   junction  three bit-planes on the window rows [1, rows - 1): ANY (jn !=
//             0: an edge with at least one of its 8 neighbours an edge),
//             END (jn == 2: exactly one) and CORE (jn > 2: two or more),
//             from a saturating bit-sliced count of the 8 neighbour planes,
//             masked by the frame's interior (1 <= y < h - 1, 1 <= x <
//             wt - 1) in frame coordinates, so a tile on the frame border
//             stays right.  In the offset form (a halo-widened width tile
//             of the width-tiled path, dist/tile.py) the map's local
//             column 0 is frame column gx0 of a frame wt wide; the whole
//             frame is gx0 = 0, wt = w.  Only this test sees the offset:
//             the dilations read 0 beyond the map either way;
//   dilate    one thread per tile word.  A structuring element is a set of
//             (dy, dx) taps, symmetric in both; OR-ing rows first, it is
//             the OR over |dx| of the word at dx of the union of the rows
//             whose run reaches |dx|.  For the ring (runs of
//             pallas_morph.py:_se_runs: |dy| <= 2 {4, 5}, 3 {3..5}, 4
//             {0..4}, 5 {0..3}): |dx| <= 2 from rows 4-5, 3 from rows 3-5,
//             4 from rows 0-4 and 5 from rows 0-3.  The d^2 < 64 disk:
//             |dx| <= 3 from rows 0-7, 4-5 from rows 0-6, 6 from rows 0-5,
//             7 from rows 0-3; the d^2 < 16 disk: |dx| <= 2 from rows 0-3,
//             3 from rows 0-2 (rows by |dy|).  The word at dx is one funnel
//             shift of two adjacent words, so the three elements take 30
//             shifts of row unions a word;
//   store     out = ring & ~(d64 | d16), one 128-byte warp write per tile
//             word, each lane its own pixel.
// The batch form takes b frames of (h, w) one after the other: grid z is
// the frame, and a block reads and writes its own frame's plane only, at
// the offset z h w, so no dilation reaches across frames.
// The halo is 8 rows and 8 pixels: 7 for the d^2 < 64 disk and 1 for the
// junction's stencil.  Words beyond the window read 0, which disturbs only
// the window's outer bits, at least 24 pixels from the tile.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 64;
constexpr int kTileWords = 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 8;
constexpr int kWinRows = kTileRows + 2 * kHalo;
constexpr int kWinWords = kTileWords + 2;
constexpr int kWin = kWinRows * kWinWords;
constexpr int kLoads = (kWin + kWarps - 1) / kWarps;
constexpr int kTileWordsAll = kTileRows * kTileWords;

// bits [lo, hi) of a word, 0 <= lo, hi <= 32
__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  if (hi <= lo) return 0u;
  const unsigned top = hi >= 32 ? kFull : (1u << hi) - 1u;
  return top & ~((1u << lo) - 1u);
}

// the frame's interior (1 <= y < h - 1, 1 <= x < wt - 1) as the word of
// row y whose bit 0 is frame column x0
__device__ __forceinline__ unsigned interior(int y, int x0, int h, int wt) {
  if (y < 1 || y >= h - 1) return 0u;
  return bit_range(min(max(1 - x0, 0), 32), min(max(wt - 1 - x0, 0), 32));
}

// three adjacent words of a row; at(dx) is the word whose bit i holds
// pixel x0 + i + dx, |dx| < 32
struct Row3 {
  unsigned l, m, r;
  __device__ __forceinline__ unsigned at(int dx) const {
    if (dx == 0) return m;
    if (dx > 0) return __funnelshift_r(m, r, dx);
    return __funnelshift_l(l, m, -dx);
  }
  // the word at -dx and at +dx
  __device__ __forceinline__ unsigned pm(int dx) const {
    return at(-dx) | at(dx);
  }
  __device__ __forceinline__ Row3& operator|=(const Row3& o) {
    l |= o.l;
    m |= o.m;
    r |= o.r;
    return *this;
  }
};

__device__ __forceinline__ Row3 row3(const unsigned* plane, int r, int c) {
  const unsigned* row = plane + r * kWinWords;
  return {c > 0 ? row[c - 1] : 0u, row[c],
          c + 1 < kWinWords ? row[c + 1] : 0u};
}

// the union of rows r + dy and r - dy, lo <= dy <= hi, around word c
__device__ __forceinline__ Row3 rows(const unsigned* plane, int r, int c,
                                     int lo, int hi) {
  Row3 acc{0u, 0u, 0u};
#pragma unroll
  for (int d = lo; d <= hi; ++d) {
    acc |= row3(plane, r + d, c);
    if (d) acc |= row3(plane, r - d, c);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    merge_mask_kernel(const int* __restrict__ lbl, int* __restrict__ out,
                      int h, int w, int gx0, int wt) {
  __shared__ unsigned s_nz[kWin], s_any[kWin], s_end[kWin], s_core[kWin];
  __shared__ unsigned s_out[kTileWordsAll];
  const size_t plane = (size_t)blockIdx.z * h * w;
  lbl += plane;
  out += plane;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty0 = blockIdx.y * kTileRows;
  const int tw0 = blockIdx.x * kTileWords;
  // window row r is frame row ty0 - kHalo + r; window word c starts at
  // pixel (tw0 - 1 + c) * 32
  auto frame_y = [&](int r) { return ty0 - kHalo + r; };
  auto frame_x0 = [&](int c) { return (tw0 - 1 + c) * 32; };

  // load: all of a warp's pixels first, then one ballot per word (every
  // lane reaches it: there is no early return)
  int v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = warp + j * kWarps;
    const int y = frame_y(i / kWinWords);
    const int x = frame_x0(i % kWinWords) + lane;
    v[j] = i < kWin && y >= 0 && y < h && x >= 0 && x < w ? lbl[y * w + x]
                                                          : 0;
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const unsigned bits = __ballot_sync(kFull, v[j] > 0);
    const int i = warp + j * kWarps;
    if (lane == 0 && i < kWin) s_nz[i] = bits;
  }
  __syncthreads();

  // junction: ANY, END and CORE on window rows [1, kWinRows - 1)
  for (int i = threadIdx.x; i < (kWinRows - 2) * kWinWords; i += kThreads) {
    const int r = 1 + i / kWinWords, c = i % kWinWords;
    const Row3 up = row3(s_nz, r - 1, c), md = row3(s_nz, r, c),
               dn = row3(s_nz, r + 1, c);
    unsigned a1 = 0u, a2 = 0u;  // at least one, two neighbours set
    const unsigned nb[8] = {up.at(-1), up.m, up.at(1), md.at(-1),
                            md.at(1),  dn.at(-1), dn.m, dn.at(1)};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a2 |= a1 & nb[k];
      a1 |= nb[k];
    }
    const unsigned any =
        md.m & a1 & interior(frame_y(r), frame_x0(c) + gx0, h, wt);
    const int o = r * kWinWords + c;
    s_any[o] = any;
    s_end[o] = any & ~a2;
    s_core[o] = any & a2;
  }
  __syncthreads();

  // dilate: one thread per tile word
  for (int i = threadIdx.x; i < kTileWordsAll; i += kThreads) {
    const int r = kHalo + i / kTileWords, c = 1 + i % kTileWords;
    // ring 16 <= d^2 < 36 of ANY
    const Row3 a03 = rows(s_any, r, c, 0, 3);
    const Row3 a4 = rows(s_any, r, c, 4, 4);
    const Row3 a5 = rows(s_any, r, c, 5, 5);
    const Row3 a3 = rows(s_any, r, c, 3, 3);
    Row3 a45 = a4;
    a45 |= a5;
    Row3 a345 = a45;
    a345 |= a3;
    Row3 a04 = a03;
    a04 |= a4;
    const unsigned ring = a45.m | a45.pm(1) | a45.pm(2) | a345.pm(3) |
                          a04.pm(4) | a03.pm(5);
    // d^2 < 64 of END
    Row3 e = rows(s_end, r, c, 0, 3);
    unsigned clear = e.pm(7);
    e |= rows(s_end, r, c, 4, 5);
    clear |= e.pm(6);
    e |= rows(s_end, r, c, 6, 6);
    clear |= e.pm(4) | e.pm(5);
    e |= rows(s_end, r, c, 7, 7);
    clear |= e.m | e.pm(1) | e.pm(2) | e.pm(3);
    // d^2 < 16 of CORE
    Row3 k = rows(s_core, r, c, 0, 2);
    clear |= k.pm(3);
    k |= rows(s_core, r, c, 3, 3);
    clear |= k.m | k.pm(1) | k.pm(2);
    s_out[i] = ring & ~clear;
  }
  __syncthreads();

  // store: one warp per tile word, each lane its own pixel
  for (int i = warp; i < kTileWordsAll; i += kWarps) {
    const int y = ty0 + i / kTileWords;
    const int x = (tw0 + i % kTileWords) * 32 + lane;
    if (y < h && x < w) out[y * w + x] = (int)((s_out[i] >> lane) & 1u);
  }
}

}  // namespace

// lbl, out: (b, h, w) int32, 1 <= b <= 65535 (gridDim.z); gx0: the frame
// column of local column 0, wt: the frame's width (0 and w for a whole
// frame)
extern "C" int rd_merge_mask(const void* lbl, void* out, int h,
                             int w, int b, int gx0, int wt, void* stream) {
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + 32 * kTileWords - 1) / (32 * kTileWords),
                  (h + kTileRows - 1) / kTileRows, b);
  merge_mask_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)lbl, (int*)out, h, w, gx0, wt);
  rd::count_launch();
  return (int)cudaGetLastError();
}

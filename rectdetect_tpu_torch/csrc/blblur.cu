// Kernel #12 blblur: the edge-limited blur of the rect pipeline, `iters`
// rounds of one horizontal and one vertical pass (blblur0/blblur1,
// oclrect.cl:155-205; host loop oclrect.c:286-296).
//
// Replaces the TPU kernels rectdetect_tpu/ops/pallas_blblur.py:
// _pass_kernel (blblur_pallas_blocked), and with it _kernel (blblur_pallas)
// and _fused_kernel (blblur_pallas_fused), which compute the same function
// and only tile the frame differently for VMEM.
//
// Bound: device memory.  The function must read the packed frame and the
// edge map and write the result once, 12 B per pixel for all the passes.
// Two kernels:
//
//  * blblur_arms, one launch per call: each pass's taps depend on the edge
//    map alone, which does not change between passes.  For each pixel and
//    axis it finds the negative and positive arm lengths (0-5 taps each)
//    with the break rules of ops/regions.py:_blblur_axis (frame border,
//    edge entry, diagonal corner, `oe`) and packs the four into one 16-bit
//    word: bits 0-2 horizontal negative, 3-5 horizontal positive, 6-8
//    vertical negative, 9-11 vertical positive.  The arms never leave the
//    frame, so the fused kernel needs no frame-border logic.
//  * blblur_fused, ceil(iters / F) launches: each block loads one output
//    tile with a halo of 4F pixels on every side into shared memory once
//    (the packed plane by cp.async, zero-filled outside the frame; the arm
//    words), runs F rounds of a horizontal and a vertical pass there, and
//    writes the inner tile once.  A pass reaches 4 px along its axis, so the
//    region each pass computes shrinks by 4 on that axis's halo, pass by
//    pass, to the tile itself.  The channels live unpacked in two words per
//    pixel: L | a << 16 (sums of up to 10 taps stay below 2^16 in each
//    half) and b.  Each output's sum is a fixed trip of 9 taps, each a
//    multiply-add by a 0/1 flag of its arm lengths (no breaks, no
//    divergence), the centre weighted 0-2, and the truncating average an
//    exact multiply-shift by the tap count (the JAX package's _DIV_MAGIC,
//    pallas_blblur.py:37-38: exact for n <= 4095 d).  A tap count of 0
//    keeps the input pixel.
//
// Integer arithmetic only, so the result equals the plain version exactly.
// F (1, 2, 5 or 10) and its tile are compile-time choices, timed against
// each other by chip_smoke.py.  The kernel stays well above the memory
// bound: the blocks of one wave all load their tiles, then all compute,
// with nothing to overlap the two; every pass moves its windows through
// shared memory between syncs; and the masked sums are integer work, which
// the H100 issues at half its float rate.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSize = 4;  // BLBLURSIZE, oclrect.cl:72
constexpr int kDivN = 19;
constexpr int kThreadsX = 32, kThreadsY = 16;

// The arm pass: one block of kArmW x kArmRows threads per kArmW x kArmH
// pixels.  The block's edges with a halo of kSize + 1 become bit masks in
// shared memory, one per tile row and one per tile column (both by ballot);
// a pixel's four arms are then found for all five taps of an arm at once
// with bit operations.
constexpr int kArmW = 32, kArmH = 32, kArmRows = 8, kArmHalo = kSize + 1;
constexpr int kArmT = kArmW + 2 * kArmHalo;  // the tile's side, <= 64 bits
static_assert(kArmH == kArmW, "square tiles: one mask width for both axes");

// bits j < m of the five taps (m clamped to 0..5)
__device__ __forceinline__ unsigned below(int m) {
  return m >= 5 ? 0x1Fu : m <= 0 ? 0u : (1u << m) - 1u;
}

// Arm lengths of one pixel along one axis: the taps the negative (k = 0,
// -1, ..., -kSize) and positive (k = 0..kSize) scans of
// regions._blblur_axis keep before their first break, as the index of the
// first break bit.  e: the edges at offsets -5..5 along the axis (bit
// 5 + k); x: those across the axis, at +1 (the corner test); coord,
// limit: the pixel's coordinate along the axis and the frame's size;
// cross_ok: the pixel is not on the last row (horizontal) or column
// (vertical).  Outside the frame the masks hold 0: no edge, as the plain
// version's zero padding.
__device__ __forceinline__ unsigned arm_pair(unsigned e, unsigned x,
                                             int coord, int limit,
                                             bool cross_ok) {
  // negative arm, tap j = -k: E(k) at bit j of er >> 5, E(k - 1) at bit j
  // of er >> 6 (er: e reversed, bit 10 - i <- bit i)
  const unsigned er = __brev(e) >> 21, xr = __brev(x) >> 21;
  const unsigned ek = (er >> 5) & 0x1Fu, ekm = (er >> 6) & 0x1Fu;
  const unsigned xk = (xr >> 5) & 0x1Fu;
  const unsigned gt0 = below(coord);                 // q = coord - j > 0
  const unsigned lt0 = 0x1Fu & ~below(coord + 1);    // q < 0
  const unsigned nb = lt0 | (gt0 & ek & ~ekm) |
                      (cross_ok ? gt0 & ~ek & ekm & xk : 0u);
  // positive arm, tap j = k: E(k) at bit j of e >> 5, E(k + 1) of e >> 6
  const unsigned pk = (e >> 5) & 0x1Fu, pk1 = (e >> 6) & 0x1Fu;
  const int m = limit - 1 - coord;
  const unsigned ltl = below(m);                     // q < limit - 1
  const unsigned gtl = 0x1Fu & ~below(m + 1);        // q > limit - 1
  const unsigned pb = gtl | (ltl & ~pk & pk1) | ((e >> 5) & 1u ? ~pk & 0x1Fu
                                                               : 0u);
  const unsigned n = __ffs(nb | 0x20u) - 1, p = __ffs(pb | 0x20u) - 1;
  return n | p << 3;
}

__global__ void __launch_bounds__(kArmW* kArmRows)
    blblur_arms(const int* __restrict__ edge, uint16_t* __restrict__ arms,
                int h, int w) {
  // bit c of rowm[r] / bit r of colm[c]: the edge at tile row r, column c
  __shared__ unsigned long long rowm[kArmT], colm[kArmT];
  const int bx = blockIdx.x * kArmW - kArmHalo;
  const int by = blockIdx.y * kArmH - kArmHalo;
  const int lane = threadIdx.x, warp = threadIdx.y;
  // all of this warp's loads first, then the ballots
  constexpr int kPerWarp = (kArmT + kArmRows - 1) / kArmRows;
  bool e0[kPerWarp], e1[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int r = warp + i * kArmRows, gy = by + r;
    const bool row = r < kArmT && gy >= 0 && gy < h;
    const int g0 = bx + lane, g1 = bx + 32 + lane;
    e0[i] = row && g0 >= 0 && g0 < w && edge[(size_t)gy * w + g0];
    e1[i] = row && lane < kArmT - 32 && g1 >= 0 && g1 < w &&
            edge[(size_t)gy * w + g1];
  }
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int r = warp + i * kArmRows;
    const unsigned b0 = __ballot_sync(0xFFFFFFFFu, e0[i]);
    const unsigned b1 = __ballot_sync(0xFFFFFFFFu, e1[i]);
    if (lane == 0 && r < kArmT) rowm[r] = b0 | (unsigned long long)b1 << 32;
  }
  __syncthreads();
  {
    const unsigned long long m0 = rowm[lane];
    const unsigned long long m1 = lane < kArmT - 32 ? rowm[32 + lane] : 0ull;
    for (int c = warp; c < kArmT; c += kArmRows) {
      const unsigned b0 = __ballot_sync(0xFFFFFFFFu, (m0 >> c) & 1ull);
      const unsigned b1 = __ballot_sync(0xFFFFFFFFu, (m1 >> c) & 1ull);
      if (lane == 0) colm[c] = b0 | (unsigned long long)b1 << 32;
    }
  }
  __syncthreads();
  const int x = blockIdx.x * kArmW + lane;
  const int tx = lane;
  // bits 0..10 of a window: offsets -5..5 from the pixel (tile column
  // tx + 5, row ty + 5)
  for (int ty = warp; ty < kArmH; ty += kArmRows) {
    const int y = blockIdx.y * kArmH + ty;
    if (x >= w || y >= h) break;
    const unsigned hrow = (unsigned)(rowm[ty + kArmHalo] >> tx) & 0x7FFu;
    const unsigned hcross =
        (unsigned)(rowm[ty + kArmHalo + 1] >> tx) & 0x7FFu;
    const unsigned vcol = (unsigned)(colm[tx + kArmHalo] >> ty) & 0x7FFu;
    const unsigned vcross =
        (unsigned)(colm[tx + kArmHalo + 1] >> ty) & 0x7FFu;
    arms[(size_t)y * w + x] =
        (uint16_t)(arm_pair(hrow, hcross, x, w, y < h - 1) |
                   arm_pair(vcol, vcross, y, h, x < w - 1) << 6);
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// The fused kernel's shared region: (TH + 2 halo) x (TW + 2 halo) pixels,
// each a word L | a << 16 (lo, two buffers), a 16-bit b (hi, two
// buffers) and its arm word.  A thread computes a run of kRun outputs along
// the pass's axis from a window of kRun + 8 taps in registers, so a tap
// is read from shared memory once per run, not once per output.  The
// lanes of a warp take runs on consecutive rows (horizontal) or columns
// (vertical): the row pitches, odd in words for lo and odd in words of two
// b values for hi and the arms, keep either free of bank conflicts.  A
// run may read up to kRun - 1 taps past its region: the pitches and the
// row count leave room for them, and their outputs are not stored.
constexpr int kRun = 8;

template <int F, int TH, int TW>
struct Tile {
  static constexpr int kHalo = kSize * F;
  static constexpr int kLH = TH + 2 * kHalo, kLW = TW + 2 * kHalo;
  static constexpr int kRows = kLH + kRun;
  static constexpr int kPL = (kLW + kRun) | 1;
  static constexpr int kPH = (((kLW + kRun + 1) / 2) | 1) * 2;
  static constexpr int kSmem =
      2 * kRows * kPL * 4 + 2 * kRows * kPH * 2 + kRows * kPH * 2;
};

// Flags of the taps k = 1..4 of an arm of length n: n > k as 0 or 1, and
// the centre's n > 0, in rows of 12 words so that the six rows start in
// six different bank groups.
constexpr int kFlagRow = 12;

// the average of one output from its window w*[j .. j + 8] (tap k at
// j + 4 + k) and the flag rows fn, fp of its arm lengths n, p: the masked
// sums as multiply-adds by 0/1 flags, the division an exact multiply-shift
__device__ __forceinline__ void tap_sum(const unsigned* wl, const unsigned* wh,
                                        int j, unsigned n, unsigned p,
                                        const unsigned* __restrict__ flags,
                                        const unsigned* __restrict__ magic,
                                        unsigned& lo, unsigned& hi) {
  const uint4 an = *(const uint4*)(flags + n * kFlagRow);
  const uint4 ap = *(const uint4*)(flags + p * kFlagRow);
  const unsigned wc = flags[n * kFlagRow + 4] + flags[p * kFlagRow + 4];
  const unsigned fn[4] = {an.x, an.y, an.z, an.w};
  const unsigned fp[4] = {ap.x, ap.y, ap.z, ap.w};
  unsigned sl = wl[j + kSize] * wc, sh = wh[j + kSize] * wc;
#pragma unroll
  for (int k = 1; k <= kSize; ++k) {
    sl += wl[j + kSize - k] * fn[k - 1];
    sh += wh[j + kSize - k] * fn[k - 1];
    sl += wl[j + kSize + k] * fp[k - 1];
    sh += wh[j + kSize + k] * fp[k - 1];
  }
  const unsigned cnt = n + p;
  if (cnt == 0) {
    lo = wl[j + kSize];
    hi = wh[j + kSize];
  } else {
    const unsigned m = magic[cnt];
    lo = ((sl & 0xFFFFu) * m) >> kDivN | (((sl >> 16) * m) >> kDivN) << 16;
    hi = (sh * m) >> kDivN;
  }
}

// one pass over rows [r0, r1) x columns [c0, c1) of the region, src ->
// dst: runs along the rows (horizontal, the arm bits at 0) or along the
// columns (vertical, at 6)
template <int PL, int PH, bool HORIZONTAL>
__device__ __forceinline__ void pass(const unsigned* __restrict__ slo,
                                     const uint16_t* __restrict__ shi,
                                     unsigned* __restrict__ dlo,
                                     uint16_t* __restrict__ dhi,
                                     const uint16_t* __restrict__ arm,
                                     const unsigned* __restrict__ flags,
                                     const unsigned* __restrict__ magic,
                                     int r0, int r1, int c0, int c1) {
  const int nr = r1 - r0, nc = c1 - c0;
  // HORIZONTAL: item = (row, run of columns), rows fastest; else (column,
  // run of rows), columns fastest
  const int across = HORIZONTAL ? nr : nc;
  const int along = HORIZONTAL ? nc : nr;
  const int items = across * ((along + kRun - 1) / kRun);
  const int step_lo = HORIZONTAL ? 1 : PL, step_hi = HORIZONTAL ? 1 : PH;
  for (int it = threadIdx.y * kThreadsX + threadIdx.x; it < items;
       it += kThreadsX * kThreadsY) {
    const int run = it / across, a = it - run * across;
    const int r = HORIZONTAL ? r0 + a : r0 + run * kRun;
    const int c = HORIZONTAL ? c0 + run * kRun : c0 + a;
    const int left = along - run * kRun;  // outputs of this run to store
    const unsigned* pl = slo + (r * PL + c) - kSize * step_lo;
    const uint16_t* ph = shi + (r * PH + c) - kSize * step_hi;
    unsigned wl[kRun + 2 * kSize], wh[kRun + 2 * kSize];
#pragma unroll
    for (int t = 0; t < kRun + 2 * kSize; ++t) {
      wl[t] = pl[t * step_lo];
      wh[t] = ph[t * step_hi];
    }
    const uint16_t* pa = arm + r * PH + c;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const unsigned av = (unsigned)pa[j * step_hi] >> (HORIZONTAL ? 0 : 6);
      unsigned lo, hi;
      tap_sum(wl, wh, j, av & 7, (av >> 3) & 7, flags, magic, lo, hi);
      if (j < left) {
        dlo[r * PL + c + j * step_lo] = lo;
        dhi[r * PH + c + j * step_hi] = (uint16_t)hi;
      }
    }
  }
}

// `rounds` (1..F) rounds of a horizontal then a vertical pass, in -> out
template <int F, int TH, int TW>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    blblur_fused(const int* __restrict__ in, const uint16_t* __restrict__ arms,
                 int* __restrict__ out, int h, int w, int rounds) {
  using T = Tile<F, TH, TW>;
  constexpr int LH = T::kLH, LW = T::kLW, HALO = T::kHalo;
  constexpr int PL = T::kPL, PH = T::kPH, NL = T::kRows * PL,
                NH = T::kRows * PH;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned magic[16];
  __shared__ __align__(16) unsigned flags[8 * kFlagRow];
  unsigned* lo[2] = {(unsigned*)smem, (unsigned*)smem + NL};
  uint16_t* hi[2] = {(uint16_t*)((unsigned*)smem + 2 * NL),
                     (uint16_t*)((unsigned*)smem + 2 * NL) + NH};
  uint16_t* arm = hi[1] + NH;

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  if (tid < 16) magic[tid] = tid == 0 ? 0u : (1u << kDivN) / tid + 1u;
  if (tid < 8 * kFlagRow) {
    // row n: n > 1, n > 2, n > 3, n > 4, n > 0
    const int n = tid / kFlagRow, k = tid % kFlagRow;
    flags[tid] = k < 4 ? n > k + 1 : k == 4 ? n > 0 : 0u;
  }
  const int y0 = blockIdx.y * TH - HALO, x0 = blockIdx.x * TW - HALO;
  // the region: packed values into lo[1] by cp.async, the arm words by
  // plain loads while those are in flight; 0 outside the frame
  for (int r = threadIdx.y; r < LH; r += kThreadsY) {
    const int gy = y0 + r;
    for (int c = threadIdx.x; c < LW; c += kThreadsX) {
      const int gx = x0 + c;
      const bool valid = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const size_t g = valid ? (size_t)gy * w + gx : 0;
      cp_async4(lo[1] + r * PL + c, in + g, valid);
      arm[r * PH + c] = valid ? arms[g] : (uint16_t)0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int r = threadIdx.y; r < LH; r += kThreadsY) {
    for (int c = threadIdx.x; c < LW; c += kThreadsX) {
      const unsigned v = lo[1][r * PL + c];
      lo[0][r * PL + c] = (v & 4095u) | ((v >> 12) & 1023u) << 16;
      hi[0][r * PH + c] = (uint16_t)(v >> 22);
    }
  }
  __syncthreads();
  for (int rd = 0; rd < rounds; ++rd) {
    // horizontal: rows with the halo the later vertical passes read,
    // columns with the halo the later rounds read
    const int hy = kSize * (rounds - rd), hx = kSize * (rounds - 1 - rd);
    pass<PL, PH, true>(lo[0], hi[0], lo[1], hi[1], arm, flags, magic,
                       HALO - hy, HALO + TH + hy, HALO - hx, HALO + TW + hx);
    __syncthreads();
    pass<PL, PH, false>(lo[1], hi[1], lo[0], hi[0], arm, flags, magic,
                        HALO - hx, HALO + TH + hx, HALO - hx, HALO + TW + hx);
    __syncthreads();
  }
  for (int r = threadIdx.y; r < TH; r += kThreadsY) {
    const int gy = blockIdx.y * TH + r;
    if (gy >= h) break;
    for (int c = threadIdx.x; c < TW; c += kThreadsX) {
      const int gx = blockIdx.x * TW + c;
      if (gx >= w) break;
      const unsigned l = lo[0][(r + HALO) * PL + c + HALO];
      const unsigned b = hi[0][(r + HALO) * PH + c + HALO];
      out[(size_t)gy * w + gx] =
          (int)(b << 22 | (l >> 16) << 12 | (l & 0xFFFFu));
    }
  }
}

template <int F, int TH, int TW>
cudaError_t launch_fused(const int* in, const uint16_t* arms, int* out, int h,
                         int w, int rounds, cudaStream_t s) {
  constexpr int smem = Tile<F, TH, TW>::kSmem;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        blblur_fused<F, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  blblur_fused<F, TH, TW>
      <<<grid, dim3(kThreadsX, kThreadsY), smem, s>>>(in, arms, out, h, w,
                                                      rounds);
  return cudaGetLastError();
}

// rounds 1..F from a launch of the fused kernel with F rounds' halo; the
// tiles (TH, TW) are ops/hopper_blblur.py:TILES
cudaError_t fused(int fuse, const int* in, const uint16_t* arms, int* out,
                  int h, int w, int rounds, cudaStream_t s) {
  switch (fuse) {
    case 1: return launch_fused<1, 32, 128>(in, arms, out, h, w, rounds, s);
    case 2: return launch_fused<2, 24, 128>(in, arms, out, h, w, rounds, s);
    case 5: return launch_fused<5, 48, 96>(in, arms, out, h, w, rounds, s);
    case 10: return launch_fused<10, 32, 48>(in, arms, out, h, w, rounds, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t arm_pass(const int* edge, uint16_t* arms, int h, int w,
                     cudaStream_t s) {
  blblur_arms<<<dim3((w + kArmW - 1) / kArmW, (h + kArmH - 1) / kArmH),
                dim3(kArmW, kArmRows), 0, s>>>(edge, arms, h, w);
  return cudaGetLastError();
}

}  // namespace

// out and tmp: (h, w) int32 buffers, neither aliasing packed; arms: (h, w)
// uint16 scratch.  1 + ceil(iters / fuse) launches, the last into out.
extern "C" int rd_blblur(const void* packed, const void* edge, void* out,
                         void* tmp, void* arms, int h, int w, int iters,
                         int fuse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (h <= 0 || w <= 0) return 0;
  if (iters <= 0)
    return (int)cudaMemcpyAsync(out, packed, sizeof(int) * (size_t)h * w,
                                cudaMemcpyDeviceToDevice, s);
  if (fuse != 1 && fuse != 2 && fuse != 5 && fuse != 10)
    return (int)cudaErrorInvalidValue;
  uint16_t* A = (uint16_t*)arms;
  cudaError_t e = arm_pass((const int*)edge, A, h, w, s);
  if (e != cudaSuccess) return (int)e;
  const int n = (iters + fuse - 1) / fuse;
  const int* src = (const int*)packed;
  for (int i = 0; i < n; ++i) {
    int* dst = (int*)((n - 1 - i) % 2 == 0 ? out : tmp);
    const int rounds = i == n - 1 ? iters - fuse * (n - 1) : fuse;
    e = fused(fuse, src, A, dst, h, w, rounds, s);
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return 0;
}

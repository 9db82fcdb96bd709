// Kernel #12 blblur: the edge-limited blur of the rect pipeline, `iters`
// rounds of one horizontal and one vertical pass (blblur0/blblur1,
// oclrect.cl:155-205; host loop oclrect.c:286-296).
//
// Replaces the TPU kernels rectdetect_tpu/ops/pallas_blblur.py:
// _pass_kernel (blblur_pallas_blocked), and with it _kernel (blblur_pallas)
// and _fused_kernel (blblur_pallas_fused), which compute the same function
// and only tile the frame differently for VMEM.
//
// One thread per pixel and one launch per pass (20 per frame at the
// default 10 rounds), ping-ponging between two buffers.  Each thread runs
// the 9-tap break scan of regions._blblur_axis: a negative and a positive
// arm of BLBLURSIZE + 1 taps that stop at edge boundaries, summing the
// three packed-Lab channels and the tap count, then the truncating integer
// average.  Integer arithmetic only, so the result is exact.
//
// Bound: device memory.  The function must read the packed frame and the
// edge map and write the result once, 12 B per pixel for all the passes;
// the operations it needs (a running-sum add and a difference per channel
// and one division per channel, per pixel and pass, with the tap counts
// once per axis) take less time than those bytes on this card.  This
// kernel moves 12 B per pixel in each pass (the taps of the neighbours hit
// in L1), 20 times the bytes the function needs at 10 rounds, and adds
// every tap.  Fusing the rounds into shared-memory tiles with halos (as
// _fused_kernel did in VMEM) is later work.

#include "common.cuh"

namespace {

constexpr int kSize = 4;  // BLBLURSIZE, oclrect.cl:72

__device__ __forceinline__ bool edge_at(const int* __restrict__ edge, int h,
                                        int w, int y, int x) {
  return y >= 0 && y < h && x >= 0 && x < w && edge[y * w + x] != 0;
}

__global__ void blblur_pass(const int* __restrict__ in,
                            const int* __restrict__ edge,
                            int* __restrict__ out, int h, int w,
                            int horizontal) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  // scan axis (sy, sx) per tap, cross axis (cy, cx) for the corner test
  const int sy = horizontal ? 0 : 1, sx = horizontal ? 1 : 0;
  const int coord = horizontal ? x : y;
  const int limit = horizontal ? w : h;
  const bool cross_ok = horizontal ? y < h - 1 : x < w - 1;
  const int cy = horizontal ? 1 : 0, cx = horizontal ? 0 : 1;
#define ED(k) edge_at(edge, h, w, y + (k) * sy, x + (k) * sx)
  int wsum = 0, c0 = 0, c1 = 0, c2 = 0;
  // negative arm: k = 0, -1, ..., -kSize
  for (int k = 0; k >= -kSize; --k) {
    const int q = coord + k;
    bool brk = q < 0;
    brk = brk || (q > 0 && ED(k) && !ED(k - 1));
    brk = brk || (q > 0 && cross_ok && !ED(k) && ED(k - 1) &&
                  edge_at(edge, h, w, y + k * sy + cy, x + k * sx + cx));
    if (brk) break;
    const int v = in[(y + k * sy) * w + x + k * sx];
    ++wsum;
    c0 += v & 4095;
    c1 += (v >> 12) & 1023;
    c2 += (v >> 22) & 1023;
  }
  // positive arm: k = 0..kSize
  const bool oe = ED(0);
  for (int k = 0; k <= kSize; ++k) {
    const int q = coord + k;
    bool brk = q > limit - 1;
    brk = brk || (q < limit - 1 && !ED(k) && ED(k + 1));
    brk = brk || (oe && !ED(k));
    if (brk) break;
    const int v = in[(y + k * sy) * w + x + k * sx];
    ++wsum;
    c0 += v & 4095;
    c1 += (v >> 12) & 1023;
    c2 += (v >> 22) & 1023;
  }
#undef ED
  const int p = y * w + x;
  if (wsum == 0) {
    out[p] = in[p];
    return;
  }
  // averages of in-range channels stay in range: no clamp needed; b
  // reaches the sign bit, so pack unsigned
  const unsigned v = ((unsigned)(c2 / wsum) << 22) |
                     ((unsigned)(c1 / wsum) << 12) | (unsigned)(c0 / wsum);
  out[p] = (int)v;
}

}  // namespace

// out and tmp: (h, w) int32 buffers, neither aliasing packed
extern "C" int rd_blblur(const void* packed, const void* edge, void* out,
                         void* tmp, int h, int w, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g = rd::pixel_grid(h, w), t = rd::pixel_block();
  const int* E = (const int*)edge;
  if (iters <= 0)
    return (int)cudaMemcpyAsync(out, packed, sizeof(int) * (size_t)h * w,
                                cudaMemcpyDeviceToDevice, s);
  const int* src = (const int*)packed;
  for (int i = 0; i < iters; ++i) {
    blblur_pass<<<g, t, 0, s>>>(src, E, (int*)tmp, h, w, 1);
    blblur_pass<<<g, t, 0, s>>>((const int*)tmp, E, (int*)out, h, w, 0);
    src = (const int*)out;
  }
  return (int)cudaGetLastError();
}

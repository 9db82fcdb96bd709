// K1 edge_front: edgevec of the blurred L plane plus the Lab edge
// magnitude of the re-quantized blurred planes, in one pass.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_grad.py:_grad_kernel
// (edge_front_pallas).  Reference: edgevec_f oclimgutil.cl:395-420 (5x5
// bank :346-352), edge_plab oclimgutil.cl:422-437.
//
// Bound: device memory.  Per pixel it reads 12 B (three float planes,
// each neighbour tap hits L1/L2) and writes 12 B (em + 2-float vec), with
// ~150 flops.  One thread per pixel; the 5x5 and 3x3 taps are read
// through reflect-101 index math instead of a padded copy, so nothing but
// the input and the outputs touches device memory.  The accumulation order
// is gradient._grad5's (yy outer, xx inner, zero coefficients skipped),
// the multiply-adds are fused exactly where the JAX reference's are
// (ops/fp.py), and the build uses --fmad=false so that nvcc fuses nothing
// else: every float op rounds as in the plain version.

#include "common.cuh"

namespace {

__device__ __forceinline__ float quant(float x, float scale, float hi) {
  float q = fminf(fmaxf(floorf(x * scale), 0.0f), hi);
  return (q + 0.5f) / scale;
}

__global__ void edge_front_kernel(const float* __restrict__ labb,
                                  float* __restrict__ em,
                                  float* __restrict__ vec, int h, int w) {
  // v5c, oclimgutil.cl:346-352; the y filter is its transpose
  constexpr float V5C[5][5] = {
      {-4.667f, -4.083f, 0.000f, 4.083f, 4.667f},
      {-10.024f, -0.963f, 0.000f, 0.963f, 10.024f},
      {-14.120f, 3.622f, 0.000f, -3.622f, 14.120f},
      {-10.024f, -0.963f, 0.000f, 0.963f, 10.024f},
      {-4.667f, -4.083f, 0.000f, 4.083f, 4.667f}};
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;

  // ---- edgevec on L ----------------------------------------------------
  rd::DotChain cvx, cvy;
#pragma unroll
  for (int yy = -2; yy <= 2; ++yy) {
    const int row = rd::mirror(y + yy, h) * w;
#pragma unroll
    for (int xx = -2; xx <= 2; ++xx) {
      const float cx = V5C[yy + 2][xx + 2];
      const float cy = V5C[xx + 2][yy + 2];
      if (cx == 0.0f && cy == 0.0f) continue;
      const float s = labb[(row + rd::mirror(x + xx, w)) * 3];
      if (cx != 0.0f) cvx.add(cx, s);
      if (cy != 0.0f) cvy.add(cy, s);
    }
  }
  const float vx = cvx.value(), vy = cvy.value();
  const float ivlen = __fmaf_rn(vx, vx, vy * vy);
  // correctly rounded 1/sqrt, as gradient._rsqrt computes it
  const float rs = (float)(1.0 / sqrt((double)fmaxf(ivlen, 1e-30f)));
  const bool big = ivlen > 1e-10f;
  const size_t p = (size_t)y * w + x;
  vec[2 * p] = big ? vx * rs : 0.70710678118f;
  vec[2 * p + 1] = big ? vy * rs : 0.70710678118f;

  // ---- edge_lab on the quantized planes ---------------------------------
  const int ym = rd::mirror(y - 1, h) * w, y0 = y * w,
            yp = rd::mirror(y + 1, h) * w;
  const int xm = rd::mirror(x - 1, w), xp = rd::mirror(x + 1, w);
  const float scales[3] = {4096.0f, 1024.0f, 1024.0f};
  const float his[3] = {4095.0f, 1023.0f, 1023.0f};
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sc = scales[c], hi = his[c];
#define Q(r, cc) quant(labb[((r) + (cc)) * 3 + c], sc, hi)
    const float nmm = Q(ym, xm), nm0 = Q(ym, x), nmp = Q(ym, xp);
    const float n0m = Q(y0, xm), n0p = Q(y0, xp);
    const float npm = Q(yp, xm), np0 = Q(yp, x), npp = Q(yp, xp);
#undef Q
    const float t0 = nm0 + n0m - np0 - n0p;
    const float t1 = nm0 - n0m + n0p - np0;
    const float s1 = (nmp - npm) * t1;
    const float v = fmaxf(0.0f, __fmaf_rn(nmm - npp, t0, s1));  // s0 + s1
    total = c == 0 ? v : total + v;
  }
  em[p] = total > 0.0f ? sqrtf(total) : 0.0f;
}

}  // namespace

extern "C" int rd_edge_front(const void* labb, void* em, void* vec, int h,
                             int w, void* stream) {
  edge_front_kernel<<<rd::pixel_grid(h, w), rd::pixel_block(), 0,
                      (cudaStream_t)stream>>>(
      (const float*)labb, (float*)em, (float*)vec, h, w);
                      rd::count_launch();
  return (int)cudaGetLastError();
}

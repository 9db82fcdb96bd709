// K2 thinthres / thincubic: non-max suppression of the edge magnitude
// along the unit gradient, with bicubic samples at +-1 and +-2 steps.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_thin.py:_thin_kernel
// (thinthres_pallas / thincubic_pallas).  Reference: thinthres_f_f_f2
// oclimgutil.cl:456-471, thincubic_float_float :473-491, bicubic :65-94.
//
// Bound: latency of the gathers.  Per pixel it reads 12 B of its own
// (em, vec) and 4 x 16 taps of em around it, all within +-4 px, which
// stay in L1/L2; it writes 4 B.  The TPU kernel avoided gathers by
// selecting every candidate tap from 64 pre-rolled copies; on the GPU a
// thread simply loads the 16 taps each sample needs (thin.py:8-15), with
// reflect-101 index math for the border.  The sample position, its
// truncation and the Horner bicubicSub sequence are the plain version's,
// op for op (fused multiply-adds where the JAX reference has them), and
// --fmad=false keeps the flat-plateau tie am1 <= a0 exact.

#include "common.cuh"

namespace {

__device__ __forceinline__ float bicubic_sub(float p0, float p1, float p2,
                                             float p3, float x) {
  const float v = p1 - p2;
  const float w = p3 - p0;
  // multiply-adds fused as in the JAX reference (ops/fp.py)
  float u = __fmaf_rn(v, 3.0f, w);
  u = __fmaf_rn(u, x, __fmaf_rn(-4.0f, v, p0 - p1 - w));
  u = __fmaf_rn(u, x, p2 - p0);
  u = u * x * 0.5f + p1;
  return u;
}

// split pos = c + k*v into the integer tap offset and the fraction;
// offsets outside [-kr, kr] take -kr, as the plain select chain does
__device__ __forceinline__ void int_frac(float k, float v, int c, int kr,
                                         int* fd, float* f) {
  const float pos = (float)c + k * v;
  const float ip = truncf(pos);
  int d = (int)ip - c;
  *fd = (d < -kr || d > kr) ? -kr : d;
  *f = pos - ip;
}

__device__ __forceinline__ float sample(const float* __restrict__ em, int h,
                                        int w, int x, int y, float vx,
                                        float vy, float k, int kr) {
  int fdx, fdy;
  float fx, fy;
  int_frac(k, vx, x, kr, &fdx, &fx);
  int_frac(k, vy, y, kr, &fdy, &fy);
  float rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = rd::mirror(y + fdy + j - 1, h) * w;
    float t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = em[r + rd::mirror(x + fdx + i - 1, w)];
    rows[j] = bicubic_sub(t[0], t[1], t[2], t[3], fx);
  }
  return bicubic_sub(rows[0], rows[1], rows[2], rows[3], fy);
}

__global__ void thin_kernel(const float* __restrict__ em,
                            const float* __restrict__ vec,
                            float* __restrict__ out, int h, int w, int cubic,
                            float slack) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t p = (size_t)y * w + x;
  const float vx = vec[2 * p], vy = vec[2 * p + 1];
  const float am2 = sample(em, h, w, x, y, vx, vy, -2.0f, 2);
  const float am1 = sample(em, h, w, x, y, vx, vy, -1.0f, 1);
  const float a0 = em[p];
  const float ap1 = sample(em, h, w, x, y, vx, vy, 1.0f, 1);
  const float ap2 = sample(em, h, w, x, y, vx, vy, 2.0f, 2);
  bool keep;
  if (cubic) {
    keep = (am2 * slack <= a0) && (am1 * slack <= a0) &&
           (a0 >= ap1 * slack) && (a0 >= ap2 * slack);
  } else {
    keep = (am1 <= a0) && (a0 >= ap1);
  }
  out[p] = keep ? am2 + am1 + a0 + ap1 + ap2 : 0.0f;
}

}  // namespace

extern "C" int rd_thin(const void* em, const void* vec, void* out, int h,
                       int w, int cubic, float slack, void* stream) {
  thin_kernel<<<rd::pixel_grid(h, w), rd::pixel_block(), 0,
                (cudaStream_t)stream>>>((const float*)em, (const float*)vec,
                                        (float*)out, h, w, cubic, slack);
                rd::count_launch();
  return (int)cudaGetLastError();
}

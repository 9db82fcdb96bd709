// K1 edge_front: edgevec of the blurred L plane plus the Lab edge
// magnitude of the re-quantized blurred planes, in one pass.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_grad.py:_grad_kernel
// (edge_front_pallas).  Reference: edgevec_f oclimgutil.cl:395-420 (5x5
// bank :346-352), edge_plab oclimgutil.cl:422-437.
//
// Bound: device memory, 12 B read (three interleaved float planes) and
// 12 B written (em + a float2 vec) per pixel, with ~150 flops.  A block
// stages its kTileRows x kTileCols tile with a 2-row halo and 4 columns
// on each side in shared memory, 4 pixels a thread at a time (3 float4
// loads away from the frame's sides), reflect-101 applied to the rows and
// columns while staging, and quantizes each staged pixel once: four
// planes, raw L and the three quantized ones.  Each thread then owns one
// column of kRowsPerThread rows and reads the windows its rows share into
// registers once: the 5x5 L taps of all its rows, then each quantized
// plane's 3x3 taps.  The accumulation order is gradient._grad5's (yy
// outer, xx inner, zero coefficients skipped), the multiply-adds are
// fused exactly where the JAX reference's are (ops/fp.py), and the build
// uses --fmad=false so that nvcc fuses nothing else: every float op
// rounds as in the plain version.  Staging changes where a value is read,
// not how it rounds.
//
// Batch form: b frames of h x w stacked on a leading axis, one grid with
// blockIdx.z = frame; frame z reads and writes only its own plane (its
// reflect-101 stays inside it), so b = 1 is the single-frame kernel.

#include "common.cuh"

namespace {

constexpr int kTileCols = 64;
constexpr int kRowsPerThread = 4;
constexpr int kThreads = 256;
constexpr int kHalo = 2;
constexpr int kThreadRows = kThreads / kTileCols;
constexpr int kTileRows = kThreadRows * kRowsPerThread;
constexpr int kRows = kTileRows + 2 * kHalo;
// staged columns x0 - 4 .. x0 + kTileCols + 3: whole 4-pixel quads, whose
// 12 floats start on 16 bytes where a row does
constexpr int kPad = 4;
constexpr int kCols = kTileCols + 2 * kPad;
constexpr int kQuads = kCols / 4;
constexpr int kQuadsPerThread = (kRows * kQuads + kThreads - 1) / kThreads;
static_assert(kThreads % kTileCols == 0, "whole rows of threads");

// the packed Lab lattice (oclimgutil.cl:36-39): (q + 0.5) * (1 / scale)
// equals (q + 0.5) / scale, since q + 0.5 is exact for q <= 4095 and
// scale is a power of two
__device__ __forceinline__ float quant(float x, float scale, float inv,
                                       float hi) {
  const float q = fminf(fmaxf(floorf(x * scale), 0.0f), hi);
  return (q + 0.5f) * inv;
}

// L on 4096 levels, a and b on 1024
__device__ __forceinline__ float quant_l(float x) {
  return quant(x, 4096.0f, 1.0f / 4096.0f, 4095.0f);
}

__device__ __forceinline__ float quant_ab(float x) {
  return quant(x, 1024.0f, 1.0f / 1024.0f, 1023.0f);
}

// correctly rounded 1/sqrt(max(x, 1e-30)), as gradient._rsqrt computes it
// by rounding the float64 1.0 / sqrt once; chip_smoke.py holds the two
// equal on every float above 1e-10, all that reach a stored output
__device__ __forceinline__ float unit_rsqrt(float x) {
  return __frsqrt_rn(fmaxf(x, 1e-30f));
}

__global__ void __launch_bounds__(kThreads)
    edge_front_kernel(const float* __restrict__ labb, float* __restrict__ em,
                      float2* __restrict__ vec, int h, int w, int vec4) {
  // v5c, oclimgutil.cl:346-352; the y filter is its transpose
  constexpr float V5C[5][5] = {
      {-4.667f, -4.083f, 0.000f, 4.083f, 4.667f},
      {-10.024f, -0.963f, 0.000f, 0.963f, 10.024f},
      {-14.120f, 3.622f, 0.000f, -3.622f, 14.120f},
      {-10.024f, -0.963f, 0.000f, 0.963f, 10.024f},
      {-4.667f, -4.083f, 0.000f, 4.083f, 4.667f}};
  __shared__ __align__(16) float raw[kRows][kCols];
  __shared__ __align__(16) float qnt[3][kRows][kCols];
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  const int y0 = blockIdx.y * kTileRows, x0 = blockIdx.x * kTileCols;
  // this block's frame
  const size_t plane = (size_t)h * w;
  labb += blockIdx.z * plane * 3;
  em += blockIdx.z * plane;
  vec += blockIdx.z * plane;

  // stage: staged pixel (r, c) is frame pixel (mirror(y0 - 2 + r),
  // mirror(x0 - 4 + c)) (rows and columns past h + 1 and w + 1, and
  // columns before -2, feed no stored pixel and are clamped there to stay
  // in mirror's range).  A thread takes 4 pixels of a staged row at a
  // time: away from the frame's sides (and where rows start on 16 bytes)
  // their 12 interleaved floats are 3 float4 loads, elsewhere 12 loads
  // through the mirrored columns.  All of a thread's loads are in flight
  // before its first store; then each pixel is quantized once and the 4
  // pixels go to the 4 planes as one float4 each.
  const bool wide = vec4 && x0 >= kPad && x0 + kTileCols + kPad <= w;
  float f[kQuadsPerThread][12];
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    const int i = tid + k * kThreads, r = i / kQuads;
    const int c = 4 * (i - r * kQuads);
    if (i >= kRows * kQuads) continue;
    const float* row =
        labb + (size_t)rd::mirror(min(y0 - kHalo + r, h + 1), h) * w * 3;
    if (wide) {
      const float4* src =
          reinterpret_cast<const float4*>(row + 3 * (x0 - kPad + c));
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float4 x = src[v];
        f[k][4 * v] = x.x;
        f[k][4 * v + 1] = x.y;
        f[k][4 * v + 2] = x.z;
        f[k][4 * v + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gx = rd::mirror(min(max(x0 - kPad + c + e, -2), w + 1), w);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) f[k][3 * e + ch] = row[3 * gx + ch];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    const int i = tid + k * kThreads, r = i / kQuads;
    const int c = 4 * (i - r * kQuads);
    if (i >= kRows * kQuads) continue;
    // pixel e of the quad: L, a, b at floats 3 e, 3 e + 1, 3 e + 2
    const float* p = f[k];
    *reinterpret_cast<float4*>(&raw[r][c]) =
        make_float4(p[0], p[3], p[6], p[9]);
    *reinterpret_cast<float4*>(&qnt[0][r][c]) =
        make_float4(quant_l(p[0]), quant_l(p[3]), quant_l(p[6]),
                    quant_l(p[9]));
    *reinterpret_cast<float4*>(&qnt[1][r][c]) =
        make_float4(quant_ab(p[1]), quant_ab(p[4]), quant_ab(p[7]),
                    quant_ab(p[10]));
    *reinterpret_cast<float4*>(&qnt[2][r][c]) =
        make_float4(quant_ab(p[2]), quant_ab(p[5]), quant_ab(p[8]),
                    quant_ab(p[11]));
  }
  __syncthreads();

  // vec: edgevec on L, the 5x5 taps of this thread's rows in registers
  const int lx = threadIdx.x, ly0 = threadIdx.y * kRowsPerThread;
  const int x = x0 + lx;
  float win[kRowsPerThread + 4][5];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread + 4; ++rr) {
#pragma unroll
    for (int cc = 0; cc < 5; ++cc) win[rr][cc] = raw[ly0 + rr][lx + 2 + cc];
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    rd::DotChain cvx, cvy;
#pragma unroll
    for (int yy = -2; yy <= 2; ++yy) {
#pragma unroll
      for (int xx = -2; xx <= 2; ++xx) {
        const float cx = V5C[yy + 2][xx + 2];
        const float cy = V5C[xx + 2][yy + 2];
        const float s = win[r + yy + 2][xx + 2];
        if (cx != 0.0f) cvx.add(cx, s);
        if (cy != 0.0f) cvy.add(cy, s);
      }
    }
    const float vx = cvx.value(), vy = cvy.value();
    const float ivlen = __fmaf_rn(vx, vx, vy * vy);
    const float rs = unit_rsqrt(ivlen);
    const bool big = ivlen > 1e-10f;
    const int y = y0 + ly0 + r;
    if (x < w && y < h) {
      vec[(size_t)y * w + x] = big ? make_float2(vx * rs, vy * rs)
                                   : make_float2(0.70710678118f,
                                                 0.70710678118f);
    }
  }

  // em: edge_lab on the quantized planes, a plane's 3x3 taps at a time
  float total[kRowsPerThread];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float q[kRowsPerThread + 2][3];
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread + 2; ++rr) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        q[rr][cc] = qnt[c][ly0 + 1 + rr][lx + 3 + cc];
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float nmm = q[r][0], nm0 = q[r][1], nmp = q[r][2];
      const float n0m = q[r + 1][0], n0p = q[r + 1][2];
      const float npm = q[r + 2][0], np0 = q[r + 2][1], npp = q[r + 2][2];
      const float t0 = nm0 + n0m - np0 - n0p;
      const float t1 = nm0 - n0m + n0p - np0;
      const float s1 = (nmp - npm) * t1;
      const float v = fmaxf(0.0f, __fmaf_rn(nmm - npp, t0, s1));  // s0 + s1
      total[r] = c == 0 ? v : total[r] + v;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int y = y0 + ly0 + r;
    if (x < w && y < h) {
      em[(size_t)y * w + x] = total[r] > 0.0f ? sqrtf(total[r]) : 0.0f;
    }
  }
}

}  // namespace

// labb: (b, h, w, 3) float32; em: (b, h, w); vec: (b, h, w, 2); 1 <= b <=
// 65535 (gridDim.z)
extern "C" int rd_edge_front(const void* labb, void* em, void* vec, int h,
                             int w, int b, void* stream) {
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileCols - 1) / kTileCols,
                  (h + kTileRows - 1) / kTileRows, b);
  // rows start on 16 bytes: the base is aligned and a row is 12 w bytes;
  // with w % 4 == 0 a frame is 12 h w bytes, a multiple of 16 too, so every
  // frame's base is aligned when the first one is
  const int vec4 = w % 4 == 0 && reinterpret_cast<size_t>(labb) % 16 == 0;
  edge_front_kernel<<<grid, dim3(kTileCols, kThreadRows), 0,
                      (cudaStream_t)stream>>>(
      (const float*)labb, (float*)em, (float2*)vec, h, w, vec4);
  rd::count_launch();
  return (int)cudaGetLastError();
}

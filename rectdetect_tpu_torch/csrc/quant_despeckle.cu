// Kernel #5 quant_despeckle: quantize the packed-Lab plane to n levels per
// channel (quantize, oclrect.cl:207-216), then give every on-edge pixel the
// nearest-colour off-edge 3x3 neighbour of the quantized plane (despeckle,
// oclrect.cl:218-244).
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
// _quant_despeckle_kernel (quant_despeckle_pallas).
//
// One thread per pixel; each quantizes its own pixel and its 8 neighbours
// (the neighbours' loads hit in L1), so the quantized plane never goes to
// device memory.  Bound: device memory, 8 B read (packed + edge magnitude)
// and 4 B written per pixel.
//
// Floats as the jitted JAX composition (ops/regions.py): the lattice snap
// floor(fma(v, n, 0.5)) / n with a correctly rounded division; the distance
// sqrtf((dL*dL + da*da) + db*db) with no fused multiply-add (built with
// --fmad=false) and a correctly rounded sqrt.  Ties keep the first
// neighbour in (dy, dx) scan order: strict <.

#include "common.cuh"

namespace {

__device__ __forceinline__ int floor_clamp(float v, float hi) {
  return (int)fminf(fmaxf(floorf(v), 0.0f), hi);
}

__device__ __forceinline__ int quantize(int p, float n0, float n1, float n2) {
  const float lf = ((float)(p & 4095) + 0.5f) * (1.0f / 4096.0f);
  const float af = ((float)((p >> 12) & 1023) + 0.5f) * (1.0f / 1024.0f);
  const float bf = ((float)((p >> 22) & 1023) + 0.5f) * (1.0f / 1024.0f);
  const float ql = floorf(__fmaf_rn(lf, n0, 0.5f)) / n0;
  const float qa = floorf(__fmaf_rn(af, n1, 0.5f)) / n1;
  const float qb = floorf(__fmaf_rn(bf, n2, 0.5f)) / n2;
  const unsigned v = ((unsigned)floor_clamp(qb * 1024.0f, 1023.0f) << 22) |
                     ((unsigned)floor_clamp(qa * 1024.0f, 1023.0f) << 12) |
                     (unsigned)floor_clamp(ql * 4096.0f, 4095.0f);
  return (int)v;
}

__device__ __forceinline__ void lab_of(int p, float* l, float* a, float* b) {
  *l = ((float)(p & 4095) + 0.5f) * (1.0f / 4096.0f);
  *a = ((float)((p >> 12) & 1023) + 0.5f) * (1.0f / 1024.0f);
  *b = ((float)((p >> 22) & 1023) + 0.5f) * (1.0f / 1024.0f);
}

__global__ void quant_despeckle_kernel(const int* __restrict__ packed,
                                       const float* __restrict__ emag,
                                       int* __restrict__ out, int h, int w,
                                       float n0, float n1, float n2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  const int self = quantize(packed[p], n0, n1, n2);
  if (!(emag[p] >= 1e-6f)) {
    out[p] = self;
    return;
  }
  float l0, a0, b0;
  lab_of(self, &l0, &a0, &b0);
  float best_d = 1e10f;
  int best = self;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int yy = y + dy, xx = x + dx;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const int q = yy * w + xx;
      if (emag[q] >= 1e-6f) continue;
      const int cand = quantize(packed[q], n0, n1, n2);
      float l, a, b;
      lab_of(cand, &l, &a, &b);
      const float dl = l - l0, da = a - a0, db = b - b0;
      const float d = sqrtf((dl * dl + da * da) + db * db);
      if (d < best_d) {
        best_d = d;
        best = cand;
      }
    }
  }
  out[p] = best;
}

}  // namespace

extern "C" int rd_quant_despeckle(const void* packed, const void* emag,
                                  void* out, int h, int w, int n0, int n1,
                                  int n2, void* stream) {
  quant_despeckle_kernel<<<rd::pixel_grid(h, w), rd::pixel_block(), 0,
                           (cudaStream_t)stream>>>(
      (const int*)packed, (const float*)emag, (int*)out, h, w, (float)n0,
      (float)n1, (float)n2);
  return (int)cudaGetLastError();
}

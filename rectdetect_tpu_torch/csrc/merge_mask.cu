// Kernel #6 merge_mask: the positive simpleJunction of the strong-edge
// labels (oclrect.cl:74-95) and the merge mask built on it (mkMergeMask0/1,
// oclrect.cl:246-287): the ring 16 <= d^2 < 36 around every junction pixel,
// cleared inside the d^2 < 64 disk around line ends (jn == 2) and the
// d^2 < 16 disk around junction cores (jn > 2).
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
// _merge_mask_kernel (merge_mask_pallas).
//
// Bound: device memory, 4 B read and 4 B written per pixel.  The TPU kernel
// rolled (bh x full width) VMEM slabs through log-depth window-OR pyramids;
// here one block owns a 32x32 output tile and stages it in shared memory
// twice: the "label > 0" bytes with an 8-pixel halo, then the junction code
// with a 7-pixel halo (the largest element's radius), so every tap of the
// three structuring elements is a shared-memory byte read.  Most pixels lie
// outside every ring, and their clearing disks are never read.  Pixels
// outside the frame read 0; the junction's interior test uses frame
// coordinates, as in the reference.

#include "common.cuh"

namespace {

constexpr int kTile = 32;                  // output tile, both axes
constexpr int kRowsPerThread = kTile / rd::kBlockY;
constexpr int kJHalo = 7;                  // d^2 < 64 -> |d| <= 7
constexpr int kNHalo = kJHalo + 1;         // the junction's 3x3 stencil
constexpr int kJW = kTile + 2 * kJHalo;    // 46
constexpr int kNW = kTile + 2 * kNHalo;    // 48

__global__ void merge_mask_kernel(const int* __restrict__ lbl,
                                  int* __restrict__ out, int h, int w) {
  __shared__ unsigned char nz[kNW * kNW];
  __shared__ unsigned char jn[kJW * kJW];
  const int tid = threadIdx.y * rd::kBlockX + threadIdx.x;
  const int nthreads = rd::kBlockX * rd::kBlockY;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;

  for (int i = tid; i < kNW * kNW; i += nthreads) {
    const int gy = y0 - kNHalo + i / kNW, gx = x0 - kNHalo + i % kNW;
    nz[i] = gy >= 0 && gy < h && gx >= 0 && gx < w && lbl[gy * w + gx] > 0;
  }
  __syncthreads();
  for (int i = tid; i < kJW * kJW; i += nthreads) {
    const int jy = i / kJW, jx = i % kJW;
    const int gy = y0 - kJHalo + jy, gx = x0 - kJHalo + jx;
    const unsigned char* c = nz + (jy + 1) * kNW + (jx + 1);
    int code = 0;
    if (*c && gy >= 1 && gy < h - 1 && gx >= 1 && gx < w - 1) {
      const int cnt = c[-kNW - 1] + c[-kNW] + c[-kNW + 1] + c[-1] + c[1] +
                      c[kNW - 1] + c[kNW] + c[kNW + 1];
      code = cnt > 0 ? cnt + 1 : 0;
    }
    jn[i] = (unsigned char)code;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int ly = threadIdx.y + r * rd::kBlockY;
    const int gy = y0 + ly;
    if (gy >= h || gx >= w) continue;
    const unsigned char* c = jn + (ly + kJHalo) * kJW + (threadIdx.x + kJHalo);
    bool ring = false;
#pragma unroll
    for (int dy = -5; dy <= 5; ++dy) {
#pragma unroll
      for (int dx = -5; dx <= 5; ++dx) {
        const int d2 = dy * dy + dx * dx;
        if (d2 >= 16 && d2 < 36) ring |= c[dy * kJW + dx] != 0;
      }
    }
    bool clear = false;
    if (ring) {
#pragma unroll
      for (int dy = -7; dy <= 7; ++dy) {
#pragma unroll
        for (int dx = -7; dx <= 7; ++dx) {
          const int d2 = dy * dy + dx * dx;
          const int v = c[dy * kJW + dx];
          if (d2 < 64) clear |= v == 2;
          if (d2 < 16) clear |= v > 2;
        }
      }
    }
    out[gy * w + gx] = ring && !clear;
  }
}

}  // namespace

extern "C" int rd_merge_mask(const void* lbl, void* out, int h, int w,
                             void* stream) {
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  merge_mask_kernel<<<grid, rd::pixel_block(), 0, (cudaStream_t)stream>>>(
      (const int*)lbl, (int*)out, h, w);
  rd::count_launch();
  return (int)cudaGetLastError();
}

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
// arrays; here one block stages a 32x32 tile with a 3-pixel halo in shared
// memory (background -1 and pixels outside the frame read 0, which no slot
// takes), and each thread keeps its 4 slots in registers while it walks the
// 49 taps.

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = kTile / rd::kBlockY;
constexpr int kHalo = 3;
constexpr int kTW = kTile + 2 * kHalo;

__global__ void distinct_bids_kernel(const int* __restrict__ bnd,
                                     int* __restrict__ out, int h, int w) {
  __shared__ int tile[kTW * kTW];
  const int tid = threadIdx.y * rd::kBlockX + threadIdx.x;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  for (int i = tid; i < kTW * kTW; i += rd::kBlockX * rd::kBlockY) {
    const int gy = y0 - kHalo + i / kTW, gx = x0 - kHalo + i % kTW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    tile[i] = in ? max(bnd[gy * w + gx], 0) : 0;
  }
  __syncthreads();

  const long long n = (long long)h * w;
  const int gx = x0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int ly = threadIdx.y + r * rd::kBlockY;
    const int gy = y0 + ly;
    if (gy >= h || gx >= w) continue;
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    for (int dy = 0; dy < 2 * kHalo + 1; ++dy) {
      const int* row = tile + (ly + dy) * kTW + threadIdx.x;
#pragma unroll
      for (int dx = 0; dx < 2 * kHalo + 1; ++dx) {
        const int b = row[dx];
        if (b > 0 && b != s0 && b != s1 && b != s2 && b != s3) {
          if (s0 == 0) {
            s0 = b;
          } else if (s1 == 0) {
            s1 = b;
          } else if (s2 == 0) {
            s2 = b;
          } else if (s3 == 0) {
            s3 = b;
          }
        }
      }
    }
    const long long p = (long long)gy * w + gx;
    out[p] = s0;
    out[n + p] = s1;
    out[2 * n + p] = s2;
    out[3 * n + p] = s3;
  }
}

}  // namespace

// out: (4, h, w) int32, slot-major
extern "C" int rd_distinct_bids(const void* bnd, void* out, int h, int w,
                                void* stream) {
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  distinct_bids_kernel<<<grid, rd::pixel_block(), 0, (cudaStream_t)stream>>>(
      (const int*)bnd, (int*)out, h, w);
  rd::count_launch();
  return (int)cudaGetLastError();
}

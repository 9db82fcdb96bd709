// Kernel #8 despeckle2: region sizes (calcSize, oclrect.cl:336-348), then
// every region of <= thre pixels takes the label of its largest in-frame
// 3x3 neighbour (despeckle2, oclrect.cl:350-371), the first maximum in
// (dy, dx) scan order (strict >).
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
// _despeckle2_kernel (despeckle2_pallas) and the size pass that feeds it.
//
// Bound: device memory, 4 B read and 4 B written per pixel, plus the size
// table (4 B per pixel, in L2).  The TPU kernel avoided a full-frame
// scatter and gather (TPU scatters pay per index) with run-length sizes and
// a forward-fill scan in VMEM; on the GPU the histogram is one atomicAdd
// pass, warp-aggregated because neighbouring pixels mostly share a region
// (one frame-sized region would otherwise queue ~10^6 atomics on one
// address), and the absorption reads the sizes it needs directly.  Labels
// lie in [0, h*w): every pixel belongs to a region.

#include "common.cuh"

namespace {

__global__ void sizes_kernel(const int* __restrict__ label,
                             int* __restrict__ sizes, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned active = __ballot_sync(0xffffffffu, p < n);
  if (p >= n) return;
  const int l = min(max(label[p], 0), n - 1);
  // one atomic per distinct label of the warp
  const unsigned same = __match_any_sync(active, l);
  if ((int)(threadIdx.x & 31) == __ffs(same) - 1) {
    atomicAdd(sizes + l, __popc(same));
  }
}

__global__ void absorb_kernel(const int* __restrict__ label,
                              const int* __restrict__ sizes,
                              int* __restrict__ out, int h, int w, int thre) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int n = h * w;
  const int p = y * w + x;
  const int lb = label[p];
  if (sizes[min(max(lb, 0), n - 1)] > thre) {
    out[p] = lb;
    return;
  }
  int best_sz = 0, best_lb = lb;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int yy = y + dy, xx = x + dx;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const int c = label[yy * w + xx];
      const int s = sizes[min(max(c, 0), n - 1)];
      if (s > best_sz) {
        best_sz = s;
        best_lb = c;
      }
    }
  }
  out[p] = best_lb;
}

}  // namespace

// sizes: (h*w,) int32 scratch
extern "C" int rd_despeckle2(const void* label, void* sizes, void* out, int h,
                             int w, int thre, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  cudaError_t err = cudaMemsetAsync(sizes, 0, sizeof(int) * (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  sizes_kernel<<<(n + 255) / 256, 256, 0, s>>>((const int*)label,
                                               (int*)sizes, n);
  rd::count_launch();
  absorb_kernel<<<rd::pixel_grid(h, w), rd::pixel_block(), 0, s>>>(
      (const int*)label, (const int*)sizes, (int*)out, h, w, thre);
  rd::count_launch();
  return (int)cudaGetLastError();
}

// Kernel #9 links CCL: the region merge's labels (labelxPreprocess +
// labelMergeMain, oclrect.cl:289-334) at their exact fixpoint, every pixel
// labelled with the minimum flat index of its 4-connected component over
// the merge links.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_ccl.py:
// _links_block_kernel with its seam union (_links_seam_union) and resolve,
// as reached through label_links_blocked / label_merge_exact.
//
// Bound: latency of dependent loads and atomics (every pixel is foreground
// and one region may span the frame).  The TPU flooded (bh x width) VMEM
// blocks with segmented row/column min-scans to their fixpoint and stitched
// the block seams in a second pass; here it is K4's union-find (common.cuh:
// atomicMin linking, path halving), in three launches:
//   init:    parent[p] = p;
//   merge:   each pixel evaluates the links to its right and lower
//            neighbours from the despeckled colours, the merge mask and the
//            strong edges (regions._merge_pairs of the JAX package) and
//            unites across each, so the link masks never reach device
//            memory;
//   flatten: label[p] = root of p, in place.
// A link between a and b (b right of or below a) holds when b is not on a
// strong edge and the pixel merging is interior with equal colours or a
// mask bit, or, whatever the edges, when the colours are equal and b is
// the lower pixel or (right link) b's upper neighbour differs from b.

#include "common.cuh"

namespace {

__device__ __forceinline__ bool interior(int y, int x, int h, int w) {
  return y >= 1 && y < h - 1 && x >= 1 && x < w - 1;
}

__global__ void init_kernel(int* parent, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) parent[p] = p;
}

__global__ void merge_kernel(const int* __restrict__ packed,
                             const int* __restrict__ mask,
                             const int* __restrict__ edge, int* parent, int h,
                             int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int a = y * w + x;
  const int ca = packed[a];
  const bool ma = mask[a] != 0;
  const bool ia = interior(y, x, h, w);
  if (x + 1 < w) {
    const int b = a + 1;
    const int cb = packed[b];
    const bool eq = ca == cb;
    bool link = edge[b] <= 0 &&
                ((ia && (eq || ma)) ||
                 (interior(y, x + 1, h, w) && (eq || mask[b] != 0)));
    link |= eq && !(y > 0 && packed[b - w] == cb);
    if (link) rd::unite(parent, a, b);
  }
  if (y + 1 < h) {
    const int b = a + w;
    const bool eq = ca == packed[b];
    bool link = edge[b] <= 0 &&
                ((ia && (eq || ma)) ||
                 (interior(y + 1, x, h, w) && (eq || mask[b] != 0)));
    link |= eq;
    if (link) rd::unite(parent, a, b);
  }
}

__global__ void flatten_kernel(int* parent, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) parent[p] = rd::find_root(parent, p);
}

}  // namespace

// out: (h, w) int32, the parent array and then the labels
extern "C" int rd_label_merge(const void* packed, const void* mask,
                              const void* edge, void* out, int h, int w,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  int* L = (int*)out;
  init_kernel<<<(n + 255) / 256, 256, 0, s>>>(L, n);
  merge_kernel<<<rd::pixel_grid(h, w), rd::pixel_block(), 0, s>>>(
      (const int*)packed, (const int*)mask, (const int*)edge, L, h, w);
  flatten_kernel<<<(n + 255) / 256, 256, 0, s>>>(L, n);
  return (int)cudaGetLastError();
}

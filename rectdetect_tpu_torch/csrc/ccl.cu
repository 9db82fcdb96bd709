// K4 label_components: exact 8-connected equal-value connected-component
// labels, each pixel labelled with the minimum flat index of its
// component, background (value == bgc) -1.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_ccl.py:
// _ccl_block_kernel together with its XLA seam pass (_seam_union) and
// root resolve (_resolve), as reached through label_components_exact /
// label_components_pieces.  Reference: labelxPreprocess / label8xMain,
// oclimgutil.cl:495-538.
//
// Bound: latency of dependent loads and atomics, not bandwidth (the frame
// is read once, the parent array is a few MB and stays in L2).  The TPU
// flooded blocks in VMEM for a capped number of rounds and stitched the
// seams in a second pass; the GPU has atomics, so this is a union-find in
// three launches (arXiv 1708.08180, 1712.09789):
//   init:    parent[p] = p for foreground, -1 for background;
//   merge:   every foreground pixel unites with its equal-valued
//            neighbours to the W, NW, N and NE (each 8-edge once), linking
//            the larger root under the smaller with atomicMin; finds use
//            path halving, also by atomicMin;
//   flatten: label[p] = root of p.
// Every parent pointer only ever decreases and stays inside its
// component, so each root is its component's minimum flat index: the
// labels are exact and equal to the JAX labels whatever order the atomics
// run in.  There is no round cap.  find_root / unite live in common.cuh,
// shared with the links CCL (links_ccl.cu).

#include "common.cuh"

namespace {

__global__ void init_kernel(const int* __restrict__ pix, int* parent, int h,
                            int w, int bgc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  parent[p] = pix[p] != bgc ? p : -1;
}

__global__ void merge_kernel(const int* __restrict__ pix, int* parent, int h,
                             int w, int bgc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  const int v = pix[p];
  if (v == bgc) return;
  if (x > 0 && pix[p - 1] == v) rd::unite(parent, p, p - 1);
  if (y > 0) {
    const int q = p - w;
    if (x > 0 && pix[q - 1] == v) rd::unite(parent, p, q - 1);
    if (pix[q] == v) rd::unite(parent, p, q);
    if (x + 1 < w && pix[q + 1] == v) rd::unite(parent, p, q + 1);
  }
}

__global__ void flatten_kernel(const int* __restrict__ pix, int* parent,
                               int* __restrict__ out, int h, int w,
                               int bgc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  out[p] = pix[p] != bgc ? rd::find_root(parent, p) : -1;
}

}  // namespace

// parent: (h, w) int32 scratch
extern "C" int rd_label_components(const void* pix, void* out, void* parent,
                                   int h, int w, int bgc, void* stream) {
  const dim3 g = rd::pixel_grid(h, w), t = rd::pixel_block();
  cudaStream_t s = (cudaStream_t)stream;
  const int* P = (const int*)pix;
  int* L = (int*)parent;
  init_kernel<<<g, t, 0, s>>>(P, L, h, w, bgc);
  rd::count_launch();
  merge_kernel<<<g, t, 0, s>>>(P, L, h, w, bgc);
  rd::count_launch();
  flatten_kernel<<<g, t, 0, s>>>(P, L, (int*)out, h, w, bgc);
  rd::count_launch();
  return (int)cudaGetLastError();
}

// Shared parts of the two block-based union-finds, K4 (ccl.cu) and the
// links CCL (links_ccl.cu): the tile shape and the flatten pass.
#pragma once

#include "common.cuh"

namespace rd {
namespace {

constexpr int kTW = 32;  // tile columns: one warp a row
constexpr int kTH = 16;  // tile rows

// label[p] = root of p, in place: up the chain from p's tile root, reading
// only, so no atomics; background (-1) stays as it is.  Frame blockIdx.y
// of a batch is the parent array of n entries at the offset y n.
__global__ void flatten_kernel(int* parent, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  parent += (size_t)blockIdx.y * n;
  int r = load_parent(parent + p);
  if (r < 0) return;
  for (int q = load_parent(parent + r); q != r; q = load_parent(parent + r))
    r = q;
  parent[p] = r;
}

}  // namespace
}  // namespace rd

// Shared helpers of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace rd {

// the library's launch counter (launches.cu): each entry point calls this
// once for every kernel it launches
void count_launch();

// reflect-101 index (the reference's mirror(), oclimgutil.cl:41-45);
// valid for i in [-(n-1), 2n-2]
__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Left-to-right sum of products a0*b0 + a1*b1 + ... with the multiply-add
// contraction XLA:CPU applies to the jitted JAX reference (ops/fp.py):
// a1*b1 rounded, fused with a0*b0, then fused with each later term.
struct DotChain {
  float a0 = 0.0f, b0 = 0.0f, acc = 0.0f;
  int n = 0;
  __device__ __forceinline__ void add(float a, float b) {
    if (n == 0) {
      a0 = a;
      b0 = b;
    } else if (n == 1) {
      acc = __fmaf_rn(a0, b0, a * b);
    } else {
      acc = __fmaf_rn(a, b, acc);
    }
    ++n;
  }
  __device__ __forceinline__ float value() const {
    return n == 1 ? a0 * b0 : acc;
  }
};

// one thread per pixel over an (h, w) frame
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

inline dim3 pixel_grid(int h, int w) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
}

inline dim3 pixel_block() { return dim3(kBlockX, kBlockY); }

// Union-find over a parent array of flat indices (K4, ccl.cu, and the
// links CCL, links_ccl.cu).  Every pointer only ever decreases, by
// atomicMin, and stays inside its component, so each root is its
// component's minimum flat index whatever order the threads run in.
__device__ __forceinline__ int load_parent(const int* p) {
  return *(const volatile int*)p;
}

// root of x, halving the path on the way (each visited node is pointed at
// its grandparent)
__device__ inline int find_root(int* parent, int x) {
  while (true) {
    const int px = load_parent(parent + x);
    if (px == x) return x;
    const int gp = load_parent(parent + px);
    if (gp < px) atomicMin(parent + x, gp);
    x = gp;
  }
}

// join the sets of a and b, the larger root linked under the smaller
__device__ inline void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // link root b under a; if b stopped being a root meanwhile, retry
    // with what it points to now
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

}  // namespace rd

// K3 strings_chain: the edge -> strings morphology prefix.
//   rect:        simpleJunction(positive) -> simpleConnect(rect)
//                -> stringify(parity 0) -> stringify(parity 1)
//                (oclrect.c:265-272, oclrect.cl:74-121)
//   poly_branch: simpleJunction -> simpleConnect(poly) -> stringify x2
//                -> removeBranch (oclpolyline.c stages 1-4,
//                oclpolyline.cl:66-147)
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:_morph_kernel
// (morph_chain_pallas); the semantics are ops/morphology.py's, borders
// included (each stage zeroes its own border ring, reads outside the
// frame are 0).
//
// Bound: device memory and launch latency.  Each stage reads a 3x3 or
// 5x5 int32 neighbourhood (L1/L2 hits) and writes 4 B per pixel, so the
// chain moves ~8 B per pixel per stage through device memory, five stages
// in all.  One launch per stage: stringify's parity 1 must read parity 0's
// finished output, and a separate launch is the grid-wide barrier.
// Keeping the chain in a shared-memory tile with a halo, as the TPU
// kernel did in VMEM, is later work.

#include "common.cuh"

namespace {

__device__ __forceinline__ int at(const int* __restrict__ img, int h, int w,
                                  int y, int x) {
  return (y < 0 || y >= h || x < 0 || x >= w) ? 0 : img[y * w + x];
}

__device__ __forceinline__ bool interior(int h, int w, int y, int x,
                                         int m) {
  return y >= m && y < h - m && x >= m && x < w - m;
}

#define PIXEL_INDEX                                       \
  const int x = blockIdx.x * blockDim.x + threadIdx.x;    \
  const int y = blockIdx.y * blockDim.y + threadIdx.y;    \
  if (x >= w || y >= h) return;                           \
  const int p = y * w + x;

// 8-neighbour offsets, NEIGH8 order (oclpolyline.cl:63-64)
__constant__ int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
__constant__ int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};

// simpleJunction (oclpolyline.cl:66-87 / oclrect.cl:74-95)
__global__ void junction_kernel(const int* __restrict__ in, int* out, int h,
                                int w, int positive_only) {
  PIXEL_INDEX
  int v = in[p];
  const bool nz = positive_only ? v > 0 : v != 0;
  int cnt = 1;
  for (int k = 0; k < 8; ++k) {
    const int u = at(in, h, w, y + kDy[k], x + kDx[k]);
    cnt += (positive_only ? u > 0 : u != 0) ? 1 : 0;
  }
  out[p] = (interior(h, w, y, x, 1) && nz && cnt > 1) ? cnt : 0;
}

// simpleConnect, poly patterns (oclpolyline.cl:89-110)
__global__ void connect_poly_kernel(const int* __restrict__ jn, int* out,
                                    int h, int w) {
  PIXEL_INDEX
#define N(dy, dx) at(jn, h, w, y + (dy), x + (dx))
  bool b = (N(0, -2) != 0) && (N(0, -1) == 2) && (N(0, 1) == 2) && (N(0, 2) != 0);
  b |= (N(-2, 0) != 0) && (N(-1, 0) == 2) && (N(1, 0) == 2) && (N(2, 0) != 0);
  b |= (N(-2, -2) != 0) && (N(-1, -1) == 2) && (N(1, 1) == 2) && (N(2, 2) != 0);
  b |= (N(-2, 2) != 0) && (N(-1, 1) == 2) && (N(1, -1) == 2) && (N(2, -2) != 0);
  b |= (N(0, 2) != 0) && (N(0, 1) == 2) && (N(1, -1) == 2) && (N(1, -2) != 0);
  b |= (N(0, -2) != 0) && (N(0, -1) == 2) && (N(1, 1) == 2) && (N(1, 2) != 0);
  b |= (N(-2, 1) != 0) && (N(-1, 1) == 2) && (N(1, 0) == 2) && (N(2, 0) != 0);
  b |= (N(-2, -1) != 0) && (N(-1, -1) == 2) && (N(1, 0) == 2) && (N(2, 0) != 0);
#undef N
  out[p] = (interior(h, w, y, x, 2) && (jn[p] != 0 || b)) ? 1 : 0;
}

// simpleConnect, rect patterns (oclrect.cl:97-121)
__global__ void connect_rect_kernel(const int* __restrict__ jn, int* out,
                                    int h, int w) {
  PIXEL_INDEX
#define N(dy, dx) at(jn, h, w, y + (dy), x + (dx))
  bool b = (N(0, -1) == 2) && (N(0, 1) != 0);
  b |= (N(0, -1) != 0) && (N(0, 1) == 2);
  b |= (N(-1, 0) == 2) && (N(1, 0) != 0);
  b |= (N(-1, 0) != 0) && (N(1, 0) == 2);
  b |= (N(-1, -1) == 2) && (N(1, 1) == 2);
  b |= (N(-1, 1) == 2) && (N(1, -1) == 2);
  b |= (N(0, 1) == 2) && (N(1, -1) == 2);
  b |= (N(0, -1) == 2) && (N(1, 1) == 2);
  b |= (N(-1, 1) == 2) && (N(1, 0) == 2);
  b |= (N(-1, -1) == 2) && (N(1, 0) == 2);
#undef N
  out[p] = (interior(h, w, y, x, 2) && (jn[p] != 0 || b)) ? 1 : 0;
}

// stringify (oclpolyline.cl:112-124): on the frame-global checkerboard
// parity, clear a pixel with both a vertical and a horizontal neighbour
__global__ void stringify_kernel(const int* __restrict__ in, int* out, int h,
                                 int w, int parity) {
  PIXEL_INDEX
  const bool up = at(in, h, w, y - 1, x) != 0;
  const bool dn = at(in, h, w, y + 1, x) != 0;
  const bool lf = at(in, h, w, y, x - 1) != 0;
  const bool rt = at(in, h, w, y, x + 1) != 0;
  const bool corner = (up && lf) || (up && rt) || (dn && lf) || (dn && rt);
  const bool clear =
      (((y + x) & 1) == parity) && corner && interior(h, w, y, x, 1);
  out[p] = clear ? 0 : in[p];
}

// removeBranch (oclpolyline.cl:126-147): keep pixels with <= 2 neighbours
__global__ void remove_branch_kernel(const int* __restrict__ in, int* out,
                                     int h, int w) {
  PIXEL_INDEX
  int cnt = 0;
  for (int k = 0; k < 8; ++k)
    cnt += at(in, h, w, y + kDy[k], x + kDx[k]) != 0 ? 1 : 0;
  out[p] = (interior(h, w, y, x, 1) && in[p] != 0 && cnt <= 2) ? 1 : 0;
}

}  // namespace

// variant: 0 = rect, 1 = poly_branch.  a and b are (h, w) int32 scratch
// maps; out may not alias them.
extern "C" int rd_strings_chain(const void* edge, void* out, void* a,
                                void* b, int h, int w, int variant,
                                void* stream) {
  const dim3 g = rd::pixel_grid(h, w), t = rd::pixel_block();
  cudaStream_t s = (cudaStream_t)stream;
  int* A = (int*)a;
  int* B = (int*)b;
  int* O = (int*)out;
  junction_kernel<<<g, t, 0, s>>>((const int*)edge, A, h, w, variant == 0);
  if (variant == 0)
    connect_rect_kernel<<<g, t, 0, s>>>(A, B, h, w);
  else
    connect_poly_kernel<<<g, t, 0, s>>>(A, B, h, w);
  stringify_kernel<<<g, t, 0, s>>>(B, A, h, w, 0);
  if (variant == 1) {
    stringify_kernel<<<g, t, 0, s>>>(A, B, h, w, 1);
    remove_branch_kernel<<<g, t, 0, s>>>(B, O, h, w);
  } else {
    stringify_kernel<<<g, t, 0, s>>>(A, O, h, w, 1);
  }
  // junction, connect, two stringify passes, and remove_branch for poly
  for (int k = variant == 1 ? 5 : 4; k > 0; --k) rd::count_launch();
  return (int)cudaGetLastError();
}

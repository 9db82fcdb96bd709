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
// is read once and the labels written once, 7.4 MB at 720p).  The inputs
// are 1-pixel-wide edge chains and boundary rings, on which per-pixel
// unions through device memory build deep trees.  The TPU flooded blocks
// in VMEM for a capped number of rounds and stitched the seams in a second
// pass.  Here it is a block-based union-find (Playne & Hawick, IEEE TPDS
// 2018; Allegretti, Bolelli & Grana, IEEE TPDS 2019) in three launches,
// the scheme of the links CCL (links_ccl.cu) for 8-connectivity:
//   tile:    each block takes a kTH x kTW tile, one warp a row.  A tile
//            without foreground writes -1 and leaves after one block vote.
//            Otherwise the warp's ballot of "foreground and equal to the
//            left neighbour" gives each pixel its row run's first pixel,
//            with no atomics; each pixel then unites, by shared-memory
//            atomics on tile-local indices, with its equal NW, N and NE
//            neighbours in the tile, skipping a neighbour that its run's
//            left pixel already reaches or that lies in one row run with
//            the neighbour before it.  Row-major tile order is monotone in
//            the flat index, so a tile root is the minimum flat index of
//            its piece; the pass writes parent[p] = that root's flat index;
//   seam:    one thread per pixel on a tile's left column or top row (not
//            the frame's) unites, through device memory (common.cuh:
//            atomicMin linking, path halving), with its equal neighbours
//            across the seam: W, NW and SW in its tile row across a column
//            seam, and NW, N and NE across a row seam, which holds both
//            diagonals at every tile corner.  A link is skipped where the
//            pixel before it along the seam, with the same value, reaches
//            the same neighbours, or where the neighbour before it is
//            equal too;
//   flatten: label[p] = root of p, in place, by reading the chain from
//            p's tile root (no writes but p's own, so no atomics).
// Every pointer only decreases and stays inside its component, so each
// label is its component's minimum flat index whatever order the atomics
// run in, with no round cap.

#include "tile_ccl.cuh"

namespace {

using rd::kTH;
using rd::kTW;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kTW* kTH)
    tile_kernel(const int* __restrict__ pix, int* __restrict__ parent, int h,
                int w, int bgc) {
  __shared__ int s_pix[kTH][kTW];
  __shared__ int s_par[kTH * kTW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int x = x0 + tx, y = y0 + ty;
  const bool in = x < w && y < h;
  const int v = in ? pix[y * w + x] : bgc;
  const bool fg = v != bgc;
  if (!__syncthreads_or(fg)) {
    if (in) parent[y * w + x] = -1;
    return;
  }
  s_pix[ty][tx] = v;
  // the run of (ty, tx) starts at the last lane up to tx that is not equal
  // to its left neighbour
  const int left = __shfl_up_sync(kFull, v, 1);
  const unsigned eql = __ballot_sync(kFull, fg && tx > 0 && left == v);
  const int l = ty * kTW + tx;
  s_par[l] = ty * kTW + 31 - __clz(~eql & ((2u << tx) - 1));
  __syncthreads();
  if (fg && ty > 0) {
    const int* up = s_pix[ty - 1];
    const bool nw = tx > 0 && up[tx - 1] == v;
    const bool n = up[tx] == v;
    const bool ne = tx + 1 < kTW && up[tx + 1] == v;
    const int u = l - kTW;
    if (eql >> tx & 1) {
      // the left neighbour, in this run, reaches NW and N
      if (ne && !n) rd::unite(s_par, l, u + 1);
    } else {
      if (nw) rd::unite(s_par, l, u - 1);
      if (n && !nw) rd::unite(s_par, l, u);
      if (ne && !n) rd::unite(s_par, l, u + 1);
    }
  }
  __syncthreads();
  if (in) {
    int r = -1;
    if (fg) {
      r = rd::find_root(s_par, l);
      r = (y0 + r / kTW) * w + x0 + r % kTW;
    }
    parent[y * w + x] = r;
  }
}

// one thread per pixel b on the first column of a tile right of the
// frame's first column, then per pixel on the first row of a tile below
// the frame's first row.  b unites with each equal neighbour across the
// seam (walked in order along it) unless the one before it is equal too;
// where b's predecessor along the seam has b's value, it reaches all but
// the last of b's neighbours already.  Across a column seam both skips
// stay in b's tile row, where the two pixels are one tile piece.  Across
// a row seam the two may lie in two tiles of one tile row, which the
// column seams join; those never rely on a row seam, so no link is
// skipped for one that is skipped for it.
__global__ void seam_kernel(const int* __restrict__ pix, int* parent, int h,
                            int w, int bgc) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv = (w - 1) / kTW * h;  // pixels on column seams
  const int nh = (h - 1) / kTH * w;  // pixels on row seams
  if (k < nv) {
    const int y = k % h, x = (k / h + 1) * kTW;
    const int b = y * w + x, v = pix[b];
    if (v == bgc) return;
    // W, NW and SW in b's tile row: rows lo..hi of column x - 1
    const int ys = y - y % kTH;
    const int hi = min(y + 1, min(ys + kTH, h) - 1);
    int r = y > ys ? y - 1 : y;
    bool prev = false;
    if (y > ys && pix[b - w] == v) {
      r = y + 1;
      prev = pix[b - 1] == v;
    }
    for (; r <= hi; ++r) {
      const bool eq = pix[r * w + x - 1] == v;
      if (eq && !prev) rd::unite(parent, b, r * w + x - 1);
      prev = eq;
    }
  } else if (k < nv + nh) {
    const int j = k - nv;
    const int x = j % w, y = (j / w + 1) * kTH;
    const int b = y * w + x, v = pix[b];
    if (v == bgc) return;
    // NW, N and NE: columns c..hi of row y - 1
    const int hi = min(x + 1, w - 1);
    int c = max(x - 1, 0);
    bool prev = false;
    if (x > 0 && pix[b - 1] == v) {
      c = x + 1;
      prev = pix[b - w] == v;
    }
    for (; c <= hi; ++c) {
      const bool eq = pix[(y - 1) * w + c] == v;
      if (eq && !prev) rd::unite(parent, b, (y - 1) * w + c);
      prev = eq;
    }
  }
}

}  // namespace

// out: (h, w) int32, the parent array and then the labels
extern "C" int rd_label_components(const void* pix, void* out, int h, int w,
                                   int bgc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  if (n <= 0) return 0;
  const int* P = (const int*)pix;
  int* L = (int*)out;
  tile_kernel<<<dim3((w + kTW - 1) / kTW, (h + kTH - 1) / kTH),
                dim3(kTW, kTH), 0, s>>>(P, L, h, w, bgc);
  rd::count_launch();
  const int seams = (w - 1) / kTW * h + (h - 1) / kTH * w;
  seam_kernel<<<max(1, (seams + 255) / 256), 256, 0, s>>>(P, L, h, w, bgc);
  rd::count_launch();
  rd::flatten_kernel<<<(n + 255) / 256, 256, 0, s>>>(L, n);
  rd::count_launch();
  return (int)cudaGetLastError();
}

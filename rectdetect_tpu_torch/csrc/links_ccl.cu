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
// the block seams in a second pass.  Here it is a block-based union-find
// (Playne & Hawick, IEEE TPDS 2018; Allegretti, Bolelli & Grana, IEEE TPDS
// 2019) in three launches:
//   tile:    each block loads a kTH x kTW tile of the colours, the merge
//            mask and the strong edges, with the row above the tile's
//            colours (the right link reads the upper neighbour of its right
//            pixel), into shared memory and evaluates the right and lower
//            links inside the tile (regions._merge_pairs of the JAX
//            package).  A warp is a tile row: the ballot of its right links
//            gives each pixel its run's first pixel, with no atomics; a
//            lower link unites the two rows' runs with shared-memory
//            atomics on tile-local indices, unless the pixel to its left
//            already did (both right links and its lower link hold).
//            Row-major tile order is monotone in the flat index, so a tile
//            root is the minimum flat index of its piece; the pass writes
//            parent[p] = that root's flat index;
//   seam:    only the links across a tile's right column or bottom row
//            unite through device memory (common.cuh: atomicMin linking,
//            path halving), between tile roots, and not where the link
//            before it along the seam implies it;
//   flatten: label[p] = root of p, in place, by reading the chain from
//            p's tile root (no writes but p's own, so no atomics).
// Every pointer only decreases and stays inside its component, so each
// label is its component's minimum flat index whatever order the atomics
// run in.  A link between a and b (b right of or below a) holds when b is
// not on a strong edge and the pixel merging is interior with equal
// colours or a mask bit, or, whatever the edges, when the colours are
// equal and b is the lower pixel or (right link) b's upper neighbour
// differs from b.  "Interior" is in frame coordinates: in the offset form
// (a width tile of the width-tiled path, dist/tile.py) the map's local
// column 0 is frame column gx0 of a frame wt wide, and the links test
// interior(y, x + gx0) against wt; the whole frame is gx0 = 0, wt = w.
// Only the links see the offset.
//
// The batch form takes b frames of (h, w) one after the other in every
// buffer: the tile pass's grid z and the seam and flatten passes' grid y
// are the frame, whose planes sit at the offset z h w.  Labels stay flat
// indices of the frame's own plane (0..h w - 1), so each frame's
// union-find runs on its own parent array, and no link crosses frames.

#include "tile_ccl.cuh"

namespace {

using rd::kTH;
using rd::kTW;
constexpr unsigned kFull = 0xffffffffu;

// frame row y, frame column xg of a frame h x wt
__device__ __forceinline__ bool interior(int y, int xg, int h, int wt) {
  return y >= 1 && y < h - 1 && xg >= 1 && xg < wt - 1;
}

// the right link of (y, xg) to (y, xg + 1), in frame coordinates: colours
// ca, cb, the merge mask bits, b on a strong edge, and b's upper
// neighbour's colour (y > 0)
__device__ __forceinline__ bool right_link(int y, int xg, int h, int wt,
                                           int ca, int cb, bool ma, bool mb,
                                           bool eb, int cb_up) {
  const bool eq = ca == cb;
  const bool link = !eb && ((interior(y, xg, h, wt) && (eq || ma)) ||
                            (interior(y, xg + 1, h, wt) && (eq || mb)));
  return link || (eq && !(y > 0 && cb_up == cb));
}

// the lower link of (y, xg) to (y + 1, xg)
__device__ __forceinline__ bool lower_link(int y, int xg, int h, int wt,
                                           int ca, int cb, bool ma, bool mb,
                                           bool eb) {
  const bool eq = ca == cb;
  const bool link = !eb && ((interior(y, xg, h, wt) && (eq || ma)) ||
                            (interior(y + 1, xg, h, wt) && (eq || mb)));
  return link || eq;
}

__global__ void __launch_bounds__(kTW* kTH)
    tile_kernel(const int* __restrict__ packed, const int* __restrict__ mask,
                const int* __restrict__ edge, int* __restrict__ parent, int h,
                int w, int gx0, int wt) {
  __shared__ int s_col[kTH + 1][kTW];  // row 0: the row above the tile
  __shared__ bool s_mask[kTH][kTW];
  __shared__ bool s_edge[kTH][kTW];
  __shared__ int s_par[kTH * kTW];
  __shared__ unsigned s_right[kTH];  // right links of each row, by lane
  const size_t plane = (size_t)blockIdx.z * h * w;
  packed += plane;
  mask += plane;
  edge += plane;
  parent += plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int x = x0 + tx, y = y0 + ty;
  const bool in = x < w && y < h;
  const int l = ty * kTW + tx;
  if (in) {
    const int p = y * w + x;
    s_col[ty + 1][tx] = packed[p];
    s_mask[ty][tx] = mask[p] != 0;
    s_edge[ty][tx] = edge[p] > 0;
  }
  if (ty == 0 && y0 > 0 && x < w) s_col[0][tx] = packed[(y0 - 1) * w + x];
  __syncthreads();
  bool right = false, lower = false;
  if (in) {
    const int ca = s_col[ty + 1][tx];
    const bool ma = s_mask[ty][tx];
    right = tx + 1 < kTW && x + 1 < w &&
            right_link(y, x + gx0, h, wt, ca, s_col[ty + 1][tx + 1], ma,
                       s_mask[ty][tx + 1], s_edge[ty][tx + 1],
                       s_col[ty][tx + 1]);
    lower = ty + 1 < kTH && y + 1 < h &&
            lower_link(y, x + gx0, h, wt, ca, s_col[ty + 2][tx], ma,
                       s_mask[ty + 1][tx], s_edge[ty + 1][tx]);
  }
  // the row run of (ty, tx) starts after the last lane before tx that has
  // no right link
  const unsigned rights = __ballot_sync(kFull, right);
  const unsigned lowers = __ballot_sync(kFull, lower);
  const unsigned breaks = ~rights & ((1u << tx) - 1);
  s_par[l] = ty * kTW + (breaks ? 32 - __clz(breaks) : 0);
  if (tx == 0) s_right[ty] = rights;
  __syncthreads();
  // the left neighbour's lower link joins the same two runs when both rows
  // link the two columns
  const bool implied = tx > 0 && (lowers >> (tx - 1) & 1) &&
                       (rights >> (tx - 1) & 1) &&
                       (s_right[ty + (lower ? 1 : 0)] >> (tx - 1) & 1);
  if (lower && !implied) rd::unite(s_par, l, l + kTW);
  __syncthreads();
  if (in) {
    const int r = rd::find_root(s_par, l);
    parent[y * w + x] = (y0 + r / kTW) * w + x0 + r % kTW;
  }
}

// one thread per link across a tile seam: first the right links out of
// each tile's last column, then the lower links out of each tile's last
// row.  A link is implied, and skipped, where the link before it along the
// seam holds and both its ends link to that link's ends inside their tiles.
__global__ void seam_kernel(const int* __restrict__ packed,
                            const int* __restrict__ mask,
                            const int* __restrict__ edge, int* parent, int h,
                            int w, int gx0, int wt) {
  const size_t plane = (size_t)blockIdx.y * h * w;
  packed += plane;
  mask += plane;
  edge += plane;
  parent += plane;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv = (w - 1) / kTW * h;  // right links across column seams
  const int nh = (h - 1) / kTH * w;  // lower links across row seams
  if (k < nv) {
    const int y = k % h, x = (k / h + 1) * kTW - 1;
    const int a = y * w + x, b = a + 1;
    const int ca = packed[a], cb = packed[b];
    const bool ma = mask[a] != 0, mb = mask[b] != 0;
    const int xg = x + gx0;
    if (!right_link(y, xg, h, wt, ca, cb, ma, mb, edge[b] > 0,
                    y > 0 ? packed[b - w] : 0))
      return;
    if (y % kTH != 0) {
      // the row above, inside the same two tiles
      const int ua = a - w, ub = b - w;
      const int cua = packed[ua], cub = packed[ub];
      const bool mua = mask[ua] != 0, mub = mask[ub] != 0;
      if (right_link(y - 1, xg, h, wt, cua, cub, mua, mub, edge[ub] > 0,
                     y > 1 ? packed[ub - w] : 0) &&
          lower_link(y - 1, xg, h, wt, cua, ca, mua, ma, edge[a] > 0) &&
          lower_link(y - 1, xg + 1, h, wt, cub, cb, mub, mb, edge[b] > 0))
        return;
    }
    rd::unite(parent, a, b);
  } else if (k < nv + nh) {
    const int j = k - nv;
    const int x = j % w, y = (j / w + 1) * kTH - 1;
    const int a = y * w + x, b = a + w;
    const int ca = packed[a], cb = packed[b];
    const bool ma = mask[a] != 0, mb = mask[b] != 0;
    const int xg = x + gx0;
    if (!lower_link(y, xg, h, wt, ca, cb, ma, mb, edge[b] > 0)) return;
    if (x % kTW != 0) {
      // the column to the left, inside the same two tiles
      const int la = a - 1, lb = b - 1;
      const int cla = packed[la], clb = packed[lb];
      const bool mla = mask[la] != 0, mlb = mask[lb] != 0;
      if (lower_link(y, xg - 1, h, wt, cla, clb, mla, mlb, edge[lb] > 0) &&
          right_link(y, xg - 1, h, wt, cla, ca, mla, ma, edge[a] > 0,
                     y > 0 ? packed[a - w] : 0) &&
          right_link(y + 1, xg - 1, h, wt, clb, cb, mlb, mb, edge[b] > 0,
                     ca))
        return;
    }
    rd::unite(parent, a, b);
  }
}

}  // namespace

// packed, mask, edge: (b, h, w) int32, 1 <= b <= 65535 (gridDim.z and
// gridDim.y); out: (b, h, w) int32, the parent arrays and then the labels;
// gx0: the frame column of local column 0, wt: the frame's width (0 and w
// for a whole frame)
extern "C" int rd_label_merge(const void* packed, const void* mask,
                              const void* edge, void* out, int h,
                              int w, int b, int gx0, int wt, void* stream) {
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  if (n <= 0) return 0;
  const int* P = (const int*)packed;
  const int* M = (const int*)mask;
  const int* E = (const int*)edge;
  int* L = (int*)out;
  tile_kernel<<<dim3((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, b),
                dim3(kTW, kTH), 0, s>>>(P, M, E, L, h, w, gx0, wt);
  rd::count_launch();
  // per frame
  const int seams = (w - 1) / kTW * h + (h - 1) / kTH * w;
  seam_kernel<<<dim3(max(1, (seams + 255) / 256), b), 256, 0, s>>>(
      P, M, E, L, h, w, gx0, wt);
  rd::count_launch();
  rd::flatten_kernel<<<dim3((n + 255) / 256, b), 256, 0, s>>>(L, n);
  rd::count_launch();
  return (int)cudaGetLastError();
}

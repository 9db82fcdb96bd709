// Kernel #10 seg_scan: inclusive segmented scan over an (S,) int32 table
// whose segments are maximal runs of equal keys; op 0 = sum saturating at
// cap, op 1 = max.  Values are non-negative.  A segment's first element
// keeps its own value; each later one is op(previous, value).
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_scan.py:
// _seg_scan_kernel (seg_scan_sorted; seg_total_sorted is two of them).
//
// Bound: device memory, 12 B per element (key and value read, result
// written) plus the key of the predecessor, which hits in L1.
// seg_total_sorted needs those 12 B once for its two scans; run as two
// scans, it moves them twice (and each scan re-reads and re-writes the
// leading run of every tile in its fix-up).  The TPU ran
// its grid in order and carried (last key, running value) in SMEM from
// one block to the next; Hopper runs blocks in parallel, so this is the
// classic three-phase form:
//   tile:  each block scans its 1024-element tile alone (a sequential scan
//          of 4 elements per thread, then a shared-memory scan of the 256
//          thread aggregates with the segmented operator), and records the
//          tile's aggregate and the position of its first segment start;
//   carry: one block scans the tile aggregates into each tile's carry-in;
//   fix:   elements before their tile's first segment start (a run that
//          began in an earlier tile) combine with the carry-in.
// min(cap, a + b) is associative for non-negative values (evaluated in 64
// bits, so nothing wraps), and max is, so the order of combination does
// not change the result.  `rev` runs the same scan from the end (the
// reverse scan of seg_total_sorted) without flipping copies.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

struct Seg {
  int start;  // a segment starts inside the span
  int v;      // scan value at the span's end
};

__device__ __forceinline__ int combine_v(int op, int cap, int a, int b) {
  if (op == 0) {
    const long long s = (long long)a + (long long)b;
    return s < (long long)cap ? (int)s : cap;
  }
  return a > b ? a : b;
}

// left span followed by right span
__device__ __forceinline__ Seg combine(int op, int cap, Seg l, Seg r) {
  return Seg{l.start | r.start, r.start ? r.v : combine_v(op, cap, l.v, r.v)};
}

__device__ __forceinline__ int phys(int j, int n, int rev) {
  return rev ? n - 1 - j : j;
}

// in-block exclusive scan of one Seg per thread; returns the exclusive
// prefix of this thread (valid only if has_prefix) and the block total
__device__ Seg block_exclusive(Seg mine, int op, int cap, bool* has_prefix,
                               Seg* total) {
  __shared__ int s_start[kThreads];
  __shared__ int s_v[kThreads];
  const int t = threadIdx.x;
  Seg acc = mine;
  s_start[t] = acc.start;
  s_v[t] = acc.v;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    Seg left{0, 0};
    const bool has = t >= d;
    if (has) left = Seg{s_start[t - d], s_v[t - d]};
    __syncthreads();
    if (has) acc = combine(op, cap, left, acc);
    s_start[t] = acc.start;
    s_v[t] = acc.v;
    __syncthreads();
  }
  *has_prefix = t > 0;
  Seg prefix{0, 0};
  if (t > 0) prefix = Seg{s_start[t - 1], s_v[t - 1]};
  *total = Seg{s_start[kThreads - 1], s_v[kThreads - 1]};
  __syncthreads();
  return prefix;
}

__global__ void tile_kernel(const int* __restrict__ key,
                            const int* __restrict__ val, int* __restrict__ out,
                            int* __restrict__ tile_start,
                            int* __restrict__ tile_v,
                            int* __restrict__ tile_first, int n, int op,
                            int cap, int rev) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int v[kItems];
  int st[kItems];
  Seg mine{0, 0};
  bool any = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    st[j] = 0;
    v[j] = 0;
    if (i < n) {
      const int p = phys(i, n, rev);
      v[j] = val[p];
      st[j] = i == 0 || key[p] != key[phys(i - 1, n, rev)];
      if (!any) {
        mine.v = v[j];
        any = true;
      } else {
        mine.v = st[j] ? v[j] : combine_v(op, cap, mine.v, v[j]);
      }
      mine.start |= st[j];
    }
  }
  bool has_prefix;
  Seg total;
  const Seg prefix = block_exclusive(mine, op, cap, &has_prefix, &total);
  // the tile's first segment start: min over threads of their first one
  __shared__ int s_first;
  if (threadIdx.x == 0) s_first = kTile;
  __syncthreads();
  int acc = 0;
  bool have = has_prefix;
  if (have) acc = prefix.v;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i >= n) break;
    if (st[j]) {
      acc = v[j];
      have = true;
      atomicMin(&s_first, threadIdx.x * kItems + j);
    } else {
      acc = have ? combine_v(op, cap, acc, v[j]) : v[j];
      have = true;
    }
    out[phys(i, n, rev)] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tile_start[blockIdx.x] = total.start;
    tile_v[blockIdx.x] = total.v;
    tile_first[blockIdx.x] = s_first;
  }
}

// carry[b] = the scan value just before tile b (meaningful where tile b
// begins inside a run, i.e. tile_first[b] > 0)
__global__ void carry_kernel(const int* __restrict__ tile_start,
                             const int* __restrict__ tile_v,
                             int* __restrict__ carry, int ntiles, int op,
                             int cap) {
  Seg run{0, 0};
  for (int c0 = 0; c0 < ntiles; c0 += kThreads) {
    const int b = c0 + threadIdx.x;
    Seg mine{1, 0};  // past the end: a neutral start
    if (b < ntiles) mine = Seg{tile_start[b], tile_v[b]};
    bool has_prefix;
    Seg total;
    const Seg prefix = block_exclusive(mine, op, cap, &has_prefix, &total);
    Seg before = run;
    if (has_prefix) before = c0 == 0 ? prefix : combine(op, cap, run, prefix);
    else if (c0 == 0) before = Seg{0, 0};
    if (b < ntiles) carry[b] = before.v;
    run = c0 == 0 ? total : combine(op, cap, run, total);
  }
}

__global__ void fix_kernel(int* __restrict__ out,
                           const int* __restrict__ carry,
                           const int* __restrict__ tile_first, int n, int op,
                           int cap, int rev) {
  const int b = blockIdx.x;
  if (b == 0) return;
  const int first = tile_first[b];
  const int c = carry[b];
  for (int k = threadIdx.x; k < first; k += blockDim.x) {
    const int i = b * kTile + k;
    if (i >= n) break;
    const int p = phys(i, n, rev);
    out[p] = combine_v(op, cap, c, out[p]);
  }
}

}  // namespace

// scratch: 4 * ceil(n / 1024) int32
extern "C" int rd_seg_scan(const void* key, const void* val, void* out,
                           void* scratch, int n, int op, int cap, int rev,
                           void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (n + kTile - 1) / kTile;
  int* sc = (int*)scratch;
  int* tile_start = sc;
  int* tile_v = sc + ntiles;
  int* tile_first = sc + 2 * ntiles;
  int* carry = sc + 3 * ntiles;
  tile_kernel<<<ntiles, kThreads, 0, s>>>((const int*)key, (const int*)val,
                                          (int*)out, tile_start, tile_v,
                                          tile_first, n, op, cap, rev);
  rd::count_launch();
  carry_kernel<<<1, kThreads, 0, s>>>(tile_start, tile_v, carry, ntiles, op,
                                      cap);
  rd::count_launch();
  fix_kernel<<<ntiles, kThreads, 0, s>>>((int*)out, carry, tile_first, n, op,
                                         cap, rev);
  rd::count_launch();
  return (int)cudaGetLastError();
}

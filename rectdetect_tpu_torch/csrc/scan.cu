// Kernel #10 seg_scan: segmented scans over an (S,) int32 table whose
// segments are maximal runs of equal keys, and the per-element run totals
// built on them.  Values are non-negative.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_scan.py:
// _seg_scan_kernel (seg_scan_sorted; seg_total_sorted is two of them).
// The TPU ran its grid in order and carried (last key, running value) in
// SMEM from one block to the next; Hopper runs blocks in parallel.
//
// Bound: device memory, 12 B per element (key and value read, result
// written).
//
// seg_total (rd_seg_total, the main path's strength pair): every element
// gets min(cap, its run's sum), and a run's first element the larger of
// that and its own value: what a forward satsum scan (a segment's first
// element keeps its own value) followed by a reverse max scan gives.  One
// cooperative launch reads key and val once and writes the totals once;
// each block walks its kTotalTile-element tiles (the grid is as large as
// the tiles or as many blocks as fit on the card, whichever is smaller):
//   A  each tile loads its elements, kTotalItems consecutive ones a
//      thread, and scans them in registers, warp shuffles and one step
//      across the block's warps: the exact 64-bit prefix sums of the
//      values (kept in shared memory), and for each element the last
//      segment start at or before it and the first one after it.  It
//      publishes a descriptor: the sum of its elements before its first
//      segment start (all of them if none: the lead) and the sum from its
//      last start on (the trail, -1 if no segment starts inside it), both
//      saturated at cap;
//   -  one grid barrier;
//   B  per tile, warp 0 looks back over the descriptors, 32 at a time, to
//      the nearest earlier tile with a start: the carry-in of the run the
//      tile begins inside is that tile's trail plus the leads of the tiles
//      between.  Warp 1 looks forward to the nearest later tile with a
//      start: the tile's trailing run goes on through the leads of the
//      tiles between and that tile's lead.  Then each element's run total
//      is the difference of two prefix sums of its tile, plus the carry-in
//      if its run began in an earlier tile and the carry-out if it goes on
//      past the tile.
// B walks a block's tiles in reverse, so its first tile is the one A left
// in shared memory and registers (with one tile a block, as at 720p, each
// tile is loaded and scanned once); with more tiles than resident blocks
// it loads and scans the others again, from L2.  min(cap, a + b) is
// associative for non-negative values and the sums are exact in 64 bits,
// so no order of combination changes a total and nothing wraps.
//
// The grid barrier is cooperative_groups' grid sync under
// cudaLaunchCooperativeKernel, as in despeckle2.cu: the launch itself
// refuses a grid that cannot be co-resident, and a decoupled look-back
// would need its descriptor flags reset between calls (a memset launch or
// an epoch) and a second pass to carry totals backwards.
//
// seg_scan (rd_seg_scan, seg_scan_sorted; not on the main path) keeps the
// classic three-phase form in three launches:
//   tile:  each block scans its 1024-element tile alone (a sequential scan
//          of 4 elements per thread, then a shared-memory scan of the 256
//          thread aggregates with the segmented operator), and records the
//          tile's aggregate and the position of its first segment start;
//   carry: one block scans the tile aggregates into each tile's carry-in;
//   fix:   elements before their tile's first segment start (a run that
//          began in an earlier tile) combine with the carry-in.
// op 0 = sum saturating at cap, op 1 = max; a segment's first element
// keeps its own value, each later one is op(previous, value).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
                            int cap) {
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
      v[j] = val[i];
      st[j] = i == 0 || key[i] != key[i - 1];
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
    out[i] = acc;
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
                           int cap) {
  const int b = blockIdx.x;
  if (b == 0) return;
  const int first = tile_first[b];
  const int c = carry[b];
  for (int k = threadIdx.x; k < first; k += blockDim.x) {
    const int i = b * kTile + k;
    if (i >= n) break;
    out[i] = combine_v(op, cap, c, out[i]);
  }
}

// ---- seg_total: one cooperative launch ----------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTotalThreads = 256;
constexpr int kTotalItems = 4;
constexpr int kTotalTile = kTotalThreads * kTotalItems;
constexpr int kTotalWarps = kTotalThreads / 32;

static_assert(kTotalItems % 4 == 0, "a thread's items load as int4");
static_assert(kTotalWarps >= 2, "warps 0 and 1 look back and forward");

struct TotalShared {
  long long pre[kTotalTile + 1];  // sum of the tile's values before local j
  long long warp_sum[kTotalWarps];
  int warp_last[kTotalWarps];   // the warp's last segment start, or -1
  int warp_first[kTotalWarps];  // its first, or kTotalTile
  long long carry_in, carry_out;
};

// a tile's descriptor: x = the lead (the sum before its first segment
// start, or of the whole tile), y = the trail (the sum from its last start
// on, -1 if no segment starts inside it); sums saturated at cap
__device__ __forceinline__ int saturate(long long x, int cap) {
  return x < (long long)cap ? (int)x : cap;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// Scan tile t (A; B repeats it for a tile no longer in shared memory):
// s.pre, and for each item j of this thread the tile-local index of the
// last segment start at or before it (last[j], -1 if none) and of the
// first start after it (next[j], kTotalTile if none).  Returns the tile's
// first and last start.  vec: key and val are 16-byte aligned.
__device__ __forceinline__ void scan_tile(
    TotalShared& s, const int* __restrict__ key, const int* __restrict__ val,
    int n, int t, int vec, int last[kTotalItems], int next[kTotalItems],
    int* tile_first, int* tile_last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int loc0 = threadIdx.x * kTotalItems;
  const int base = t * kTotalTile + loc0;
  int k[kTotalItems], v[kTotalItems];
  if (vec && base + kTotalItems <= n) {
#pragma unroll
    for (int q = 0; q < kTotalItems; q += 4) {
      const int4 kk = *reinterpret_cast<const int4*>(key + base + q);
      const int4 vv = *reinterpret_cast<const int4*>(val + base + q);
      k[q] = kk.x;
      k[q + 1] = kk.y;
      k[q + 2] = kk.z;
      k[q + 3] = kk.w;
      v[q] = vv.x;
      v[q + 1] = vv.y;
      v[q + 2] = vv.z;
      v[q + 3] = vv.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTotalItems; ++j) {
      k[j] = base + j < n ? key[base + j] : 0;
      v[j] = base + j < n ? val[base + j] : 0;
    }
  }
  // the key before this thread's first item
  int prev = __shfl_up_sync(kFull, k[kTotalItems - 1], 1);
  if (lane == 0 && base > 0 && base <= n) prev = key[base - 1];
  bool st[kTotalItems];
  long long sum = 0;
  int mine_last = -1, mine_first = kTotalTile;
#pragma unroll
  for (int j = 0; j < kTotalItems; ++j) {
    const int i = base + j;
    st[j] = i < n && (i == 0 || k[j] != (j ? k[j - 1] : prev));
    sum += v[j];
    if (st[j]) {
      mine_last = loc0 + j;
      mine_first = min(mine_first, loc0 + j);
    }
  }
  // within the warp: inclusive prefix sum and max, inclusive suffix min
  long long isum = sum;
  int imax = mine_last, imin = mine_first;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long a = __shfl_up_sync(kFull, isum, d);
    const int b = __shfl_up_sync(kFull, imax, d);
    const int c = __shfl_down_sync(kFull, imin, d);
    if (lane >= d) {
      isum += a;
      imax = max(imax, b);
    }
    if (lane + d < 32) imin = min(imin, c);
  }
  __syncthreads();  // the previous tile's readers are done with s
  if (lane == 31) {
    s.warp_sum[warp] = isum;
    s.warp_last[warp] = imax;
  }
  if (lane == 0) s.warp_first[warp] = imin;
  __syncthreads();
  // exclusive: the threads before (after) this one
  long long esum = isum - sum;
  int emax = __shfl_up_sync(kFull, imax, 1);
  int emin = __shfl_down_sync(kFull, imin, 1);
  if (lane == 0) emax = -1;
  if (lane == 31) emin = kTotalTile;
  int tfirst = kTotalTile, tlast = -1;
#pragma unroll
  for (int q = 0; q < kTotalWarps; ++q) {
    if (q < warp) {
      esum += s.warp_sum[q];
      emax = max(emax, s.warp_last[q]);
    }
    if (q > warp) emin = min(emin, s.warp_first[q]);
    tfirst = min(tfirst, s.warp_first[q]);
    tlast = max(tlast, s.warp_last[q]);
  }
  long long p = esum;
  int cur = emax;
#pragma unroll
  for (int j = 0; j < kTotalItems; ++j) {
    s.pre[loc0 + j] = p;
    p += v[j];
    if (st[j]) cur = loc0 + j;
    last[j] = cur;
  }
  if (threadIdx.x == kTotalThreads - 1) s.pre[kTotalTile] = p;
  cur = emin;
#pragma unroll
  for (int j = kTotalItems - 1; j >= 0; --j) {
    next[j] = cur;
    if (st[j]) cur = loc0 + j;
  }
  *tile_first = tfirst;
  *tile_last = tlast;
  __syncthreads();  // s.pre is complete
}

__global__ void __launch_bounds__(kTotalThreads)
    seg_total_kernel(const int* __restrict__ key, const int* __restrict__ val,
                     int* __restrict__ out, int2* __restrict__ desc, int n,
                     int cap, int ntiles, int vec) {
  __shared__ TotalShared s;
  const cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, g = gridDim.x;
  const int mine = (ntiles - b + g - 1) / g;  // tiles b, b + g, ...
  int last[kTotalItems], next[kTotalItems];
  int first_s = 0, last_s = 0;

  // A: scan each tile, publish its descriptor
  for (int i = 0; i < mine; ++i) {
    const int t = b + i * g;
    scan_tile(s, key, val, n, t, vec, last, next, &first_s, &last_s);
    if (threadIdx.x == 0) {
      const bool has = first_s < kTotalTile;
      const long long total = s.pre[kTotalTile];
      desc[t] = make_int2(saturate(has ? s.pre[first_s] : total, cap),
                          has ? saturate(total - s.pre[last_s], cap) : -1);
    }
  }
  grid.sync();

  // B: the totals, the tiles in reverse (the last one is still here)
  for (int i = mine - 1; i >= 0; --i) {
    const int t = b + i * g;
    if (i != mine - 1)
      scan_tile(s, key, val, n, t, vec, last, next, &first_s, &last_s);
    if (warp == 0 && first_s > 0) {
      // back to the nearest earlier tile with a start (tile 0 has one)
      long long acc = 0;
      for (int c = t - 1; c >= 0; c -= 32) {
        const int tt = c - lane;
        const int2 d = tt >= 0 ? __ldcg(desc + tt) : make_int2(0, -1);
        const unsigned has = __ballot_sync(kFull, d.y >= 0);
        const int f = has ? __ffs(has) - 1 : 32;
        acc += warp_sum(lane < f ? d.x : (lane == f ? d.y : 0));
        acc = min(acc, (long long)cap);
        if (has) break;
      }
      if (lane == 0) s.carry_in = acc;
    } else if (warp == 1) {
      // on to the nearest later tile with a start, its lead included
      long long acc = 0;
      for (int c = t + 1; c < ntiles; c += 32) {
        const int tt = c + lane;
        const int2 d = tt < ntiles ? __ldcg(desc + tt) : make_int2(0, -1);
        const unsigned has = __ballot_sync(kFull, d.y >= 0);
        const int f = has ? __ffs(has) - 1 : 32;
        acc += warp_sum(lane <= f ? d.x : 0);
        acc = min(acc, (long long)cap);
        if (has) break;
      }
      if (lane == 0) s.carry_out = acc;
    }
    __syncthreads();
    const int base = t * kTotalTile + threadIdx.x * kTotalItems;
#pragma unroll
    for (int j = 0; j < kTotalItems; ++j) {
      if (base + j >= n) break;
      const int loc = threadIdx.x * kTotalItems + j;
      long long sum = s.pre[next[j]] - s.pre[max(last[j], 0)];
      if (last[j] < 0) sum += s.carry_in;
      if (next[j] == kTotalTile) sum += s.carry_out;
      sum = min(sum, (long long)cap);
      // a run's first element: the larger of the total and its own value
      if (last[j] == loc) sum = max(sum, s.pre[loc + 1] - s.pre[loc]);
      out[base + j] = (int)sum;
    }
  }
}

// blocks of seg_total_kernel the card holds at once, per device.
// Threads of one process (the per-device workers of dist/stream.py) may
// fill the cache at once: each writes the same value for its device, the
// occupancy of this kernel there, so any read sees 0 (and queries) or it
int total_resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, seg_total_kernel, kTotalThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

}  // namespace

// scratch words (int32) of one rd_seg_scan call: four a tile (its start
// flag, aggregate, first start and carry-in)
extern "C" int rd_seg_scan_scratch_words(int n) {
  return n > 0 ? 4 * ((n + kTile - 1) / kTile) : 0;
}

// scratch: rd_seg_scan_scratch_words(n) int32, any contents
extern "C" int rd_seg_scan(const void* key, const void* val, void* out,
                           void* scratch, int n, int op, int cap,
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
                                          tile_first, n, op, cap);
  rd::count_launch();
  carry_kernel<<<1, kThreads, 0, s>>>(tile_start, tile_v, carry, ntiles, op,
                                      cap);
  rd::count_launch();
  fix_kernel<<<ntiles, kThreads, 0, s>>>((int*)out, carry, tile_first, n, op,
                                         cap);
  rd::count_launch();
  return (int)cudaGetLastError();
}

// scratch words (int32) of one rd_seg_total call: a descriptor a tile
extern "C" int rd_seg_total_scratch_words(int n) {
  return 2 * (n > 0 ? (n + kTotalTile - 1) / kTotalTile : 1);
}

// scratch: rd_seg_total_scratch_words(n) int32, 8-byte aligned, any
// contents
extern "C" int rd_seg_total(const void* key, const void* val, void* out,
                            void* scratch, int n, int cap, void* stream) {
  if (n <= 0) return 0;
  int ntiles = (n + kTotalTile - 1) / kTotalTile;
  const int resident = total_resident_blocks();
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = ntiles < resident ? ntiles : resident;
  int vec = (reinterpret_cast<size_t>(key) | reinterpret_cast<size_t>(val)) %
                16 == 0;
  const int* k = (const int*)key;
  const int* v = (const int*)val;
  int* o = (int*)out;
  int2* d = (int2*)scratch;
  void* args[] = {&k, &v, &o, &d, &n, &cap, &ntiles, &vec};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)seg_total_kernel, dim3(blocks), dim3(kTotalThreads), args,
      0, (cudaStream_t)stream);
  rd::count_launch();
  return (int)err;
}

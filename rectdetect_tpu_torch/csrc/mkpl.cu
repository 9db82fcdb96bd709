// Kernel #14 mkpl: the max-deviation subdivision of the polyline stage
// (mkpl_pass1/2/3, oclpolyline.cl:509-646; host loop oclpolyline.c:186-216)
// over the compacted arc slot list, all rounds in one launch.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_mkpl.py:_mkpl_kernel
// (mkpl_subdivide_pallas), and takes its idea: a subdivision only ever
// splits a segment inside its range of arc-length numbers, so with the
// live slots in (arc, number) order every segment is a contiguous run of
// positions for the whole launch, and pass3 is implicit in run membership.
// The TPU kernel reduced with Hillis-Steele ladders and renamed provisional
// slot-order ids afterwards, which is exact only when the arena cannot
// overflow; here the ids are allocated as the plain version
// (ops/mkpl.py:mkpl_subdivide) allocates them: split segments ranked by
// id, dropped once count + rank >= cap, so the arena and lsid are bit-equal
// to the plain version's also under overflow.
//
// Design: one launch of one thread-block cluster (kBlocks blocks of
// kThreads threads); the cluster's barrier separates the phases.
// Set-up (once): the live slots (label in (0, count] with polyid != 0) are
// counted per arc and listed, the arcs' runs laid out by a prefix sum, and
// each listed slot placed at run start + number - 1 when its arc's numbers
// are 1..size without repeats (a compare-and-swap claims the place); an
// arc where that fails is ranked by (number, slot) instead.  Then each
// round has two barriers:
//   A. per position, a warp per piece of 32 positions: the previous
//      round's pass3 (a position past its segment's end index moves one
//      right-pointer hop), the fixed-point distance to its segment's chord,
//      and a segmented max of (distance, -slot) over the parts of the runs
//      in the piece by warp shuffles; each part's maximum goes into its
//      segment's key by one 64-bit atomic max (a run inside one piece is
//      one part);
//   B. per segment id 0..count (chunks of kThreads): the run's key and
//      its winner's position; the split test; an exclusive scan of the
//      split flags in id order across all chunks (block scans and a
//      decoupled look-back); the record writes, and the run cut after the
//      winner (the first later position with a larger number starts the
//      new segment's run).
// The rounds make one atomic per run part, none per slot.  The floats follow
// _closest_point_dist and fp.hypot operation for operation (fmaf where XLA
// contracts, built with --fmad=false; '/' and sqrtf correctly rounded).
// The result does not depend on the order the blocks run in.
//
// Precondition, as ops/polyline.py:mkpl_init builds the arena: every live
// slot's label is at most count and its number at most its segment's end
// index (the plain pass3 then moves exactly the positions past a split).
//
// Bound: latency, not bytes.  Per round it moves ~40 B per live slot and
// ~60 B per segment, resident in L2; the chains of dependent loads in the
// two phases and the two barriers set the time.  A cluster's barrier costs
// less than a grid-wide one, and one cluster has threads enough for the
// rounds' work (a few thousand live positions, a few hundred segments at
// 720p; more loop over the warps and blocks).
//
// The slot-range form (the width-tiled path, ops/hopper_mkpl.py) splits
// the same device functions over three entry points, launched on each
// tile's device with the tile's own arena and scratch: rd_mkpl_setup (the
// set-up above, one cluster; the same inputs give every tile the same run
// layout, since a position depends only on (arc, number, slot)),
// rd_mkpl_keys (phase A of one round over the tile's share of the live
// positions, [part * chunk, (part + 1) * chunk) with chunk =
// ceil(live / parts), into the tile's own key table; with round ==
// rounds the last round's pass3 and lsid at those positions) and
// rd_mkpl_splits (phase B on the key tables' elementwise maximum over the
// tiles, `red`, in one block that scans the chunks in id order, so that
// every tile's copy takes the same splits).  The caller reduces the key
// tables between the two; the keys of a tile's range are maxima over its
// positions, so their maximum over the tiles is the one-launch key.  A
// key's distance stays below 2^31 (a frame's diagonal times 65536), so
// the keys order as int64 too.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;  // ids a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 8;     // the cluster (the portable size)
constexpr int kBatch = 4;      // slots a thread loads at once in set-up
constexpr int kPiece = 32;     // positions a warp scans in phase A
constexpr int kKeyBlocks = 64;  // rd_mkpl_keys' largest grid
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFix = 65536.0f;     // oclpolyline.cl:535
constexpr int kMinNIndex = 4;        // oclpolyline.cl:21
constexpr float kMinEdgeLen = 1.0f;  // oclpolyline.cl:20

// misc words
constexpr int kCnt = 0;  // two: the count before an even / an odd round
constexpr int kLive = 2;
constexpr int kAnyBad = 3;
constexpr int kListed = 4;
constexpr int kMisc = 5;

struct Args {
  const int* comp_idx;  // (S,) flat pixel per slot, n = empty
  const int* dense;     // (n,) arc id image
  const int* number;    // (n,) arc-length number image
  // arena (cap,) each; written during the launch, so never __restrict__
  float *sx, *sy, *ex, *ey;
  int *sidx, *eidx, *left, *right, *scount, *ecount, *polyid, *npix, *level;
  int* count;
  // scratch, the 8-byte words first
  u64* maxkey;  // (cap,) key of each segment's run, 0 between rounds
  u64* status;  // (chunks,) look-back words: tag << 32 | flag count
  u64* stage;   // (S,) (number, slot) keys of the arcs ranked by sorting
  int *lslot, *lpix, *llab, *lnum;  // (S,) each: the list of live slots
  int* posof;   // (S,) slot -> position
  int* perm;    // (S,) position -> slot
  int* pix;     // (S,) position -> flat pixel
  int* num;     // (S,) position -> number
  int* lab;     // (S,) position -> segment, before the last round's pass3
  int* size;    // (cap,) live slots per arc
  int* cursor;  // (cap,)
  int* bad;     // (cap,) arc not placed by its numbers
  int* runstart;  // (cap,) first position of each segment's run
  int* runend;    // (cap,) one past its last
  int* misc;      // (kMisc,)
  int* lsid;      // (n,) output image, zero-filled
  // phase B's keys: maxkey itself in the one-launch form, the tiles'
  // reduced key tables in the slot-range form (read-only)
  const u64* red;
  int S, cap, n, w, rounds, minerr_fix, chunks;
  // slot-range form: this launch's round and the tile's part of `parts`;
  // parts == 0 in the one-launch form
  int round, part, parts;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// scratch words (int32) of one call; rd_mkpl_scratch_words gives it to the
// wrapper
__host__ __device__ int scratch_words(int S, int cap) {
  const int chunks = cdiv(cap, kThreads);
  return 2 * (cap + chunks + S) + 9 * S + 5 * cap + kMisc;
}

// fp.hypot: x1 * sqrt(1 + (x2/x1)^2), the 1 + r*r fused
__device__ __forceinline__ float hypot_xla(float a, float b) {
  a = fabsf(a);
  b = fabsf(b);
  const float x1 = fmaxf(a, b), x2 = fminf(a, b);
  if (x1 == 0.0f) return x1;
  const float r = x2 / x1;
  return x1 * sqrtf(__fmaf_rn(r, r, 1.0f));
}

// _closest_point_dist (closestPoint, oclpolyline.cl:51-59)
__device__ __forceinline__ float chord_dist(float sx, float sy, float ex,
                                            float ey, float px, float py) {
  const float dx = ex - sx;
  const float dy = ey - sy;
  const float l2 = __fmaf_rn(dx, dx, dy * dy);
  const float num = __fmaf_rn(px - sx, dx, (py - sy) * dy);
  float t = l2 > 1e-4f ? num / fmaxf(l2, 1e-4f) : 0.0f;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float cx = __fmaf_rn(t, dx, sx);
  const float cy = __fmaf_rn(t, dy, sy);
  return hypot_xla(cx - px, cy - py);
}

// the slots s0 + k * stride, k < kBatch: pixel, label, number and whether
// each takes part (live_px of the plain version; a label above the input
// count breaks the precondition and takes no part), loaded a stage at a
// time so that each stage's loads are in flight together
struct Slots {
  int p[kBatch], lab[kBatch], num[kBatch];
  bool valid[kBatch], live[kBatch];
};

__device__ __forceinline__ void load_slots(const Args& a, int count0, int s0,
                                           int stride, Slots& q) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int s = s0 + k * stride;
    q.p[k] = s < a.S ? a.comp_idx[s] : a.n;
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    q.valid[k] = q.p[k] < a.n;
    q.p[k] = max(q.p[k], 0);
    q.lab[k] = q.valid[k] ? a.dense[q.p[k]] : 0;
    q.num[k] = q.valid[k] ? a.number[q.p[k]] : 0;
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int l = q.lab[k];
    q.live[k] = q.valid[k] && l > 0 && l <= count0 && a.polyid[l] != 0;
  }
}

// the key a position competes with: larger distance first, then smaller
// slot (the plain version's winner, the minimum slot at the maximum)
__device__ __forceinline__ u64 dist_key(int d, int slot) {
  return (u64)(unsigned)d << 32 | (unsigned)~(unsigned)slot;
}

__device__ __forceinline__ int key_dist(u64 k) { return (int)(k >> 32); }
__device__ __forceinline__ int key_slot(u64 k) {
  return (int)~(unsigned)(k & 0xffffffffu);
}

// a misc word another block wrote before the last barrier
__device__ __forceinline__ int misc(const Args& a, int k) {
  return *(const volatile int*)(a.misc + k);
}

// exclusive prefix sum of v over the block; *total the block's sum
__device__ int block_exclusive_sum(int v, int* total) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int c = s_warp[k];
    before += k < warp ? c : 0;
    all += c;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// the arena fields the split test and the record writes read
struct Seg {
  float sx, sy, ex, ey;
  int sidx, eidx, scount, ecount, polyid, right, runstart, runend;
};

__device__ __forceinline__ Seg load_seg(const Args& a, int g) {
  Seg q;
  q.sx = a.sx[g];
  q.sy = a.sy[g];
  q.ex = a.ex[g];
  q.ey = a.ey[g];
  q.sidx = a.sidx[g];
  q.eidx = a.eidx[g];
  q.scount = a.scount[g];
  q.ecount = a.ecount[g];
  q.polyid = a.polyid[g];
  q.right = a.right[g];
  q.runstart = a.runstart[g];
  q.runend = a.runend[g];
  return q;
}

// pass2 split conditions (oclpolyline.cl:564-577) of segment q, whose run
// has the maximum distance md at the winner pixel p
__device__ int split_test(const Args& a, const Seg& q, int md, int p) {
  if (q.polyid == 0) return 0;
  if (q.eidx - q.sidx < kMinNIndex - 1) return 0;
  if (q.scount > 1 || q.ecount > 1) return 0;
  if (md < a.minerr_fix) return 0;
  const float sx = q.sx, sy = q.sy, ex = q.ex, ey = q.ey;
  const float mdf = (float)md;
  const float cdx = ex - sx, cdy = ey - sy;
  const float chord_sq = __fmaf_rn(cdx, cdx, cdy * cdy);
  if (md < a.minerr_fix * 3 && mdf * mdf / fmaxf(chord_sq, 1e-30f) < 100000.0f)
    return 0;
  const float wx = (float)(p % a.w), wy = (float)(p / a.w);
  const float dsx = wx - sx, dsy = wy - sy;
  const float dex = wx - ex, dey = wy - ey;
  const float dss = __fmaf_rn(dsx, dsx, dsy * dsy);
  const float dse = __fmaf_rn(dex, dex, dey * dey);
  return dss >= kMinEdgeLen * kMinEdgeLen && dse >= kMinEdgeLen * kMinEdgeLen;
}

// ---- set-up ---------------------------------------------------------------

__device__ void setup_clear(const Args& a, int count0, int tid, int nth) {
  for (int g = tid; g <= count0; g += nth) {
    a.size[g] = 0;
    a.cursor[g] = 0;
    a.bad[g] = 0;
    a.maxkey[g] = 0;
  }
  for (int c = tid; c < a.chunks; c += nth) a.status[c] = 0;
  if (tid == 0) {
    a.misc[kCnt] = count0;
    a.misc[kAnyBad] = 0;
    a.misc[kListed] = 0;
  }
}

// every valid slot: lsid's value unless it takes part (its label, as the
// plain version leaves it), and perm cleared at its index (the valid slots
// come first, so this clears every position; a position left uncleared
// would only send its arc to ranking); every live slot: counted per arc
// (the lanes of a warp that share an arc add once) and listed
__device__ void setup_count(const Args& a, int count0, int tid, int nth) {
  const int lane = threadIdx.x & 31;
  for (int b = tid - lane; b < a.S; b += kBatch * nth) {
    Slots q;
    load_slots(a, count0, b + lane, nth, q);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (!__any_sync(kFull, q.valid[k])) continue;
      const int s = b + lane + k * nth;
      if (q.valid[k]) {
        a.perm[s] = -1;
        // the slot-range form: the live slots' labels come from each
        // tile's range, the others from part 0 alone
        if (a.parts == 0 || (a.part == 0 && !q.live[k]))
          a.lsid[q.p[k]] = q.lab[k];
      }
      const int lab = q.lab[k];
      const unsigned same = __match_any_sync(kFull, q.live[k] ? lab : -1);
      if (q.live[k] && lane == __ffs(same) - 1)
        atomicAdd(a.size + lab, __popc(same));
      const unsigned lives = __ballot_sync(kFull, q.live[k]);
      int base = 0;
      if (lane == 0 && lives) base = atomicAdd(a.misc + kListed, __popc(lives));
      base = __shfl_sync(kFull, base, 0);
      if (q.live[k]) {
        const int j = base + __popc(lives & ((1u << lane) - 1));
        a.lslot[j] = s;
        a.lpix[j] = q.p[k];
        a.llab[j] = lab;
        a.lnum[j] = q.num[k];
      }
    }
  }
}

// block 0: the runs of the arcs 0..count0, in arc order, by a prefix sum
// of the sizes
__device__ void setup_layout(const Args& a, int count0) {
  const int per = cdiv(count0 + 1, kThreads);
  const int lo = min((int)threadIdx.x * per, count0 + 1);
  const int hi = min(lo + per, count0 + 1);
  int c = 0;
  for (int g = lo; g < hi; ++g) c += a.size[g];
  int total;
  int run = block_exclusive_sum(c, &total);
  for (int g = lo; g < hi; ++g) {
    a.runstart[g] = run;
    run += a.size[g];
    a.runend[g] = run;
  }
  if (threadIdx.x == 0) a.misc[kLive] = total;
}

__device__ __forceinline__ void put(const Args& a, int i, int slot, int p,
                                    int lab, int num) {
  a.perm[i] = slot;
  a.posof[slot] = i;
  a.pix[i] = p;
  a.lab[i] = lab;
  a.num[i] = num;
}

// each listed slot claims run start + number - 1 and fills that position;
// an arc whose numbers are not 1..size without repeats is marked for
// ranking, which fills all its positions again
__device__ void setup_place(const Args& a, int tid, int nth) {
  const int listed = misc(a, kListed);
  for (int j = tid; j < listed; j += nth) {
    const int s = a.lslot[j], p = a.lpix[j], lab = a.llab[j], num = a.lnum[j];
    const int i = a.runstart[lab] + num - 1;
    if (num >= 1 && num <= a.size[lab] && atomicCAS(a.perm + i, -1, s) == -1) {
      put(a, i, s, p, lab, num);
    } else {
      a.bad[lab] = 1;
      a.misc[kAnyBad] = 1;
    }
  }
}

__device__ __forceinline__ u64 order_key(int num, int s) {
  return (u64)((unsigned)num ^ 0x80000000u) << 32 | (unsigned)s;
}

// the marked arcs: gather their slots' keys, then rank each by (number,
// slot) among them
__device__ void setup_gather(const Args& a, int tid, int nth) {
  const int listed = misc(a, kListed);
  for (int j = tid; j < listed; j += nth) {
    const int lab = a.llab[j];
    if (!a.bad[lab]) continue;
    const int c = atomicAdd(a.cursor + lab, 1);
    a.stage[a.runstart[lab] + c] = order_key(a.lnum[j], a.lslot[j]);
  }
}

__device__ void setup_rank(const Args& a, int tid, int nth) {
  const int listed = misc(a, kListed);
  for (int j = tid; j < listed; j += nth) {
    const int lab = a.llab[j];
    if (!a.bad[lab]) continue;
    const int s = a.lslot[j], num = a.lnum[j];
    const u64 key = order_key(num, s);
    const int lo = a.runstart[lab], hi = a.runend[lab];
    int rank = 0;
    for (int i = lo; i < hi; ++i) rank += a.stage[i] < key;
    put(a, lo + rank, s, a.lpix[j], lab, num);
  }
}

// ---- a round --------------------------------------------------------------

// a thread's position for phase A: its index, pixel, number and slot, and
// its segment before the previous round's pass3
struct Pos {
  int i, p, num, slot, lab;
};

__device__ __forceinline__ Pos load_pos(const Args& a, int i, int live) {
  Pos q;
  q.i = i;
  q.p = q.num = q.slot = 0;
  q.lab = -1;
  if (i < live) {
    q.p = a.pix[i];
    q.num = a.num[i];
    q.slot = a.perm[i];
    q.lab = a.lab[i];
  }
  return q;
}

// pass3 of the previous round for a live position: past its segment's end
// index it moves one right-pointer hop.  Returns the chord of its segment,
// loaded with the test and loaded again only after a move.
__device__ __forceinline__ float4 pass3(const Args& a, int r, Pos& q) {
  const int l = q.lab;
  const int eidx = a.eidx[l], right = a.right[l];
  float4 c = make_float4(a.sx[l], a.sy[l], a.ex[l], a.ey[l]);
  if (r > 0 && eidx < q.num) {
    q.lab = right;
    a.lab[q.i] = right;
    c = make_float4(a.sx[right], a.sy[right], a.ex[right], a.ey[right]);
  }
  return c;
}

// A for one piece (the calling warp) of the positions before `hi`: pass3,
// the distances, the segmented scan of the run keys
__device__ void piece_keys(const Args& a, int r, int hi, Pos& q) {
  const int lane = threadIdx.x & 31;
  const int i = q.i;
  const bool valid = i < hi;
  u64 key = 0;
  if (valid) {
    const float4 c = pass3(a, r, q);
    const float px = (float)(q.p % a.w), py = (float)(q.p / a.w);
    key = dist_key((int)(chord_dist(c.x, c.y, c.z, c.w, px, py) * kFix),
                   q.slot);
  }
  const int l = q.lab;
  // a run's part starts at the piece's first position or where the
  // segment changes, and ends at the piece's last or where it changes
  const int before = __shfl_up_sync(kFull, l, 1);
  const int after = __shfl_down_sync(kFull, l, 1);
  const bool head = lane == 0 || before != l;
  const bool end = valid && (lane == 31 || i + 1 == hi || after != l);
  u64 v = key;
  int f = head;
  for (int o = 1; o < 32; o <<= 1) {
    const u64 uv = __shfl_up_sync(kFull, v, o);
    const int uf = __shfl_up_sync(kFull, f, o);
    if (lane >= o) {
      if (!f && uv > v) v = uv;
      f |= uf;
    }
  }
  if (end) atomicMax(a.maxkey + l, v);
}

// A: every piece of live positions; a thread whose position is the same
// for the whole launch (`resident`) keeps it in registers (`mine`)
__device__ void round_distances(const Args& a, int r, bool resident,
                                Pos& mine) {
  const int live = misc(a, kLive);
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int warps = gridDim.x * blockDim.x >> 5;
  const int pieces = cdiv(live, kPiece);
  if (resident) {
    if (warp < pieces) piece_keys(a, r, live, mine);
    return;
  }
  for (int pc = warp; pc < pieces; pc += warps) {
    Pos q = load_pos(a, pc * kPiece + lane, live);
    piece_keys(a, r, live, q);
  }
}

// sum of the split flags of the chunks before c (decoupled look-back);
// publishes this chunk's own count and then its inclusive prefix
__device__ int look_back(const Args& a, int c, int agg, int r) {
  __shared__ int s_prefix;
  const u64 tag_agg = (u64)(2 * r + 2) << 32;
  const u64 tag_inc = (u64)(2 * r + 3) << 32;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    if (lane == 0)
      atomicExch(a.status + c, (c == 0 ? tag_inc : tag_agg) | (unsigned)agg);
    int prefix = 0;
    for (int j = c - 1; j >= 0; j -= 32) {
      const int idx = j - lane;
      u64 st = tag_inc;  // before chunk 0: an inclusive prefix of 0
      if (idx >= 0) {
        do {
          st = *(volatile u64*)(a.status + idx);
        } while (st < tag_agg);
      }
      const unsigned inc = __ballot_sync(kFull, st >= tag_inc);
      const int stop = inc ? __ffs(inc) - 1 : 31;
      int v = lane <= stop ? (int)(st & 0xffffffffu) : 0;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      prefix += v;
      if (inc) break;
    }
    if (c > 0 && lane == 0)
      atomicExch(a.status + c, tag_inc | (unsigned)(prefix + agg));
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  return s_prefix;
}

// B: split tests, id-order allocation, records.  `serial`: one block takes
// the chunks in id order and carries their flag count, no look-back.
__device__ void round_splits(const Args& a, int r, bool serial) {
  const int count = misc(a, kCnt + (r & 1));
  const int chunks = cdiv(count + 1, kThreads);
  int carry = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int g = c * kThreads + threadIdx.x;
    int flag = 0, wpos = 0, md = 0, p = 0, wn = 0, next = 0;
    Seg q;
    if (g <= count) {
      // the run's key from phase A, loaded with the segment, and cleared
      // for the next round
      q = load_seg(a, g);
      const u64 key = a.red[g];  // read before maxkey[g] is cleared
      if (q.runend > q.runstart) {
        a.maxkey[g] = 0;
        wpos = a.posof[key_slot(key)];
        md = key_dist(key);
        p = a.pix[wpos];
        wn = a.num[wpos];
        next = wpos + 1 < q.runend ? a.num[wpos + 1] : wn + 1;
        flag = split_test(a, q, md, p);
      }
    }
    int total;
    const int excl = block_exclusive_sum(flag, &total);
    const int prefix = serial ? carry : look_back(a, c, total, r);
    carry += total;
    const int gn = count + prefix + excl + 1;
    if (flag && gn < a.cap) {
      // new segment gn covers [wn, end], old g keeps [start, wn]
      const float wx = (float)(p % a.w), wy = (float)(p / a.w);
      a.sx[gn] = wx;
      a.sy[gn] = wy;
      a.ex[gn] = q.ex;
      a.ey[gn] = q.ey;
      a.sidx[gn] = wn;
      a.eidx[gn] = q.eidx;
      a.left[gn] = g;
      a.right[gn] = q.right;
      a.polyid[gn] = q.polyid;
      a.level[gn] = md;
      a.npix[gn] = 0;
      a.scount[gn] = 0;
      a.ecount[gn] = 0;
      // old right neighbour's left pointer -> gn (oclpolyline.cl:614)
      if (q.right != 0) a.left[q.right] = gn;
      a.ex[g] = wx;
      a.ey[g] = wy;
      a.eidx[g] = wn;
      a.right[g] = gn;
      // pass3: the positions numbered past wn now belong to gn
      int cut = wpos + 1;
      if (next <= wn)
        while (cut < q.runend && a.num[cut] <= wn) ++cut;
      a.runend[g] = cut;
      a.runstart[gn] = cut;
      a.runend[gn] = q.runend;
      a.maxkey[gn] = 0;
    }
    if (c == chunks - 1 && threadIdx.x == 0)
      a.misc[kCnt + ((r + 1) & 1)] =
          count + min(prefix + total, a.cap - 1 - count);
    __syncthreads();
  }
}

// the set-up, by the whole cluster
__device__ void setup(const Args& a, cg::cluster_group& cluster, int tid,
                      int nth) {
  // the ids that exist before the first round (the precondition puts
  // every live slot's label among them)
  const int count0 = min(*a.count, a.cap - 1);
  setup_clear(a, count0, tid, nth);
  cluster.sync();
  setup_count(a, count0, tid, nth);
  cluster.sync();
  if (blockIdx.x == 0) setup_layout(a, count0);
  cluster.sync();
  setup_place(a, tid, nth);
  cluster.sync();
  if (misc(a, kAnyBad)) {
    setup_gather(a, tid, nth);
    cluster.sync();
    setup_rank(a, tid, nth);
    cluster.sync();
  }
}

__global__ void __launch_bounds__(kThreads, 1) mkpl_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  setup(a, cluster, tid, nth);

  const int live = misc(a, kLive);
  const bool resident = live <= nth;
  Pos mine = load_pos(a, tid, live);
  for (int r = 0; r < a.rounds; ++r) {
    round_distances(a, r, resident, mine);
    cluster.sync();
    round_splits(a, r, false);
    cluster.sync();
  }

  // the last round's pass3, and lsid at the live positions
  if (resident) {
    if (tid < live) {
      if (a.rounds > 0) pass3(a, a.rounds, mine);
      a.lsid[mine.p] = mine.lab;
    }
  } else {
    for (int i = tid; i < live; i += nth) {
      Pos q = load_pos(a, i, live);
      if (a.rounds > 0) pass3(a, a.rounds, q);
      a.lsid[q.p] = q.lab;
    }
  }
  if (tid == 0) *a.count = misc(a, kCnt + (a.rounds & 1));
}

// ---- the slot-range form ----------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) mkpl_setup_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  setup(a, cluster, blockIdx.x * blockDim.x + threadIdx.x,
        gridDim.x * blockDim.x);
}

// phase A of round a.round over this part's positions; at round == rounds
// the last round's pass3, lsid at those positions and the final count
__global__ void __launch_bounds__(kThreads) mkpl_keys_kernel(Args a) {
  const int live = a.misc[kLive];
  const int chunk = cdiv(live, a.parts);
  const int lo = min(a.part * chunk, live);
  const int hi = min(lo + chunk, live);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  if (a.round < a.rounds) {
    const int lane = threadIdx.x & 31;
    const int pieces = cdiv(hi - lo, kPiece);
    for (int pc = tid >> 5; pc < pieces; pc += nth >> 5) {
      Pos q = load_pos(a, lo + pc * kPiece + lane, hi);
      piece_keys(a, a.round, hi, q);
    }
    return;
  }
  for (int i = lo + tid; i < hi; i += nth) {
    Pos q = load_pos(a, i, hi);
    if (a.rounds > 0) pass3(a, a.rounds, q);
    a.lsid[q.p] = q.lab;
  }
  if (tid == 0) *a.count = a.misc[kCnt + (a.rounds & 1)];
}

__global__ void __launch_bounds__(kThreads, 1) mkpl_splits_kernel(Args a) {
  round_splits(a, a.round, true);
}

}  // namespace

extern "C" int rd_mkpl_scratch_words(int S, int cap) {
  return scratch_words(S, cap);
}

// fields: (13, cap) int32 rows in SegmentArena order (sx, sy, ex, ey as
// float bits), updated in place; count: one int32, updated in place;
// scratch: rd_mkpl_scratch_words(S, cap) int32, 8-byte aligned; lsid: (n,)
// int32, zero-filled.
static Args make_args(const void* comp_idx, const void* dense,
                      const void* number, void* fields, void* count,
                      void* scratch, void* lsid, const void* red, int S,
                      int cap, int n, int w, int rounds, int minerr_fix,
                      int round, int part, int parts) {
  Args a;
  a.comp_idx = (const int*)comp_idx;
  a.dense = (const int*)dense;
  a.number = (const int*)number;
  int* f = (int*)fields;
  a.sx = (float*)(f + 0 * (size_t)cap);
  a.sy = (float*)(f + 1 * (size_t)cap);
  a.ex = (float*)(f + 2 * (size_t)cap);
  a.ey = (float*)(f + 3 * (size_t)cap);
  a.sidx = f + 4 * (size_t)cap;
  a.eidx = f + 5 * (size_t)cap;
  a.left = f + 6 * (size_t)cap;
  a.right = f + 7 * (size_t)cap;
  a.scount = f + 8 * (size_t)cap;
  a.ecount = f + 9 * (size_t)cap;
  a.polyid = f + 10 * (size_t)cap;
  a.npix = f + 11 * (size_t)cap;
  a.level = f + 12 * (size_t)cap;
  a.count = (int*)count;
  a.S = S;
  a.cap = cap;
  a.n = n;
  a.w = w;
  a.rounds = rounds;
  a.minerr_fix = minerr_fix;
  a.chunks = cdiv(cap, kThreads);
  a.round = round;
  a.part = part;
  a.parts = parts;
  u64* q = (u64*)scratch;
  a.maxkey = q;
  a.red = red ? (const u64*)red : a.maxkey;
  a.status = a.maxkey + cap;
  a.stage = a.status + a.chunks;
  a.lslot = (int*)(a.stage + S);
  a.lpix = a.lslot + S;
  a.llab = a.lpix + S;
  a.lnum = a.llab + S;
  a.posof = a.lnum + S;
  a.perm = a.posof + S;
  a.pix = a.perm + S;
  a.num = a.pix + S;
  a.lab = a.num + S;
  a.size = a.lab + S;
  a.cursor = a.size + cap;
  a.bad = a.cursor + cap;
  a.runstart = a.bad + cap;
  a.runend = a.runstart + cap;
  a.misc = a.runend + cap;
  a.lsid = (int*)lsid;
  return a;
}

static int launch_cluster(void (*kernel)(Args), const Args& a,
                          void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kBlocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  rd::count_launch();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int rd_mkpl(const void* comp_idx, const void* dense,
                       const void* number, void* fields, void* count,
                       void* scratch, void* lsid, int S, int cap, int n,
                       int w, int rounds, int minerr_fix, void* stream) {
  return launch_cluster(
      mkpl_kernel,
      make_args(comp_idx, dense, number, fields, count, scratch, lsid,
                nullptr, S, cap, n, w, rounds, minerr_fix, 0, 0, 0),
      stream);
}

// The slot-range form, one tile's launches: the arguments of rd_mkpl for
// the tile's own fields, count, scratch and lsid (zero-filled), plus red
// (rd_mkpl_splits: the (cap,) key tables' elementwise maximum over the
// tiles, int64), the round, and the tile's part of `parts`.
extern "C" int rd_mkpl_setup(const void* comp_idx, const void* dense,
                             const void* number, void* fields, void* count,
                             void* scratch, void* lsid, const void* red,
                             int S, int cap, int n, int w, int rounds,
                             int minerr_fix, int round, int part, int parts,
                             void* stream) {
  if (parts < 1 || part < 0 || part >= parts) return (int)cudaErrorInvalidValue;
  return launch_cluster(
      mkpl_setup_kernel,
      make_args(comp_idx, dense, number, fields, count, scratch, lsid, red,
                S, cap, n, w, rounds, minerr_fix, round, part, parts),
      stream);
}

extern "C" int rd_mkpl_keys(const void* comp_idx, const void* dense,
                            const void* number, void* fields, void* count,
                            void* scratch, void* lsid, const void* red,
                            int S, int cap, int n, int w, int rounds,
                            int minerr_fix, int round, int part, int parts,
                            void* stream) {
  if (parts < 1 || part < 0 || part >= parts) return (int)cudaErrorInvalidValue;
  const Args a = make_args(comp_idx, dense, number, fields, count, scratch,
                           lsid, red, S, cap, n, w, rounds, minerr_fix, round,
                           part, parts);
  // a part holds at most ceil(S / parts) positions; a block a thread each,
  // looping beyond kKeyBlocks
  int blocks = cdiv(cdiv(S, parts), kThreads);
  blocks = blocks < 1 ? 1 : blocks > kKeyBlocks ? kKeyBlocks : blocks;
  mkpl_keys_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  rd::count_launch();
  return (int)cudaGetLastError();
}

extern "C" int rd_mkpl_splits(const void* comp_idx, const void* dense,
                              const void* number, void* fields, void* count,
                              void* scratch, void* lsid, const void* red,
                              int S, int cap, int n, int w, int rounds,
                              int minerr_fix, int round, int part, int parts,
                              void* stream) {
  if (parts < 1 || part < 0 || part >= parts || !red)
    return (int)cudaErrorInvalidValue;
  mkpl_splits_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(make_args(
      comp_idx, dense, number, fields, count, scratch, lsid, red, S, cap, n,
      w, rounds, minerr_fix, round, part, parts));
  rd::count_launch();
  return (int)cudaGetLastError();
}

// Kernel #14 mkpl: the max-deviation subdivision of the polyline stage
// (mkpl_pass1/2/3, oclpolyline.cl:509-646; host loop oclpolyline.c:186-216)
// over the compacted arc slot list, all rounds in one launch.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_mkpl.py:_mkpl_kernel
// (mkpl_subdivide_pallas).  The TPU kernel sorted the slots by (arc,
// number), kept every segment a contiguous run and reduced with
// Hillis-Steele ladders, because the TPU has no gathers or atomics; it
// allocated provisional ids in slot order and renamed them afterwards,
// which is exact only when the arena cannot overflow (cap >= slots).  The
// port's arc slot list is larger than the arena (76800 slots, 16384
// segments at 720p), so this kernel allocates exactly as the plain
// version (ops/mkpl.py:mkpl_subdivide) does: split segments ranked by
// id, dropped once count + rank >= cap.
//
// Design: one cooperative persistent kernel; grid-wide barriers separate
// the phases of each round:
//   1. per slot: fixed-point distance to its segment's chord, atomicMax
//      into the segment's maximum;
//   2. per slot: the winner, the minimum slot (= minimum flat index)
//      reaching the maximum, by atomicMin;
//   3. block 0: the split test of every segment (ids 0..count) and an
//      id-ordered prefix sum over them, which allocates the new ids;
//   4. per segment: the record writes (new segment, truncated old one, the
//      old right neighbour's left pointer);
//   5. per slot: pixels past a split move one right-pointer hop.
// Integer atomics give the same result in any order, so runs are
// deterministic.  The floats follow _closest_point_dist and fp.hypot
// operation for operation (fmaf where XLA contracts, built with
// --fmad=false; '/' and sqrtf correctly rounded), so the arena is
// bit-equal to the plain version's.
//
// Bound: latency.  Per round it moves ~30 B per slot and ~80 B per arena
// entry (a few MB, resident in L2), but 5 grid barriers and a one-block
// allocation pass per round serialise it; 15 rounds replace ~100 small
// launches each of the plain form.  The allocation pass covers the live
// ids only: over the whole arena (16384 ids, 32 dependent split tests per
// thread) it took most of the kernel's time.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr float kFix = 65536.0f;   // oclpolyline.cl:535
constexpr int kMinNIndex = 4;      // oclpolyline.cl:21
constexpr float kMinEdgeLen = 1.0f;  // oclpolyline.cl:20

struct Args {
  const int* comp_idx;  // (S,) flat pixel per slot, n = empty
  const int* dense;     // (n,) arc id image
  const int* number;    // (n,) arc-length number image
  // arena (cap,) each; written during the launch, so never __restrict__
  float *sx, *sy, *ex, *ey;
  int *sidx, *eidx, *left, *right, *scount, *ecount, *polyid, *npix, *level;
  int* count;
  // scratch
  int *lab, *num, *dist;     // (S,)
  int *maxd, *winner, *gn;   // (cap,)
  int* lsid;                 // (n,) output image, zero-filled
  int S, cap, n, w, rounds, minerr_fix;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int slot_pixel(const Args& a, int s) {
  return clampi(a.comp_idx[s], 0, a.n - 1);
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

// pass2 split conditions (oclpolyline.cl:564-577) of segment g
__device__ int split_test(const Args& a, int g) {
  if (a.polyid[g] == 0) return 0;
  const int ws = a.winner[g];
  if (ws >= a.S) return 0;
  const int md = a.maxd[g];
  if (a.eidx[g] - a.sidx[g] < kMinNIndex - 1) return 0;
  if (a.scount[g] > 1 || a.ecount[g] > 1) return 0;
  if (md < a.minerr_fix) return 0;
  const float sx = a.sx[g], sy = a.sy[g], ex = a.ex[g], ey = a.ey[g];
  const float mdf = (float)md;
  const float cdx = ex - sx, cdy = ey - sy;
  const float chord_sq = __fmaf_rn(cdx, cdx, cdy * cdy);
  if (md < a.minerr_fix * 3 && mdf * mdf / fmaxf(chord_sq, 1e-30f) < 100000.0f)
    return 0;
  const int p = slot_pixel(a, ws);
  const float wx = (float)(p % a.w), wy = (float)(p / a.w);
  const float dsx = wx - sx, dsy = wy - sy;
  const float dex = wx - ex, dey = wy - ey;
  const float dss = __fmaf_rn(dsx, dsx, dsy * dsy);
  const float dse = __fmaf_rn(dex, dex, dey * dey);
  return dss >= kMinEdgeLen * kMinEdgeLen && dse >= kMinEdgeLen * kMinEdgeLen;
}

// block 0: split every segment that passes, allocating ids count+1, ...
// in id order; splits that would reach cap drop (ops/mkpl.py:141-143).
// Only ids 0..count hold segments; gn stays cap beyond them.
__device__ void allocate(const Args& a) {
  __shared__ int s_sum[kThreads];
  const int t = threadIdx.x;
  const int count = *a.count;
  const int lim = min(count + 1, a.cap);
  const int per = (lim + kThreads - 1) / kThreads;
  const int lo = min(t * per, lim), hi = min(lo + per, lim);
  int c = 0;
  for (int g = lo; g < hi; ++g) {
    const int f = split_test(a, g);
    a.gn[g] = f;
    c += f;
  }
  s_sum[t] = c;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    const int add = t >= d ? s_sum[t - d] : 0;
    __syncthreads();
    s_sum[t] += add;
    __syncthreads();
  }
  const int total = s_sum[kThreads - 1];
  int rank = s_sum[t] - c;
  for (int g = lo; g < hi; ++g) {
    if (a.gn[g]) {
      ++rank;
      a.gn[g] = count + rank < a.cap ? count + rank : a.cap;
    } else {
      a.gn[g] = a.cap;
    }
  }
  __syncthreads();
  if (t == 0) *a.count = count + min(total, a.cap - 1 - count);
}

__global__ void __launch_bounds__(kThreads) mkpl_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;

  for (int s = tid; s < a.S; s += nth) {
    const bool live = a.comp_idx[s] < a.n;
    const int p = slot_pixel(a, s);
    a.lab[s] = live ? a.dense[p] : 0;
    a.num[s] = live ? a.number[p] : 0;
  }
  for (int g = tid; g < a.cap; g += nth) {
    a.maxd[g] = -1;
    a.winner[g] = a.S;
    a.gn[g] = a.cap;
  }
  grid.sync();

  for (int round = 0; round < a.rounds; ++round) {
    // 1. fixed-point distance to the chord; segment maximum
    for (int s = tid; s < a.S; s += nth) {
      const int l = a.lab[s];
      int d = -1;
      if (l > 0 && l < a.cap && a.polyid[l] != 0) {
        const int p = slot_pixel(a, s);
        const float px = (float)(p % a.w), py = (float)(p / a.w);
        const float dd = chord_dist(a.sx[l], a.sy[l], a.ex[l], a.ey[l], px,
                                    py);
        d = (int)(dd * kFix);
        atomicMax(a.maxd + l, d);
      }
      a.dist[s] = d;
    }
    grid.sync();
    // 2. winner: the minimum slot at the segment maximum
    for (int s = tid; s < a.S; s += nth) {
      const int d = a.dist[s];
      if (d >= 0 && d == a.maxd[a.lab[s]]) atomicMin(a.winner + a.lab[s], s);
    }
    grid.sync();
    // 3. split tests and id allocation
    if (blockIdx.x == 0) allocate(a);
    grid.sync();
    // 4. records: new segment gn covers [wn, end], old g keeps [start, wn]
    for (int g = tid; g < a.cap; g += nth) {
      const int gn = a.gn[g];
      if (gn < a.cap) {
        const int ws = a.winner[g];
        const int p = slot_pixel(a, ws);
        const float wx = (float)(p % a.w), wy = (float)(p / a.w);
        const int wn = a.num[ws];
        const int right = a.right[g];
        a.sx[gn] = wx;
        a.sy[gn] = wy;
        a.ex[gn] = a.ex[g];
        a.ey[gn] = a.ey[g];
        a.sidx[gn] = wn;
        a.eidx[gn] = a.eidx[g];
        a.left[gn] = g;
        a.right[gn] = right;
        a.polyid[gn] = a.polyid[g];
        a.level[gn] = a.maxd[g];
        a.npix[gn] = 0;
        a.scount[gn] = 0;
        a.ecount[gn] = 0;
        // old right neighbour's left pointer -> gn (oclpolyline.cl:614)
        if (right != 0) a.left[right] = gn;
        a.ex[g] = wx;
        a.ey[g] = wy;
        a.eidx[g] = wn;
        a.right[g] = gn;
      }
      a.maxd[g] = -1;
      a.winner[g] = a.S;
    }
    grid.sync();
    // 5. pass3: pixels past the split move one right-pointer hop
    for (int s = tid; s < a.S; s += nth) {
      if (a.dist[s] < 0) continue;
      const int l = a.lab[s];
      if (a.eidx[l] < a.num[s]) a.lab[s] = a.right[l];
    }
    grid.sync();
  }

  for (int s = tid; s < a.S; s += nth) {
    const int i = a.comp_idx[s];
    if (i < a.n) a.lsid[i] = a.lab[s];
  }
}

}  // namespace

// fields: (13, cap) int32 rows in SegmentArena order (sx, sy, ex, ey as
// float bits), updated in place; count: one int32, updated in place;
// scratch: 3 * S + 3 * cap int32; lsid: (n,) int32, zero-filled.
extern "C" int rd_mkpl(const void* comp_idx, const void* dense,
                       const void* number, void* fields, void* count,
                       void* scratch, void* lsid, int S, int cap, int n,
                       int w, int rounds, int minerr_fix, void* stream) {
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
  int* sc = (int*)scratch;
  a.lab = sc;
  a.num = sc + S;
  a.dist = sc + 2 * (size_t)S;
  a.maxd = sc + 3 * (size_t)S;
  a.winner = a.maxd + cap;
  a.gn = a.winner + cap;
  a.lsid = (int*)lsid;
  a.S = S;
  a.cap = cap;
  a.n = n;
  a.w = w;
  a.rounds = rounds;
  a.minerr_fix = minerr_fix;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mkpl_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // enough blocks to cover the slots once, at most what can be co-resident
  const int want = (S + kThreads - 1) / kThreads;
  const int blocks = max(1, min(want, sms * min(per_sm, 2)));
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)mkpl_kernel, dim3(blocks),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

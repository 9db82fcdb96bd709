// Kernel #15 hyp: quad hypothesis reduction, one group of segments to one
// quad (removeShortLS -> pickExternalLS -> pickLongestLS(4) -> sortByAngle
// -> findCorners -> triangle, perimeter and convexity checks,
// oclrect.c:1134-1151), as geometry/quad.py:reduce_groups computes it.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_hyp.py:_hyp_kernel
// (reduce_groups_pallas).
//
// Bound: operations.  The gift-wrapping hull tests every candidate
// endpoint against every other for "a point strictly to its left", P^2
// pair tests per hull step (P = 2K endpoints), for up to max_vertices - 1
// steps; the rest is O(K) per hull edge and O(1) per group.  The TPU kernel
// held (groups x P x P) blocks in VMEM and unrolled every step; here one
// block of 2K threads (one per endpoint) takes one group: the group's
// segments and endpoints sit in shared memory, each hull step is a loop
// over P in every thread and a block-wide first-max on (score, index), each
// hull edge's pick a first-max over the K segments, and one thread runs the
// O(1) tail.  The walk ends at the step that closes the hull, which gives
// the same vertices as running all steps.
//
// Every float operation is the plain version's, rounded once in the same
// order (built with --fmad=false; sqrtf and division correctly rounded),
// so the two agree bit for bit; atan2f is the card's, as in the plain
// version run on the card.  The flip in sortByAngle negates v, keeping
// atan2(-0, -x) = -pi apart from atan2(+0, -x) = +pi.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxK = 64;           // segments per group
constexpr int kMaxP = 2 * kMaxK;    // endpoints per group
constexpr int kMaxH = 64;           // hull vertices
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-20f;

struct Best {
  float s;
  int i;
};

// the first maximum: a larger score, or an equal score at a lower index
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.s > a.s || (b.s == a.s && b.i < a.i)) ? b : a;
}

// first-max of (s, i) over the block; every thread gets the result
__device__ Best block_first_max(Best v, Best* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.s = __shfl_down_sync(0xffffffffu, v.s, off);
    o.i = __shfl_down_sync(0xffffffffu, v.i, off);
    v = better(v, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best b = scratch[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) b = better(b, scratch[w]);
    scratch[0] = b;
  }
  __syncthreads();
  const Best r = scratch[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float max_eps(float a) {
  return (a != a || a > kEps) ? a : kEps;
}

__global__ void hyp_kernel(const float* __restrict__ segs,
                           const unsigned char* __restrict__ valid_in,
                           float* __restrict__ corners_out,
                           unsigned char* __restrict__ ok_out, int k,
                           int max_vertices, float short_ratio2) {
  __shared__ float e0x[kMaxK], e0y[kMaxK], e1x[kMaxK], e1y[kMaxK];
  __shared__ float sq[kMaxK], sqm[kMaxK];
  __shared__ int valid[kMaxK];
  __shared__ float px[kMaxP], py[kMaxP];
  __shared__ float relx[kMaxP], rely[kMaxP], dist[kMaxP];
  __shared__ int pvalid[kMaxP], cand[kMaxP];
  __shared__ int hidx[kMaxH], picks[kMaxH];
  __shared__ int picked[kMaxK];
  __shared__ Best scratch[kMaxP / 32];
  __shared__ int s_nvalid, s_done, s_cur, s_nh;
  __shared__ float s_longest;

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int p = 2 * k;
  const float* gs = segs + (size_t)g * k * 4;

  // ---- segments, squared lengths, removeShortLS (oclrect.c:926-943) ----
  if (t < k) {
    e0x[t] = gs[4 * t];
    e0y[t] = gs[4 * t + 1];
    e1x[t] = gs[4 * t + 2];
    e1y[t] = gs[4 * t + 3];
    const float dx = e1x[t] - e0x[t], dy = e1y[t] - e0y[t];
    sq[t] = dx * dx + dy * dy;
    const int v = valid_in[(size_t)g * k + t] != 0 && sq[t] > 0.0f;
    valid[t] = v;
    sqm[t] = v ? sq[t] : -1.0f;
    picked[t] = 0;
  }
  __syncthreads();
  if (t == 0) {
    int n = 0;
    float m = sqm[0];
    for (int j = 0; j < k; ++j) {
      n += valid[j];
      m = fmaxf(m, sqm[j]);
    }
    s_nvalid = n;
    s_longest = m;
  }
  __syncthreads();
  int keep = 0;
  if (t < k) {
    // rank of t in the stable argsort of -sqm
    int rank = 0;
    for (int j = 0; j < k; ++j)
      rank += sqm[j] > sqm[t] || (sqm[j] == sqm[t] && j < t);
    const bool passes = sqm[t] > short_ratio2 * s_longest;
    keep = s_nvalid <= 4 ? valid[t] : (valid[t] && (passes || rank < 4));
  }
  __syncthreads();
  if (t < k) valid[t] = keep;
  __syncthreads();

  // ---- endpoints, gift-wrapping hull (oclrect.c:697-734) ----------------
  if (t < p) {
    const int s = t >> 1;
    px[t] = (t & 1) ? e1x[s] : e0x[s];
    py[t] = (t & 1) ? e1y[s] : e0y[s];
    pvalid[t] = valid[s];
  }
  __syncthreads();
  Best b0{-INFINITY, t};
  if (t < p) b0.s = pvalid[t] ? px[t] : -kBig;
  const int start = block_first_max(b0, scratch).i;
  if (t == 0) {
    hidx[0] = start;
    for (int i = 1; i < max_vertices; ++i) hidx[i] = -1;
    s_cur = start;
    s_done = 0;
  }
  __syncthreads();
  for (int step = 1; step < max_vertices; ++step) {
    const int cur = s_cur;
    if (t < p) {
      const float rx = px[t] - px[cur], ry = py[t] - py[cur];
      relx[t] = rx;
      rely[t] = ry;
      dist[t] = rx * rx + ry * ry;
      cand[t] = pvalid[t] && dist[t] > 1e-12f;
    }
    __syncthreads();
    Best b{-INFINITY, t};
    if (t < p) {
      bool good = cand[t];
      if (good) {
        const float rx = relx[t], ry = rely[t], di = dist[t];
        const float perp = 0.1f * sqrtf(max_eps(di));
        for (int j = 0; j < p; ++j) {
          if (!cand[j]) continue;
          const float cross = rx * rely[j] - ry * relx[j];
          const float norm = sqrtf(max_eps(di * dist[j]));
          const float a = 1e-5f * norm;
          const float thr = (a != a || a > perp) ? a : perp;
          if (cross > thr) {
            good = false;
            break;
          }
        }
      }
      b.s = good ? dist[t] : -1.0f;
    }
    const Best nb = block_first_max(b, scratch);
    if (t == 0) {
      // a good candidate has dist > 1e-12, so any_good <=> max score > 0
      const bool any_good = nb.s > 0.0f;
      if (any_good && nb.i != start) {
        hidx[step] = nb.i;
        s_cur = nb.i;
      } else {
        s_done = 1;
      }
    }
    __syncthreads();
    if (s_done) break;
  }
  if (t == 0) {
    int nh = 0;
    while (nh < max_vertices && hidx[nh] >= 0) ++nh;
    s_nh = nh;
  }
  __syncthreads();

  // ---- a pick per hull edge (pickExternalLS, oclrect.c:945-992) --------
  const int nh = s_nh;
  float dex = 0.0f, dey = 0.0f, dx = 0.0f, dy = 0.0f, l2 = 0.0f;
  if (t < k) {
    const float den = max_eps(sqrtf(sq[t]));
    dex = (e0x[t] - e1x[t]) / den;
    dey = (e0y[t] - e1y[t]) / den;
    dx = e1x[t] - e0x[t];
    dy = e1y[t] - e0y[t];
    l2 = dx * dx + dy * dy;
  }
  for (int i = 0; i < nh; ++i) {
    const int a = hidx[i], c = hidx[i + 1 < nh ? i + 1 : 0];
    Best b{-INFINITY, t};
    bool ok = false;
    if (t < k) {
      const float q0x = px[a], q0y = py[a], q1x = px[c], q1y = py[c];
      const float mx = (q0x + q1x) * 0.5f, my = (q0y + q1y) * 0.5f;
      float tt = ((mx - e0x[t]) * dx + (my - e0y[t]) * dy) / max_eps(l2);
      tt = l2 > 0.0f ? tt : 0.0f;
      tt = fminf(fmaxf(tt, 0.0f), 1.0f);
      const float dmx = mx - (e0x[t] + tt * dx);
      const float dmy = my - (e0y[t] + tt * dy);
      const float dm = dmx * dmx + dmy * dmy;
      const bool close = dm < 1.0f;
      const float qdx = q0x - q1x, qdy = q0y - q1y;
      const float qsq = qdx * qdx + qdy * qdy;
      const float qn = max_eps(sqrtf(qsq));
      const bool para = fabsf((qdx / qn) * dex + (qdy / qn) * dey) > 0.95f &&
                        dm / max_eps(qsq) < 0.01f;
      ok = valid[t] && !picked[t] && (close || para);
      b.s = ok ? sq[t] : -1.0f;
    }
    const bool any_ok = __syncthreads_or(ok);
    const Best nb = block_first_max(b, scratch);
    if (t == 0) {
      picks[i] = any_ok ? nb.i : -1;
      if (any_ok) picked[nb.i] = 1;
    }
    __syncthreads();
  }
  if (t != 0) return;
  for (int i = nh; i < max_vertices; ++i) picks[i] = -1;

  // ---- pickLongestLS(4) (oclrect.c:994-1009) ---------------------------
  float len0 = 0.0f;
  int n_picked = 0;
  int top[4] = {0, 0, 0, 0};
  for (int i = 0; i < max_vertices; ++i) {
    const bool pv = picks[i] >= 0;
    const float psq = sq[pv ? picks[i] : 0];
    const float plen = pv ? sqrtf(psq) : 0.0f;
    len0 = i == 0 ? plen : len0 + plen;
    n_picked += pv;
    // rank in the stable argsort of -(pv ? psq : -1)
    const float si = pv ? psq : -1.0f;
    int rank = 0;
    for (int j = 0; j < max_vertices; ++j) {
      const bool pj = picks[j] >= 0;
      const float sj = pj ? sq[picks[j]] : -1.0f;
      rank += sj > si || (sj == si && j < i);
    }
    if (rank < 4) top[rank] = pv ? picks[i] : 0;
  }
  const bool enough = n_picked >= 4;
  float s0x[4], s0y[4], s1x[4], s1y[4], l4[4];
  for (int r = 0; r < 4; ++r) {
    s0x[r] = e0x[top[r]];
    s0y[r] = e0y[top[r]];
    s1x[r] = e1x[top[r]];
    s1y[r] = e1y[top[r]];
    l4[r] = sqrtf(sq[top[r]]);
  }

  // ---- gv, sortByAngle (oclrect.c:821-877) -----------------------------
  const float lsum = max_eps(((l4[0] + l4[1]) + l4[2]) + l4[3]);
  float gx = 0.0f, gy = 0.0f;
  for (int r = 0; r < 4; ++r) {
    const float mx = (s0x[r] + s1x[r]) * 0.5f * l4[r];
    const float my = (s0y[r] + s1y[r]) * 0.5f * l4[r];
    gx = r == 0 ? mx : gx + mx;
    gy = r == 0 ? my : gy + my;
  }
  gx = gx / lsum;
  gy = gy / lsum;
  float ang[4];
  for (int r = 0; r < 4; ++r) {
    float vx = s0y[r] - s1y[r];
    float vy = -(s0x[r] - s1x[r]);
    if (vx * (s0x[r] - gx) + vy * (s0y[r] - gy) < 0.0f) {
      vx = -vx;
      vy = -vy;
    }
    ang[r] = atan2f(vx, vy);
  }
  float u0x[4], u0y[4], u1x[4], u1y[4];
  for (int r = 0; r < 4; ++r) {
    int pos = 0;
    for (int j = 0; j < 4; ++j)
      pos += ang[j] < ang[r] || (ang[j] == ang[r] && j < r);
    u0x[pos] = s0x[r];
    u0y[pos] = s0y[r];
    u1x[pos] = s1x[r];
    u1y[pos] = s1y[r];
  }

  // ---- findCorners (oclrect.c:1011-1045) -------------------------------
  bool cok = true;
  float cx[4], cy[4];
  for (int i = 0; i < 4; ++i) {
    const int n = (i + 1) & 3;
    const float d = (u1x[n] - u0x[n]) * (u1y[i] - u0y[i]) -
                    (u1y[n] - u0y[n]) * (u1x[i] - u0x[i]);
    cok = cok && fabsf(d) >= 1e-4f;
    const float nn = (u0y[n] - u0y[i]) * (u1x[i] - u0x[i]) -
                     (u0x[n] - u0x[i]) * (u1y[i] - u0y[i]);
    const float qq = nn / (fabsf(d) < 1e-4f ? 1.0f : d);
    cx[i] = u0x[n] + qq * (u1x[n] - u0x[n]);
    cy[i] = u0y[n] + qq * (u1y[n] - u0y[n]);
  }

  // ---- perimeter, closeToTriangle, isConvex (oclrect.c:886-922) --------
  float len1 = 0.0f, ex[4], ey[4];
  for (int i = 0; i < 4; ++i) {
    ex[i] = cx[(i + 1) & 3] - cx[i];
    ey[i] = cy[(i + 1) & 3] - cy[i];
    const float l = sqrtf(ex[i] * ex[i] + ey[i] * ey[i]);
    len1 = i == 0 ? l : len1 + l;
  }
  bool tri = false;
  for (int i = 0; i < 4; ++i) {
    const int n1 = (i + 1) & 3, n2 = (i + 2) & 3;
    const float ddx = cx[n2] - cx[i], ddy = cy[n2] - cy[i];
    const float ll = ddx * ddx + ddy * ddy;
    float tt = ((cx[n1] - cx[i]) * ddx + (cy[n1] - cy[i]) * ddy) / max_eps(ll);
    tt = ll > 0.0f ? tt : 0.0f;
    const float rx = cx[n1] - (cx[i] + tt * ddx);
    const float ry = cy[n1] - (cy[i] + tt * ddy);
    const float d0 = rx * rx + ry * ry;
    const float bx = cx[i] - cx[n2], by = cy[i] - cy[n2];
    const float d1 = bx * bx + by * by;
    tri = tri || d0 / max_eps(d1) < 0.001f;
  }
  bool convex = true;
  bool sign0 = false;
  for (int i = 0; i < 4; ++i) {
    const int n = (i + 1) & 3;
    const bool pos = ex[i] * ey[n] - ey[i] * ex[n] > 0.0f;
    if (i == 0) sign0 = pos;
    convex = convex && pos == sign0;
  }

  float* co = corners_out + (size_t)g * 8;
  for (int i = 0; i < 4; ++i) {
    co[2 * i] = cx[i];
    co[2 * i + 1] = cy[i];
  }
  ok_out[g] = enough && cok && !tri && len1 <= 2.0f * len0 && convex;
}

}  // namespace

// segs: (g, k, 2, 2) float32; valid: (g, k) bool; corners: (g, 4, 2)
// float32; ok: (g,) bool.  k <= 64, max_vertices <= 64.
extern "C" int rd_hyp(const void* segs, const void* valid, void* corners,
                      void* ok, int g, int k, int max_vertices,
                      float short_ratio2, void* stream) {
  if (k < 1 || k > kMaxK || max_vertices < 1 || max_vertices > kMaxH)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int threads = ((2 * k + 31) / 32) * 32;
  hyp_kernel<<<g, threads, 0, (cudaStream_t)stream>>>(
      (const float*)segs, (const unsigned char*)valid, (float*)corners,
      (unsigned char*)ok, k, max_vertices, short_ratio2);
  rd::count_launch();
  return (int)cudaGetLastError();
}

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
// held (groups x P x P) blocks in VMEM and unrolled every step.  A frame
// fills few of its groups, so on the card a group's time is the latency of
// its chain of steps, and the design shortens that chain.  One block takes
// one group:
//   - the kept segments (removeShortLS) are compacted in index order, so
//     the hull walks over their 2n endpoints only, and a first maximum
//     over compacted indices is one over the original indices;
//   - each hull step spreads its pair tests over the block, kLanes
//     threads per candidate, each over every kLanes-th endpoint; a thread
//     that finds a point to the candidate's left sets the candidate's flag
//     in shared memory, and after a __syncthreads each candidate left
//     unflagged posts (distance bits, complement of its index) to one
//     shared 64-bit atomicMax, which is the first maximum.  A pair's sqrtf
//     is taken only where cross > perp: the threshold is perp, a value
//     above it or NaN, so the test fails otherwise whatever the pair term
//     is.  Few candidates are good, so the atomic meets little contention,
//     and the step needs no warp-wide vote or reduction;
//   - pickExternalLS's tests of every (hull edge, kept segment) pair run
//     at once, each setting its segment's bit in its edge's mask, the
//     bits in the segments' order (longest first, then by index); the
//     greedy "longest not yet picked" chain is then one find-first-set
//     per edge;
//   - pickLongestLS ranks its picks with one thread per pick, and one
//     thread runs the O(1) tail.
// The walk ends at the step that closes the hull, which gives the same
// vertices as running all steps.
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
// threads per hull candidate: 2 kMaxK kLanes = 512 threads at most
constexpr int kLanes = 4;
constexpr float kBig = 1e30f;
constexpr float kEps = 1e-20f;

__device__ __forceinline__ float max_eps(float a) {
  return (a != a || a > kEps) ? a : kEps;
}

// an unsigned key in the order of a float that is not NaN; -0 as +0
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a first-maximum key: the score's key above the complement of the index,
// so the largest score wins and, among equal ones, the lowest index
__device__ __forceinline__ unsigned long long first_max_key(unsigned key,
                                                             int idx) {
  return (unsigned long long)key << 32 | (0xffffffffu - (unsigned)idx);
}

__device__ __forceinline__ int first_max_index(unsigned long long k) {
  return (int)(0xffffffffu - (unsigned)k);
}

__global__ void __launch_bounds__(1024)
    hyp_kernel(const float* __restrict__ segs,
               const unsigned char* __restrict__ valid_in,
               float* __restrict__ corners_out,
               unsigned char* __restrict__ ok_out, int k, int max_vertices,
               float short_ratio2) {
  __shared__ float e0x[kMaxK], e0y[kMaxK], e1x[kMaxK], e1y[kMaxK];
  __shared__ float sq[kMaxK], sqm[kMaxK], dex[kMaxK], dey[kMaxK];
  __shared__ int order[kMaxK];          // kept segments by (-sq, index)
  __shared__ float cpx[kMaxP], cpy[kMaxP];  // kept endpoints, index order
  __shared__ float4 rel[kMaxP];         // x, y, distance or -1 (no candidate)
  __shared__ int left[kMaxP];           // some point lies to the left
  __shared__ float hx[kMaxH], hy[kMaxH];
  __shared__ unsigned long long okmask[kMaxH];
  __shared__ int picks[kMaxH];
  __shared__ float plen[kMaxH];
  __shared__ int top[4];
  __shared__ unsigned s_kept[2];
  __shared__ int s_longest;               // float bits
  __shared__ unsigned long long s_best;   // first_max_key of a maximum

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const float* gs = segs + (size_t)g * k * 4;

  // ---- segments, squared lengths, removeShortLS (oclrect.c:926-943) ----
  float my_sq = 0.0f;
  int v = 0;
  if (t < k) {
    e0x[t] = gs[4 * t];
    e0y[t] = gs[4 * t + 1];
    e1x[t] = gs[4 * t + 2];
    e1y[t] = gs[4 * t + 3];
    const float dx = e1x[t] - e0x[t], dy = e1y[t] - e0y[t];
    my_sq = dx * dx + dy * dy;
    sq[t] = my_sq;
    v = valid_in[(size_t)g * k + t] != 0 && my_sq > 0.0f;
    sqm[t] = v ? my_sq : -1.0f;
  }
  if (t < 4) top[t] = 0;
  if (t < 2) s_kept[t] = 0;
  if (t == 0) {
    s_longest = __float_as_int(-1.0f);
    s_best = 0;
  }
  const int nvalid = __syncthreads_count(v);
  // the largest sqm: valid squared lengths are > 0 (not NaN), whose bits
  // order as ints, the rest -1
  if (v) atomicMax(&s_longest, __float_as_int(my_sq));
  __syncthreads();
  int keep = 0;
  if (t < k) {
    const float s = sqm[t];
    if (nvalid <= 4) {
      keep = v;
    } else if (v) {
      keep = s > short_ratio2 * __int_as_float(s_longest);
      if (!keep) {
        // rank of t in the stable argsort of -sqm
        int rank = 0;
        for (int j = 0; j < k; ++j)
          rank += sqm[j] > s || (sqm[j] == s && j < t);
        keep = rank < 4;
      }
    }
  }
  if (keep) atomicOr(&s_kept[t >> 5], 1u << (t & 31));
  __syncthreads();
  const unsigned long long kept =
      s_kept[0] | ((unsigned long long)s_kept[1] << 32);
  const int nk = __popcll(kept);
  const int p = 2 * nk;
  if (keep) {
    const int c = __popcll(kept & ((1ull << t) - 1));
    cpx[2 * c] = e0x[t];
    cpy[2 * c] = e0y[t];
    cpx[2 * c + 1] = e1x[t];
    cpy[2 * c + 1] = e1y[t];
    // rank among the kept segments by (-sq, index): the first maximum of
    // sq over any subset of them is the one of lowest rank
    int r = 0;
    for (int j = 0; j < k; ++j)
      r += (kept >> j & 1) && (sq[j] > my_sq || (sq[j] == my_sq && j < t));
    order[r] = t;
  }
  if (t < k) {
    const float den = max_eps(sqrtf(my_sq));
    dex[t] = (e0x[t] - e1x[t]) / den;
    dey[t] = (e0y[t] - e1y[t]) / den;
  }
  if (t < 2 * k) {
    // the start: the first maximum of x over the kept endpoints (-kBig
    // elsewhere), over all 2k endpoints in their original order
    const int s = t >> 1;
    const float x = (kept >> s & 1) ? ((t & 1) ? e1x[s] : e0x[s]) : -kBig;
    atomicMax(&s_best, first_max_key(order_key(x), t));
  }
  __syncthreads();

  // ---- gift-wrapping hull (oclrect.c:697-734) ---------------------------
  const int i = t / kLanes;  // this thread's candidate
  const int s0 = first_max_index(s_best);  // the start's endpoint
  float curx = (s0 & 1) ? e1x[s0 >> 1] : e0x[s0 >> 1];
  float cury = (s0 & 1) ? e1y[s0 >> 1] : e0y[s0 >> 1];
  // its compacted index, or -1 where it is not kept
  const int start = (kept >> (s0 >> 1) & 1)
                        ? 2 * __popcll(kept & ((1ull << (s0 >> 1)) - 1)) +
                              (s0 & 1)
                        : -1;
  if (t == 0) {
    hx[0] = curx;
    hy[0] = cury;
  }
  int nh = 1;
  for (int step = 1; step < max_vertices; ++step) {
    if (t < p) {
      const float rx = cpx[t] - curx, ry = cpy[t] - cury;
      const float d = rx * rx + ry * ry;
      rel[t] = make_float4(rx, ry, d > 1e-12f ? d : -1.0f, 0.0f);
      left[t] = 0;
    }
    __syncthreads();
    // every thread has read the start or the last step's s_best
    if (t == 0) s_best = 0;
    if (i < p) {
      const float4 a = rel[i];
      if (a.z > 0.0f) {
        const float perp = 0.1f * sqrtf(max_eps(a.z));
        for (int j = t % kLanes; j < p; j += kLanes) {
          const float4 b = rel[j];
          if (!(b.z > 0.0f)) continue;
          const float cross = a.x * b.y - a.y * b.x;
          // the threshold is perp, above it or NaN
          if (!(cross > perp)) continue;
          const float norm = sqrtf(max_eps(a.z * b.z));
          const float an = 1e-5f * norm;
          const float thr = (an != an || an > perp) ? an : perp;
          if (cross > thr) {
            left[i] = 1;
            break;
          }
        }
      }
    }
    __syncthreads();
    // a good candidate's distance is > 1e-12: its bits are a positive key
    if (t < p && rel[t].z > 0.0f && !left[t])
      atomicMax(&s_best, first_max_key(__float_as_uint(rel[t].z), t));
    __syncthreads();
    const unsigned long long best = s_best;
    const int next = best ? first_max_index(best) : -1;
    if (next < 0 || next == start) break;
    curx = cpx[next];
    cury = cpy[next];
    if (t == 0) {
      hx[nh] = curx;
      hy[nh] = cury;
    }
    ++nh;
  }

  // ---- a pick per hull edge (pickExternalLS, oclrect.c:945-992) --------
  if (t < nh) okmask[t] = 0;
  __syncthreads();
  for (int u = t; u < nh * nk; u += blockDim.x) {
    const int e = u / nk, c = u - e * nk;  // hull edge, segment rank
    const int s = order[c];
    const int n = e + 1 < nh ? e + 1 : 0;
    const float q0x = hx[e], q0y = hy[e], q1x = hx[n], q1y = hy[n];
    const float dx = e1x[s] - e0x[s], dy = e1y[s] - e0y[s];
    const float l2 = sq[s];
    const float mx = (q0x + q1x) * 0.5f, my = (q0y + q1y) * 0.5f;
    float tt = ((mx - e0x[s]) * dx + (my - e0y[s]) * dy) / max_eps(l2);
    tt = l2 > 0.0f ? tt : 0.0f;
    tt = fminf(fmaxf(tt, 0.0f), 1.0f);
    const float dmx = mx - (e0x[s] + tt * dx);
    const float dmy = my - (e0y[s] + tt * dy);
    const float dm = dmx * dmx + dmy * dmy;
    const bool close = dm < 1.0f;
    const float qdx = q0x - q1x, qdy = q0y - q1y;
    const float qsq = qdx * qdx + qdy * qdy;
    const float qn = max_eps(sqrtf(qsq));
    const bool para =
        fabsf((qdx / qn) * dex[s] + (qdy / qn) * dey[s]) > 0.95f &&
        dm / max_eps(qsq) < 0.01f;
    if (close || para) atomicOr(&okmask[e], 1ull << c);
  }
  __syncthreads();
  if (t == 0) {
    // each edge takes the longest segment not picked yet: its lowest rank
    unsigned long long used = 0;
    for (int e = 0; e < max_vertices; ++e) {
      const unsigned long long m = e < nh ? okmask[e] & ~used : 0ull;
      if (m) {
        const int c = __ffsll(m) - 1;
        used |= 1ull << c;
        picks[e] = order[c];
      } else {
        picks[e] = -1;
      }
    }
  }
  __syncthreads();

  // ---- pickLongestLS(4) (oclrect.c:994-1009) ---------------------------
  bool pv = false;
  if (t < max_vertices) {
    const int pk = picks[t];
    pv = pk >= 0;
    const float psq = sq[pv ? pk : 0];
    plen[t] = pv ? sqrtf(psq) : 0.0f;
    // rank in the stable argsort of -(pv ? psq : -1)
    const float si = pv ? psq : -1.0f;
    int rank = 0;
    for (int j = 0; j < max_vertices; ++j) {
      const int pj = picks[j];
      const float sj = pj >= 0 ? sq[pj] : -1.0f;
      rank += sj > si || (sj == si && j < t);
    }
    if (rank < 4) top[rank] = pv ? pk : 0;
  }
  const int n_picked = __syncthreads_count(pv);
  if (t != 0) return;
  float len0 = plen[0];
  for (int e = 1; e < max_vertices; ++e) len0 = len0 + plen[e];
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

// threads of one group's block with kLanes threads per hull candidate;
// at least 64, for the k segments and the max_vertices picks
int block_threads(int k) {
  const int t = (2 * k * kLanes + 31) / 32 * 32;
  return t < 64 ? 64 : t;
}

}  // namespace

// segs: (g, k, 2, 2) float32; valid: (g, k) bool; corners: (g, 4, 2)
// float32; ok: (g,) bool.  k <= 64, max_vertices <= 64.
extern "C" int rd_hyp(const void* segs, const void* valid, void* corners,
                      void* ok, int g, int k, int max_vertices,
                      float short_ratio2, void* stream) {
  if (k < 1 || k > kMaxK || max_vertices < 1 || max_vertices > kMaxH)
    return (int)cudaErrorInvalidValue;
  const int threads = block_threads(k);
  if (g == 0) return 0;
  hyp_kernel<<<g, threads, 0, (cudaStream_t)stream>>>(
      (const float*)segs, (const unsigned char*)valid, (float*)corners,
      (unsigned char*)ok, k, max_vertices, short_ratio2);
  rd::count_launch();
  return (int)cudaGetLastError();
}

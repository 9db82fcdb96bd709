// The pose kernel: 3D pose of each quad candidate (poseEstimation,
// oclrect.c:590-634), as geometry/pose.py:pose_estimate computes it:
// preconditioned nonlinear CG (oclrect.c:557-588) with a Newton line search
// (oclrect.c:514-536) on the planarity / rectangularity objective
// (oclrect.c:441-477), once per normalization mode, then the better mode,
// the sign flip and the 3D corners.
//
// The JAX package leaves this to XLA (rectdetect_tpu/geometry/pose.py,
// exact derivatives by jax.grad and nested jvp); no Pallas kernel replaces
// it.  Eagerly, the same steps in PyTorch are ~10^5 small launches per
// frame (2 modes x 12 CG iterations x 10 line-search steps, each a jet
// evaluation of ~200 operations).
//
// Bound: operations (a few hundred bytes per group, ~10^5 float operations
// per (group, mode)); what sets the time is one problem's chain of
// dependent operations, not the card's rate.  So each (group, mode) is
// spread over the lanes of one warp, and the chain of each lane is cut:
//
//  * the gradient and diagonal Hessian: lane i of a mode carries a jet
//    seeded with e_i alone.  In forward mode d[i] and dd[i] of every
//    operation depend only on the values and on the i-th entries, so lane
//    i's (v, d, dd) equals the (v, d[i], dd[i]) of the plain version's jet
//    with all four seeds bit for bit, in a third of the registers;
//  * the CG vector steps gather the lanes' entries by __shfl_sync and every
//    lane sums them in the plain version's order (pose.py:_dot4,
//    _inversedot), so all lanes of a mode hold the same x and direction and
//    take the same branches;
//  * the line search runs on every lane of the mode.  Its jet at a
//    candidate point gives the candidate's objective value (the jet's v is
//    the float evaluation, operation for operation) and, when the
//    candidate is taken, the next step's f' and f''; a rejected candidate
//    leaves x and so the jet as they were.  One jet per step, where the
//    plain version evaluates a jet and a value; the last step needs the
//    value only, and a step after `stop` changes nothing, so the search
//    ends there;
//  * each lane pair also splits the objective's two plane-distance terms
//    (the cross products, each with a jet division; the same code on other
//    corners): each lane evaluates the shared terms and one of the two, the
//    pair exchanges them by shuffle, and both add them in the plain order.
//    The other terms differ in their code, and lanes that ran them apart
//    would run one after the other;
//  * the objective has one out-of-line copy as a jet and one as a value
//    (jet_at, value_at): inlined at each call, the CG loop's code outgrew
//    the instruction cache.
//
// A group takes 2 modes x 4 seeds x 2 halves = 16 lanes, two groups a
// warp; the two modes compare their results by shuffles.  Every operation
// is the plain version's (pose.py, class Jet), term for term, rounded once
// (built with --fmad=false; division and sqrtf correctly rounded), so the
// two agree bit for bit.

#include <math.h>

#include "common.cuh"

namespace {

constexpr float kEps = 1e-20f;
constexpr int kResetK = 10;  // CG_RESET_K, oclrect.c:576

__device__ __forceinline__ float max_eps(float a) {
  return (a != a || a > kEps) ? a : kEps;
}

// a value with its first and second derivatives along one seed direction
// (pose.py, class Jet, with N = 1)
struct Jet {
  float v, d, dd;
};

__device__ __forceinline__ Jet operator+(const Jet& a, const Jet& b) {
  return {a.v + b.v, a.d + b.d, a.dd + b.dd};
}

__device__ __forceinline__ Jet operator-(const Jet& a, const Jet& b) {
  return {a.v - b.v, a.d - b.d, a.dd - b.dd};
}

__device__ __forceinline__ Jet operator-(const Jet& a, float c) {
  return {a.v - c, a.d, a.dd};
}

__device__ __forceinline__ Jet operator*(const Jet& a, const Jet& b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d,
          (a.dd * b.v + (a.d * 2.0f) * b.d) + a.v * b.dd};
}

__device__ __forceinline__ Jet operator*(const Jet& a, float c) {
  return {a.v * c, a.d * c, a.dd * c};
}

__device__ __forceinline__ Jet operator/(const Jet& a, const Jet& b) {
  const float v = a.v / b.v;
  const float d = (a.d - v * b.d) / b.v;
  return {v, d, ((a.dd - (d * 2.0f) * b.d) - v * b.dd) / b.v};
}

// a constant over a jet
__device__ __forceinline__ Jet recip(float a, const Jet& b) {
  const float v = a / b.v;
  const float d = -(v * b.d) / b.v;
  return {v, d, (-((d * 2.0f) * b.d) - v * b.dd) / b.v};
}

// jnp.maximum(a, 1e-20): the derivatives pass where a > 1e-20
__device__ __forceinline__ Jet max_eps(const Jet& a) {
  const bool m = a.v > kEps;
  return {max_eps(a.v), m ? a.d : 0.0f, m ? a.dd : 0.0f};
}

__device__ __forceinline__ float recip(float a, float b) { return a / b; }

template <class T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

template <class T>
__device__ __forceinline__ T sq(const T& x) {
  return x * x;
}

__device__ __forceinline__ float norm4(const float v[4]) {
  return sqrtf(((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]) + v[3] * v[3]);
}

__device__ __forceinline__ float shfl_xor(unsigned mask, float a, int m) {
  return __shfl_xor_sync(mask, a, m);
}

__device__ __forceinline__ Jet shfl_xor(unsigned mask, const Jet& a,
                                           int m) {
  Jet r;
  r.v = __shfl_xor_sync(mask, a.v, m);
  r.d = __shfl_xor_sync(mask, a.d, m);
  r.dd = __shfl_xor_sync(mask, a.dd, m);
  return r;
}

template <class T>
__device__ __forceinline__ T pick(bool c, const T& a, const T& b) {
  return c ? a : b;
}

// comp * ((n . qt) - (n . qo))^2 / max(n . n, eps), n = (qa - qo) x (qb - qo):
// one of the objective's two plane-distance terms
template <class T>
__device__ __forceinline__ T plane_term(const T* qo, const T* qa, const T* qb,
                                        const T* qt, const T& comp) {
  T a[3], b[3], n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = qa[k] - qo[k];
    b[k] = qb[k] - qo[k];
  }
  n[0] = a[1] * b[2] - a[2] * b[1];
  n[1] = a[2] * b[0] - a[0] * b[2];
  n[2] = a[0] * b[1] - a[1] * b[0];
  return comp * sq(dot3(n, qt) - dot3(n, qo)) / max_eps(dot3(n, n));
}

// corner i's unit ray, component k, in shared memory (component-major, one
// column per lane) and read where it is used, so that the 12 values hold no
// registers through the CG loop
struct Rays {
  const volatile float* col;  // this lane's column
  __device__ __forceinline__ float operator()(int i, int k) const {
    return col[(3 * i + k) * 32];
  }
};

// the objective (value, oclrect.c:441-477) for T = float or Jet;
// p(i, k): corner i's unit ray; mode1: the normalization mode.  This lane
// computes the plane term of `half` and takes the other from lane ^ 1 of
// `mask`.
template <class T>
__device__ T quad_value(const T x[4], Rays p, bool mode1, int half,
                        unsigned mask) {
  T q[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) q[i][k] = x[i] * p(i, k);
  auto dsq = [&](int i, int j) {
    T d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = q[i][k] - q[j][k];
    return dot3(d, d);
  };
  const T l01 = dsq(0, 1), l12 = dsq(1, 2), l23 = dsq(2, 3), l03 = dsq(0, 3);
  const T l02 = dsq(0, 2), l13 = dsq(1, 3);
  // the mode's corners by value: a pointer picked at run time would put q
  // in local memory
  T qa[3], qb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    qa[k] = pick(mode1, q[0][k], q[2][k]);
    qb[k] = pick(mode1, q[2][k], q[0][k]);
  }

  T score = sq(pick(mode1, l23, l03) - 1.0f);
  score = score + sq(pick(mode1, l01, l12) - 1.0f);
  const T comp = recip(1.0f, pick(mode1, l12, l01));
  T ab[3], cd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ab[k] = (qa[k] - q[1][k]) + (qb[k] - q[3][k]);
    cd[k] = (q[1][k] - qb[k]) + (q[3][k] - qa[k]);
  }
  score = score + dot3(ab, ab);
  score = score + comp * dot3(cd, cd);
  score = score + sq(l01 + l12 - l02);
  score = score + sq(l03 + l23 - l02);
  score = score + sq(l01 + l03 - l13);
  score = score + sq(l12 + l23 - l13);
  // the plane through corners 0, 1, 3 against corner 2, and through 1, 0, 2
  // against corner 3
  const bool h1 = half != 0;
  T qo[3], qi[3], qj[3], qt[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    qo[k] = pick(h1, q[1][k], q[0][k]);
    qi[k] = pick(h1, q[0][k], q[1][k]);
    qj[k] = pick(h1, q[2][k], q[3][k]);
    qt[k] = pick(h1, q[3][k], q[2][k]);
  }
  const T mine = plane_term(qo, qi, qj, qt, comp);
  const T other = shfl_xor(mask, mine, 1);
  score = score + (h1 ? other : mine);
  return score + (h1 ? mine : other);
}

// The objective as a jet seeded with s at y, and as a value, each one copy
// in the kernel's code; the arguments are scalars so that they pass in
// registers, not through local memory.
__device__ __noinline__ Jet jet_at(float y0, float y1, float y2, float y3,
                                      float s0, float s1, float s2, float s3,
                                      Rays p, bool mode1, int half,
                                      unsigned mask) {
  const float y[4] = {y0, y1, y2, y3}, sd[4] = {s0, s1, s2, s3};
  Jet yj[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yj[i].v = y[i];
    yj[i].d = sd[i];
    yj[i].dd = 0.0f;
  }
  return quad_value(yj, p, mode1, half, mask);
}

__device__ __noinline__ float value_at(float y0, float y1, float y2, float y3,
                                       Rays p, bool mode1, int half,
                                       unsigned mask) {
  const float y[4] = {y0, y1, y2, y3};
  return quad_value(y, p, mode1, half, mask);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// lanes of a mode (4 seeds x 2 halves), of a group (2 modes), groups a warp
constexpr int kPerMode = 8, kPerGroup = 2 * kPerMode;
constexpr int kGroupsPerWarp = 32 / kPerGroup;

__global__ void __launch_bounds__(32)
    pose_kernel(const float* __restrict__ corners, int g, float half_w,
                float half_h, float focal, int cg_iters, int ls_iters,
                float* __restrict__ c2, float* __restrict__ c3,
                float* __restrict__ value) {
  const int lane = threadIdx.x;
  const int grp = blockIdx.x * kGroupsPerWarp + lane / kPerGroup;
  const bool live = grp < g;
  const int gi = live ? grp : g - 1;  // idle lanes mirror the last group
  const int mi = (lane / kPerMode) & 1;
  const bool mode1 = mi == 0;
  const int seed = (lane % kPerMode) / 2;
  const int half = lane % 2;
  const int mode_lane0 = lane / kPerMode * kPerMode;
  const unsigned mode_mask = ((1u << kPerMode) - 1) << mode_lane0;
  const unsigned group_mask = ((1u << kPerGroup) - 1)
                              << (lane / kPerGroup * kPerGroup);

  __shared__ float s_rays[12][32], s_c2[8][32];
  const Rays rays{&s_rays[0][lane]};
  float p[4][3];
  float e0x[4], e0y[4];
  {
    const float* c = corners + (size_t)gi * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e0x[i] = c[2 * i];
      e0y[i] = c[2 * i + 1];
    }
    // the top-left edge: outward normal with the most negative y
    // (oclrect.c:597-601)
    const float gx = (((e0x[0] + e0x[1]) + e0x[2]) + e0x[3]) / 4.0f;
    const float gy = (((e0y[0] + e0y[1]) + e0y[2]) + e0y[3]) / 4.0f;
    int tl = 0;
    float best = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = (i + 1) & 3;
      float vx = e0x[n] - e0x[i], vy = e0y[n] - e0y[i];
      const float nrm = max_eps(sqrtf(vx * vx + vy * vy));
      vx = vx / nrm;
      vy = vy / nrm;
      const float vpx = -vy, vpy = vx;
      const bool sign = (e0x[i] - gx) * vpx + (e0y[i] - gy) * vpy < 0.0f;
      const float y = sign ? -vpy : vpy;
      // argmin, the first minimum; NaN counts as the minimum
      if (i == 0 || (y != y && best == best) || y < best) {
        best = y;
        tl = i;
      }
    }
    // rotated by selects: an index known only at run time would put the
    // arrays in local memory
    float rx[4], ry[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = (i + tl) & 3;
      rx[i] = j == 0 ? e0x[0] : j == 1 ? e0x[1] : j == 2 ? e0x[2] : e0x[3];
      ry[i] = j == 0 ? e0y[0] : j == 1 ? e0y[1] : j == 2 ? e0y[2] : e0y[3];
    }
    // rays through the corners: x right, y up, z = focal
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = rx[i] - half_w, b = -(ry[i] - half_h);
      const float nrm = max_eps(sqrtf((a * a + b * b) + focal * focal));
      p[i][0] = a / nrm;
      p[i][1] = b / nrm;
      p[i][2] = focal / nrm;
      e0x[i] = rx[i];
      e0y[i] = ry[i];
    }
  }
  auto inv_dist = [&](int i, int j) {
    const float a = p[i][0] - p[j][0], b = p[i][1] - p[j][1],
                c = p[i][2] - p[j][2];
    return 1.0f / max_eps(sqrtf((a * a + b * b) + c * c));
  };
  float x[4];
  if (mode1) {
    const float d01 = inv_dist(0, 1), d23 = inv_dist(2, 3);
    x[0] = d01;
    x[1] = d01;
    x[2] = d23;
    x[3] = d23;
  } else {
    const float d12 = inv_dist(1, 2), d03 = inv_dist(0, 3);
    x[0] = d03;
    x[1] = d12;
    x[2] = d12;
    x[3] = d03;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s_rays[3 * i + k][lane] = p[i][k];
    s_c2[2 * i][lane] = e0x[i];
    s_c2[2 * i + 1][lane] = e0y[i];
  }

  // entry j of a 4-vector held one entry per seed lane, on every lane
  auto gather = [&](float v, int j) {
    return __shfl_sync(mode_mask, v, mode_lane0 + j * 2);
  };
  // the jet of the objective at y, seeded with the direction s
  auto jet = [&](const float y[4], const float s[4]) {
    return jet_at(y[0], y[1], y[2], y[3], s[0], s[1], s[2], s[3], rays, mode1,
                  half, mode_mask);
  };
  // this lane's entry of the gradient and the diagonal Hessian at x, and
  // the objective there
  float g_own, m_own, fval;
  auto grad = [&]() {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = i == seed ? 1.0f : 0.0f;
    const Jet f = jet(x, e);
    g_own = f.d;
    m_own = f.dd;
    fval = f.v;
  };
  auto dot4 = [&](float a, float b) {
    const float ab = a * b;
    return ((gather(ab, 0) + gather(ab, 1)) + gather(ab, 2)) + gather(ab, 3);
  };

  // preconditioned nonlinear CG (cgexecute, oclrect.c:557-588); this lane
  // holds entry `seed` of r, s and the direction
  grad();
  float r = -g_own;
  bool pos = __all_sync(mode_mask, m_own > 0.0f);
  float s = pos ? r / m_own : r;
  float dir = s;
  float deltanew = dot4(r, s);
  int k = 0;
  for (int it = 0; it < cg_iters; ++it) {
    // Newton line search along dir (lineSearch, oclrect.c:514-536)
    if (ls_iters > 0) {
      float dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = gather(dir, i);
      const float nrm = max_eps(norm4(dv));
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = dv[i] / nrm;
      Jet cur = jet(x, dv);
      float scale = 1.0f;
      for (int ls = 0; ls < ls_iters; ++ls) {
        float g2 = cur.dd;
        g2 = g2 * g2 < 1e-10f ? 1.0f : g2;
        const float delta = fabsf(cur.d / g2);
        if (delta < 1e-10f) break;  // stop: x does not change any more
        const float step = delta * scale;
        float cand[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cand[i] = x[i] + dv[i] * step;
        if (ls == ls_iters - 1) {
          if (!(value_at(cand[0], cand[1], cand[2], cand[3], rays, mode1,
                         half, mode_mask) > cur.v)) {
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = cand[i];
          }
          break;
        }
        const Jet nxt = jet(cand, dv);
        if (nxt.v > cur.v) {
          scale = scale * 0.5f;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = cand[i];
          cur = nxt;
        }
      }
    }
    grad();
    r = -g_own;
    const float deltaold = deltanew;
    const float deltamid = dot4(r, s);
    pos = __all_sync(mode_mask, m_own > 0.0f);
    s = pos ? r / m_own : r;
    deltanew = dot4(r, s);
    const float beta =
        (deltanew - deltamid) / (deltaold == 0.0f ? 1.0f : deltaold);
    const bool reset = k == kResetK || beta <= 0.0f || deltaold == 0.0f;
    dir = reset ? s : s + dir * beta;
    k = (reset ? 0 : k) + 1;
  }

  // the better mode, the sign flip, the 3D corners; fval is the objective
  // at the final x (the last gradient jet's value)
  const float vo = __shfl_xor_sync(group_mask, fval, kPerMode);
  float xo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    xo[i] = __shfl_xor_sync(group_mask, x[i], kPerMode);
  if (!live || lane % kPerGroup != 0) return;
  // this lane runs mode 1
  const float v0 = fval, v1 = vo;
  const bool w0 = v0 < v1;
  float* o2 = c2 + (size_t)grp * 8;
  float* o3 = c3 + (size_t)grp * 12;
  const bool neg = (w0 ? x[0] : xo[0]) < 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float xw = w0 ? x[i] : xo[i];
    const float xi = neg ? -xw : xw;
    o2[2 * i] = s_c2[2 * i][lane];
    o2[2 * i + 1] = s_c2[2 * i + 1][lane];
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) o3[3 * i + kk] = rays(i, kk) * xi;
  }
  value[grp] = nan_min(v0, v1);
}

}  // namespace

// corners: (g, 4, 2) float32 -> c2 (g, 4, 2), c3 (g, 4, 3), value (g,)
// float32
extern "C" int rd_pose(const void* corners, void* c2, void* c3, void* value,
                       int g, float half_w, float half_h, float focal,
                       int cg_iters, int ls_iters, void* stream) {
  if (g == 0) return 0;
  const int blocks = (g + kGroupsPerWarp - 1) / kGroupsPerWarp;
  pose_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(
      (const float*)corners, g, half_w, half_h, focal, cg_iters, ls_iters,
      (float*)c2, (float*)c3, (float*)value);
  rd::count_launch();
  return (int)cudaGetLastError();
}

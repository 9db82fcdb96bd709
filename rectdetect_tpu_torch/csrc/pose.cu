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
// evaluation of ~200 operations); here each (group, mode) is one thread
// with its problem in registers.
//
// Bound: operations (a few hundred bytes per group, ~10^5 float operations
// per thread); the threads are independent, so the kernel is one launch of
// 2G threads, 32 groups x 2 modes per block, the modes exchanging their
// result through shared memory.
//
// Derivatives are forward mode: Jet<N> carries a value and its first and
// second derivatives along N seed directions.  The line search seeds the
// unit direction (N = 1); the gradient and the diagonal Hessian seed
// e_0..e_3 (N = 4).  Every operation is the plain version's (pose.py, class
// Jet), term for term, rounded once (built with --fmad=false; division and
// sqrtf correctly rounded), so the two agree bit for bit.

#include <math.h>

#include "common.cuh"

namespace {

constexpr float kEps = 1e-20f;
constexpr int kGroupsPerBlock = 32;
constexpr int kResetK = 10;  // CG_RESET_K, oclrect.c:576

__device__ __forceinline__ float max_eps(float a) {
  return (a != a || a > kEps) ? a : kEps;
}

template <int N>
struct Jet {
  float v, d[N], dd[N];
};

template <int N>
__device__ __forceinline__ Jet<N> operator+(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.d[i] = a.d[i] + b.d[i];
    r.dd[i] = a.dd[i] + b.dd[i];
  }
  return r;
}

template <int N>
__device__ __forceinline__ Jet<N> operator-(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.d[i] = a.d[i] - b.d[i];
    r.dd[i] = a.dd[i] - b.dd[i];
  }
  return r;
}

template <int N>
__device__ __forceinline__ Jet<N> operator-(const Jet<N>& a, float c) {
  Jet<N> r = a;
  r.v = a.v - c;
  return r;
}

template <int N>
__device__ __forceinline__ Jet<N> operator*(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.d[i] = a.d[i] * b.v + a.v * b.d[i];
    r.dd[i] = (a.dd[i] * b.v + (a.d[i] * 2.0f) * b.d[i]) + a.v * b.dd[i];
  }
  return r;
}

template <int N>
__device__ __forceinline__ Jet<N> operator*(const Jet<N>& a, float c) {
  Jet<N> r;
  r.v = a.v * c;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.d[i] = a.d[i] * c;
    r.dd[i] = a.dd[i] * c;
  }
  return r;
}

template <int N>
__device__ __forceinline__ Jet<N> operator/(const Jet<N>& a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
    r.dd[i] = ((a.dd[i] - (r.d[i] * 2.0f) * b.d[i]) - r.v * b.dd[i]) / b.v;
  }
  return r;
}

// a constant over a jet
template <int N>
__device__ __forceinline__ Jet<N> recip(float a, const Jet<N>& b) {
  Jet<N> r;
  r.v = a / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.d[i] = -(r.v * b.d[i]) / b.v;
    r.dd[i] = (-((r.d[i] * 2.0f) * b.d[i]) - r.v * b.dd[i]) / b.v;
  }
  return r;
}

// jnp.maximum(a, 1e-20): the derivatives pass where a > 1e-20
template <int N>
__device__ __forceinline__ Jet<N> max_eps(const Jet<N>& a) {
  Jet<N> r;
  const bool m = a.v > kEps;
  r.v = max_eps(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.d[i] = m ? a.d[i] : 0.0f;
    r.dd[i] = m ? a.dd[i] : 0.0f;
  }
  return r;
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

// the objective (value, oclrect.c:441-477) for T = float or a Jet;
// p[i][k]: corner i's unit ray; mode1: the normalization mode
template <class T>
__device__ T quad_value(const T x[4], const float p[4][3], bool mode1) {
  T q[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) q[i][k] = x[i] * p[i][k];
  auto dsq = [&](int i, int j) {
    T d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = q[i][k] - q[j][k];
    return dot3(d, d);
  };
  const T l01 = dsq(0, 1), l12 = dsq(1, 2), l23 = dsq(2, 3), l03 = dsq(0, 3);
  const T l02 = dsq(0, 2), l13 = dsq(1, 3);
  const T* qa = mode1 ? q[0] : q[2];
  const T* qb = mode1 ? q[2] : q[0];

  T score = sq((mode1 ? l23 : l03) - 1.0f);
  score = score + sq((mode1 ? l01 : l12) - 1.0f);
  const T comp = recip(1.0f, mode1 ? l12 : l01);
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
  {
    T a[3], b[3], n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[k] = q[1][k] - q[0][k];
      b[k] = q[3][k] - q[0][k];
    }
    n[0] = a[1] * b[2] - a[2] * b[1];
    n[1] = a[2] * b[0] - a[0] * b[2];
    n[2] = a[0] * b[1] - a[1] * b[0];
    score = score + comp * sq(dot3(n, q[2]) - dot3(n, q[0])) /
                        max_eps(dot3(n, n));
  }
  {
    T a[3], b[3], n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[k] = q[0][k] - q[1][k];
      b[k] = q[2][k] - q[1][k];
    }
    n[0] = a[1] * b[2] - a[2] * b[1];
    n[1] = a[2] * b[0] - a[0] * b[2];
    n[2] = a[0] * b[1] - a[1] * b[0];
    score = score + comp * sq(dot3(n, q[3]) - dot3(n, q[1])) /
                        max_eps(dot3(n, n));
  }
  return score;
}

__device__ __forceinline__ float norm4(const float v[4]) {
  return sqrtf(((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]) + v[3] * v[3]);
}

__device__ __forceinline__ float dot4(const float a[4], const float b[4]) {
  return ((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3];
}

// Newton line search along dir (lineSearch, oclrect.c:514-536)
__device__ void line_search(float x[4], const float dir[4], int n_iter,
                            const float p[4][3], bool mode1) {
  const float nrm = max_eps(norm4(dir));
  float d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = dir[i] / nrm;
  float scale = 1.0f;
  bool stop = false;
  for (int it = 0; it < n_iter; ++it) {
    Jet<1> xj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xj[i].v = x[i];
      xj[i].d[0] = d[i];
      xj[i].dd[0] = 0.0f;
    }
    const Jet<1> f = quad_value(xj, p, mode1);
    const float val = f.v, g1 = f.d[0];
    float g2 = f.dd[0];
    g2 = g2 * g2 < 1e-10f ? 1.0f : g2;
    const float delta = fabsf(g1 / g2);
    stop = stop || delta < 1e-10f;
    float cand[4];
    const float step = delta * scale;
#pragma unroll
    for (int i = 0; i < 4; ++i) cand[i] = x[i] + d[i] * step;
    const bool worse = quad_value(cand, p, mode1) > val;
    if (!(stop || worse)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = cand[i];
    }
    if (worse) scale = scale * 0.5f;
  }
}

__device__ void grad_and_diag_hess(const float x[4], const float p[4][3],
                                   bool mode1, float g[4], float m[4]) {
  Jet<4> xj[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xj[i].v = x[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xj[i].d[j] = i == j ? 1.0f : 0.0f;
      xj[i].dd[j] = 0.0f;
    }
  }
  const Jet<4> f = quad_value(xj, p, mode1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[i] = f.d[i];
    m[i] = f.dd[i];
  }
}

// r / m where the diagonal Hessian is all-positive, else r
// (inversedot, oclrect.c:538-555)
__device__ __forceinline__ void inversedot(const float m[4], const float r[4],
                                           float s[4]) {
  const bool pos = m[0] > 0.0f && m[1] > 0.0f && m[2] > 0.0f && m[3] > 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = pos ? r[i] / m[i] : r[i];
}

__device__ void cg_minimize(float x[4], int n_iter, int ls_iter,
                            const float p[4][3], bool mode1) {
  float g[4], m[4], r[4], s[4], d[4];
  grad_and_diag_hess(x, p, mode1, g, m);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = -g[i];
  inversedot(m, r, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = s[i];
  float deltanew = dot4(r, s);
  int k = 0;
  for (int it = 0; it < n_iter; ++it) {
    line_search(x, d, ls_iter, p, mode1);
    grad_and_diag_hess(x, p, mode1, g, m);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = -g[i];
    const float deltaold = deltanew;
    const float deltamid = dot4(r, s);
    inversedot(m, r, s);
    deltanew = dot4(r, s);
    const float beta =
        (deltanew - deltamid) / (deltaold == 0.0f ? 1.0f : deltaold);
    const bool reset = k == kResetK || beta <= 0.0f || deltaold == 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = reset ? s[i] : s[i] + d[i] * beta;
    k = (reset ? 0 : k) + 1;
  }
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__global__ void pose_kernel(const float* __restrict__ corners, int g,
                            float half_w, float half_h, float focal,
                            int cg_iters, int ls_iters, float* __restrict__ c2,
                            float* __restrict__ c3, float* __restrict__ value) {
  __shared__ float s_val[2][kGroupsPerBlock];
  __shared__ float s_x[2][kGroupsPerBlock][4];
  const int lg = threadIdx.x, mi = threadIdx.y;
  const int grp = blockIdx.x * kGroupsPerBlock + lg;
  const bool live = grp < g;
  const bool mode1 = mi == 0;

  float p[4][3];
  float e0x[4], e0y[4];
  if (live) {
    const float* c = corners + (size_t)grp * 8;
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
    float rx[4], ry[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rx[i] = e0x[(i + tl) & 3];
      ry[i] = e0y[(i + tl) & 3];
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
    cg_minimize(x, cg_iters, ls_iters, p, mode1);
    s_val[mi][lg] = quad_value(x, p, mode1);
#pragma unroll
    for (int i = 0; i < 4; ++i) s_x[mi][lg][i] = x[i];
  }
  __syncthreads();
  if (!live || !mode1) return;

  // the better mode, the sign flip, the 3D corners
  const float v0 = s_val[0][lg], v1 = s_val[1][lg];
  const int w = v0 < v1 ? 0 : 1;
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = s_x[w][lg][i];
  const bool neg = x[0] < 0.0f;
  float* o2 = c2 + (size_t)grp * 8;
  float* o3 = c3 + (size_t)grp * 12;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float xi = neg ? -x[i] : x[i];
    o2[2 * i] = e0x[i];
    o2[2 * i + 1] = e0y[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) o3[3 * i + k] = p[i][k] * xi;
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
  const dim3 block(kGroupsPerBlock, 2);
  const int blocks = (g + kGroupsPerBlock - 1) / kGroupsPerBlock;
  pose_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
      (const float*)corners, g, half_w, half_h, focal, cg_iters, ls_iters,
      (float*)c2, (float*)c3, (float*)value);
  return (int)cudaGetLastError();
}

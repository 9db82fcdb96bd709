"""3D pose of the quad candidates (port of rectdetect_tpu/geometry/pose.py),
the plain version of the pose kernel (ops/hopper_pose.py, csrc/pose.cu).

Given a quad's 4 image corners and the horizontal angle of view, find the
per-corner ray depths that make the 3D corners a planar rectangle, by
minimizing the objective `value` (oclrect.c:441-477) with preconditioned
nonlinear conjugate gradient (oclrect.c:557-588), a Newton line search
(oclrect.c:514-536) and a diagonal-Hessian preconditioner (inversedot,
oclrect.c:538-555), once for each of the two normalization modes
(oclrect.c:611-619).

The JAX package differentiates exactly with jax.grad and nested jvp.  The
port takes the same derivatives in forward mode, with a second-order jet
(`Jet`: a value, and the first and second derivatives along N seed
directions, carried through every operation of the objective):
  * the line search needs f, grad f . d and d^T H d along the unit
    direction d: one jet seeded with d;
  * the gradient and the diagonal Hessian need grad f . e_i and H_ii: one
    jet with the 4 seeds e_0..e_3.
Both modes run as one batch of 2G problems (the first G in mode 1, the
next G in mode 0).  Every operation is a float32 operation rounded once,
in the order the CUDA kernel runs it (square roots correctly rounded, no
fused multiply-adds), so the two agree; the JAX reference's reverse-mode
gradient rounds otherwise, and the difference grows over the CG
iterations (tests/test_torch_rect.py states the tolerance).
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import fp

INIT_SCALE = 1.0     # oclrect.c:429
CG_RESET_K = 10      # oclrect.c:576
_EPS = fp.f32(1e-20)


class Jet:
    """A value v (B,1) with its first (d) and second (dd) derivatives along
    N seed directions, (B,N) each.  The operations below are the CUDA
    kernel's (csrc/pose.cu, struct Jet), term for term."""
    __slots__ = ("v", "d", "dd")

    def __init__(self, v, d, dd):
        self.v, self.d, self.dd = v, d, dd

    def __add__(a, b):
        if isinstance(b, Jet):
            return Jet(a.v + b.v, a.d + b.d, a.dd + b.dd)
        return Jet(a.v + b, a.d, a.dd)

    def __sub__(a, b):
        if isinstance(b, Jet):
            return Jet(a.v - b.v, a.d - b.d, a.dd - b.dd)
        return Jet(a.v - b, a.d, a.dd)

    def __neg__(a):
        return Jet(-a.v, -a.d, -a.dd)

    def __mul__(a, b):
        if isinstance(b, Jet):
            return Jet(a.v * b.v, a.d * b.v + a.v * b.d,
                       (a.dd * b.v + (a.d * 2.0) * b.d) + a.v * b.dd)
        return Jet(a.v * b, a.d * b, a.dd * b)

    __rmul__ = __mul__

    def __truediv__(a, b):
        if isinstance(b, Jet):
            v = a.v / b.v
            d = (a.d - v * b.d) / b.v
            return Jet(v, d, ((a.dd - (d * 2.0) * b.d) - v * b.dd) / b.v)
        return Jet(a.v / b, a.d / b, a.dd / b)

    def __rtruediv__(b, a):
        # a constant over a jet
        v = a / b.v
        d = -(v * b.d) / b.v
        return Jet(v, d, (-((d * 2.0) * b.d) - v * b.dd) / b.v)


def _select(mask, a, b):
    if isinstance(a, Jet):
        return Jet(torch.where(mask, a.v, b.v), torch.where(mask, a.d, b.d),
                   torch.where(mask, a.dd, b.dd))
    return torch.where(mask, a, b)


def _max_eps(a):
    """jnp.maximum(a, 1e-20); the derivatives pass where a > 1e-20."""
    if isinstance(a, Jet):
        m = a.v > _EPS
        return Jet(torch.clamp_min(a.v, _EPS), torch.where(m, a.d, 0.0),
                   torch.where(m, a.dd, 0.0))
    return torch.clamp_min(a, _EPS)


def _sq(x):
    return x * x


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub3(a, b):
    return [a[k] - b[k] for k in range(3)]


def _add3(a, b):
    return [a[k] + b[k] for k in range(3)]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def quad_value(x, p, mode1):
    """The planarity / rectangularity objective (value, oclrect.c:441-477).

    x: 4 depths, each a (B,1) tensor or a Jet; p: p[i][k], the unit ray of
    corner i, (B,1) tensors; mode1: (B,1) bool, the normalization mode
    (True: mode 1).  Returns a (B,1) tensor or a Jet."""
    q = [[x[i] * p[i][k] for k in range(3)] for i in range(4)]

    def dsq(i, j):
        d = _sub3(q[i], q[j])
        return _dot3(d, d)

    l01, l12, l23, l03 = dsq(0, 1), dsq(1, 2), dsq(2, 3), dsq(0, 3)
    l02, l13 = dsq(0, 2), dsq(1, 3)
    qa = [_select(mode1, q[0][k], q[2][k]) for k in range(3)]
    qb = [_select(mode1, q[2][k], q[0][k]) for k in range(3)]

    score = _sq(_select(mode1, l23, l03) - 1.0)
    score = score + _sq(_select(mode1, l01, l12) - 1.0)
    comp = 1.0 / _select(mode1, l12, l01)
    ab = _add3(_sub3(qa, q[1]), _sub3(qb, q[3]))
    score = score + _dot3(ab, ab)
    cd = _add3(_sub3(q[1], qb), _sub3(q[3], qa))
    score = score + comp * _dot3(cd, cd)
    score = score + _sq(l01 + l12 - l02)
    score = score + _sq(l03 + l23 - l02)
    score = score + _sq(l01 + l03 - l13)
    score = score + _sq(l12 + l23 - l13)
    n013 = _cross(_sub3(q[1], q[0]), _sub3(q[3], q[0]))
    score = score + comp * _sq(_dot3(n013, q[2]) - _dot3(n013, q[0])) / \
        _max_eps(_dot3(n013, n013))
    n102 = _cross(_sub3(q[0], q[1]), _sub3(q[2], q[1]))
    score = score + comp * _sq(_dot3(n102, q[3]) - _dot3(n102, q[1])) / \
        _max_eps(_dot3(n102, n102))
    return score


def _value(x, p, mode1):
    return quad_value([x[:, i:i + 1] for i in range(4)], p, mode1)[:, 0]


def _jet(x, seeds, p, mode1):
    """quad_value as a jet: x (B,4), seeds (B,4,N), the seed directions of
    each depth."""
    z = torch.zeros_like(seeds[:, 0])
    xs = [Jet(x[:, i:i + 1], seeds[:, i], z) for i in range(4)]
    return quad_value(xs, p, mode1)


def _norm4(v):
    return fp.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
                   + v[:, 3] * v[:, 3])


def _dot4(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2] + \
        a[:, 3] * b[:, 3]


def _line_search(x, direction, n_iter, p, mode1):
    """Newton line search along `direction` (lineSearch,
    oclrect.c:514-536): f and its first and second derivatives along the
    unit direction from one jet."""
    d = direction / torch.clamp_min(_norm4(direction), _EPS)[:, None]
    scale = torch.full_like(x[:, 0], INIT_SCALE)
    stop = torch.zeros_like(x[:, 0], dtype=torch.bool)
    for _ in range(n_iter):
        j = _jet(x, d[:, :, None], p, mode1)
        val, g1, g2 = j.v[:, 0], j.d[:, 0], j.dd[:, 0]
        g2 = torch.where(g2 * g2 < fp.f32(1e-10), 1.0, g2)
        delta = torch.abs(g1 / g2)
        stop = stop | (delta < fp.f32(1e-10))
        cand = x + d * (delta * scale)[:, None]
        worse = _value(cand, p, mode1) > val
        x = torch.where((stop | worse)[:, None], x, cand)
        scale = torch.where(worse, scale * 0.5, scale)
    return x


def _grad_and_diag_hess(x, p, mode1):
    eye = torch.eye(4, dtype=x.dtype, device=x.device)
    j = _jet(x, eye.expand(x.shape[0], 4, 4), p, mode1)
    return j.d, j.dd


def _inversedot(m, r):
    """r / m where the diagonal Hessian is all-positive, else r
    (inversedot, oclrect.c:538-555)."""
    pos = m > 0
    return torch.where(pos.all(-1, keepdim=True),
                       r / torch.where(pos, m, 1.0), r)


def cg_minimize(x, n_iter: int, ls_iter: int, p, mode1):
    """Preconditioned nonlinear CG (cgexecute, oclrect.c:557-588) on a
    batch: x (B,4) start depths."""
    g, m = _grad_and_diag_hess(x, p, mode1)
    r = -g
    s = _inversedot(m, r)
    d = s
    deltanew = _dot4(r, s)
    k = torch.zeros_like(deltanew, dtype=torch.int32)
    for _ in range(n_iter):
        x = _line_search(x, d, ls_iter, p, mode1)
        g, m = _grad_and_diag_hess(x, p, mode1)
        r = -g
        deltaold = deltanew
        deltamid = _dot4(r, s)
        s = _inversedot(m, r)
        deltanew = _dot4(r, s)
        beta = (deltanew - deltamid) / torch.where(deltaold == 0, 1.0,
                                                   deltaold)
        reset = (k == CG_RESET_K) | (beta <= 0) | (deltaold == 0)
        d = torch.where(reset[:, None], s, s + d * beta[:, None])
        k = torch.where(reset, 0, k) + 1
    return x


def pose_setup(corners: torch.Tensor, iw: int, ih: int, tan_aov: float):
    """poseEstimation's set-up (oclrect.c:590-609) for a batch: corners
    (G,4,2) -> (c2 (G,4,2) rotated so the top-left corner comes first,
    p (G,4,3) unit rays, x0 (2G,4) start depths: mode 1, then mode 0)."""
    e0 = corners
    e1 = torch.roll(corners, -1, dims=1)
    c = corners.unbind(1)
    gv = (c[0] + c[1] + c[2] + c[3]) / 4.0       # orientation sign only
    # the top-left edge: outward normal with the most negative y
    v = e1 - e0
    v = v / torch.clamp_min(fp.sqrt(v[..., 0] * v[..., 0]
                                    + v[..., 1] * v[..., 1]), _EPS)[..., None]
    vpx, vpy = -v[..., 1], v[..., 0]
    rel = e0 - gv[:, None]
    sign = (rel[..., 0] * vpx + rel[..., 1] * vpy) < 0
    tl = torch.argmin(torch.where(sign, -vpy, vpy), dim=1, keepdim=True)
    order = (torch.arange(4, device=corners.device) + tl) & 3
    c2 = torch.gather(e0, 1, order[..., None].expand(-1, -1, 2))

    # rays through the corners: x right, y up, z = focal (oclrect.c:604-606)
    f32 = torch.float32
    focal = torch.tensor(iw / 2, dtype=f32) / torch.tensor(tan_aov, dtype=f32)
    px = c2[..., 0] - fp.f32(iw / 2)
    py = -(c2[..., 1] - fp.f32(ih / 2))
    pz = focal.to(corners.device).expand_as(px)
    nrm = torch.clamp_min(fp.sqrt(px * px + py * py + pz * pz), _EPS)
    p = torch.stack([px / nrm, py / nrm, pz / nrm], dim=-1)

    def inv_dist(i, j):
        dd = p[:, i] - p[:, j]
        n = fp.sqrt(dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]
                    + dd[:, 2] * dd[:, 2])
        return 1.0 / torch.clamp_min(n, _EPS)

    d01, d23 = inv_dist(0, 1), inv_dist(2, 3)
    d12, d03 = inv_dist(1, 2), inv_dist(0, 3)
    x0 = torch.cat([torch.stack([d01, d01, d23, d23], dim=-1),
                    torch.stack([d03, d12, d12, d03], dim=-1)])
    return c2, p, x0


def pose_finish(x: torch.Tensor, value: torch.Tensor, p: torch.Tensor):
    """The better of the two modes, the sign flip and the 3D corners:
    x (2G,4) depths and value (2G,) -> (c3 (G,4,3), value (G,))."""
    g = p.shape[0]
    v0, v1 = value[:g], value[g:]
    val = torch.minimum(v0, v1)
    x = torch.where((v0 < v1)[:, None], x[:g], x[g:])
    x = torch.where(x[:, :1] < 0, -x, x)
    return p * x[:, :, None], val


def pose_estimate(corners: torch.Tensor, iw: int, ih: int, tan_aov: float,
                  cg_iters: int = 12, ls_iters: int = 10):
    """Batched pose estimation: corners (G,4,2) float32 -> (c2 (G,4,2),
    c3 (G,4,3), value (G,)).  tan_aov is divided into iw/2 in float32, as
    in the jitted JAX pipeline."""
    c2, p, x0 = pose_setup(corners, iw, ih, tan_aov)
    g = corners.shape[0]
    pp = torch.cat([p, p])
    pl = [[pp[:, i, k:k + 1] for k in range(3)] for i in range(4)]
    mode1 = (torch.arange(2 * g, device=corners.device) < g)[:, None]
    x = cg_minimize(x0, cg_iters, ls_iters, pl, mode1)
    c3, val = pose_finish(x, _value(x, pl, mode1), p)
    return c2, c3, val


def _closest_point_ls(vx, vy, wx, wy, px, py):
    """closestPointLS2 (oclrect.c:408-416), clamped to the segment."""
    dx, dy = wx - vx, wy - vy
    l2 = dx * dx + dy * dy
    t = torch.where(l2 > 0, ((px - vx) * dx + (py - vy) * dy)
                    / torch.clamp_min(l2, _EPS), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return vx + t * dx, vy + t * dy


def looks_like_a_screen(c2, c3, val, accept_value: float = 0.05,
                        aspect_limit: float = 12.0,
                        offset_ratio_limit: float = 100.0):
    """Acceptance test (looksLikeAScreen, oclrect.c:636-656), batched:
    c2 (G,4,2), c3 (G,4,3), val (G,) -> bool (G,)."""
    def norm3(a):
        return fp.sqrt(a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]
                       + a[:, 2] * a[:, 2])

    ok = val <= fp.f32(accept_value)
    ok = ok & (c3[:, :, 2] >= 0).all(-1)
    asp = norm3(c3[:, 0] - c3[:, 1]) / torch.clamp_min(
        norm3(c3[:, 1] - c3[:, 2]), _EPS)
    ok = ok & (asp >= fp.f32(1.0 / aspect_limit)) & \
        (asp <= fp.f32(aspect_limit))

    offs = []
    for i in range(4):
        ax, ay = c2[:, i, 0], c2[:, i, 1]
        bx, by = c2[:, (i + 1) % 4, 0], c2[:, (i + 1) % 4, 1]
        s = []
        for j in (2, 3):
            qx, qy = c2[:, (i + j) % 4, 0], c2[:, (i + j) % 4, 1]
            cx, cy = _closest_point_ls(ax, ay, bx, by, qx, qy)
            s.append((qx - cx) * (qx - cx) + (qy - cy) * (qy - cy))
        offs.append(torch.maximum(s[0], s[1]))
    offs = torch.stack(offs, dim=1)
    maxs = offs.max(1).values
    mins = offs.min(1).values
    return ok & (maxs <= fp.f32(offset_ratio_limit)
                 * torch.clamp_min(mins, _EPS))

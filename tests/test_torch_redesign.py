"""PyTorch port, the kernels' own schedules in plain PyTorch against the
plain versions on the CPU: blblur's arm words and fused shared-memory
rounds (csrc/blblur.cu), its multiply-shift division, and the pose
kernel's lanes (csrc/pose.cu: one seed direction per jet, the line search
that reuses its candidate's jet).

The plain versions (ops/regions.py:blblur, geometry/pose.py) are held to
the JAX package by tests/test_torch_regions.py and tests/test_torch_rect.py;
these tests compile no JAX.  Everything here must be bit-equal: blblur is
integer arithmetic, and the pose schedule rounds the same float
operations in the same order.
"""

import math

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch import parity
from rectdetect_tpu_torch.geometry import pose
from rectdetect_tpu_torch.ops import fp, regions
from rectdetect_tpu_torch.ops.regions import _coord_maps
from rectdetect_tpu_torch.ops.shifts import pad2d, shifted

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

TAN_AOV = math.tan(math.radians(72.0) / 2)
SIZE = regions.BLBLURSIZE

# floor(n / d) = (n * DIV_MAGIC[d - 1]) >> DIV_N for 1 <= d <= 11 and
# 0 <= n <= 4095 d (the JAX package's _DIV_MAGIC, pallas_blblur.py:37-38);
# every product stays below 2^32
DIV_N = 19
DIV_MAGIC = tuple((1 << DIV_N) // d + 1 for d in range(1, 12))


def div_by_count(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """floor(n / d) by the kernel's multiply-shift; int64 tensors."""
    magic = torch.tensor((0,) + DIV_MAGIC, dtype=torch.int64,
                         device=n.device)
    return (n * magic[d]) >> DIV_N


def _arm_lengths(edge: torch.Tensor, horizontal: bool):
    """(neg, pos) taps kept by the scans of regions._blblur_axis before
    their first break, (H,W) int32 each."""
    h, w = edge.shape
    yy, xx = _coord_maps(h, w, edge.device)
    r = SIZE + 1
    ep = pad2d(edge, r, "zero")

    def ed(dy, dx):
        return shifted(ep, r, dy, dx, h, w) != 0

    def off(k):
        return (0, k) if horizontal else (k, 0)

    cross = (1, 0) if horizontal else (0, 1)
    coord, limit = (xx, w) if horizontal else (yy, h)
    cross_ok = yy < h - 1 if horizontal else xx < w - 1
    lengths = []
    alive = torch.ones((h, w), dtype=torch.bool, device=edge.device)
    n = torch.zeros((h, w), dtype=torch.int32, device=edge.device)
    for k in range(0, -SIZE - 1, -1):
        q = coord + k
        brk = q < 0
        brk |= (q > 0) & ed(*off(k)) & ~ed(*off(k - 1))
        brk |= ((q > 0) & cross_ok & ~ed(*off(k)) & ed(*off(k - 1)) &
                ed(off(k)[0] + cross[0], off(k)[1] + cross[1]))
        alive &= ~brk
        n += alive
    lengths.append(n)
    oe = ed(0, 0)
    alive = torch.ones_like(alive)
    n = torch.zeros_like(n)
    for k in range(0, SIZE + 1):
        q = coord + k
        brk = q > limit - 1
        brk |= (q < limit - 1) & ~ed(*off(k)) & ed(*off(k + 1))
        brk |= oe & ~ed(*off(k))
        alive &= ~brk
        n += alive
    lengths.append(n)
    return lengths


def blblur_arms(edge: torch.Tensor) -> torch.Tensor:
    """The arm pass: (H,W) int32 words, bits 0-2 horizontal negative, 3-5
    horizontal positive, 6-8 vertical negative, 9-11 vertical positive."""
    hn, hp = _arm_lengths(edge, True)
    vn, vp = _arm_lengths(edge, False)
    return hn | hp << 3 | vn << 6 | vp << 9


# the kernel never reads a pixel outside the region its previous pass
# wrote; the mirror fills the rest with this, so a read would show
_STALE = (1 << 31) - 1


def _pass(lo, hi, arm, rows, cols, shift, axis):
    """One pass over lo/hi[rows, cols] (int64 (LH,LW)); the rest of the
    result is stale."""
    r0, r1 = rows
    c0, c1 = cols
    a = arm[r0:r1, c0:c1] >> shift
    n, p = a & 7, (a >> 3) & 7
    dy, dx = (0, 1) if axis == 1 else (1, 0)
    if min(r0 - SIZE * dy, c0 - SIZE * dx) < 0 or \
            r1 + SIZE * dy > lo.shape[0] or \
            c1 + SIZE * dx > lo.shape[1]:
        raise ValueError("a pass reads outside the loaded region")

    def tap(x, k):
        return x[r0 + k * dy:r1 + k * dy, c0 + k * dx:c1 + k * dx]

    wc = (n > 0).long() + (p > 0).long()
    slo, shi = tap(lo, 0) * wc, tap(hi, 0) * wc
    for k in range(1, SIZE + 1):
        slo = slo + torch.where(n > k, tap(lo, -k), 0) + \
            torch.where(p > k, tap(lo, k), 0)
        shi = shi + torch.where(n > k, tap(hi, -k), 0) + \
            torch.where(p > k, tap(hi, k), 0)
    cnt = n + p
    keep = cnt == 0
    d = torch.clamp(cnt, min=1)
    nlo = div_by_count(slo & 0xFFFF, d) | div_by_count(slo >> 16, d) << 16
    nhi = div_by_count(shi, d)
    out_lo = torch.full_like(lo, _STALE)
    out_hi = torch.full_like(hi, _STALE)
    out_lo[r0:r1, c0:c1] = torch.where(keep, tap(lo, 0), nlo)
    out_hi[r0:r1, c0:c1] = torch.where(keep, tap(hi, 0), nhi)
    return out_lo, out_hi


def blblur_tiled(packed: torch.Tensor, edge: torch.Tensor, iters: int,
                 fuse: int, tile: tuple[int, int]) -> torch.Tensor:
    """The kernel's schedule: the arm words once, then launches of up to
    `fuse` rounds, each over (rows, columns) = `tile` output tiles with a
    halo of 4 * fuse, the pass regions shrinking by 4 per pass."""
    if iters <= 0:
        return packed.clone()
    th, tw = tile
    h, w = packed.shape
    arms = blblur_arms(edge).long()
    halo = SIZE * fuse
    lh, lw = th + 2 * halo, tw + 2 * halo
    src = packed
    for start in range(0, iters, fuse):
        rounds = min(fuse, iters - start)
        dst = torch.empty_like(packed)
        for by in range(0, h, th):
            for bx in range(0, w, tw):
                ys, ye = max(by - halo, 0), min(by + th + halo, h)
                xs, xe = max(bx - halo, 0), min(bx + tw + halo, w)
                oy, ox = ys - (by - halo), xs - (bx - halo)
                v = torch.zeros((lh, lw), dtype=torch.int64)
                arm = torch.zeros_like(v)
                v[oy:oy + ye - ys, ox:ox + xe - xs] = \
                    src[ys:ye, xs:xe].long() & 0xFFFFFFFF
                arm[oy:oy + ye - ys, ox:ox + xe - xs] = arms[ys:ye, xs:xe]
                lo = (v & 4095) | ((v >> 12) & 1023) << 16
                hi = v >> 22
                for rd in range(rounds):
                    hy = SIZE * (rounds - rd)
                    hx = SIZE * (rounds - 1 - rd)
                    lo, hi = _pass(lo, hi, arm, (halo - hy, halo + th + hy),
                                   (halo - hx, halo + tw + hx), 0, 1)
                    lo, hi = _pass(lo, hi, arm, (halo - hx, halo + th + hx),
                                   (halo - hx, halo + tw + hx), 6, 0)
                ny, nx = min(th, h - by), min(tw, w - bx)
                l = lo[halo:halo + ny, halo:halo + nx]
                b = hi[halo:halo + ny, halo:halo + nx]
                word = b << 22 | (l >> 16) << 12 | (l & 0xFFFF)
                dst[by:by + ny, bx:bx + nx] = torch.where(
                    word >= 1 << 31, word - (1 << 32), word).int()
        src = dst
    return src


def grad_and_diag_hess_lanes(x, p, mode1):
    """pose._grad_and_diag_hess as the kernel's lanes compute it: one jet
    per seed direction e_i -> (g (B,4), diagonal Hessian (B,4), f (B,))."""
    g, m = [], []
    for i in range(4):
        seed = torch.zeros_like(x)
        seed[:, i] = 1.0
        j = pose._jet(x, seed[:, :, None], p, mode1)
        g.append(j.d[:, 0])
        m.append(j.dd[:, 0])
    return torch.stack(g, 1), torch.stack(m, 1), j.v[:, 0]


def _line_search_lanes(x, direction, n_iter, p, mode1):
    """pose._line_search with the kernel's steps: the jet at a taken
    candidate serves the next step, the last step evaluates the value
    only, and nothing changes after `stop`."""
    if n_iter <= 0:
        return x
    d = direction / torch.clamp_min(pose._norm4(direction), pose._EPS)[:, None]
    cur = pose._jet(x, d[:, :, None], p, mode1)
    scale = torch.full_like(x[:, 0], pose.INIT_SCALE)
    stop = torch.zeros_like(x[:, 0], dtype=torch.bool)
    for it in range(n_iter):
        g2 = cur.dd[:, 0]
        g2 = torch.where(g2 * g2 < fp.f32(1e-10), 1.0, g2)
        delta = torch.abs(cur.d[:, 0] / g2)
        stop = stop | (delta < fp.f32(1e-10))
        cand = x + d * (delta * scale)[:, None]
        if it == n_iter - 1:
            worse = pose._value(cand, p, mode1) > cur.v[:, 0]
            return torch.where((stop | worse)[:, None], x, cand)
        nxt = pose._jet(cand, d[:, :, None], p, mode1)
        worse = nxt.v[:, 0] > cur.v[:, 0]
        take = (~stop & ~worse)[:, None]
        x = torch.where(take, cand, x)
        cur = pose.Jet(torch.where(take, nxt.v, cur.v),
                       torch.where(take, nxt.d, cur.d),
                       torch.where(take, nxt.dd, cur.dd))
        scale = torch.where(worse & ~stop, scale * 0.5, scale)
    return x


def pose_estimate_lanes(corners: torch.Tensor, iw: int, ih: int,
                        tan_aov: float, cg_iters: int = 12,
                        ls_iters: int = 10):
    """pose.pose_estimate on the kernel's schedule; the objective at the
    result is the last gradient jet's value."""
    c2, p, x = pose.pose_setup(corners, iw, ih, tan_aov)
    g = corners.shape[0]
    pp = torch.cat([p, p])
    pl = [[pp[:, i, k:k + 1] for k in range(3)] for i in range(4)]
    mode1 = (torch.arange(2 * g, device=corners.device) < g)[:, None]
    grad, m, f = grad_and_diag_hess_lanes(x, pl, mode1)
    r = -grad
    s = pose._inversedot(m, r)
    d = s
    deltanew = pose._dot4(r, s)
    k = torch.zeros_like(deltanew, dtype=torch.int32)
    for _ in range(cg_iters):
        x = _line_search_lanes(x, d, ls_iters, pl, mode1)
        grad, m, f = grad_and_diag_hess_lanes(x, pl, mode1)
        r = -grad
        deltaold = deltanew
        deltamid = pose._dot4(r, s)
        s = pose._inversedot(m, r)
        deltanew = pose._dot4(r, s)
        beta = (deltanew - deltamid) / torch.where(deltaold == 0, 1.0,
                                                   deltaold)
        reset = (k == pose.CG_RESET_K) | (beta <= 0) | (deltaold == 0)
        d = torch.where(reset[:, None], s, s + d * beta[:, None])
        k = torch.where(reset, 0, k) + 1
    c3, val = pose.pose_finish(x, f, p)
    return c2, c3, val


def _packed(h, w, r):
    return torch.from_numpy(((r.integers(0, 1024, (h, w)) << 22)
                             | (r.integers(0, 1024, (h, w)) << 12)
                             | r.integers(0, 4096, (h, w))).astype(np.int32))


@pytest.mark.parametrize("fuse", [1, 2, 3])
@pytest.mark.parametrize("shape", [(32, 44), (37, 53)])
def test_blblur_tiled_schedule_matches_plain(shape, fuse):
    """Random edges with edge pixels on the frame border; 8x16 tiles,
    which divide neither frame; 4 rounds, so the last launch of fuse 3
    runs 1; pixels outside a pass's region are poisoned in the mirror."""
    h, w = shape
    r = np.random.default_rng(h * 100 + fuse)
    packed = _packed(h, w, r)
    edge = (r.random((h, w)) < 0.2).astype(np.int32)
    edge[0, ::3] = 1
    edge[-1, 1::2] = 1
    edge[::2, 0] = 1
    edge[1::3, -1] = 1
    edge = torch.from_numpy(edge)
    for iters in (1, 4):
        got = blblur_tiled(packed, edge, iters, fuse, (8, 16))
        assert torch.equal(got, regions.blblur(packed, edge, iters)), iters


def test_blblur_arm_words_bound_the_taps():
    """Arm lengths 0-5 per side, no arm leaving the frame, and a pixel with
    no taps only where the plain pass keeps its input."""
    r = np.random.default_rng(3)
    edge = torch.from_numpy((r.random((23, 31)) < 0.3).astype(np.int32))
    arms = blblur_arms(edge)
    yy, xx = torch.meshgrid(torch.arange(23), torch.arange(31),
                            indexing="ij")
    for shift, coord, n in ((0, xx, 31), (6, yy, 23)):
        neg, pos = (arms >> shift) & 7, (arms >> (shift + 3)) & 7
        assert neg.max() <= 5 and pos.max() <= 5
        assert (coord - neg + 1 >= 0).all() and (coord + pos - 1 < n).all()
    packed = _packed(23, 31, r)
    once = regions._blblur_axis(packed, edge, True)
    none = ((arms & 7) + ((arms >> 3) & 7)) == 0
    assert torch.equal(once[none], packed[none]) and none.any()


def test_div_by_count_exhaustive():
    """(n * M_d) >> 19 = floor(n / d) for every d in [1, 11] and n in
    [0, 4095 d], with every product below 2^32 (the kernel's uint32)."""
    for d in range(1, 12):
        n = torch.arange(0, 4095 * d + 1, dtype=torch.int64)
        dd = torch.full_like(n, d)
        np.testing.assert_array_equal(
            div_by_count(n, dd).numpy(), (n // d).numpy())
        assert int(n[-1]) * DIV_MAGIC[d - 1] < 1 << 32


def test_grad_lanes_bit_equal_to_jet4():
    """One jet per seed direction equals the 4-seed jet bit for bit, at the
    start depths and at perturbed ones, in both modes."""
    q = torch.from_numpy(parity.pose_quads(0, 16, 4, 640, 480, TAN_AOV))
    _, p, x0 = pose.pose_setup(q, 640, 480, TAN_AOV)
    pp = torch.cat([p, p])
    pl = [[pp[:, i, k:k + 1] for k in range(3)] for i in range(4)]
    mode1 = (torch.arange(2 * len(q)) < len(q))[:, None]
    r = np.random.default_rng(0)
    for x in (x0, x0 * torch.from_numpy(
            r.uniform(0.7, 1.3, x0.shape).astype(np.float32))):
        g, m, f = grad_and_diag_hess_lanes(x, pl, mode1)
        g4, m4 = pose._grad_and_diag_hess(x, pl, mode1)
        np.testing.assert_array_equal(g.numpy(), g4.numpy())
        np.testing.assert_array_equal(m.numpy(), m4.numpy())
        np.testing.assert_array_equal(f.numpy(),
                                      pose._value(x, pl, mode1).numpy())
    assert np.isnan(g4.numpy()).any() and np.isfinite(g4.numpy()).any()


@pytest.mark.parametrize("cg_iters,ls_iters", [(12, 10), (3, 1), (2, 0)])
def test_pose_lanes_schedule_bit_equal_to_plain(cg_iters, ls_iters):
    """The kernel's schedule on 16 projected rectangles and 4 degenerate
    quads: c2, c3 and value bit-equal, NaN in the same places."""
    q = torch.from_numpy(parity.pose_quads(0, 16, 4, 640, 480, TAN_AOV))
    got = pose_estimate_lanes(q, 640, 480, TAN_AOV, cg_iters,
                                          ls_iters)
    want = pose.pose_estimate(q, 640, 480, TAN_AOV, cg_iters, ls_iters)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert np.isnan(want[2].numpy()).any()

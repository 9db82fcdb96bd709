"""PyTorch port, the kernels' own schedules in plain PyTorch against the
plain versions on the CPU: blblur's arm words and fused shared-memory
rounds (csrc/blblur.cu), its multiply-shift division, the pose kernel's
lanes (csrc/pose.cu: one seed direction per jet, the line search that
reuses its candidate's jet), mkpl's sorted-domain rounds (csrc/mkpl.cu:
runs in (arc, number) order, per-tile run keys, the id-order scan in
chunks, pass3 as a run cut), the links CCL's and K4's tiled union-finds
(csrc/links_ccl.cu, csrc/ccl.cu: tile pass from a shared-memory copy,
seam unions with their skip rules, flatten) and the hyp kernel's hull
walk and picks (csrc/hyp.cu: compacted endpoints, pair tests split over
lanes with the sqrt only past the perpendicular bound, first maxima by
order keys, the picks by bit masks), K3's chain on 32-pixel bit words
(csrc/morph.cu: shift-and-carry neighbours, bit-sliced counts, windows
that shrink stage by stage, parity masks), quant_despeckle's window
(csrc/quant_despeckle.cu: one quantization per window pixel through a
level-code table, integer squared distances, the sqrt only below the
best square), K2 thin's tiles (csrc/thin.cu: a mirrored em window, the
fraction-free part of bicubicSub once per window cell, taps at
tile-local indices), despeckle2's one launch (csrc/despeckle2.cu:
per-tile tables of runs of equal labels with a spill path, sizes zeroed
and added through them, the absorption from each run's slot), merge_mask's
bit words and seg_total's tile descriptors (csrc/merge_mask.cu,
csrc/scan.cu), distinct_bids' row lists (csrc/distinct_bids.cu: bit
words of the taps that hold an id, the first 4 distinct ids of each
row's 7 taps, merged in dy order) and edge_front's staged tiles
(csrc/edge_front.cu: reflect-101 while staging, each staged pixel
quantized once by the inverse scale).

The plain versions (ops/regions.py:blblur, label_merge and
quantize_despeckle, geometry/pose.py, ops/mkpl.py:mkpl_subdivide,
ops/ccl.py, ops/morphology.py:strings_chain, geometry/quad.py,
ops/thin.py, ops/regions.py:sizes_despeckle2, ops/hopper_bids.py,
ops/hopper_grad.py) are held
to the JAX package by tests/test_torch_regions.py,
tests/test_torch_rect.py, tests/test_torch_hypotheses.py,
tests/test_torch_morph_ccl.py, tests/test_torch_polyline.py and
tests/test_torch_frontend.py; these tests compile no JAX.  Everything
here must be bit-equal: blblur, the CCL, K3, despeckle2 and
distinct_bids are integer arithmetic, and the pose, mkpl,
quant_despeckle, thin and edge_front schedules round the same float
operations in the same order.
"""

import math

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch import parity
from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.geometry import pose, quad
from rectdetect_tpu_torch.ops import (fp, gradient, hopper_bids,
                                      hopper_grad, hopper_scan, mkpl,
                                      morphology, polyline, regions, thin)
from rectdetect_tpu_torch.ops.ccl import label_components_plain
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


def mkpl_sorted(arena, label, number, minerror, n_iters, comp, piece=16,
                chunk=8):
    """csrc/mkpl.cu's schedule: the live slots placed in (arc, number)
    order (an arc whose numbers are not 1..size without repeats ranked by
    (number, slot)), then per round the previous round's pass3, the
    distance keys reduced over each run's part in every `piece` positions
    and the parts' maxima into the run's key, the split test, the id-order
    ranks chunk by chunk (`chunk` ids), the record writes and the run cut
    after the winner.  Returns (arena, lsid) as mkpl.mkpl_subdivide."""
    h, w = label.shape
    n = h * w
    cap = arena.cap
    f = {k: getattr(arena, k).clone() for k in arena._fields if k != "count"}
    count = int(arena.count)
    dense = label.reshape(-1).tolist()
    numimg = number.reshape(-1).tolist()
    polyid = f["polyid"].tolist()
    live = {}                                  # slot -> (pixel, arc, number)
    for s, p in enumerate(comp.idx.tolist()):
        if p < n:
            p = max(p, 0)
            lab = dense[p]
            if 0 < lab <= count and polyid[lab] != 0:
                live[s] = (p, lab, numimg[p])
    size = np.zeros(cap, np.int64)
    for _, lab, _ in live.values():
        size[lab] += 1
    runend = np.cumsum(size)
    runstart = runend - size
    perm = np.full(len(live), -1, np.int64)
    bad = np.zeros(cap, bool)
    for s, (_, lab, num) in live.items():
        k = runstart[lab] + num - 1
        if 1 <= num <= size[lab] and perm[k] < 0:
            perm[k] = s
        else:
            bad[lab] = True
    for lab in np.flatnonzero(bad):
        members = sorted((num, s) for s, (_, a, num) in live.items()
                         if a == lab)
        perm[runstart[lab]:runend[lab]] = [s for _, s in members]
    pix = np.array([live[s][0] for s in perm], np.int64)
    num_s = np.array([live[s][2] for s in perm], np.int64)
    lab_s = np.array([live[s][1] for s in perm], np.int64)
    posof = {s: i for i, s in enumerate(perm)}
    n_live = len(perm)
    px = torch.from_numpy(pix % w).to(torch.float32)
    py = torch.from_numpy(pix // w).to(torch.float32)
    minerr_fix = int(minerror * mkpl.FIX)
    for r in range(n_iters - 1):
        if r > 0:
            eidx, right = f["end_index"].numpy(), f["right_ptr"].numpy()
            lab_s = np.where(eidx[lab_s] < num_s, right[lab_s], lab_s)
        lt = torch.from_numpy(lab_s)
        d = mkpl._closest_point_dist(f["sx"][lt], f["sy"][lt], f["ex"][lt],
                                     f["ey"][lt], px, py)
        dist = torch.trunc(d * mkpl.FIX).to(torch.int32).numpy()
        key = dist.astype(np.int64) * 2 ** 32 + (2 ** 32 - 1 - perm)
        maxkey = {}
        for t0 in range(0, n_live, piece):
            t1 = min(t0 + piece, n_live)
            cuts = [t0] + [i for i in range(t0 + 1, t1)
                           if lab_s[i] != lab_s[i - 1]] + [t1]
            for a, b in zip(cuts[:-1], cuts[1:]):
                maxkey[lab_s[a]] = max(maxkey.get(lab_s[a], 0),
                                       key[a:b].max())
        runs = {g: maxkey[g] for g in range(count + 1)
                if runend[g] > runstart[g]}
        gs = list(runs)
        md = np.array([runs[g] >> 32 for g in gs], np.int64)
        wpos = np.array([posof[2 ** 32 - 1 - (runs[g] & 0xffffffff)]
                         for g in gs], np.int64)
        flags = np.zeros(count + 1, bool)
        if gs:
            gi = torch.tensor(gs)
            sx, sy, ex, ey = (f[k][gi] for k in ("sx", "sy", "ex", "ey"))
            mdt = torch.from_numpy(md.astype(np.int32))
            mdf = mdt.to(torch.float32)
            wx = torch.from_numpy(pix[wpos] % w).to(torch.float32)
            wy = torch.from_numpy(pix[wpos] // w).to(torch.float32)
            cdx, cdy = ex - sx, ey - sy
            chord_sq = fp.fma(cdx, cdx, cdy * cdy)
            curv_keep = ~((mdt < minerr_fix * 3) &
                          (mdf * mdf / torch.clamp(chord_sq, min=1e-30)
                           < 100000.0))
            dss = fp.fma(wx - sx, wx - sx, (wy - sy) * (wy - sy))
            dse = fp.fma(wx - ex, wx - ex, (wy - ey) * (wy - ey))
            ok = ((f["polyid"][gi] != 0)
                  & (f["end_index"][gi] - f["start_index"][gi] >= 3)
                  & (f["start_count"][gi] <= 1) & (f["end_count"][gi] <= 1)
                  & (mdt >= minerr_fix) & curv_keep
                  & (dss >= 1.0) & (dse >= 1.0))
            flags[gs] = ok.numpy()
        ranks, prefix = {}, 0
        for c0 in range(0, count + 1, chunk):
            fl = flags[c0:c0 + chunk].astype(np.int64)
            excl = np.cumsum(fl) - fl
            for j in np.flatnonzero(fl):
                ranks[c0 + j] = prefix + excl[j] + 1
            prefix += int(fl.sum())
        for g, rank in ranks.items():
            gn = count + rank
            if gn >= cap:
                continue
            k = gs.index(g)
            p, wn = pix[wpos[k]], num_s[wpos[k]]
            right = int(f["right_ptr"][g])
            for dst, val in (("sx", p % w), ("sy", p // w), ("ex", f["ex"][g]),
                             ("ey", f["ey"][g]), ("start_index", wn),
                             ("end_index", f["end_index"][g]),
                             ("left_ptr", g), ("right_ptr", right),
                             ("polyid", f["polyid"][g]), ("level", md[k]),
                             ("npix", 0), ("start_count", 0),
                             ("end_count", 0)):
                f[dst][gn] = val
            if right != 0:
                f["left_ptr"][right] = gn
            f["ex"][g], f["ey"][g] = float(p % w), float(p // w)
            f["end_index"][g], f["right_ptr"][g] = int(wn), gn
            q = wpos[k] + 1
            while q < runend[g] and num_s[q] <= wn:
                q += 1
            runstart[gn], runend[gn] = q, runend[g]
            runend[g] = q
        count += min(prefix, cap - 1 - count)
    if n_iters > 1:
        eidx, right = f["end_index"].numpy(), f["right_ptr"].numpy()
        lab_s = np.where(eidx[lab_s] < num_s, right[lab_s], lab_s)
    lsid = np.zeros(n, np.int32)
    for s, p in enumerate(comp.idx.tolist()):
        if p < n and s not in posof:
            lsid[max(p, 0)] = dense[max(p, 0)]
    lsid[pix] = lab_s
    out = arena._replace(count=torch.tensor(count, dtype=torch.int32), **f)
    return out, torch.from_numpy(lsid.reshape(h, w))


def _polylines(h=256, w=256, seed=4, count=120):
    """Binary edge map of `count` random zig-zag polylines (as
    tests/test_torch_cuda.py's)."""
    r = np.random.default_rng(seed)
    m = np.zeros((h, w), np.int32)
    for _ in range(count):
        y, x = r.integers(2, h - 2), r.integers(2, w - 2)
        dy, dx = r.integers(-1, 2, 2)
        for _ in range(r.integers(15, 60)):
            if r.random() < 0.15:
                dy, dx = r.integers(-1, 2, 2)
            y, x = np.clip(y + dy, 1, h - 2), np.clip(x + dx, 1, w - 2)
            m[y, x] = 1
    return torch.from_numpy(m)


def scrambled_numbers(dense, number, comp):
    """Arc numbers that are no longer 1..size without repeats on every
    third arc: a repeated number, a gap, or both."""
    num = number.clone().reshape(-1)
    flat = dense.reshape(-1)
    live = comp.idx[comp.valid()].long()
    for k, arc in enumerate(torch.unique(flat[live]).tolist()):
        px = live[flat[live] == arc]
        if k % 3 or px.numel() < 4:
            continue
        order = px[torch.argsort(num[px])]
        if k % 9 == 0:
            num[order[2]] = num[order[1]]           # a repeat
        elif k % 9 == 3:
            num[order[2:]] += 2                     # a gap
        else:
            num[order[1]] = num[order[2]]           # a repeat ...
            num[order[-1]] += 5                     # ... and a gap
    return num.reshape(number.shape)


@pytest.mark.parametrize("cap", [4096, 200, 180])
def test_mkpl_sorted_schedule_matches_plain(cap):
    """Arena and lsid bit-equal to mkpl_subdivide on 120 polylines (173
    arcs; at caps 200 and 180 the arena overflows and splits drop in id
    order), with 16-position pieces and 8-id chunks, so runs span pieces
    and the scan crosses chunks; and with scrambled numbers, which the
    schedule ranks in place of placing them."""
    arena, dense, number, comp = polyline.mkpl_inputs(
        _polylines(), 4, cap, PipelineConfig())
    cases = [(arena, number)]
    number2 = scrambled_numbers(dense, number, comp)
    cases.append((polyline.mkpl_init(dense, number2, cap, comp), number2))
    for a0, num in cases:
        want = mkpl.mkpl_subdivide(a0, dense, num, 1.0, 16, comp)
        got = mkpl_sorted(a0, dense, num, 1.0, 16, comp)
        assert torch.equal(got[1], want[1])
        for fld in want[0]._fields:
            assert torch.equal(getattr(got[0], fld),
                               getattr(want[0], fld)), fld
    if cap < 4096:
        assert int(want[0].count) == cap - 1


def test_mkpl_sorted_schedule_rounds_and_layouts():
    """0, 1 and 3 rounds, one-position pieces and one-id chunks."""
    arena, dense, number, comp = polyline.mkpl_inputs(
        _polylines(96, 96, 7, 30), 4, 4096, PipelineConfig())
    for iters, piece, chunk in ((1, 16, 8), (2, 1, 1), (4, 5, 3)):
        want = mkpl.mkpl_subdivide(arena, dense, number, 1.0, iters, comp)
        got = mkpl_sorted(arena, dense, number, 1.0, iters, comp, piece,
                          chunk)
        assert torch.equal(got[1], want[1])
        for fld in want[0]._fields:
            assert torch.equal(getattr(got[0], fld),
                               getattr(want[0], fld)), fld


def _interior(y, x, h, w):
    return 1 <= y < h - 1 and 1 <= x < w - 1


def _right_link(y, x, h, w, ca, cb, ma, mb, eb, cb_up):
    """csrc/links_ccl.cu right_link."""
    eq = ca == cb
    link = not eb and ((_interior(y, x, h, w) and (eq or ma)) or
                       (_interior(y, x + 1, h, w) and (eq or mb)))
    return link or (eq and not (y > 0 and cb_up == cb))


def _lower_link(y, x, h, w, ca, cb, ma, mb, eb):
    """csrc/links_ccl.cu lower_link."""
    eq = ca == cb
    link = not eb and ((_interior(y, x, h, w) and (eq or ma)) or
                       (_interior(y + 1, x, h, w) and (eq or mb)))
    return link or eq


def _root(par, x):
    while par[x] != x:
        x = par[x]
    return x


def _unite(par, a, b):
    a, b = _root(par, a), _root(par, b)
    if a != b:
        par[max(a, b)] = min(a, b)


POISON = -7


def label_merge_tiled(packed, mask, edge, th, tw):
    """csrc/links_ccl.cu's schedule: each th x tw tile evaluates its inner
    links from its shared-memory copy (the tile and the row above it, the
    rest poisoned), joins each row's runs of right links, unites the runs
    of adjacent rows where a lower link is not implied by the one to its
    left, and writes each pixel's tile root; the links across the seams
    unite the roots unless the link before along the seam implies them;
    a last pass flattens."""
    pk, mk, ed = packed.numpy(), mask.numpy() != 0, edge.numpy() > 0
    h, w = pk.shape
    parent = np.arange(h * w)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            rows, cols = min(th, h - y0), min(tw, w - x0)
            col = np.full((th + 1, tw), POISON)
            col[1:rows + 1, :cols] = pk[y0:y0 + rows, x0:x0 + cols]
            if y0 > 0:
                col[0, :cols] = pk[y0 - 1, x0:x0 + cols]
            m = np.zeros((th, tw), bool)
            e = np.ones((th, tw), bool)
            m[:rows, :cols] = mk[y0:y0 + rows, x0:x0 + cols]
            e[:rows, :cols] = ed[y0:y0 + rows, x0:x0 + cols]
            right = np.zeros((th, tw), bool)
            lower = np.zeros((th, tw), bool)
            for ty in range(rows):
                for tx in range(cols):
                    y, x = y0 + ty, x0 + tx
                    right[ty, tx] = tx + 1 < tw and x + 1 < w and _right_link(
                        y, x, h, w, col[ty + 1, tx], col[ty + 1, tx + 1],
                        m[ty, tx], m[ty, tx + 1], e[ty, tx + 1],
                        col[ty, tx + 1])
                    lower[ty, tx] = ty + 1 < th and y + 1 < h and _lower_link(
                        y, x, h, w, col[ty + 1, tx], col[ty + 2, tx],
                        m[ty, tx], m[ty + 1, tx], e[ty + 1, tx])
            par = []
            for ty in range(th):
                start = 0
                for tx in range(tw):
                    if tx and not right[ty, tx - 1]:
                        start = tx
                    par.append(ty * tw + start)
            for ty in range(rows):
                for tx in range(cols):
                    implied = (tx > 0 and lower[ty, tx - 1]
                               and right[ty, tx - 1]
                               and right[min(ty + 1, th - 1), tx - 1])
                    if lower[ty, tx] and not implied:
                        _unite(par, ty * tw + tx, (ty + 1) * tw + tx)
            for ty in range(rows):
                for tx in range(cols):
                    r = _root(par, ty * tw + tx)
                    parent[(y0 + ty) * w + x0 + tx] = \
                        (y0 + r // tw) * w + x0 + r % tw

    def rlink(y, x):
        return _right_link(y, x, h, w, pk[y, x], pk[y, x + 1], mk[y, x],
                           mk[y, x + 1], ed[y, x + 1],
                           pk[y - 1, x + 1] if y > 0 else 0)

    def llink(y, x):
        return _lower_link(y, x, h, w, pk[y, x], pk[y + 1, x], mk[y, x],
                           mk[y + 1, x], ed[y + 1, x])

    for x in range(tw - 1, w - 1, tw):
        for y in range(h):
            if rlink(y, x) and not (y % th and rlink(y - 1, x)
                                    and llink(y - 1, x)
                                    and llink(y - 1, x + 1)):
                _unite(parent, y * w + x, y * w + x + 1)
    for y in range(th - 1, h - 1, th):
        for x in range(w):
            if llink(y, x) and not (x % tw and llink(y, x - 1)
                                    and rlink(y, x - 1)
                                    and rlink(y + 1, x - 1)):
                _unite(parent, y * w + x, (y + 1) * w + x)
    out = np.array([_root(parent, p) for p in range(h * w)], np.int32)
    return torch.from_numpy(out.reshape(h, w))


def merge_frames(shape, seed=12):
    """The kind of frame tests/test_torch_cuda.py's region-merge test
    draws: sparse strong edges with two lines across, blocks of three
    colours, one colour over a quarter of the frame, speckles."""
    h, w = shape
    r = np.random.default_rng(seed + h * w)
    strong = (r.random((h, w)) < 0.08) * r.integers(1, 900, (h, w))
    strong[h // 3, 3:w - 3] = 5
    strong[3:h - 3, w // 3] = 6
    strong = np.where(r.random((h, w)) < 0.05, -1, strong)
    strong = torch.from_numpy(strong.astype(np.int32))
    colours = np.kron(r.integers(0, 3, (h // 4 + 1, w // 4 + 1)),
                      np.ones((4, 4), np.int64))[:h, :w]
    colours[: h // 2, : w // 2] = 7
    colours = np.where(r.random((h, w)) < 0.06, 9, colours)
    packed = torch.from_numpy(colours.astype(np.int32))
    return packed, regions.junction_merge_mask(strong), strong


def random_links_frame(shape):
    """Three colours, a merge mask on a fifth and strong edges on a third
    of the pixels, at random: every link rule and every implied-link test
    of the schedule meets both outcomes."""
    h, w = shape
    r = np.random.default_rng(h * 7 + w)
    return (torch.from_numpy(r.integers(0, 3, (h, w)).astype(np.int32)),
            torch.from_numpy((r.random((h, w)) < 0.2).astype(np.int32)),
            torch.from_numpy((r.random((h, w)) < 0.3).astype(np.int32)))


def serpentine(h, w):
    """Colour 1 on a path that runs along every other row, turning at
    alternate ends (so it crosses every seam), colour 0 elsewhere; no mask,
    no strong edges."""
    c = np.zeros((h, w), np.int32)
    for y in range(0, h, 2):
        c[y] = 1
        if y + 1 < h:
            c[y + 1, w - 1 if (y // 2) % 2 == 0 else 0] = 1
    z = torch.zeros((h, w), dtype=torch.int32)
    return torch.from_numpy(c), z, z


@pytest.mark.parametrize("tiles", [(8, 8), (5, 7)])
@pytest.mark.parametrize("shape", [(37, 53), (70, 33), (96, 128)])
def test_links_tiled_union_find_matches_plain(shape, tiles):
    """The region-merge frames, random colours, mask and edges, a
    serpentine across every seam and a frame of one colour, with tiles
    that divide no side."""
    h, w = shape
    one = torch.full((h, w), 5, dtype=torch.int32)
    zero = torch.zeros((h, w), dtype=torch.int32)
    frames = [merge_frames(shape), random_links_frame(shape),
              serpentine(h, w), (one, zero, zero)]
    for packed, mask, edge in frames:
        want = regions.label_merge(packed, mask, edge)
        got = label_merge_tiled(packed, mask, edge, *tiles)
        assert torch.equal(got, want)
    assert int(torch.unique(want).numel()) == 1
    serp = regions.label_merge(*frames[2])
    assert int((serp == 0).sum()) == int((frames[2][0] == 1).sum())


def label_components_tiled(pix, bgc, th, tw):
    """csrc/ccl.cu's schedule: each th x tw tile without foreground writes
    -1; otherwise each row's runs of equal neighbours come from its
    "equal to the left" flags, each pixel unites with its equal NW, N and
    NE neighbours in the tile (only NE, past an equal N, where its left
    neighbour is in its run; N past an equal NW and NE past an equal N
    skipped), and each pixel gets its tile root.  Along the seams, a pixel
    on a tile's first column unites with its equal W, NW and SW in its
    tile row, and one on a tile's first row with its equal NW, N and NE,
    each skipped where the neighbour before it along the seam is equal
    too, and all but the last where the pixel before it along the seam
    has its value (on a column seam both in its tile row); a last pass
    flattens."""
    p = pix.numpy()
    h, w = p.shape
    parent = np.full(h * w, -1)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            rows, cols = min(th, h - y0), min(tw, w - x0)
            tile = np.full((th, tw), bgc)
            tile[:rows, :cols] = p[y0:y0 + rows, x0:x0 + cols]
            fg = tile != bgc
            if not fg.any():
                continue
            eql = np.zeros((th, tw), bool)
            eql[:, 1:] = fg[:, 1:] & (tile[:, 1:] == tile[:, :-1])
            par = []
            for ty in range(th):
                start = 0
                for tx in range(tw):
                    if not eql[ty, tx]:
                        start = tx
                    par.append(ty * tw + start)
            for ty in range(1, th):
                for tx in range(tw):
                    if not fg[ty, tx]:
                        continue
                    v, up = tile[ty, tx], tile[ty - 1]
                    nw = tx > 0 and up[tx - 1] == v
                    n = up[tx] == v
                    ne = tx + 1 < tw and up[tx + 1] == v
                    lt, u = ty * tw + tx, (ty - 1) * tw + tx
                    if eql[ty, tx]:
                        if ne and not n:
                            _unite(par, lt, u + 1)
                    else:
                        if nw:
                            _unite(par, lt, u - 1)
                        if n and not nw:
                            _unite(par, lt, u)
                        if ne and not n:
                            _unite(par, lt, u + 1)
            for ty in range(rows):
                for tx in range(cols):
                    if fg[ty, tx]:
                        r = _root(par, ty * tw + tx)
                        parent[(y0 + ty) * w + x0 + tx] = \
                            (y0 + r // tw) * w + x0 + r % tw
    for x in range(tw, w, tw):
        for y in range(h):
            v = p[y, x]
            if v == bgc:
                continue
            ys = y - y % th
            hi = min(y + 1, min(ys + th, h) - 1)
            r, prev = (y - 1 if y > ys else y), False
            if y > ys and p[y - 1, x] == v:
                r, prev = y + 1, p[y, x - 1] == v
            for r in range(r, hi + 1):
                eq = p[r, x - 1] == v
                if eq and not prev:
                    _unite(parent, y * w + x, r * w + x - 1)
                prev = eq
    for y in range(th, h, th):
        for x in range(w):
            v = p[y, x]
            if v == bgc:
                continue
            c, prev = max(x - 1, 0), False
            if x > 0 and p[y, x - 1] == v:
                c, prev = x + 1, p[y - 1, x] == v
            for c in range(c, min(x + 1, w - 1) + 1):
                eq = p[y - 1, c] == v
                if eq and not prev:
                    _unite(parent, y * w + x, (y - 1) * w + c)
                prev = eq
    out = np.array([_root(parent, q) if parent[q] >= 0 else -1
                    for q in range(h * w)], np.int32)
    return torch.from_numpy(out.reshape(h, w))


def edge_map(shape, seed=3):
    """1-px chains: 8-connected random walks (diagonal steps included)
    over sparse noise, as edge_bin and the rect strings are."""
    h, w = shape
    r = np.random.default_rng(seed + h * w)
    e = (r.random((h, w)) < 0.03).astype(np.int32)
    for _ in range(max(2, h * w // 300)):
        y, x = r.integers(0, h), r.integers(0, w)
        for _ in range(r.integers(5, 3 * (h + w))):
            e[y, x] = 1
            y = min(max(y + r.integers(-1, 2), 0), h - 1)
            x = min(max(x + r.integers(-1, 2), 0), w - 1)
    return torch.from_numpy(e)


def boundary_marks(shape):
    """mark_boundary of the region labels of a region-merge frame:
    boundary rings of many distinct labels side by side, background -1."""
    seg = regions.label_merge(*merge_frames(shape))
    return regions.mark_boundary(seg)


def corner_staircase(h, w, th, tw, anti):
    """Value 1 on diagonal steps from tile to tile that touch only at tile
    corners: through the NW-SE diagonal at each corner, or (anti) the
    NE-SW one; background 0."""
    c = np.zeros((h, w), np.int32)
    ty, tx = 0, (w - 1) // tw if anti else 0
    while ty * th < h and 0 <= tx * tw < w:
        y0, x0 = ty * th, tx * tw
        y1, x1 = min(y0 + th, h) - 1, min(x0 + tw, w) - 1
        ya, xa, yb, xb = (y0, x1, y1, x0) if anti else (y0, x0, y1, x1)
        y, x = ya, xa
        while True:
            c[y, x] = 1
            if (y, x) == (yb, xb):
                break
            y += y < yb
            x += (x < xb) - (x > xb)
        ty += 1
        tx += -1 if anti else 1
    return torch.from_numpy(c)


@pytest.mark.parametrize("tiles", [(8, 8), (5, 7)])
@pytest.mark.parametrize("shape", [(37, 53), (70, 33), (1, 61), (61, 1)])
def test_ccl_tiled_union_find_matches_plain(shape, tiles):
    """Edge maps, boundary marks (background -1), staircases that cross
    every tile corner on either diagonal, a frame of one value and frames
    of background only, with tiles that divide no side."""
    h, w = shape
    frames = [(edge_map(shape), 0), (boundary_marks(shape), -1),
              (corner_staircase(h, w, *tiles, False), 0),
              (corner_staircase(h, w, *tiles, True), 0),
              (torch.full((h, w), 5, dtype=torch.int32), 0),
              (torch.zeros((h, w), dtype=torch.int32), 0),
              (torch.full((h, w), -1, dtype=torch.int32), -1)]
    for pix, bgc in frames:
        want = label_components_plain(pix, bgc)
        assert torch.equal(label_components_tiled(pix, bgc, *tiles), want)
    assert int(want.max()) == -1
    for pix, _ in frames[2:4]:
        lbl = label_components_plain(pix, 0)
        assert int(torch.unique(lbl[pix == 1]).numel()) == 1
    if min(shape) > 1:
        marks = frames[1][0]
        assert int(torch.unique(marks).numel()) > 3
        assert int(torch.unique(label_components_plain(marks, -1)).numel()) \
            > 3


def order_key(x: torch.Tensor) -> torch.Tensor:
    """csrc/hyp.cu order_key: float32 (no NaN) -> int64 key in its order,
    -0 as +0."""
    u = torch.where(x == 0, 0.0, x).view(torch.int32).to(torch.int64) \
        & 0xffffffff
    return torch.where(u >= 1 << 31, 0xffffffff - u, u | 1 << 31)


def first_max(key: torch.Tensor) -> tuple[int, int]:
    """(largest key, lowest index holding it): the kernel's atomicMax of
    first_max_key."""
    m = int(key.max())
    return m, int(torch.nonzero(key == m)[0, 0])


def hull_lanes(px, py, kept, max_vertices, lanes=4):
    """csrc/hyp.cu's hull walk for one group: the kept endpoints compacted
    in index order, the start the first maximum of x over all endpoints
    by order key, and each step's pair tests split over `lanes` threads
    per candidate, each pair's sqrt taken only where cross > perp, the
    lanes' flags combined, the next vertex the first maximum of the
    distance's bits (lowest index on a tie).  Returns the hull's endpoint
    indices."""
    kept_pts = kept.repeat_interleave(2)
    orig = torch.nonzero(kept_pts)[:, 0]
    cpx, cpy = px[orig], py[orig]
    p = cpx.shape[0]
    start = first_max(order_key(torch.where(kept_pts, px, -1e30)))[1]
    start_c = int(torch.nonzero(orig == start)[0, 0]) if kept_pts[start] \
        else -1
    hull = [start]
    cx, cy = px[start], py[start]
    eps = fp.f32(1e-20)
    for _ in range(1, max_vertices):
        rx, ry = cpx - cx, cpy - cy
        d = rx * rx + ry * ry
        d = torch.where(d > fp.f32(1e-12), d, -1.0)
        perp = fp.f32(0.1) * fp.sqrt(torch.clamp_min(d, eps))
        left = torch.zeros(p, dtype=torch.bool)
        for sub in range(min(lanes, p)):
            j = torch.arange(sub, p, lanes)
            cross = rx[:, None] * ry[None, j] - ry[:, None] * rx[None, j]
            near = (d[None, j] > 0) & (cross > perp[:, None])
            pi, pj = torch.nonzero(near, as_tuple=True)
            norm = fp.sqrt(torch.clamp_min(d[pi] * d[j][pj], eps))
            an = fp.f32(1e-5) * norm
            thr = torch.where(an.isnan() | (an > perp[pi]), an, perp[pi])
            hit = torch.zeros_like(near)
            hit[pi, pj] = cross[pi, pj] > thr
            left |= hit.any(-1)
        good = (d > 0) & ~left
        key = torch.where(good, d.view(torch.int32).to(torch.int64), 0)
        m, i = first_max(torch.cat([key, key.new_zeros(1)]))
        if m == 0 or i == start_c:
            break
        cx, cy = cpx[i], cpy[i]
        hull.append(int(orig[i]))
    return hull


def picks_by_masks(e0x, e0y, e1x, e1y, sq, kept, hx, hy, max_vertices):
    """csrc/hyp.cu's pickExternalLS: every (hull edge, kept segment) test
    at once, each setting its segment's bit, by rank in (-sq, index)
    order, in its edge's mask; then each edge in turn takes the lowest
    rank not taken yet."""
    nh = hx.shape[0]
    segs = torch.nonzero(kept)[:, 0]
    order = segs[torch.argsort(-sq[segs], stable=True)]
    eps = fp.f32(1e-20)
    n = torch.arange(1, nh + 1) % nh
    q0x, q0y, q1x, q1y = hx[:, None], hy[:, None], hx[n, None], hy[n, None]
    ax, ay, bx, by = (t[order][None, :] for t in (e0x, e0y, e1x, e1y))
    s2 = sq[order][None, :]
    dx, dy = bx - ax, by - ay
    den = torch.clamp_min(fp.sqrt(s2), eps)
    dex, dey = (ax - bx) / den, (ay - by) / den
    mx, my = (q0x + q1x) * 0.5, (q0y + q1y) * 0.5
    tt = ((mx - ax) * dx + (my - ay) * dy) / torch.clamp_min(s2, eps)
    tt = torch.where(s2 > 0, tt, 0.0)
    tt = torch.fmin(torch.fmax(tt, torch.tensor(0.0)), torch.tensor(1.0))
    dmx, dmy = mx - (ax + tt * dx), my - (ay + tt * dy)
    dm = dmx * dmx + dmy * dmy
    qdx, qdy = q0x - q1x, q0y - q1y
    qsq = qdx * qdx + qdy * qdy
    qn = torch.clamp_min(fp.sqrt(qsq), eps)
    para = (torch.abs((qdx / qn) * dex + (qdy / qn) * dey) > fp.f32(0.95)) \
        & (dm / torch.clamp_min(qsq, eps) < fp.f32(0.01))
    tests = (dm < 1.0) | para
    masks = [sum(1 << c for c in torch.nonzero(row)[:, 0].tolist())
             for row in tests]
    picks, used = [], 0
    for e in range(max_vertices):
        m = masks[e] & ~used if e < nh else 0
        if m:
            c = (m & -m).bit_length() - 1
            used |= 1 << c
            picks.append(int(order[c]))
        else:
            picks.append(-1)
    return picks


def test_hyp_lanes_schedule_matches_plain():
    """The hull walk and the picks of csrc/hyp.cu on 48 groups of the
    randomized corpus (quads, axis-aligned quads, a duplicate-heavy and a
    zero-length group), with the pair tests split over the kernel's 4
    lanes per candidate and over 1."""
    segs, valid = (torch.from_numpy(a)
                   for a in parity.segment_groups(0, 48, 48, 1.0))
    # a group left of x = 0 whose largest x is -0 first and +0 later: the
    # start is the first, as -0 == +0
    segs[5] = 0.0
    valid[5] = False
    segs[5, :3] = torch.tensor([[[-0.0, 10.0], [-50.0, 12.0]],
                                [[-50.0, 40.0], [-3.0, 60.0]],
                                [[0.0, 30.0], [-20.0, 25.0]]])
    valid[5, :3] = True
    mv = 24
    e0x, e0y, e1x, e1y = (segs[..., 0, 0], segs[..., 0, 1],
                          segs[..., 1, 0], segs[..., 1, 1])
    dx, dy = e1x - e0x, e1y - e0y
    sq = dx * dx + dy * dy
    kept = quad.remove_short(sq, valid & (sq > 0))
    g, k = kept.shape
    px = torch.stack([e0x, e1x], -1).reshape(g, 2 * k)
    py = torch.stack([e0y, e1y], -1).reshape(g, 2 * k)
    hidx, hvalid = quad.jarvis_hull(px, py, kept.repeat_interleave(2, -1),
                                    mv)
    picks = quad.pick_external(e0x, e0y, e1x, e1y, sq, kept, mv)
    sizes = set()
    for gi in range(g):
        want = hidx[gi][hvalid[gi]].tolist()
        for lanes in (1, 4):
            assert hull_lanes(px[gi], py[gi], kept[gi], mv, lanes) == want
        sizes.add(len(want))
        got = picks_by_masks(e0x[gi], e0y[gi], e1x[gi], e1y[gi], sq[gi],
                             kept[gi], px[gi][want], py[gi][want], mv)
        assert got == picks[gi].tolist()
    assert max(sizes) >= 8 and min(sizes) == 1
    assert int((picks >= 0).sum()) >= 48
    assert int((picks >= 0).sum(-1).max()) >= 4


# ---- K3 (csrc/morph.cu): the chain on 32-pixel bit words ---------------

WORD_MASK = (1 << 32) - 1
# the kernel never reads a window row its previous stage did not write;
# such rows hold this here, so a read would show
_STALE_WORD = WORD_MASK
# each stage's reach and interior margin, in order
K3_STAGES = {
    "rect": (("junction", 1, 1), ("connect", 1, 2), ("stringify0", 1, 1),
             ("stringify1", 1, 1)),
    "poly_branch": (("junction", 1, 1), ("connect", 2, 2),
                    ("stringify0", 1, 1), ("stringify1", 1, 1),
                    ("remove_branch", 1, 1)),
}
# bridge2's stages after connect: the chain ends (no mask) and the fill
K3_BRIDGE2 = (("ends", 1, 0), ("fill", 2, 2))


def k3_stages(variant, bridge2=False):
    st = K3_STAGES[variant]
    return st[:2] + K3_BRIDGE2 + st[2:] if bridge2 else st


def k3_halo(variant, bridge2=False):
    """The halo rows: the stages' reaches summed."""
    return sum(reach for _, reach, _ in k3_stages(variant, bridge2))


def _bit_range(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Words with bits [lo, hi) set, 0 <= lo, hi <= 32 (int64)."""
    one = torch.ones_like(lo)
    m = ((one << hi) - 1) & ~((one << lo) - 1)
    return torch.where(hi > lo, m, torch.zeros_like(m))


def _interior_words(m, y, x0, h, w):
    """interior(m) of the frame as words: y (T, rows, 1), x0 (T, 1, WW)."""
    lo = (m - x0).clamp(0, 32)
    hi = (w - m - x0).clamp(0, 32)
    rows = (y >= m) & (y < h - m)
    return torch.where(rows, _bit_range(lo, hi), torch.zeros_like(lo))


class _Window:
    """A stage's view of the (T, WR, WW) planes at rows [k, WR - k)."""

    def __init__(self, k, wr):
        self.k, self.wr = k, wr

    def at(self, plane, dy, dx):
        """Words of rows [k, WR - k) whose bit i holds pixel x0 + i + dx of
        row y + dy; words beyond the window read 0."""
        rows = plane[:, self.k + dy:self.wr - self.k + dy]
        if dx == 0:
            return rows
        zero = torch.zeros_like(rows[..., :1])
        if dx > 0:
            right = torch.cat([rows[..., 1:], zero], -1)
            return ((rows >> dx) | (right << (32 - dx))) & WORD_MASK
        left = torch.cat([zero, rows[..., :-1]], -1)
        return ((rows << -dx) & WORD_MASK) | (left >> (32 + dx))

    def write(self, plane, words):
        out = torch.full_like(plane, _STALE_WORD)
        out[:, self.k:self.wr - self.k] = words
        return out


def _count3(win, plane):
    """Saturating bit-sliced count of the 8 neighbour planes: at least 1,
    2, 3 set."""
    a1 = a2 = a3 = torch.zeros_like(win.at(plane, 0, 0))
    for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                   (1, 0), (1, 1)):
        p = win.at(plane, dy, dx)
        a3 = a3 | (a2 & p)
        a2 = a2 | (a1 & p)
        a1 = a1 | p
    return a1, a2, a3


def strings_chain_words(edge: torch.Tensor, variant: str, th: int,
                        tww: int, bridge2: bool = False) -> torch.Tensor:
    """csrc/morph.cu's schedule: tiles of th rows x tww words, a window of
    k3_halo rows and one word on each side, every stage on the words of a
    window that shrinks by its reach."""
    h, w = edge.shape
    r_halo = k3_halo(variant, bridge2)
    nty, ntx = -(-h // th), -(-w // (32 * tww))
    wr, ww = th + 2 * r_halo, tww + 2
    nz = edge > 0 if variant == "rect" else edge != 0
    bits = torch.zeros((nty * th + 2 * r_halo, (ntx * tww + 2) * 32),
                       dtype=torch.int64)
    bits[r_halo:r_halo + h, 32:32 + w] = nz.to(torch.int64)
    words = (bits.reshape(bits.shape[0], -1, 32)
             << torch.arange(32, dtype=torch.int64)).sum(-1)
    tiles = [(ty, tx) for ty in range(nty) for tx in range(ntx)]
    planes = {"in": torch.stack([
        words[ty * th:ty * th + wr, tx * tww:tx * tww + ww]
        for ty, tx in tiles])}
    ys = torch.tensor([ty * th - r_halo for ty, _ in tiles])[:, None, None]
    x0s = torch.tensor([(tx * tww - 1) * 32 for _, tx in tiles])[:, None, None]
    x0s = x0s + 32 * torch.arange(ww)[None, None, :]
    k = 0
    for name, reach, margin in k3_stages(variant, bridge2):
        k += reach
        win = _Window(k, wr)
        y = ys + torch.arange(k, wr - k)[None, :, None]
        inner = _interior_words(margin, y, x0s, h, w)
        if name == "junction":
            src = planes["in"]
            a1, a2, _ = _count3(win, src)
            base = win.at(src, 0, 0) & a1 & inner
            planes["nz"] = win.write(src, base)
            planes["one"] = win.write(src, base & ~a2 & WORD_MASK)
        elif name == "connect":
            nz, one = planes["nz"], planes["one"]

            def n(dy, dx):
                return win.at(nz, dy, dx)

            def o(dy, dx):
                return win.at(one, dy, dx)

            if variant == "rect":
                b = ((o(0, -1) & n(0, 1)) | (n(0, -1) & o(0, 1)) |
                     (o(-1, 0) & n(1, 0)) | (n(-1, 0) & o(1, 0)) |
                     (o(-1, -1) & o(1, 1)) | (o(-1, 1) & o(1, -1)) |
                     (o(0, 1) & o(1, -1)) | (o(0, -1) & o(1, 1)) |
                     (o(-1, 1) & o(1, 0)) | (o(-1, -1) & o(1, 0)))
            else:
                b = ((n(0, -2) & o(0, -1) & o(0, 1) & n(0, 2)) |
                     (n(-2, 0) & o(-1, 0) & o(1, 0) & n(2, 0)) |
                     (n(-2, -2) & o(-1, -1) & o(1, 1) & n(2, 2)) |
                     (n(-2, 2) & o(-1, 1) & o(1, -1) & n(2, -2)) |
                     (n(0, 2) & o(0, 1) & o(1, -1) & n(1, -2)) |
                     (n(0, -2) & o(0, -1) & o(1, 1) & n(1, 2)) |
                     (n(-2, 1) & o(-1, 1) & o(1, 0) & n(2, 0)) |
                     (n(-2, -1) & o(-1, -1) & o(1, 0) & n(2, 0)))
            planes["s"] = win.write(nz, (n(0, 0) | b) & inner)
        elif name == "ends":
            src = planes["s"]
            a1, a2, _ = _count3(win, src)
            planes["e"] = win.write(src, win.at(src, 0, 0) & a1 & ~a2
                                    & WORD_MASK)
        elif name == "fill":
            src, ends = planes["s"], planes["e"]
            fill = torch.zeros_like(win.at(src, 0, 0))
            for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
                fill = fill | (win.at(ends, -dy, -dx)
                               & win.at(ends, 2 * dy, 2 * dx))
                fill = fill | (win.at(ends, -2 * dy, -2 * dx)
                               & win.at(ends, dy, dx))
            planes["s"] = win.write(src, (win.at(src, 0, 0) | fill) & inner)
        elif name.startswith("stringify"):
            src = planes["s"]
            parity = torch.where(((y + int(name[-1])) & 1) == 1,
                                 torch.tensor(0xAAAAAAAA),
                                 torch.tensor(0x55555555))
            corner = ((win.at(src, -1, 0) | win.at(src, 1, 0)) &
                      (win.at(src, 0, -1) | win.at(src, 0, 1)))
            clear = parity & corner & inner
            planes["s"] = win.write(src, win.at(src, 0, 0) & ~clear
                                    & WORD_MASK)
        else:
            src = planes["s"]
            _, _, a3 = _count3(win, src)
            planes["s"] = win.write(src, win.at(src, 0, 0) & ~a3 & inner
                                    & WORD_MASK)
    tile = planes["s"][:, r_halo:r_halo + th, 1:1 + tww]
    out_bits = (tile[..., None] >> torch.arange(32)) & 1
    out = torch.zeros((nty * th, ntx * tww * 32), dtype=torch.int32)
    for t, (ty, tx) in enumerate(tiles):
        out[ty * th:(ty + 1) * th, tx * tww * 32:(tx + 1) * tww * 32] = (
            out_bits[t].reshape(th, tww * 32))
    return out[:h, :w]


def signed_edges(shape, density, seed):
    """(H,W) int32 in {-1, 0, 1, 2}, nonzero with probability `density`:
    rect's junction counts only values > 0, poly's every nonzero."""
    r = np.random.default_rng(seed)
    vals = r.choice(np.array([-1, 1, 2], np.int32), size=shape)
    return torch.from_numpy(np.where(r.random(shape) < density, vals, 0)
                            .astype(np.int32))


K3_SHAPES = [(37, 53), (70, 33), (1, 61), (61, 1), (33, 97)]


def _k3_word_schedule_case(shape, variant, bridge2):
    for i, density in enumerate((0.1, 0.3, 0.6)):
        edge = signed_edges(shape, density, seed=40 + i + sum(shape))
        want = morphology.strings_chain(edge, variant, bridge2)
        for tww in (1, 2):
            got = strings_chain_words(edge, variant, 8, tww, bridge2)
            assert torch.equal(got, want), (density, tww)


@pytest.mark.parametrize("variant", ["rect", "poly_branch"])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_word_schedule_matches_plain(shape, variant):
    """csrc/morph.cu's bit-word chain, tiles of 8 rows x 1 and 2 words, is
    bit-equal to morphology.strings_chain."""
    _k3_word_schedule_case(shape, variant, False)


@pytest.mark.parametrize("variant", ["rect", "poly_branch"])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_bridge2_word_schedule_matches_plain(shape, variant):
    """The same with bridge2: the chain ends' plane and the fill stage
    on the words, 3 more halo rows."""
    _k3_word_schedule_case(shape, variant, True)


def test_k3_word_schedule_on_chains_across_tiles():
    """1-px chains, 2-px gaps and crossings that run across tile and word
    edges: the bridges and the parity masks on structure the random maps
    rarely make."""
    h, w = 41, 99
    e = np.zeros((h, w), np.int32)
    e[7, 2:97] = 1
    e[7, 31:33] = 0                      # a 2-px gap across a word edge
    e[8:40, 64] = 1
    e[16, 60:70] = 1                     # a crossing on a tile row edge
    for i in range(30):
        e[9 + i, 10 + i] = 1             # a diagonal over three tiles
    e[24, 40:45] = 1
    e[24, 46:50] = 1                     # a 1-px gap
    e[30:33, 90:93] = 2
    e[35, 30:40] = -1                    # rect ignores values <= 0
    edge = torch.from_numpy(e)
    for variant in ("rect", "poly_branch"):
        want = morphology.strings_chain(edge, variant)
        assert int(want.sum()) > 0
        for tww in (1, 2):
            assert torch.equal(strings_chain_words(edge, variant, 8, tww),
                               want), (variant, tww)


def border_bridges(h, w):
    """poly's 2-reach bridges whose far end lies on the frame's border
    ring: a chain end of degree 2 one pixel in from the border, a gap,
    and a chain beyond it.  The bridge closes only while the junction map
    keeps its border ring at 0."""
    e = np.zeros((h, w), np.int32)
    for x in (5, 40):
        e[0:2, x] = 1
        e[3:5, x] = 1
        e[h - 2:h, x + 3] = 1
        e[h - 5:h - 3, x + 3] = 1
    for y in (6, 17):
        e[y, 0:2] = 1
        e[y, 3:5] = 1
        e[y + 3, w - 2:w] = 1
        e[y + 3, w - 5:w - 3] = 1
    return torch.from_numpy(e)


@pytest.mark.parametrize("shape", [(30, 50), (33, 97)])
def test_k3_word_schedule_at_the_frame_border(shape):
    """Chains that end on the frame's border ring: the junction's and the
    connect's interior masks, in frame coordinates, decide the bridges."""
    edge = border_bridges(*shape)
    for variant in ("rect", "poly_branch"):
        want = morphology.strings_chain(edge, variant)
        for tww in (1, 2):
            assert torch.equal(strings_chain_words(edge, variant, 8, tww),
                               want), (variant, tww)


def staircases(h, w):
    """Shallow 1-px edges as the thinning leaves them: runs with a straight
    2-px hole at every step, horizontal, vertical and diagonal, crossing
    word edges (x = 32, 64) and the 8-row tile edges, some ending on the
    frame's border ring and one hole next to a junction."""
    e = np.zeros((h, w), np.int32)
    for x in range(1, w - 1):
        if x % 12 not in (10, 11):
            e[7 + (x // 36) % 2, x] = 1
    for y in range(0, h):
        if y % 9 not in (7, 8):
            e[y, 31 + (y // 27) % 2] = 1
    for i in range(0, min(h, w) - 12):
        if i % 10 not in (6, 7):
            e[10 + i, 40 + i] = 1
            e[10 + i, w - 3 - i] = 1
    e[h - 3, 2:14] = 1
    e[h - 3, 8:10] = 0
    e[h - 4, 7] = 1
    e[h - 2, 7] = 1                      # a junction flanking a hole
    e[0:h, 1] = np.arange(h) % 5 < 3     # 2-px holes one pixel in
    return torch.from_numpy(e)


@pytest.mark.parametrize("shape", [(41, 99), (30, 70), (33, 97)])
def test_k3_bridge2_word_schedule_on_staircases(shape):
    """bridge2 on staircases with 2-px holes across tile and word edges
    and at the frame border: the chain ends' plane and the fill, in the
    kernel's words, are bit-equal to morphology.strings_chain, and the
    bridge closes holes that the map without it keeps."""
    edge = staircases(*shape)
    for variant in ("rect", "poly_branch"):
        want = morphology.strings_chain(edge, variant, True)
        assert int(want.sum()) > int(morphology.strings_chain(
            edge, variant).sum())
        for tww in (1, 2):
            assert torch.equal(
                strings_chain_words(edge, variant, 8, tww, True),
                want), (variant, tww)


# ---- quant_despeckle (csrc/quant_despeckle.cu): the window schedule -----

# window rows and columns of a th x tw tile: the tile and a one-pixel halo
def qd_window(th, tw):
    return th + 2, tw + 2


# the most levels a channel may have for the per-block code table
QD_MAX_LEVELS = 255


def quantize_by_table(win_p, n0, n1, n2):
    """The kernel's quantizer: each channel's level floor(v n + 1/2) by
    one fused multiply-add, its code from a table of floor(k / n 2^bits)
    over 0 <= k <= n; channels of more than QD_MAX_LEVELS levels or fewer
    than 0 divide per pixel, as the plain version does."""
    ns = (n0, n1, n2)
    if max(ns) > QD_MAX_LEVELS or min(ns) < 0:
        return regions.quantize_packed(win_p, n0, n1, n2)
    lab = regions.color.unpack_labf(win_p)
    code = torch.zeros(win_p.shape, dtype=torch.int64)
    for ch, (n, size, shift) in enumerate(zip(ns, (4096, 1024, 1024),
                                              (0, 12, 22))):
        k = torch.floor(fp.fma(lab[..., ch], float(n), 0.5)).long()
        q = torch.arange(n + 1, dtype=torch.float32) / torch.tensor(
            float(n), dtype=torch.float32)
        table = torch.floor(q * size).clamp(0, size - 1).long() << shift
        code |= table[k]
    return ((code + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def quant_despeckle_windows(packed, emag, n0, n1, n2, th=8, tw=8):
    """csrc/quant_despeckle.cu's schedule: each tile quantizes its window
    once, by the code table (out-of-frame pixels marked on-edge, never
    candidates), then each
    on-edge pixel scans its 9 window candidates in (dy, dx) order with a
    strict <, its squared distances from integer lattice differences and
    its sqrt only where the square is below the best one's."""
    h, w = packed.shape
    nty, ntx = -(-h // th), -(-w // tw)
    wr, wc = qd_window(th, tw)
    pp = torch.zeros((nty * th + 2, ntx * tw + 2), dtype=torch.int32)
    ep = torch.ones((nty * th + 2, ntx * tw + 2), dtype=torch.float32)
    pp[1:1 + h, 1:1 + w] = packed
    ep[1:1 + h, 1:1 + w] = emag
    tiles = [(ty, tx) for ty in range(nty) for tx in range(ntx)]
    # a window row or column the kernel would not load holds stale data:
    # an off-edge flag and a code no pixel has
    code = torch.full((len(tiles), th + 2, tw + 2), _STALE, dtype=torch.int32)
    off = torch.ones((len(tiles), th + 2, tw + 2), dtype=torch.bool)
    for t, (ty, tx) in enumerate(tiles):
        win_p = pp[ty * th:ty * th + wr, tx * tw:tx * tw + wc]
        win_e = ep[ty * th:ty * th + wr, tx * tw:tx * tw + wc]
        code[t, :wr, :wc] = quantize_by_table(win_p, n0, n1, n2)
        off[t, :wr, :wc] = ~(win_e >= 1e-6)
    self_code = code[:, 1:1 + th, 1:1 + tw]

    def lattice(c):
        c = c.to(torch.int64)
        return c & 4095, (c >> 12) & 1023, (c >> 22) & 1023

    l0, a0, b0 = lattice(self_code)
    best = self_code
    best_s = torch.full(self_code.shape, math.inf, dtype=torch.float32)
    best_d = torch.full(self_code.shape, 1e10, dtype=torch.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cand = code[:, 1 + dy:1 + dy + th, 1 + dx:1 + dx + tw]
            ok = off[:, 1 + dy:1 + dy + th, 1 + dx:1 + dx + tw]
            cl, ca, cb = lattice(cand)
            dl, da, db = cl - l0, ca - a0, cb - b0
            # sq_dist: the plain version's float square in units of 2^-24,
            # from the integer squares; the sqrt only below the best square
            sq = ((dl * dl + 16 * da * da).to(torch.float32)
                  + (16 * db * db).to(torch.float32))
            take = ok & (sq < best_s)
            take &= fp.sqrt(sq) < best_d
            best_d = torch.where(take, fp.sqrt(sq), best_d)
            best_s = torch.where(take, sq, best_s)
            best = torch.where(take, cand, best)
    out_t = torch.where(off[:, 1:1 + th, 1:1 + tw], self_code, best)
    out = torch.zeros((nty * th, ntx * tw), dtype=torch.int32)
    for t, (ty, tx) in enumerate(tiles):
        out[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] = out_t[t]
    return out[:h, :w]


def lab_frame(shape, seed):
    r = np.random.default_rng(seed)
    h, w = shape
    return torch.from_numpy(((r.integers(0, 1024, (h, w)) << 22)
                             | (r.integers(0, 1024, (h, w)) << 12)
                             | r.integers(0, 4096, (h, w))).astype(np.int32))


def edge_magnitudes(shape, share, seed):
    """Thinned-edge magnitudes: `share` of the pixels >= 1e-6, the rest 0
    or just below the threshold."""
    r = np.random.default_rng(seed)
    on = r.random(shape) < share
    below = np.where(r.random(shape) < 0.5, 0.0, 9e-7)
    return torch.from_numpy(np.where(on, r.random(shape) + 1e-6, below)
                            .astype(np.float32))


@pytest.mark.parametrize("shape", K3_SHAPES)
def test_quant_despeckle_window_schedule_matches_plain(shape):
    """csrc/quant_despeckle.cu's window schedule at 8x8 tiles is bit-equal
    to regions.quantize_despeckle, at edge shares 0, 0.3 and 1 and level
    triples (24, 24, 24), (5, 7, 11), (1, 1, 1), the code table at its
    limit (255), past it (300) and a negative count (-3)."""
    packed = lab_frame(shape, seed=sum(shape))
    for i, share in enumerate((0.0, 0.3, 1.0)):
        emag = edge_magnitudes(shape, share, seed=60 + i)
        for levels in ((24, 24, 24), (5, 7, 11), (1, 1, 1), (255, 255, 255),
                       (300, 24, 24), (-3, 24, 24)):
            want = regions.quantize_despeckle(packed, emag, *levels)
            got = quant_despeckle_windows(packed, emag, *levels)
            assert torch.equal(got, want), (share, levels)


def test_quant_despeckle_window_schedule_keeps_the_first_tie():
    """Neighbours at equal distances in every direction and across tile
    edges: the first in (dy, dx) scan order wins, as in the plain
    version."""
    h, w = 19, 21
    yy, xx = np.mgrid[0:h, 0:w]
    # on-edge odd rows at L code 1024; the off-edge even rows alternate
    # 512 and 1536 by column: lattice points of 24 levels (3/24, 6/24,
    # 9/24), so every neighbour is exactly 0.125 away in L
    cl = np.where(yy % 2 == 1, 1024, np.where(xx % 2 == 0, 512, 1536))
    ca = np.full((h, w), 512)
    cb = np.full((h, w), 512)
    packed = torch.from_numpy(((cb << 22) | (ca << 12) | cl).astype(np.int32))
    emag = torch.from_numpy((yy % 2 == 1).astype(np.float32))
    for levels in ((24, 24, 24), (5, 7, 11)):
        want = regions.quantize_despeckle(packed, emag, *levels)
        got = quant_despeckle_windows(packed, emag, *levels)
        assert torch.equal(got, want), levels
    # ties are present: some on-edge pixel has two off-edge neighbours at
    # its least distance with different codes
    q = regions.quantize_packed(packed, 24, 24, 24)
    lab = regions.color.unpack_labf(q)
    ties = 0
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            if emag[y, x] < 1e-6:
                continue
            ds = {}
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if emag[y + dy, x + dx] < 1e-6:
                        d = lab[y + dy, x + dx] - lab[y, x]
                        dist = float(fp.sqrt((d[0] * d[0] + d[1] * d[1])
                                             + d[2] * d[2]))
                        ds.setdefault(dist, set()).add(int(q[y + dy, x + dx]))
            if ds and len(ds[min(ds)]) > 1:
                ties += 1
    assert ties > 0


def test_quant_despeckle_integer_square_is_the_float_square():
    """sq_dist (csrc/quant_despeckle.cu): the integer lattice squares,
    summed and rounded as floats, times 2^-24, equal the plain version's
    float (dl*dl + da*da) + db*db bit for bit, extremes included."""
    r = np.random.default_rng(5)
    n = 200_000
    a = torch.from_numpy(((r.integers(0, 1024, n) << 22)
                          | (r.integers(0, 1024, n) << 12)
                          | r.integers(0, 4096, n)).astype(np.int32))
    b = torch.from_numpy(((r.integers(0, 1024, n) << 22)
                          | (r.integers(0, 1024, n) << 12)
                          | r.integers(0, 4096, n)).astype(np.int32))
    ext = torch.from_numpy(np.array(
        [0, (1023 << 22) | (1023 << 12) | 4095, (1023 << 22) | 4095,
         1023 << 12], np.int64).astype(np.int32))
    a = torch.cat([a, ext.repeat_interleave(4)])
    b = torch.cat([b, ext.repeat(4)])
    d = regions.color.unpack_labf(a) - regions.color.unpack_labf(b)
    want = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2])
    ia, ib = a.to(torch.int64), b.to(torch.int64)
    dl = (ia & 4095) - (ib & 4095)
    da = ((ia >> 12) & 1023) - ((ib >> 12) & 1023)
    db = ((ia >> 22) & 1023) - ((ib >> 22) & 1023)
    sq = ((dl * dl + 16 * da * da).to(torch.float32)
          + (16 * db * db).to(torch.float32))
    assert torch.equal(sq * 2.0 ** -24, want)
    assert torch.equal(fp.sqrt(sq) * 2.0 ** -12, fp.sqrt(want))


# ---- K2 thin (csrc/thin.cu): the tiled window of bicubic cells ----------

# tap offsets of a sample span -THIN_HALO[0]..+THIN_HALO[1] around its pixel
THIN_HALO = (3, 4)
# a window cell nothing writes
_STALE_F = 1.0e3


def _window_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-101, clamped into [0, n)."""
    m = torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))
    return m.clamp(0, n - 1)


def _cell(p0, p1, p2, p3):
    """(A, B, C, p1): the fraction-free part of bicubicSub."""
    v = p1 - p2
    w = p3 - p0
    return fp.fma(v, 3.0, w), fp.fma(-4.0, v, p0 - p1 - w), p2 - p0, p1


def _finish(a, b, c, p1, x):
    u = fp.fma(a, x, b)
    u = fp.fma(u, x, c)
    return u * x * 0.5 + p1


def thin_tiled(em: torch.Tensor, vec: torch.Tensor, mode: str, th: int,
               tw: int, slack: float = 0.99) -> torch.Tensor:
    """csrc/thin.cu's schedule: each th x tw tile loads its mirrored em
    window (rows and columns [tile - 3, tile + 4]) into a flat array of
    pitch tw + 7, computes the cells (A, B, C, p1) of every run of 4
    window columns, and each pixel's sample reads its 4 cells at
    tile-local indices (a cell past the window reads what the flat arrays
    hold there) and finishes them with its fraction."""
    lo, hi = THIN_HALO
    h, w = em.shape
    wr, wc = th + lo + hi, tw + lo + hi
    nc = wc - 3
    out = torch.zeros_like(em)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            rows = _window_index(torch.arange(wr) + y0 - lo, h)
            cols = _window_index(torch.arange(wc) + x0 - lo, w)
            flat = torch.full((wr * wc + 8,), _STALE_F)
            flat[:wr * wc] = em[rows][:, cols].reshape(-1)
            start = (torch.arange(wr)[:, None] * wc
                     + torch.arange(nc)[None, :]).reshape(-1)
            cells = [torch.full((wr * nc + 8 * nc,), _STALE_F)
                     for _ in range(4)]
            for c, val in zip(cells, _cell(*(flat[start + i]
                                             for i in range(4)))):
                c[:wr * nc] = val
            yy, xx = torch.meshgrid(torch.arange(y0, min(y0 + th, h)),
                                    torch.arange(x0, min(x0 + tw, w)),
                                    indexing="ij")
            vx, vy = vec[yy, xx, 0], vec[yy, xx, 1]
            base = (yy - y0 + lo) * nc + (xx - x0 + lo)

            def sample(k, kr):
                fdx, fx = thin._int_frac(k * vx, xx.float(), xx.int())
                fdy, fy = thin._int_frac(k * vy, yy.float(), yy.int())
                ok = lambda d: (d >= -kr) & (d <= kr)  # noqa: E731
                fdx = torch.where(ok(fdx), fdx, -kr).long()
                fdy = torch.where(ok(fdy), fdy, -kr).long()
                t = base + (fdy - 1) * nc + (fdx - 1)
                r = [_finish(*(c[t + j * nc] for c in cells), fx)
                     for j in range(4)]
                return _finish(*_cell(*r), fy)

            am2, am1 = sample(-2.0, 2), sample(-1.0, 1)
            ap1, ap2 = sample(1.0, 1), sample(2.0, 2)
            a0 = flat[(yy - y0 + lo) * wc + (xx - x0 + lo)]
            if mode == "cubic":
                keep = ((am2 * slack <= a0) & (am1 * slack <= a0)
                        & (a0 >= ap1 * slack) & (a0 >= ap2 * slack))
            else:
                keep = (am1 <= a0) & (a0 >= ap1)
            out[yy, xx] = torch.where(keep, am2 + am1 + a0 + ap1 + ap2,
                                      torch.zeros_like(a0))
    return out


def thin_inputs(shape, seed):
    """Edge magnitudes with plateaus; unit vectors of random directions
    beside zero vectors and exactly axis-aligned ones (the sample
    position truncates on an integer) and diagonals."""
    r = np.random.default_rng(seed)
    h, w = shape
    em = r.random((h, w)).astype(np.float32)
    em[r.random((h, w)) < 0.2] = 0.5
    ang = r.random((h, w)) * 2 * np.pi
    vec = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    kind = r.integers(0, 4, (h, w))
    vec[kind == 1] = 0.0
    axis = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
    vec[kind == 2] = axis[r.integers(0, 4, int((kind == 2).sum()))]
    diag = np.float32(np.sqrt(0.5)) * np.array(
        [[1, 1], [-1, 1], [1, -1], [-1, -1]], np.float32)
    vec[kind == 3] = diag[r.integers(0, 4, int((kind == 3).sum()))]
    return torch.from_numpy(em), torch.from_numpy(vec)


@pytest.mark.parametrize("tile", [(16, 32), (4, 8)])
@pytest.mark.parametrize("shape", [(5, 5), (37, 53), (9, 20), (70, 33)])
def test_thin_tiled_schedule_matches_plain(shape, tile):
    """csrc/thin.cu's cells, bit-equal to thin.thinthres and thincubic in
    both modes: at the kernel's 16 x 32 tiles and at 4 x 8 tiles (every
    tile edge inside the frame), on the wrapper's smallest frame (5 x 5),
    frames narrower than a tile and tiles straddling every border, with
    zero, axis-aligned and diagonal vectors.  Fails with the halo one row
    or column short on either side (THIN_HALO (2, 4) or (3, 3))."""
    em, vec = thin_inputs(shape, seed=sum(shape))
    for mode, plain in (("thres", thin.thinthres), ("cubic", thin.thincubic)):
        want = plain(em, vec)
        assert torch.equal(thin_tiled(em, vec, mode, *tile), want), mode


# ---- despeckle2 (csrc/despeckle2.cu): tile tables and one launch --------

# the kernel's tile (rows x columns, a column a lane), table size and
# probe limit
D2_TILE = (64, 32)
D2_SLOT_BITS = 7
D2_MAX_PROBES = 8


def _d2_slot(label: int, bits: int) -> int:
    return ((label * 2654435761) & 0xFFFFFFFF) >> (32 - bits)


def _d2_count_tile(lab, n, y0, x0, h, w, th, tw, rng, bits, probes):
    """One tile's count: the runs of equal clamped labels along each of
    its rows, inserted in an order shuffled by rng (the warps race).
    Returns (keys, counts, [(label, length) of each spilled run])."""
    runs = []
    for y in range(y0, min(y0 + th, h)):
        x = x0
        while x < min(x0 + tw, w):
            cl = min(max(lab[y][x], 0), n - 1)
            e = x
            while e < min(x0 + tw, w) and min(max(lab[y][e], 0), n - 1) == cl:
                e += 1
            runs.append((cl, e - x))
            x = e
    nslots = 1 << bits
    keys, counts, spilled = [-1] * nslots, [0] * nslots, []
    for ri in rng.permutation(len(runs)):
        cl, ln = runs[ri]
        s = _d2_slot(cl, bits)
        for _ in range(probes):
            if keys[s] in (-1, cl):
                keys[s] = cl
                counts[s] += ln
                break
            s = (s + 1) % nslots
        else:
            spilled.append((cl, ln))
    return keys, counts, spilled


def despeckle2_tiled(label: torch.Tensor, thre: int, tile=D2_TILE,
                     slot_bits=D2_SLOT_BITS, max_probes=D2_MAX_PROBES,
                     seed=0) -> torch.Tensor:
    """csrc/despeckle2.cu's schedule.  A: each tile counts its runs into
    a table of 2^slot_bits slots (linear probing, at most max_probes
    probes; a run that finds none spills; _d2_count_tile) and zeroes the
    size of every table key and spilled label in a size table of garbage;
    B: adds each table count and spilled run; C: each pixel whose region
    has <= thre pixels takes the first largest in-frame 3x3 neighbour in
    (dy, dx) order."""
    h, w = label.shape
    n = h * w
    lab = label.tolist()
    rng = np.random.default_rng(seed)
    sizes = rng.integers(-9, 9, n).tolist()       # scratch, never zeroed
    th, tw = tile
    tiles = [_d2_count_tile(lab, n, y0, x0, h, w, th, tw, rng, slot_bits,
                            max_probes)
             for y0 in range(0, h, th) for x0 in range(0, w, tw)]
    for keys, _, spilled in tiles:                # A
        for k in keys:
            if k >= 0:
                sizes[k] = 0
        for cl, _ in spilled:
            sizes[cl] = 0
    for keys, counts, spilled in tiles:           # B
        for k, c in zip(keys, counts):
            if k >= 0:
                sizes[k] += c
        for cl, ln in spilled:
            sizes[cl] += ln
    out = [row[:] for row in lab]                 # C
    for y in range(h):
        for x in range(w):
            if sizes[min(max(lab[y][x], 0), n - 1)] > thre:
                continue
            best_sz, best = 0, lab[y][x]
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < h and 0 <= xx < w:
                        c = lab[yy][xx]
                        sz = sizes[min(max(c, 0), n - 1)]
                        if sz > best_sz:
                            best_sz, best = sz, c
            out[y][x] = best
    return torch.tensor(out, dtype=torch.int32)


def d2_maps(shape, seed):
    """Label maps: every pixel its own label, 2x2 blocks, 1x4 runs and
    blocks mixed (regions of 4 pixels: thre 4 absorbs them, thre 3 keeps
    them), three labels scattered (not one component each), and labels
    out of [0, h*w) (the size index is clamped)."""
    r = np.random.default_rng(seed)
    h, w = shape
    n = h * w
    flat = np.arange(n, dtype=np.int32).reshape(h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    blocks = flat[yy - yy % 2, xx - xx % 2]
    runs = flat[yy, xx - xx % 4]
    mixed = np.where((yy // 4 + xx // 8) % 2 == 0, runs, blocks)
    odd = r.integers(0, 3, (h, w)).astype(np.int32) * (n // 3)
    odd[r.random((h, w)) < 0.05] = -5
    odd[r.random((h, w)) < 0.05] = n + 3
    return [torch.from_numpy(np.ascontiguousarray(m))
            for m in (flat, blocks, mixed, odd)]


def d2_ties(h, w):
    """Single pixels between two regions of equal size (20 pixels each,
    different labels) left and right of them, and single pixels on every
    frame border and corner: a pixel's largest neighbours tie, and the
    first in (dy, dx) order must win."""
    lab = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            lab[y, x] = (y // 4) * w + (x // 5) * 5
    for y in range(1, h - 1, 4):
        for x in range(5, w - 1, 10):
            lab[y, x] = y * w + x                 # a 1-pixel region
    for y, x in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1),
                 (0, w // 2), (h - 1, w // 2), (h // 2, 0), (h // 2, w - 1)):
        lab[y, x] = y * w + x
    return torch.from_numpy(lab)


@pytest.mark.parametrize("shape", [(1, 1), (1, 61), (61, 1), (37, 53),
                                   (70, 33)])
def test_despeckle2_tiled_schedule_matches_plain(shape):
    """csrc/despeckle2.cu's tables and runs, equal to
    regions.sizes_despeckle2 at thre 16, 4 and 3, at the kernel's 64 x 32
    tiles and 128-slot tables (maps of one label a pixel spill) and at
    8 x 8 tiles with 4-slot tables and 2 probes (nearly every tile
    spills), in two insertion orders.  Fails if the spilled runs are not
    added."""
    for i, lbl in enumerate(d2_maps(shape, seed=sum(shape))):
        for thre in (16, 4, 3):
            want = regions.sizes_despeckle2(lbl, thre)
            for cfg in ({}, {"tile": (8, 8), "slot_bits": 2,
                             "max_probes": 2}):
                for seed in (0, 1):
                    got = despeckle2_tiled(lbl, thre, seed=seed, **cfg)
                    assert torch.equal(got, want), (i, thre, cfg, seed)


def test_despeckle2_tiled_schedule_takes_the_first_tie():
    """Blocks of 20 pixels and of 19 (those that hold a 1-pixel region)
    at thre 19 and 20 (regions of exactly thre and thre + 1 pixels),
    ties between equal neighbours and small regions on the frame border:
    equal to the plain version, and some 1-pixel region has two largest
    neighbours of different labels.  Fails if ties are taken with >=
    instead of >."""
    lbl = d2_ties(29, 41)
    for thre in (1, 19, 20, 21):
        want = regions.sizes_despeckle2(lbl, thre)
        for cfg in ({}, {"tile": (8, 8), "slot_bits": 2, "max_probes": 2}):
            assert torch.equal(despeckle2_tiled(lbl, thre, **cfg), want), \
                (thre, cfg)
    sizes = regions.label_sizes(lbl)
    h, w = lbl.shape
    ties = 0
    for y in range(h):
        for x in range(w):
            if int(sizes[lbl[y, x]]) > 1:
                continue
            nb = {}
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if 0 <= y + dy < h and 0 <= x + dx < w:
                        c = int(lbl[y + dy, x + dx])
                        nb.setdefault(int(sizes[c]), set()).add(c)
            ties += len(nb[max(nb)]) > 1
    assert ties > 0


# ---- merge_mask (csrc/merge_mask.cu): bit words and row-union dilations --

# the window's halo: 8 rows (the d^2 < 64 disk's 7 and the junction's
# stencil's 1) and one word on each side
MM_HALO = 8
MM_HALO_WORDS = 1
# the kernel's structuring elements: (|dx| values, the |dy| rows whose run
# reaches them); each |dx| is taken from the union of those rows
MM_RING = (((0, 1, 2), (4, 5)), ((3,), (3, 4, 5)), ((4,), (0, 1, 2, 3, 4)),
           ((5,), (0, 1, 2, 3)))
MM_D64 = (((0, 1, 2, 3), tuple(range(8))), ((4, 5), tuple(range(7))),
          ((6,), tuple(range(6))), ((7,), (0, 1, 2, 3)))
MM_D16 = (((0, 1, 2), (0, 1, 2, 3)), ((3,), (0, 1, 2)))


def _word_shift(words: torch.Tensor, dx: int) -> torch.Tensor:
    """Words (..., WW) whose bit i holds pixel x0 + i + dx, |dx| < 32: the
    funnel shift of two adjacent words; words beyond the last axis read
    0."""
    if dx == 0:
        return words
    zero = torch.zeros_like(words[..., :1])
    if dx > 0:
        right = torch.cat([words[..., 1:], zero], -1)
        return ((words >> dx) | (right << (32 - dx))) & WORD_MASK
    left = torch.cat([zero, words[..., :-1]], -1)
    return ((words << -dx) & WORD_MASK) | (left >> (32 + dx))


def _element_offsets(groups) -> set:
    return {(sy * dy, sx * dx) for dxs, dys in groups for dx in dxs
            for dy in dys for sy in (-1, 1) for sx in (-1, 1)}


def merge_mask_words(strong: torch.Tensor, th: int, tww: int,
                     halo: int = MM_HALO,
                     halo_words: int = MM_HALO_WORDS) -> torch.Tensor:
    """csrc/merge_mask.cu's schedule: tiles of th rows x tww words, a window
    of `halo` rows and `halo_words` words on each side loaded as words of
    "label > 0"; the junction's ANY, END and CORE planes on the window rows
    [1, rows - 1) from the funnel-shifted neighbour words and a saturating
    bit-sliced count, masked by the frame's interior in frame coordinates;
    each tile word's three dilations as ORs of shifted row unions."""
    h, w = strong.shape
    nty, ntx = -(-h // th), -(-w // (32 * tww))
    wr, ww = th + 2 * halo, tww + 2 * halo_words
    bits = torch.zeros((nty * th + 2 * halo, (ntx * tww + 2 * halo_words) * 32),
                       dtype=torch.int64)
    bits[halo:halo + h, 32 * halo_words:32 * halo_words + w] = (
        strong > 0).to(torch.int64)
    words = (bits.reshape(bits.shape[0], -1, 32)
             << torch.arange(32, dtype=torch.int64)).sum(-1)
    tiles = [(ty, tx) for ty in range(nty) for tx in range(ntx)]
    nz = torch.stack([words[ty * th:ty * th + wr, tx * tww:tx * tww + ww]
                      for ty, tx in tiles])
    ys = torch.tensor([ty * th - halo for ty, _ in tiles])[:, None, None]
    x0s = torch.tensor([(tx * tww - halo_words) * 32
                        for _, tx in tiles])[:, None, None]
    x0s = x0s + 32 * torch.arange(ww)[None, None, :]
    # junction on the rows [1, wr - 1); the rows it does not write stay
    # stale, so a dilation that reaches them shows
    win = _Window(1, wr)
    a1, a2, _ = _count3(win, nz)
    inner = _interior_words(1, ys + torch.arange(1, wr - 1)[None, :, None],
                            x0s, h, w)
    anyj = win.at(nz, 0, 0) & a1 & inner
    planes = {"any": win.write(nz, anyj),
              "end": win.write(nz, anyj & ~a2 & WORD_MASK),
              "core": win.write(nz, anyj & a2)}

    def dilate(plane, groups):
        acc = torch.zeros_like(plane[:, halo:halo + th])
        for dxs, dys in groups:
            rows = torch.zeros_like(acc)
            for dy in dys:
                rows = rows | plane[:, halo + dy:halo + th + dy]
                rows = rows | plane[:, halo - dy:halo + th - dy]
            for dx in dxs:
                acc = acc | _word_shift(rows, dx) | _word_shift(rows, -dx)
        return acc

    ring = dilate(planes["any"], MM_RING)
    clear = dilate(planes["end"], MM_D64) | dilate(planes["core"], MM_D16)
    tile = (ring & ~clear & WORD_MASK)[..., halo_words:halo_words + tww]
    out_bits = (tile[..., None] >> torch.arange(32)) & 1
    out = torch.zeros((nty * th, ntx * tww * 32), dtype=torch.int32)
    for t, (ty, tx) in enumerate(tiles):
        out[ty * th:(ty + 1) * th, tx * tww * 32:(tx + 1) * tww * 32] = (
            out_bits[t].reshape(th, tww * 32))
    return out[:h, :w]


def strong_labels(shape, density, seed):
    """(H,W) int32 strong-edge labels: positive labels with probability
    `density`, and 0 and -1 (not edges) beside them."""
    r = np.random.default_rng(seed)
    lab = r.integers(1, 900, shape)
    lab = np.where(r.random(shape) < density, lab, 0)
    lab = np.where(r.random(shape) < 0.1, -1, lab)
    return torch.from_numpy(lab.astype(np.int32))


def junctions_at_edges(h, w):
    """Chains on the first and last interior rows and columns (junctions
    there, none on the border ring), line ends whose 7-px clear disk
    crosses the 8-row and 32-px tile edges, crossings, and -1 and 0
    labels beside positive ones."""
    e = np.zeros((h, w), np.int32)
    e[1, 2:w - 2] = 3
    e[h - 2, 2:w - 2] = 4
    e[2:h - 2, 1] = 5
    e[2:h - 2, w - 2] = 6
    e[h // 2, 5:min(31, w - 3)] = 7      # ends at a word edge
    e[9:min(16, h - 3), 12] = 8         # starts just below a tile edge
    if w > 40:
        e[6:h - 6, 36] = 9              # crosses the row at h // 2
        e[h // 2, 36:w - 4] = 10
    e[h // 3, 2:w - 2] = np.where(np.arange(2, w - 2) % 5 == 0, -1, 11)
    e[0, :] = -1                        # the border ring is never a junction
    e[:, 0] = 12
    return torch.from_numpy(e)


@pytest.mark.parametrize("shape", [(5, 5), (37, 53), (9, 20), (41, 33),
                                   (29, 70)])
def test_merge_mask_word_schedule_matches_plain(shape):
    """csrc/merge_mask.cu's bit-word schedule, tiles of 8 rows x 1 and 2
    words and of the kernel's 64 rows x 2 words, is equal to regions.junction_merge_mask on labels > 0, 0
    and -1 at three densities (frames narrower than a word, and widths of
    33 and 70 whose words straddle the frame edge).  Mutation checks on a
    copy: fails with MM_HALO 7 (a row short: the d^2 < 64 disk reads a row
    the junction left stale) and when the junction's interior test takes
    tile coordinates."""
    for i, density in enumerate((0.1, 0.25, 0.5)):
        strong = strong_labels(shape, density, seed=70 + i + sum(shape))
        want = regions.junction_merge_mask(strong)
        for th, tww in ((8, 1), (8, 2), (64, 2)):
            got = merge_mask_words(strong, th, tww)
            assert torch.equal(got, want), (density, th, tww)


@pytest.mark.parametrize("shape", [(30, 50), (45, 97), (20, 33)])
def test_merge_mask_word_schedule_at_the_frame_and_tile_edges(shape):
    """Junctions on the first and last interior rows and columns, line
    ends whose clear disk crosses tile edges, -1 and 0 labels beside
    positive ones: equal to the plain version.  Mutation checks on a copy:
    fails with MM_HALO 7 (a row short), with MM_HALO_WORDS 0 (a word
    short: the dilations miss taps across the tile's side edges) and when
    the junction's interior test takes tile coordinates (the window's own
    origin in place of ys and x0s)."""
    strong = junctions_at_edges(*shape)
    want = regions.junction_merge_mask(strong)
    assert int(want.sum()) > 0
    for th, tww in ((8, 1), (8, 2), (16, 1)):
        assert torch.equal(merge_mask_words(strong, th, tww), want), (th,
                                                                      tww)


def test_merge_mask_row_unions_are_the_structuring_elements():
    """The kernel's row unions cover exactly the plain version's ring,
    d^2 < 64 and d^2 < 16 offsets (regions.RING_16_36, DISK_64, DISK_16;
    the runs of pallas_morph.py:_se_runs)."""
    for groups, offsets in ((MM_RING, regions.RING_16_36),
                            (MM_D64, regions.DISK_64),
                            (MM_D16, regions.DISK_16)):
        assert _element_offsets(groups) == set(map(tuple, offsets))
    assert MM_HALO == max(dy for _, dys in MM_D64 for dy in dys) + 1


# ---- seg_total (csrc/scan.cu): tile descriptors, look-back and forward --


def seg_total_tiled(key: torch.Tensor, val: torch.Tensor, cap: int,
                    tile: int = 8, resident: int = 3, lanes: int = 32,
                    skip_between: bool = False) -> torch.Tensor:
    """csrc/scan.cu's seg_total schedule.  A: blocks (min(tiles, resident)
    of them) walk tiles b, b + g, ...; each tile's exact prefix sums, its
    elements' last start at or before them and first start after them, and
    its descriptor (lead, trail or -1 without a start; sums saturated at
    cap).  B, after the barrier, each block's tiles in reverse: the
    carry-in from a look back to the nearest earlier tile with a start,
    the carry-out from a look forward to the nearest later one, `lanes`
    descriptors at a time; each element's total min(cap, run sum), at a
    run's first element at least its own value.  skip_between: the
    carry-out takes only the lead of the tile where the run ends, not
    those of the tiles between."""
    k = key.tolist()
    v = val.tolist()
    n = len(k)
    ntiles = -(-n // tile)
    blocks = min(ntiles, resident)

    def scan_tile(t):
        lo = t * tile
        st = [lo + j < n and (lo + j == 0 or k[lo + j] != k[lo + j - 1])
              for j in range(tile)]
        pre = [0]
        for j in range(tile):
            pre.append(pre[-1] + (v[lo + j] if lo + j < n else 0))
        last, cur = [], -1
        for j in range(tile):
            cur = j if st[j] else cur
            last.append(cur)
        nxt, cur = [0] * tile, tile
        for j in reversed(range(tile)):
            nxt[j] = cur
            cur = j if st[j] else cur
        starts = [j for j in range(tile) if st[j]]
        return pre, last, nxt, (starts[0] if starts else tile), \
            (starts[-1] if starts else -1)

    desc = [None] * ntiles
    for b in range(blocks):                       # A
        for t in range(b, ntiles, blocks):
            pre, _, _, first, lastst = scan_tile(t)
            has = first < tile
            desc[t] = (min(cap, pre[first] if has else pre[tile]),
                       min(cap, pre[tile] - pre[lastst]) if has else -1)

    def look_back(t):
        acc = 0
        for c in range(t - 1, -1, -lanes):
            chunk = [desc[tt] if tt >= 0 else (0, -1)
                     for tt in range(c, c - lanes, -1)]
            f = next((i for i, d in enumerate(chunk) if d[1] >= 0), lanes)
            part = sum(d[0] for d in chunk[:f])
            if f < lanes:
                part += chunk[f][1]
            acc = min(cap, acc + part)
            if f < lanes:
                return acc
        raise AssertionError("tile 0 has a start")

    def look_forward(t):
        acc = 0
        for c in range(t + 1, ntiles, lanes):
            chunk = [desc[tt] if tt < ntiles else (0, -1)
                     for tt in range(c, c + lanes)]
            f = next((i for i, d in enumerate(chunk) if d[1] >= 0), lanes)
            part = sum(d[0] for d in chunk[:f + 1])
            if skip_between and f < lanes:
                part = chunk[f][0]
            acc = min(cap, acc + part)
            if f < lanes:
                break
        return acc

    out = [None] * n
    for b in range(blocks):                       # B
        for t in reversed(range(b, ntiles, blocks)):
            pre, last, nxt, first, _ = scan_tile(t)
            carry_in = look_back(t) if first > 0 else 0
            carry_out = look_forward(t)
            for j in range(tile):
                i = t * tile + j
                if i >= n:
                    break
                s = pre[nxt[j]] - pre[max(last[j], 0)]
                if last[j] < 0:
                    s += carry_in
                if nxt[j] == tile:
                    s += carry_out
                s = min(cap, s)
                if last[j] == j:
                    s = max(s, pre[j + 1] - pre[j])
                out[i] = s
    return torch.tensor(out, dtype=torch.int32)


def _runs(lengths, vals):
    """Keys of the given run lengths (key = run number) and values."""
    key = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    return torch.from_numpy(key), torch.from_numpy(
        np.asarray(vals, dtype=np.int64).astype(np.int32))


def _seg_cases():
    r = np.random.default_rng(31)
    big = (1 << 31) - 1
    cases = {}
    # runs of 17-40 elements across three to six tiles of 8, short runs
    lengths = [3, 17, 1, 2, 40, 5, 24, 1, 9]
    cases["runs over three or more tiles"] = (
        *_runs(lengths, r.integers(0, 60, sum(lengths))), 5000)
    # a run that ends on a tile's last element, then one that starts on the
    # next tile's first; a run of exactly one tile
    lengths = [8, 8, 5, 3, 16, 1, 7]
    cases["runs ending and starting on tile edges"] = (
        *_runs(lengths, r.integers(0, 60, sum(lengths))), 5000)
    cases["one key throughout"] = (
        *_runs([203], r.integers(0, 9, 203)), 10 ** 6)
    cases["all keys distinct"] = (
        *_runs([1] * 77, r.integers(0, 500, 77)), 300)
    # the running sum reaches cap in the middle of the long runs; some
    # runs start with a value above cap (their total is that value)
    lengths = [30, 4, 1, 25, 2, 19]
    vals = r.integers(0, 90, sum(lengths))
    vals[34] = 400
    vals[35] = 500
    cases["saturating in mid-run"] = (*_runs(lengths, vals), 300)
    # sums past 2^31 in int64, the cap at the int32 maximum
    lengths = [12, 3, 26, 1, 6]
    cases["sums past 2^31"] = (
        *_runs(lengths, r.integers(1 << 28, big, sum(lengths))), big)
    # S not a multiple of the tile, and unsorted keys (runs of equal keys
    # in index order: key 5 returns after other keys)
    key = torch.tensor([5, 5, 2, 2, 2, 5, 5, 5, 5, 5, 5, 5, 1, 1, 7, 7, 7,
                        7, 7, 7, 7, 7, 7, 7, 7, 7, 5, 5, 5], dtype=torch.int32)
    cases["ragged and unsorted"] = (
        key, torch.from_numpy(r.integers(0, 40, key.shape[0])
                              .astype(np.int32)), 120)
    # the strength table's shape: a few hundred labelled rows, then the
    # tail of key n and value 0
    lengths = list(r.integers(1, 30, 12)) + [150]
    vals = np.r_[r.integers(0, 20, sum(lengths) - 150), np.zeros(150)]
    cases["a tail of one key and value 0"] = (*_runs(lengths, vals), 100)
    return cases


SEG_CASES = _seg_cases()


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_total_tiled_schedule_matches_plain(case):
    """csrc/scan.cu's one-launch seg_total, tiles of 8 and 5 elements,
    with one block, three blocks and as many blocks as tiles (3 resident
    blocks is fewer than the tiles of every case, so B rescans all but one
    of a block's tiles), look-backs of 32 and 2 descriptors at a time: equal to
    hopper_scan.seg_total_plain."""
    key, val, cap = SEG_CASES[case]
    want = hopper_scan.seg_total_plain(key, val, cap)
    for tile in (8, 5):
        for resident in (1, 3, 10 ** 6):
            for lanes in (32, 2):
                got = seg_total_tiled(key, val, cap, tile, resident, lanes)
                assert torch.equal(got, want), (tile, resident, lanes)


def test_seg_total_needs_the_tiles_between():
    """Mutation check: with the carry-out taking only the lead of the tile
    where a run ends (skipping the tiles in between), runs over three or
    more tiles get wrong totals."""
    key, val, cap = SEG_CASES["runs over three or more tiles"]
    want = hopper_scan.seg_total_plain(key, val, cap)
    assert torch.equal(seg_total_tiled(key, val, cap), want)
    assert not torch.equal(
        seg_total_tiled(key, val, cap, skip_between=True), want)


# ---- distinct_bids (csrc/distinct_bids.cu): row lists, bit-word skip -----

DB_HALO = 3
DB_TAPS = 2 * DB_HALO + 1
# the kernel's tile (kTileRows x kTileCols) and two larger ones
DB_TILES = ((8, 32), (16, 64), (32, 32))


def _insert(slots: list, b: torch.Tensor) -> None:
    """b joins the first free slot (0) of `slots` where it is positive and
    no slot holds it (oclrect.cl:441-447); in place."""
    fresh = b > 0
    for s in slots:
        fresh = fresh & (s != b)
    for i, s in enumerate(slots):
        put = fresh & (s == 0)
        slots[i] = torch.where(put, b, s)
        fresh = fresh & ~put


def distinct_bids_rows(boundary: torch.Tensor, th: int, tw: int,
                       list_len: int = 4, dy_order=range(DB_TAPS),
                       dilation: int = DB_HALO) -> torch.Tensor:
    """csrc/distinct_bids.cu's schedule, tile by tile: each th x tw tile
    staged with a 3-pixel halo (ids > 0, 0 elsewhere and outside the
    frame); per staged row and 32-pixel word the bit word of "the row's
    taps hold an id", the OR of the funnel shifts (A >> k | B << 32 - k)
    for k in 3 - dilation .. 3 + dilation of the word A and the 6 columns
    after it B; the row list (the first list_len distinct ids of the 7
    taps) where that bit is set; per pixel the OR of its 7 rows' bits,
    and where it is set the row lists of the rows whose bit is set merged
    in dy_order.  Returns (4, H, W) int32."""
    h, w = boundary.shape
    nty, ntx = -(-h // th), -(-w // tw)
    frame = torch.zeros((nty * th + 2 * DB_HALO, ntx * tw + 2 * DB_HALO),
                        dtype=torch.int64)
    frame[DB_HALO:DB_HALO + h, DB_HALO:DB_HALO + w] = boundary.clamp(min=0)
    tiles = [(ty, tx) for ty in range(nty) for tx in range(ntx)]
    win = torch.stack([frame[ty * th:ty * th + th + 2 * DB_HALO,
                             tx * tw:tx * tw + tw + 2 * DB_HALO]
                       for ty, tx in tiles])             # (T, R, tw + 6)
    lane = torch.arange(32, dtype=torch.int64)
    nz = (win > 0).to(torch.int64)
    row_bits = []
    for j in range(tw // 32):
        a = (nz[..., 32 * j:32 * j + 32] << lane).sum(-1)
        b = (nz[..., 32 * j + 32:32 * j + 32 + DB_TAPS - 1]
             << lane[:DB_TAPS - 1]).sum(-1)
        pair = (b << 32) | a
        d = torch.zeros_like(a)
        for k in range(DB_HALO - dilation, DB_HALO + dilation + 1):
            d = d | ((pair >> k) & WORD_MASK)
        row_bits.append((d[..., None] >> lane) & 1)
    bits = torch.cat(row_bits, -1).bool()                # (T, R, tw)
    lists = [torch.zeros_like(bits, dtype=torch.int64)
             for _ in range(list_len)]
    for k in range(DB_TAPS):
        _insert(lists, torch.where(bits, win[..., k:k + tw], 0))
    lists += [torch.zeros_like(lists[0])] * (4 - list_len)
    held = torch.zeros_like(bits[:, :th])
    for dy in range(DB_TAPS):
        held = held | bits[:, dy:dy + th]
    slots = [torch.zeros_like(held, dtype=torch.int64) for _ in range(4)]
    for dy in dy_order:
        take = held & bits[:, dy:dy + th]
        for entry in lists:
            _insert(slots, torch.where(take, entry[:, dy:dy + th], 0))
    out = torch.zeros((4, nty * th, ntx * tw), dtype=torch.int64)
    for t, (ty, tx) in enumerate(tiles):
        for i, s in enumerate(slots):
            out[i, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] = s[t]
    return out[:, :h, :w].to(torch.int32)


def id_map(shape, density, ids, seed):
    """(H,W) int32 boundary ids: positive ids from 1..ids with probability
    `density`, -1 (background) elsewhere."""
    r = np.random.default_rng(seed)
    b = np.where(r.random(shape) < density, r.integers(1, ids + 1, shape), -1)
    return torch.from_numpy(b.astype(np.int32))


def bid_windows(h, w):
    """Hand-built windows: a row of 7 distinct ids, ids that repeat across
    rows, a fifth id that first comes in a later row, lone ids 3 columns
    from their neighbours, ids across the 32- and 64-pixel tile edges, ids
    on the frame border, and -1 beside positive ids everywhere else."""
    b = np.full((h, w), -1, np.int32)
    b[5, 10:17] = np.arange(1, 8)               # more than 4 in one row
    b[15:18, 10:13] = 8                         # repeats across rows
    b[16, 12] = 9
    b[25, 10:12] = (11, 12)                     # 11..14, then a fifth id
    b[26, 10:12] = (13, 14)
    b[27, 11:13] = (15, 11)
    b[35, 40] = 16                              # alone: dx = 3 reaches it
    b[35, 46] = 17
    b[9:12, 30:34] = ((20, 21, 22, 23), (24, 20, 25, 21), (26, 27, 28, 29))
    b[14:18, 62:67] = 30 + np.arange(20).reshape(4, 5)
    b[0, 0], b[0, w - 1], b[h - 1, 0], b[h - 1, w - 1] = 40, 41, 42, 43
    b[h - 1, w // 2:w // 2 + 5] = (44, 45, 44, 46, 47)
    b[1:h - 1, w - 2] = np.where(np.arange(1, h - 1) % 3 == 0, 48, -1)
    return torch.from_numpy(b)


@pytest.mark.parametrize("shape", [(1, 1), (7, 7), (37, 53), (70, 33)])
def test_distinct_bids_row_lists_match_plain(shape):
    """csrc/distinct_bids.cu's row-list schedule, at the kernel's 8 x 32
    tile and at 16 x 64 and 32 x 32, equal to distinct_bids_plain element
    for element on sparse ids, dense ids with many repeats and dense ids
    all distinct, on sides that are not multiples of the tiles."""
    for i, (density, ids) in enumerate(((0.03, 40), (0.6, 5),
                                        (0.8, 10 ** 6))):
        boundary = id_map(shape, density, ids, seed=90 + i + sum(shape))
        want = torch.stack(hopper_bids.distinct_bids_plain(boundary))
        for th, tw in DB_TILES:
            got = distinct_bids_rows(boundary, th, tw)
            assert torch.equal(got, want), (density, th, tw)


@pytest.mark.parametrize("shape", [(40, 70), (45, 97)])
def test_distinct_bids_row_lists_on_hand_built_windows(shape):
    """Rows with more than 4 distinct ids, ids repeated across rows, a
    fifth id first met in a later row, ids across tile edges and on the
    frame border, -1 beside positive ids: the schedule equals the plain
    version and fills all 4 slots somewhere."""
    boundary = bid_windows(*shape)
    want = torch.stack(hopper_bids.distinct_bids_plain(boundary))
    assert int((want[3] > 0).sum()) > 0
    for th, tw in DB_TILES:
        assert torch.equal(distinct_bids_rows(boundary, th, tw), want), (th,
                                                                         tw)


@pytest.mark.parametrize("mutation", [
    {"list_len": 3}, {"dy_order": range(DB_TAPS - 1, -1, -1)},
    {"dilation": 2}])
def test_distinct_bids_row_lists_mutations_fail(mutation):
    """Mutation checks: a row list of 3 ids, the merge in reverse dy order
    and the skip's bit words dilated by 2 columns in place of 3 each give
    other slots than the plain version on the hand-built windows."""
    boundary = bid_windows(40, 70)
    want = torch.stack(hopper_bids.distinct_bids_plain(boundary))
    assert torch.equal(distinct_bids_rows(boundary, 8, 32), want)
    assert not torch.equal(distinct_bids_rows(boundary, 8, 32, **mutation),
                           want)


# ---- edge_front (csrc/edge_front.cu): staged tiles, quantized once --------

EF_HALO = 2
EF_PAD = 4
# the kernel's tile (kTileRows x kTileCols: 4 rows of threads x 4 rows
# each, 64 columns) and two others
EF_TILES = ((16, 64), (32, 32), (8, 32))
EF_LATTICE = ((4096.0, 4095.0), (1024.0, 1023.0), (1024.0, 1023.0))


def quant_by_inverse(x: torch.Tensor, scale: float, hi: float):
    """The kernel's quantize: (q + 0.5) times 1 / scale."""
    q = torch.clamp(torch.floor(x * scale), min=0.0, max=hi)
    return (q + 0.5) * (1.0 / scale)


def edge_front_tiled(labb: torch.Tensor, th: int, tw: int,
                     reflect: bool = True):
    """csrc/edge_front.cu's schedule: each th x tw tile staged with 2 rows
    above and below and 4 columns on each side (whole 4-pixel quads),
    staged row r and column c being frame row mirror(min(y0 - 2 + r,
    h + 1)) and column mirror(min(max(x0 - 4 + c, -2), w + 1))
    (reflect-101; clamped to the frame where reflect is False), each
    staged pixel quantized once and the L plane also kept raw; vec and em
    from the staged planes in the plain version's operation order
    (ops/fp.py's fused multiply-adds).  Returns (em, vec)."""
    h, w, _ = labb.shape
    nty, ntx = -(-h // th), -(-w // tw)

    def staged(n, tile, count, pad):
        i = (torch.arange(count)[:, None] * tile - pad
             + torch.arange(tile + 2 * pad)[None, :]).clamp(-2, n + 1)
        if not reflect:
            return i.clamp(0, n - 1)
        return torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))

    gy = staged(h, th, nty, EF_HALO)
    gx = staged(w, tw, ntx, EF_PAD)
    win = labb[gy[:, None, :, None], gx[None, :, None, :]]
    raw = win[..., 0]
    qnt = [quant_by_inverse(win[..., c], *EF_LATTICE[c]) for c in range(3)]

    def tap(plane, dy, dx):
        return plane[..., EF_HALO + dy:EF_HALO + dy + th,
                     EF_PAD + dx:EF_PAD + dx + tw]

    tx, ty = [], []
    for yy in range(-2, 3):
        for xx in range(-2, 3):
            cx, cy = gradient.V5C[yy + 2][xx + 2], gradient.V5C[xx + 2][yy + 2]
            if cx != 0.0:
                tx.append((cx, tap(raw, yy, xx)))
            if cy != 0.0:
                ty.append((cy, tap(raw, yy, xx)))
    vx, vy = fp.dot_chain(tx), fp.dot_chain(ty)
    ivlen = fp.fma(vx, vx, vy * vy)
    rs = gradient._rsqrt(ivlen)
    big = ivlen > 1e-10
    half = torch.full_like(vx, gradient.SQRT_HALF)
    vec = torch.stack([torch.where(big, vx * rs, half),
                       torch.where(big, vy * rs, half)], -1)
    total = None
    for q in qnt:
        def n(dy, dx, q=q):
            return tap(q, dy, dx)
        t0 = n(-1, 0) + n(0, -1) - n(1, 0) - n(0, 1)
        t1 = n(-1, 0) - n(0, -1) + n(0, 1) - n(1, 0)
        s1 = (n(-1, 1) - n(1, -1)) * t1
        v = torch.clamp(fp.fma(n(-1, -1) - n(1, 1), t0, s1), min=0.0)
        total = v if total is None else total + v
    em = torch.where(total > 0, fp.sqrt(total), torch.zeros_like(total))
    em = em.permute(0, 2, 1, 3).reshape(nty * th, ntx * tw)[:h, :w]
    vec = vec.permute(0, 2, 1, 3, 4).reshape(nty * th, ntx * tw, 2)[:h, :w]
    return em, vec


def blurred_lab(shape, seed):
    """(H,W,3) float32 planes like the blurred Lab: smooth ramps, flat
    blocks (|v|^2 <= 1e-10 there), values on the lattice's level edges
    and noise."""
    h, w = shape
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.stack([0.3 + 0.4 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0)
                    for c in range(3)], -1)
    lab += r.normal(0, 0.02, lab.shape)
    lab[h // 3:h // 3 + 6, w // 4:w // 4 + 9] = 0.5
    edge = r.random((h, w)) < 0.1
    lab[edge, 0] = r.integers(0, 4096, int(edge.sum())) / 4096.0
    lab[edge, 1] = r.integers(0, 1024, int(edge.sum())) / 1024.0
    return torch.from_numpy(lab.astype(np.float32))


@pytest.mark.parametrize("shape", [(3, 3), (5, 7), (37, 53), (32, 64),
                                   (33, 65)])
def test_edge_front_staged_tiles_bit_equal_to_plain(shape):
    """csrc/edge_front.cu's staged-tile schedule (reflect-101 while
    staging, each staged pixel quantized once by the inverse scale) at the
    kernel's 16 x 64 tile, 32 x 32 and 8 x 32, in the plain version's
    operation order: bit-equal to edge_front_plain, on frames smaller
    than the halo, with ragged tiles and on whole and one-past-whole
    tiles."""
    labb = blurred_lab(shape, seed=sum(shape))
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    for th, tw in EF_TILES:
        em, vec = edge_front_tiled(labb, th, tw)
        assert torch.equal(em, em_p), (th, tw)
        assert torch.equal(vec, vec_p), (th, tw)


def test_edge_front_staged_tiles_need_reflect_101():
    """Mutation check: staging that clamps to the frame's edge in place
    of reflecting gives other outputs at the border."""
    labb = blurred_lab((37, 53), seed=5)
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    em, vec = edge_front_tiled(labb, 16, 64, reflect=False)
    assert not (torch.equal(em, em_p) and torch.equal(vec, vec_p))
    inner = (slice(2, -2), slice(2, -2))
    assert torch.equal(em[inner], em_p[inner])


def test_quantize_by_the_inverse_scale_is_exact():
    """For every q in [0, 4095] and both of the lattice's scales, float32
    (q + 0.5) / scale == (q + 0.5) * (1 / scale): q + 0.5 is exact and the
    scale a power of two.  Mutation check: with a scale of 1000 the two
    differ for some q."""
    q = torch.arange(4096, dtype=torch.float32) + 0.5
    for scale in (4096.0, 1024.0):
        assert torch.equal(q / scale, q * (1.0 / scale)), scale
    assert not torch.equal(q / 1000.0, q * (1.0 / 1000.0))

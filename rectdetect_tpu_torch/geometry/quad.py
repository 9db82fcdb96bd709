"""Quad hypothesis reduction, batched (port of
rectdetect_tpu/geometry/quad.py), the plain version of kernel #15.

The reference reduces each candidate segment group to a quad on the CPU
(oclrect.c:1134-1151): removeShortLS -> pickExternalLS (hull + a pick per
hull edge) -> pickLongestLS(4) -> sortByAngle -> findCorners ->
triangle, perimeter and convexity checks.  Here every step runs on (G, K)
tensors at once, without vmap, keeping the JAX package's tie rules:
argmax takes the first maximum, every argsort is stable, and the hull's
two thresholds are both required.

Each group's segments are held as four (G, K) planes (e0x, e0y, e1x,
e1y).  The float operations follow the JAX expressions one by one, each
rounded to float32 (square roots correctly rounded, `fp.sqrt`), and the
short sums over hull slots and corners run left to right, as the CUDA
kernel (ops/hopper_hyp.py, csrc/hyp.cu) runs them; the jitted JAX function
may fuse multiply-adds and associate its reductions otherwise, which moves
the corners by about an ulp (`ok` is equal on the tested corpora).
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import fp

BIG = 1e30
SHORT_RATIO = 0.05
_EPS = fp.f32(1e-20)


def _planes(segs: torch.Tensor):
    """(G,K,2,2) -> e0x, e0y, e1x, e1y, each (G,K)."""
    return segs[..., 0, 0], segs[..., 0, 1], segs[..., 1, 0], segs[..., 1, 1]


def _sq_len(e0x, e0y, e1x, e1y):
    dx = e1x - e0x
    dy = e1y - e0y
    return dx * dx + dy * dy


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx)


def _stable_rank_desc(score: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of i in argsort(-score), stable."""
    order = torch.argsort(-score, dim=-1, stable=True)
    ar = torch.arange(score.shape[-1], device=score.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def remove_short(sq: torch.Tensor, valid: torch.Tensor,
                 ratio: float = SHORT_RATIO) -> torch.Tensor:
    """removeShortLS (oclrect.c:926-943): drop segments shorter than ratio x
    the longest, but keep the 4 longest; nothing is dropped where at most 4
    are valid.  sq: (G,K) squared lengths.  Returns the new valid mask."""
    n_valid = valid.sum(-1, keepdim=True)
    sqm = torch.where(valid, sq, -1.0)
    longest = sqm.max(-1, keepdim=True).values
    passes = sqm > fp.f32(ratio * ratio) * longest
    keep = valid & (passes | (_stable_rank_desc(sqm) < 4))
    return torch.where(n_valid <= 4, valid, keep)


def jarvis_hull(px: torch.Tensor, py: torch.Tensor, pvalid: torch.Tensor,
                max_vertices: int):
    """Convex hull by gift wrapping (the stand-in for quickHull2,
    oclrect.c:697-734), from the rightmost point (lowest index on a tie).
    px, py, pvalid: (G,P).  Returns (idx (G,H), hull_valid (G,H)), H =
    max_vertices; a group's valid vertices are a prefix, idx 0 elsewhere.

    The next vertex is the farthest candidate with no other point
    strictly to its left, where "strictly" needs both thresholds: the
    sine of the angle above 1e-5 and the perpendicular distance above
    0.1 px (quad.py:83-94 says why)."""
    g = px.shape[0]
    x = torch.where(pvalid, px, -BIG)
    start = torch.argmax(x, dim=-1, keepdim=True)        # (G,1)
    cur = start
    done = torch.zeros((g, 1), dtype=torch.bool, device=px.device)
    out = [start]
    for _ in range(max_vertices - 1):
        relx = px - _take(px, cur)
        rely = py - _take(py, cur)
        dist = relx * relx + rely * rely
        cand_ok = pvalid & (dist > fp.f32(1e-12))
        cross = relx[:, :, None] * rely[:, None, :] - \
            rely[:, :, None] * relx[:, None, :]          # (G, i, j)
        norm = fp.sqrt(torch.clamp_min(dist[:, :, None] * dist[:, None, :],
                                       _EPS))
        thr = torch.maximum(
            fp.f32(1e-5) * norm,
            (fp.f32(0.1) * fp.sqrt(torch.clamp_min(dist, _EPS)))[:, :, None])
        has_left = ((cross > thr) & cand_ok[:, None, :]).any(-1)
        good = cand_ok & ~has_left
        nxt = torch.argmax(torch.where(good, dist, -1.0), dim=-1,
                           keepdim=True)
        any_good = good.any(-1, keepdim=True)
        ok = any_good & ~done & (nxt != start)
        done = done | ~any_good | (nxt == start)
        out.append(torch.where(ok, nxt, -1))
        cur = torch.where(ok, nxt, cur)
        if bool(done.all()):
            # every later step gives -1
            out += [torch.full_like(start, -1)] * (max_vertices - len(out))
            break
    idx = torch.cat(out, dim=-1)
    hull_valid = idx >= 0
    return torch.where(hull_valid, idx, 0), hull_valid


def pick_external(e0x, e0y, e1x, e1y, sq, valid, max_vertices: int):
    """pickExternalLS (oclrect.c:945-992): the hull of all endpoints; for
    each hull edge, the longest segment not picked yet that hugs it (its
    midpoint within 1 px) or parallels it.  Returns picks (G,H) int64,
    segment indices or -1."""
    g, k = e0x.shape
    px = torch.stack([e0x, e1x], dim=-1).reshape(g, 2 * k)
    py = torch.stack([e0y, e1y], dim=-1).reshape(g, 2 * k)
    pvalid = valid.repeat_interleave(2, dim=-1)
    hidx, hvalid = jarvis_hull(px, py, pvalid, max_vertices)
    qx, qy = _take(px, hidx), _take(py, hidx)
    nh = hvalid.sum(-1, keepdim=True)
    ar = torch.arange(max_vertices, device=px.device)
    succ = torch.where(ar + 1 < nh, ar + 1, 0)
    qnx, qny = _take(qx, succ), _take(qy, succ)

    de_den = torch.clamp_min(fp.sqrt(sq), _EPS)
    dex = (e0x - e1x) / de_den
    dey = (e0y - e1y) / de_den
    dx = e1x - e0x
    dy = e1y - e0y
    l2 = dx * dx + dy * dy
    l2_den = torch.clamp_min(l2, _EPS)
    picked = torch.zeros_like(valid)
    arange_k = torch.arange(k, device=px.device)
    picks = torch.full((g, max_vertices), -1, dtype=torch.int64,
                       device=px.device)
    for i in range(int(nh.max())):        # hull slots past nh pick nothing
        q0x, q0y = qx[:, i:i + 1], qy[:, i:i + 1]
        q1x, q1y = qnx[:, i:i + 1], qny[:, i:i + 1]
        mx = (q0x + q1x) * 0.5
        my = (q0y + q1y) * 0.5
        # closestPointLS2 (oclrect.c:408-416)
        t = ((mx - e0x) * dx + (my - e0y) * dy) / l2_den
        t = torch.clamp(torch.where(l2 > 0, t, 0.0), 0.0, 1.0)
        dmx = mx - (e0x + t * dx)
        dmy = my - (e0y + t * dy)
        dm = dmx * dmx + dmy * dmy
        close = dm < 1.0
        qdx = q0x - q1x
        qdy = q0y - q1y
        qsq = qdx * qdx + qdy * qdy
        qn = torch.clamp_min(fp.sqrt(qsq), _EPS)
        para = (torch.abs((qdx / qn) * dex + (qdy / qn) * dey)
                > fp.f32(0.95)) & \
            (dm / torch.clamp_min(qsq, _EPS) < fp.f32(0.01))
        ok = valid & ~picked & (close | para) & hvalid[:, i:i + 1]
        j = torch.argmax(torch.where(ok, sq, -1.0), dim=-1, keepdim=True)
        any_ok = ok.any(-1, keepdim=True)
        picks[:, i:i + 1] = torch.where(any_ok, j, -1)
        picked = picked | (any_ok & (arange_k == j))
    return picks


def _chain_sum(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def reduce_groups(segs: torch.Tensor, valid: torch.Tensor,
                  max_vertices: int = 24):
    """Batched reduction: segs (G,K,2,2) float32, valid (G,K) bool ->
    (corners (G,4,2) float32, ok (G,) bool)."""
    e0x, e0y, e1x, e1y = _planes(segs)
    sq = _sq_len(e0x, e0y, e1x, e1y)
    valid = remove_short(sq, valid & (sq > 0))
    picks = pick_external(e0x, e0y, e1x, e1y, sq, valid, max_vertices)

    # pickLongestLS(4) (oclrect.c:994-1009)
    pv = picks >= 0
    pidx = torch.where(pv, picks, 0)
    psq = _take(sq, pidx)
    plens = torch.where(pv, fp.sqrt(psq), 0.0)
    len0 = _chain_sum(plens.unbind(-1))
    order = torch.argsort(-torch.where(pv, psq, -1.0), dim=-1, stable=True)
    top4 = _take(pidx, order[:, :4])
    enough = pv.sum(-1) >= 4
    s0x, s0y, s1x, s1y = (_take(p, top4) for p in (e0x, e0y, e1x, e1y))

    # gv (oclrect.c:864-877): the length-weighted midpoint mean
    l4 = fp.sqrt(_take(sq, top4))
    lsum = torch.clamp_min(_chain_sum(l4.unbind(-1)), _EPS)
    gvx = _chain_sum(((s0x + s1x) * 0.5 * l4).unbind(-1)) / lsum
    gvy = _chain_sum(((s0y + s1y) * 0.5 * l4).unbind(-1)) / lsum

    # sortByAngle (oclrect.c:821-862).  The flip negates v: +0.0 becomes
    # -0.0, and atan2(-0, -x) = -pi where atan2(+0, -x) = +pi, which
    # axis-aligned segments reach (pallas_hyp.py:347-354)
    vx = s0y - s1y
    vy = -(s0x - s1x)
    flip = (vx * (s0x - gvx[:, None]) + vy * (s0y - gvy[:, None])) < 0
    vx = torch.where(flip, -vx, vx)
    vy = torch.where(flip, -vy, vy)
    order = torch.argsort(torch.atan2(vx, vy), dim=-1, stable=True)
    u0x, u0y, u1x, u1y = (_take(p, order) for p in (s0x, s0y, s1x, s1y))

    # findCorners (oclrect.c:1011-1045): corner i = edge i x edge i+1
    v0x, v0y, v1x, v1y = (torch.roll(p, -1, dims=-1)
                          for p in (u0x, u0y, u1x, u1y))
    d = (v1x - v0x) * (u1y - u0y) - (v1y - v0y) * (u1x - u0x)
    cok = (torch.abs(d) >= fp.f32(1e-4)).all(-1)
    n = (v0y - u0y) * (u1x - u0x) - (v0x - u0x) * (u1y - u0y)
    qq = n / torch.where(torch.abs(d) < fp.f32(1e-4), 1.0, d)
    cx = v0x + qq * (v1x - v0x)
    cy = v0y + qq * (v1y - v0y)
    nx, ny = torch.roll(cx, -1, dims=-1), torch.roll(cy, -1, dims=-1)
    ex, ey = nx - cx, ny - cy                   # corner segment i
    len1 = _chain_sum(fp.sqrt(ex * ex + ey * ey).unbind(-1))

    # closeToTriangle (oclrect.c:886-895): corner i+1 against the line
    # corner i -> corner i+2
    n2x, n2y = torch.roll(cx, -2, dims=-1), torch.roll(cy, -2, dims=-1)
    ddx, ddy = n2x - cx, n2y - cy
    l2 = ddx * ddx + ddy * ddy
    t = ((nx - cx) * ddx + (ny - cy) * ddy) / torch.clamp_min(l2, _EPS)
    t = torch.where(l2 > 0, t, 0.0)
    rx = nx - (cx + t * ddx)
    ry = ny - (cy + t * ddy)
    d0 = rx * rx + ry * ry
    bx, by = cx - n2x, cy - n2y
    d1 = bx * bx + by * by
    tri = (d0 / torch.clamp_min(d1, _EPS) < fp.f32(0.001)).any(-1)

    # isConvex (oclrect.c:897-922)
    enx, eny = torch.roll(ex, -1, dims=-1), torch.roll(ey, -1, dims=-1)
    cr = ex * eny - ey * enx
    convex = ((cr > 0) == (cr[:, :1] > 0)).all(-1)

    ok = enough & cok & ~tri & (len1 <= 2.0 * len0) & convex
    return torch.stack([cx, cy], dim=-1), ok

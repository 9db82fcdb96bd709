"""The polyline stage (oclpolyline_execute, oclpolyline.c:218-309): strings
morphology, chain labels with loops broken, arc-length numbering from the
canonical chain end, arc labels, the size filter, mkpl's subdivision
(oclpolyline.cl:439-646) and refine (:680-809).  Segment lists grow: no
capacity."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import dijkstra

from portbench.reference.upstream.grid import (RX, RY, components, interior,
                                                label_components,
                                                least_index_labels, shifted)

MINEDGELEN = 1.0
MINNINDEX = 4
FIX = 65536.0
N_ITERS = 16


class Segments(NamedTuple):
    """Segment table, index 0 unused; float64 end points."""
    sx: np.ndarray
    sy: np.ndarray
    ex: np.ndarray
    ey: np.ndarray
    si: np.ndarray
    ei: np.ndarray
    left: np.ndarray
    right: np.ndarray
    polyid: np.ndarray
    count: int


# ---- strings morphology (oclpolyline.cl:60-147) ----------------------------

def _neighbours(nz: np.ndarray) -> np.ndarray:
    return sum(shifted(nz, RY[i], RX[i], False).astype(np.int64)
               for i in range(8))


def simple_junction(img: np.ndarray, positive_only=False) -> np.ndarray:
    nz = img > 0 if positive_only else img != 0
    h, w = img.shape
    cnt = 1 + _neighbours(nz)
    return np.where(nz & interior(h, w, 1) & (cnt != 1), cnt, 0)


# simpleConnect's bridge patterns: (offset nonzero, offset == 2,
# offset == 2, offset nonzero), offsets (dy, dx)
_BRIDGES = (
    ((0, -2), (0, -1), (0, 1), (0, 2)),
    ((-2, 0), (-1, 0), (1, 0), (2, 0)),
    ((-2, -2), (-1, -1), (1, 1), (2, 2)),
    ((-2, 2), (-1, 1), (1, -1), (2, -2)),
    ((0, 2), (0, 1), (1, -1), (1, -2)),
    ((0, -2), (0, -1), (1, 1), (1, 2)),
    ((-2, 1), (-1, 1), (1, 0), (2, 0)),
    ((-2, -1), (-1, -1), (1, 0), (2, 0)),
)


def simple_connect_poly(jn: np.ndarray) -> np.ndarray:
    h, w = jn.shape
    nz, two = jn != 0, jn == 2
    hit = nz.copy()
    for a, b, c, d in _BRIDGES:
        hit |= (shifted(nz, *a, False) & shifted(two, *b, False)
                & shifted(two, *c, False) & shifted(nz, *d, False))
    return (hit & interior(h, w, 2)).astype(np.int64)


def stringify(img: np.ndarray, parity: int) -> np.ndarray:
    h, w = img.shape
    nz = img != 0
    n, s = shifted(nz, -1, 0, False), shifted(nz, 1, 0, False)
    wv, e = shifted(nz, 0, -1, False), shifted(nz, 0, 1, False)
    yy, xx = np.indices((h, w))
    drop = (((xx + yy) & 1) == parity) & interior(h, w, 1) & \
        ((n & wv) | (n & e) | (s & wv) | (s & e))
    return np.where(drop, 0, img)


def remove_branch(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    nz = img != 0
    return (nz & interior(h, w, 1) & (_neighbours(nz) <= 2)).astype(np.int64)


# ---- chains (oclpolyline.cl:149-310) ---------------------------------------

def break_loops(edge, label):
    """countEnds + breakLoops: a chain with no end loses its root pixel."""
    h, w = label.shape
    inner = interior(h, w, 1)
    jn = simple_junction(edge)
    ends = np.bincount(label[inner & (jn == 2) & (label >= 0)],
                       minlength=h * w)
    flat = np.arange(h * w).reshape(h, w)
    drop = inner & (label == flat) & (ends[np.maximum(label, 0)] == 0)
    return np.where(drop, 0, edge), np.where(drop, -1, label)


def arc_number(label: np.ndarray) -> np.ndarray:
    """Index along each chain from its least-index end (getnp's first two
    same-label neighbours are a pixel's links; a chain with no end stays
    0)."""
    h, w = label.shape
    lab = label.reshape(-1)
    p = np.flatnonzero((label >= 0) & interior(h, w, 1))
    n0, n1, found = p.copy(), p.copy(), np.zeros(len(p), np.int64)
    for i in range(8):
        q = p + RX[i] + RY[i] * w
        m = lab[q] == lab[p]
        n0 = np.where(m & (found == 0), q, n0)
        n1 = np.where(m & (found == 1), q, n1)
        found += m
    node = np.full(h * w, -1, np.int64)
    node[p] = np.arange(len(p))
    a = np.concatenate([np.arange(len(p))] * 2)
    b = node[np.concatenate([n0, n1])]
    comp = components(len(p), a, b)
    is_end = (n0 == p) | (n1 == p)
    big = np.iinfo(np.int64).max
    head = np.full(comp.max() + 1 if len(p) else 0, big)
    ends = np.flatnonzero(is_end)
    np.minimum.at(head, comp[ends], ends)
    heads = head[head < big]
    # distances from one source joined to every head
    src = len(p)
    keep = a != b
    ga = np.concatenate([a[keep], np.full(len(heads), src)])
    gb = np.concatenate([b[keep], heads])
    g = coo_matrix((np.ones(len(ga)), (ga, gb)), shape=(src + 1, src + 1))
    dist = dijkstra(g, directed=False, indices=src, unweighted=True)[:src]
    number = np.zeros(h * w, np.int64)
    reach = np.isfinite(dist)
    number[p[reach]] = dist[reach].astype(np.int64) - 1
    return number.reshape(h, w)


def label_arcs(number: np.ndarray) -> np.ndarray:
    """labelpl: pixels with number > 0 joined to 8-neighbours whose number
    differs by at most 1; 0 elsewhere."""
    h, w = number.shape
    mask = (number > 0) & interior(h, w, 1)
    out = least_index_labels(
        mask, lambda dy, dx: np.abs(shifted(number, dy, dx) - number) <= 1)
    return np.maximum(out, 0)


def filter_and_relabel(arcs: np.ndarray, size_thre: int):
    """calcSize, filterSize and relabel: arcs of more than size_thre pixels
    numbered 1.. in order of their label."""
    roots, inv, counts = np.unique(arcs, return_inverse=True,
                                   return_counts=True)
    keep = (counts > size_thre) & (roots != 0)
    dense = np.cumsum(keep) * keep
    out = dense[inv.reshape(-1)].reshape(arcs.shape)
    out[0, :] = out[-1, :] = 0
    out[:, 0] = out[:, -1] = 0
    return out, int(keep.sum())


# ---- mkpl (oclpolyline.cl:439-646) -----------------------------------------

def mkpl(label: np.ndarray, number: np.ndarray, minerror: float,
         n_iters: int = N_ITERS):
    """Subdivide each arc into segments: pass0a/0b make one segment an
    arc, then each pass splits every segment whose farthest pixel lies
    farther than the error allows at that pixel.  Returns (Segments, the
    segment id per pixel)."""
    h, w = label.shape
    pix = np.flatnonzero(label.reshape(-1) > 0)      # raster order
    g = label.reshape(-1)[pix].astype(np.int64)
    n = number.reshape(-1)[pix].astype(np.int64)
    x, y = (pix % w).astype(np.float64), (pix // w).astype(np.float64)
    count = int(g.max()) if len(g) else 0
    size = count + len(pix) + 2
    sx, sy, ex, ey = (np.zeros(size) for _ in range(4))
    si, ei, left, right, polyid, sc, ec = (np.zeros(size, np.int64)
                                           for _ in range(7))
    one = n == 1
    sc += np.bincount(g[one], minlength=size)
    last = np.full(size, -1, np.int64)
    np.maximum.at(last, g[one], pix[one])
    has = last >= 0
    sx[has], sy[has] = last[has] % w, last[has] // w
    npix = np.bincount(g, minlength=size)
    np.maximum.at(ei, g, n)
    at_end = n == ei[g]
    ok = (sc == 1) & (npix >= 2)
    ec += np.bincount(g[at_end], minlength=size) * ok
    first = np.full(size, np.iinfo(np.int64).max)
    np.minimum.at(first, g[at_end], pix[at_end])
    live = ok & (first < np.iinfo(np.int64).max)
    ex[live], ey[live] = first[live] % w, first[live] // w
    polyid[live] = np.arange(size)[live]

    minerr_fix = int(minerror * FIX)
    for _ in range(n_iters - 1):
        on = polyid[g] != 0
        gg, px, py, pp = g[on], x[on], y[on], pix[on]
        vx, vy, wx, wy = sx[gg], sy[gg], ex[gg], ey[gg]
        l2 = (vx - wx) ** 2 + (vy - wy) ** 2
        with np.errstate(invalid="ignore", divide="ignore"):
            t = ((px - vx) * (wx - vx) + (py - vy) * (wy - vy)) / l2
        t = np.minimum(np.maximum(t, 0.0), 1.0)
        short = l2 <= 1e-4
        cx = np.where(short, vx, vx + t * (wx - vx))
        cy = np.where(short, vy, vy + t * (wy - vy))
        d = (np.hypot((cx - px).astype(np.float32),
                      (cy - py).astype(np.float32))
             * np.float32(65536)).astype(np.int64)
        maxd = np.full(size, -1, np.int64)
        np.maximum.at(maxd, gg, d)
        winner = np.full(size, h * w, np.int64)
        top = d == maxd[gg]
        np.minimum.at(winner, gg[top], pp[top])

        ids = np.arange(1, count + 1)
        md = maxd[ids]
        wpx = winner[ids]
        wxx, wyy = (wpx % w).astype(np.float64), (wpx // w).astype(np.float64)
        chord_sq = (sx[ids] - ex[ids]) ** 2 + (sy[ids] - ey[ids]) ** 2
        mdf = md.astype(np.float64)
        split = (polyid[ids] != 0) & (wpx < h * w) \
            & (ei[ids] - si[ids] >= MINNINDEX - 1) \
            & (sc[ids] <= 1) & (ec[ids] <= 1) & (md >= minerr_fix) \
            & ~((md < minerror * 3 * 65536)
                & (mdf * mdf / np.maximum(chord_sq, 1e-30) < 100000.0)) \
            & ((wxx - sx[ids]) ** 2 + (wyy - sy[ids]) ** 2
               >= MINEDGELEN ** 2) \
            & ((wxx - ex[ids]) ** 2 + (wyy - ey[ids]) ** 2
               >= MINEDGELEN ** 2)
        old = ids[split]
        if len(old):
            new = count + np.arange(1, len(old) + 1)
            ww = winner[old]
            n_w = number.reshape(-1)[ww]
            wfx, wfy = (ww % w).astype(np.float64), (ww // w).astype(np.float64)
            o_right = right[old].copy()
            si[new], ei[new] = n_w, ei[old]
            sx[new], sy[new] = wfx, wfy
            ex[new], ey[new] = ex[old], ey[old]
            left[new], right[new] = old, o_right
            polyid[new] = polyid[old]
            ei[old] = n_w
            ex[old], ey[old] = wfx, wfy
            right[old] = new
            has_r = o_right != 0
            left[o_right[has_r]] = new[has_r]
            count += len(old)

        on = polyid[g] != 0
        move = on & (ei[g] < n)
        g = np.where(move, right[g], g)
    lab = np.zeros(h * w, np.int64)
    lab[pix] = g
    return (Segments(sx, sy, ex, ey, si, ei, left, right, polyid, count),
            lab.reshape(h, w))


def refine(segs: Segments, lab: np.ndarray) -> Segments:
    """Least-squares refit of each live segment to its pixels, then each
    joint snapped to the crossing of its two segments, from the refitted
    coordinates (the deterministic form of refine_pass3)."""
    h, w = lab.shape
    count = segs.count
    sx, sy, ex, ey = (a.copy() for a in segs[:4])
    size = len(sx)
    flat = lab.reshape(-1)
    pix = np.flatnonzero((flat > 0) & (flat <= count))
    g = flat[pix]
    dirx, diry = np.rint(ex - sx), np.rint(ey - sy)
    vx = pix % w - np.rint(sx[g]).astype(np.int64)
    vy = pix // w - np.rint(sy[g]).astype(np.int64)
    ax0 = vx * dirx[g] + vy * diry[g]
    ay = -vx * diry[g] + vy * dirx[g]
    ax1 = dirx[g] ** 2 + diry[g] ** 2

    def acc(v):
        return np.bincount(g, weights=v, minlength=size)
    mx00, mx01, mx11 = acc(ax0 * ax0), acc(ax0 * ax1), acc(ax1 * ax1)
    my0, my1 = acc(ax0 * ay), acc(ax1 * ay)
    ids = np.arange(1, count + 1)
    rdet = mx00[ids] * mx11[ids] - mx01[ids] * mx01[ids]
    fit = (segs.polyid[ids] != 0) & (rdet != 0)
    i = ids[fit]
    r = rdet[fit]
    as0 = (mx11[i] * my0[i] - mx01[i] * my1[i]) / r
    as1 = (mx00[i] * my1[i] - mx01[i] * my0[i]) / r
    sx[i] += -diry[i] * as1
    sy[i] += dirx[i] * as1
    ex[i] += -diry[i] * (as0 + as1)
    ey[i] += dirx[i] * (as0 + as1)

    j = ids[(segs.polyid[ids] != 0) & (segs.right[ids] != 0)]
    k = segs.right[j]
    v0, v1, v2, v3 = sx[j], sy[j], ex[j], ey[j]
    u0, u1, u2, u3 = sx[k], sy[k], ex[k], ey[k]
    d = (v2 - v0) * (u3 - u1) - (v3 - v1) * (u2 - u0)
    mid_x, mid_y = (v2 + u0) * 0.5, (v3 + u1) * 0.5
    with np.errstate(invalid="ignore", divide="ignore"):
        q = ((v1 - u1) * (u2 - u0) - (v0 - u0) * (u3 - u1)) / d
        cx, cy = v0 + q * (v2 - v0), v1 + q * (v3 - v1)
    far = (np.hypot(cx - v2, cy - v3) > 10) & (np.hypot(cx - u0, cy - u1) > 10)
    mid = (np.abs(d) < 1e-6) | far
    wx, wy = np.where(mid, mid_x, cx), np.where(mid, mid_y, cy)
    ex[j], ey[j] = wx, wy
    sx[k], sy[k] = wx, wy
    return segs._replace(sx=sx, sy=sy, ex=ex, ey=ey)


def polyline_execute(edge_binary: np.ndarray, minerror: float,
                     size_thre: int):
    """(H,W) 0/1 edge map -> (Segments, segment id per pixel)."""
    jn = simple_junction(edge_binary)
    s = stringify(stringify(simple_connect_poly(jn), 0), 1)
    strings = remove_branch(s)
    label = label_components(strings, 0)
    strings, label = break_loops(strings, label)
    number = arc_number(label)
    dense, _ = filter_and_relabel(label_arcs(number), size_thre)
    segs, lab = mkpl(dense, number, minerror)
    return refine(segs, lab), lab


def live_segments(segs: Segments) -> list[dict]:
    """The live segments as the comparison reads them."""
    ids = np.arange(1, segs.count + 1)
    ids = ids[segs.polyid[ids] != 0]
    return [{"x0": float(segs.sx[i]), "y0": float(segs.sy[i]),
             "x1": float(segs.ex[i]), "y1": float(segs.ey[i])} for i in ids]

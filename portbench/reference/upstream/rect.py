"""The rect tail after the region labels: boundary marks and their labels
(oclrect.c:340-342), the polylines of the strong edges (:361), the
reduceLS table (oclrect.cl:427-464) and executeCPUTask
(oclrect.c:1049-1226): hypothesis groups from region boundaries (source
A) and from whole polylines (source B), each reduced to a quad, posed and
tested for a screen.  Every list grows: all groups, all members."""

from __future__ import annotations

import numpy as np

from portbench.reference.upstream import geometry as geo
from portbench.reference.upstream.grid import label_components, shifted
from portbench.reference.upstream.polyline import polyline_execute


def mark_boundary(label: np.ndarray) -> np.ndarray:
    """A pixel's region label where its 5x5 window holds another label, -1
    elsewhere and within 2 pixels of the image's edge."""
    h, w = label.shape
    near = np.zeros((h, w), bool)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            near |= shifted(label, dy, dx) != label
    out = np.where(near, label, -1)
    out[:2], out[h - 2:], out[:, :2], out[:, w - 2:] = -1, -1, -1, -1
    return out


class PairTable:
    """reduceLS: per claimed hash slot, its owner segment and the box
    {max(iw-x), max(x), max(ih-y), max(y)} of the owner's pixels within 3
    of the boundary label hashed with it.  Slots are claimed first-writer
    -wins in raster order and, within a pixel, in the order of its labels
    (the deterministic stand-in for atomic arrival order)."""

    def __init__(self, boundary: np.ndarray, lsid: np.ndarray, nentry: int):
        h, w = boundary.shape
        self.nentry = nentry
        inner = lsid > 0
        inner[0], inner[-1], inner[:, 0], inner[:, -1] = (False,) * 4
        ys, xs = np.nonzero(inner)
        k_all, b_all = [], []
        for dy in range(-3, 4):
            for dx in range(-3, 4):
                yy, xx = ys + dy, xs + dx
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                k = np.flatnonzero(ok)
                b = boundary[yy[k], xx[k]]
                pos = b > 0
                k_all.append(k[pos])
                b_all.append(b[pos])
        key = np.unique(np.concatenate(k_all).astype(np.int64) * (h * w)
                        + np.concatenate(b_all))
        k, bid = key // (h * w), key % (h * w)
        owner_of = lsid[ys[k], xs[k]].astype(np.int64)
        slot = self.slot(owner_of, bid)
        self.slots, first = np.unique(slot, return_index=True)
        self.owner = owner_of[first]
        mine = owner_of == self.owner[np.searchsorted(self.slots, slot)]
        at = np.searchsorted(self.slots, slot[mine])
        x, y = xs[k[mine]], ys[k[mine]]
        self.box = np.zeros((len(self.slots), 4), np.int64)
        for c, v in enumerate((w - x, x, h - y, y)):
            np.maximum.at(self.box[:, c], at, v)

    def slot(self, lsid, bid):
        return ((lsid * bid) & 0x7FFFFFFF) % self.nentry

    def lookup(self, lsid: int, bid: int):
        """(owner, box) of the slot of (lsid, bid); owner 0 if unclaimed."""
        s = self.slot(lsid, bid)
        i = int(np.searchsorted(self.slots, s))
        if i < len(self.slots) and self.slots[i] == s:
            return int(self.owner[i]), self.box[i]
        return 0, None


def region_groups(segs, boundary: np.ndarray) -> dict:
    """Source A's groups: {boundary label: the live segments, ascending,
    whose probes (3 points along the segment, each at perpendicular
    offsets -2..2) land on it}."""
    h, w = boundary.shape
    ids = np.arange(1, segs.count + 1)
    ids = ids[segs.polyid[ids] != 0]
    x0, y0 = np.rint(segs.sx[ids]), np.rint(segs.sy[ids])
    x1, y1 = np.rint(segs.ex[ids]), np.rint(segs.ey[ids])
    dx, dy = x1 - x0, y1 - y0
    nrm = np.hypot(dx, dy)
    with np.errstate(invalid="ignore", divide="ignore"):
        vdx = np.where(nrm == 0, 0.0, -dy / nrm)
        vdy = np.where(nrm == 0, 0.0, dx / nrm)
    pairs = []
    for j in range(3):
        for dist in range(-2, 3):
            px = x0 + dx * ((j + 0.5) / 3) + vdx * dist
            py = y0 + dy * ((j + 0.5) / 3) + vdy * dist
            x = np.trunc(px + 0.5).astype(np.int64)
            y = np.trunc(py + 0.5).astype(np.int64)
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            sid = np.full(len(ids), -1, np.int64)
            sid[ok] = boundary[y[ok], x[ok]]
            hit = sid > 0
            pairs.append(np.stack([sid[hit], ids[hit]], -1))
    pairs = np.unique(np.concatenate(pairs), axis=0)
    groups = {}
    for sid, i in pairs.tolist():
        groups.setdefault(sid, []).append(i)
    return groups


def hypotheses(segs, boundary: np.ndarray, table: PairTable, iw: int,
               ih: int) -> list:
    """[(member segments, status base)] of both sources
    (oclrect.c:1064-1217)."""
    out = []
    for segid, lsids in region_groups(segs, boundary).items():
        if len(lsids) < 4:
            continue
        als = []
        for lsid in lsids:
            sx, sy, ex, ey = (float(a[lsid]) for a in segs[:4])
            owner, box = table.lookup(lsid, segid)
            if owner != lsid:
                if owner != 0:        # another owner: unclipped
                    als.append(((sx, sy), (ex, ey)))
                continue
            cl = geo.clip_line(sx, sy, ex, ey, iw - box[0], ih - box[2],
                               box[1], box[3])
            if cl is None or np.isnan(cl[0]):
                continue
            als.append(((cl[0], cl[1]), (cl[2], cl[3])))
        out.append((als, 0))
    for i in range(1, segs.count + 1):
        if segs.polyid[i] == 0 or segs.left[i] > 0:
            continue
        als = []
        j = i
        while j > 0:
            sx, sy, ex, ey = (float(a[j]) for a in segs[:4])
            if (sx - ex) ** 2 + (sy - ey) ** 2 > 32.0 ** 2:
                als.append(((sx, sy), (ex, ey)))
            j = int(segs.right[j])
        out.append((als, 2))
    return out


def rect_tail(region: np.ndarray, strong_bin: np.ndarray, tan_aov: float,
              minerror: float, size_thre: int) -> list[dict]:
    """Region labels (H,W) and the strong edge map (H,W) 0/1 -> the
    accepted rectangles {c2 (4,2), c3 (4,3), value, status}; a rectangle
    whose pose residual is not finite is left out."""
    ih, iw = region.shape
    boundary = label_components(mark_boundary(region), -1)
    segs, lsid = polyline_execute(strong_bin, minerror, size_thre)
    table = PairTable(boundary, lsid, iw * ih * 4 // 5)
    quads, status = [], []
    # golden's loop code divides by zero-length segments as upstream does
    with np.errstate(invalid="ignore", divide="ignore"):
        for als, base in hypotheses(segs, boundary, table, iw, ih):
            red = geo.reduce_group(als)
            if red is not None:
                quads.append([seg[0] for seg in red])
                status.append(base)
        if not quads:
            return []
        c2, c3, val = geo.pose_estimation(np.array(quads), iw, ih, tan_aov)
    out = []
    for i in range(len(quads)):
        if not np.isfinite(val[i]):
            continue
        screen = geo.looks_like_a_screen(c2[i], c3[i], val[i])
        out.append({"c2": c2[i], "c3": c3[i], "value": float(val[i]),
                    "status": status[i] | int(bool(screen))})
    return out

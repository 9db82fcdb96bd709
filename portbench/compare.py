"""The comparisons that decide `correct`: what the timed path handed to the
host against what the reference computes from the same frames.

The reference follows upstream's semantics and precision, written apart
from the port, so the two may part at a rare knife-edge (a mkpl split
decided by the last bit of a distance, a group's member clipped by a
slightly different box).  Each number therefore reads the whole of the
compared frames' answers, and a fault shows in it where it touches many
of them, as the control and the planted faults do.

rect: each frame's rectangles (corners c2 in pixels, 3D corners c3,
`status`).  Rectangles are matched one to one, greedily, where their
status is equal and their corners lie within MATCH_PX of each other on
mean under the best cyclic or reflected corner order (the match of
tools/ab_parity.py).
  rect_unmatched  the share of the rectangles of both sides left without
                  a partner, over the compared frames
  rect_px         the median corner distance of the matched pairs
The pose enters through `status`: its bit 0, the screen test, reads the
residual and the 3D corners.
poly: each frame's live segments (end points in pixels).  Two segments are
as far apart as the farther pair of end points under the better of the
two orientations.
  seg_unmatched   the share of the segments of both sides whose nearest
                  segment on the other side lies farther than MATCH_PX
  seg_px          the median distance from a segment to the nearest
                  segment on the other side, over both sides' segments

A number over no pair reads FAR, unless both sides are empty.
"""

from __future__ import annotations

import numpy as np

# the distance read where nothing could be matched
FAR = 1.0e6
# the largest mean corner (rect) or end point (poly) distance of a match
MATCH_PX = 2.0
SEG_MATCH_PX = 1.0


def corner_err(a, b) -> float:
    """Best mean corner distance over the cyclic shifts and the reflection."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    best = np.inf
    for s in range(4):
        for f in (1, -1):
            idx = [(s + f * j) % 4 for j in range(4)]
            best = min(best, float(np.linalg.norm(a - b[idx], axis=1).mean()))
    return best


def match_rects(port, ref):
    """Greedy one-to-one matching of the reference's rectangles to the
    port's -> ([(port rect, ref rect, corner distance)], unmatched count
    of both sides)."""
    used, pairs = set(), []
    for r in ref:
        best, bj = np.inf, -1
        for j, p in enumerate(port):
            if j in used or p["status"] != r["status"]:
                continue
            e = corner_err(p["c2"], r["c2"])
            if e < best:
                best, bj = e, j
        if best <= MATCH_PX:
            used.add(bj)
            pairs.append((port[bj], r, best))
    return pairs, len(port) + len(ref) - 2 * len(pairs)


def _median(values, empty: bool) -> float:
    if values:
        return float(np.median(values))
    return 0.0 if empty else FAR


def compare_rect(pairs) -> dict:
    """pairs: [(port's rectangles, reference's)] of the compared frames ->
    {number: value}."""
    matched, unmatched, total = [], 0, 0
    for p, r in pairs:
        m, u = match_rects(p, r)
        matched += m
        unmatched += u
        total += len(p) + len(r)
    return {"rect_unmatched": unmatched / total if total else 0.0,
            "rect_px": _median([e for _, _, e in matched], not total)}


def _seg_array(segs) -> np.ndarray:
    return np.array([[s["x0"], s["y0"], s["x1"], s["y1"]] for s in segs],
                    np.float64).reshape(-1, 2, 2)


def nearest_seg(a, b, rows: int = 512) -> np.ndarray:
    """For each segment of a (N,2,2), the distance to the nearest of b."""
    if not len(b):
        return np.full(len(a), np.inf)
    b_flip = b[:, ::-1]
    out = []
    for i in range(0, len(a), rows):
        blk = a[i:i + rows, None]                       # (r,1,2,2)
        same = np.linalg.norm(blk - b[None], axis=-1).max(-1)
        flip = np.linalg.norm(blk - b_flip[None], axis=-1).max(-1)
        out.append(np.minimum(same, flip).min(axis=1))
    return np.concatenate(out) if out else np.zeros(0)


def compare_poly(pairs) -> dict:
    """pairs: [(port's live segments, reference's)] -> {number: value}."""
    d = []
    for p, r in pairs:
        a, b = _seg_array(p), _seg_array(r)
        d.append(nearest_seg(a, b))
        d.append(nearest_seg(b, a))
    d = np.concatenate(d) if d else np.zeros(0)
    if not len(d):
        return {"seg_unmatched": 0.0, "seg_px": 0.0}
    return {"seg_unmatched": float((d > SEG_MATCH_PX).mean()),
            "seg_px": float(min(FAR, np.median(d)))}


COMPARE = {"rect": compare_rect, "poly": compare_poly}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {number: {"value", "limit"}}); a
    number without a limit, or a limit without a number, is not correct."""
    table = {k: {"value": numbers.get(k), "limit": limits.get(k)}
             for k in sorted(set(numbers) | set(limits))}
    ok = all(v["value"] is not None and v["limit"] is not None
             and v["value"] <= v["limit"] for v in table.values())
    return ok, table

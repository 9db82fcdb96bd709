"""The segment arena and the plain max-deviation subdivision (port of the
arena and mkpl_subdivide of rectdetect_tpu/ops/polyline.py).

The subdivision's CUDA kernel (ops/hopper_mkpl.py) and the polyline stage
(ops/polyline.py) both build on this module, so its plain form lives
apart from either.  Float expressions carry XLA's multiply-add
contraction (ops/fp.py): the subdivision turns float distances into
fixed-point integers, so an ulp there could move a split.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rectdetect_tpu_torch.ops import fp
from rectdetect_tpu_torch.ops.chain import set_drop
from rectdetect_tpu_torch.ops.compact import Compaction

MINEDGELEN = 1.0   # oclpolyline.cl:20
MINNINDEX = 4      # oclpolyline.cl:21
FIX = 65536.0      # fixed-point scale for distances (oclpolyline.cl:535)

_I32 = torch.int32
_F32 = torch.float32


class SegmentArena(NamedTuple):
    """SoA form of the reference's LS_t list (oclpolyline.cl:29-39): every
    field (cap,), slot 0 unused, `count` a scalar tensor."""
    sx: torch.Tensor          # startCoords
    sy: torch.Tensor
    ex: torch.Tensor          # endCoords
    ey: torch.Tensor
    start_index: torch.Tensor
    end_index: torch.Tensor
    left_ptr: torch.Tensor
    right_ptr: torch.Tensor
    start_count: torch.Tensor
    end_count: torch.Tensor
    polyid: torch.Tensor
    npix: torch.Tensor
    level: torch.Tensor
    count: torch.Tensor

    @property
    def cap(self) -> int:
        return self.sx.shape[0]


_REDUCE = {"add": "sum", "max": "amax", "min": "amin"}


def seg_scatter(cap: int, tgt, val, mode: str, init):
    """Reduce `val` into cap slots at `tgt`; target `cap` drops."""
    out = torch.full((cap + 1,), init, dtype=val.dtype, device=val.device)
    out = out.scatter_reduce(0, tgt.long(), val, reduce=_REDUCE[mode],
                             include_self=True)
    return out[:cap]


def _closest_point_dist(sx, sy, ex, ey, px, py):
    """Distance from (px,py) to segment (sx,sy)-(ex,ey) (closestPoint,
    oclpolyline.cl:51-59: degenerate segments collapse to the start)."""
    dx = ex - sx
    dy = ey - sy
    l2 = fp.fma(dx, dx, dy * dy)
    num = fp.fma(px - sx, dx, (py - sy) * dy)
    t = torch.where(l2 > 1e-4, num / torch.clamp(l2, min=1e-4),
                    torch.zeros_like(l2))
    t = torch.clamp(t, 0.0, 1.0)
    cx = fp.fma(t, dx, sx)
    cy = fp.fma(t, dy, sy)
    return fp.hypot(cx - px, cy - py)


def _chord_max(a: SegmentArena, lab, px, py):
    """pass1 over some slots: each live slot's fixed-point distance to its
    segment's chord (-1 elsewhere), and the per-segment maximum over these
    slots (-1 where none).  Returns (lc, live_px, dist, maxdist)."""
    cap = a.cap
    lc = torch.clamp(lab, 0, cap - 1).long()
    seg_sx, seg_sy, seg_ex, seg_ey = a.sx[lc], a.sy[lc], a.ex[lc], a.ey[lc]
    live_px = (lab > 0) & (lab < cap) & (a.polyid[lc] != 0)
    d = _closest_point_dist(seg_sx, seg_sy, seg_ex, seg_ey, px, py)
    dist = torch.where(live_px, torch.trunc(d * FIX).to(_I32), -1)
    tgt = torch.where(live_px, lab, cap)
    return lc, live_px, dist, seg_scatter(cap, tgt, dist, "max", -1)


def _winner(cap: int, lab, lc, live_px, dist, maxdist, slot_l, n_slots: int):
    """The smallest of these slots (= min flat index) that reaches its
    segment's maximum `maxdist`, per segment; n_slots where none."""
    md_px = maxdist[lc]
    at_max = live_px & (dist == md_px) & (md_px >= 0)
    return seg_scatter(cap, torch.where(at_max, lab, cap), slot_l, "min",
                       n_slots)


def _split(a: SegmentArena, maxdist, winner, px, py, num,
           minerr_fix: int) -> SegmentArena:
    """pass2 (oclpolyline.cl:564-620): the split tests of every segment, the
    id-order allocation of the new ones and the record writes."""
    cap = a.cap
    n_slots = px.shape[0]
    dev = px.device
    seg_id = torch.arange(cap, dtype=_I32, device=dev)
    zi = torch.zeros_like(seg_id)
    has_w = winner < n_slots
    wc = torch.clamp(winner, 0, n_slots - 1).long()
    wx, wy, wn = px[wc], py[wc], num[wc]

    # pass2 split conditions (oclpolyline.cl:564-577)
    md = maxdist
    mdf = md.to(_F32)
    cdx, cdy = a.ex - a.sx, a.ey - a.sy
    chord_sq = fp.fma(cdx, cdx, cdy * cdy)
    curv_keep = ~((md < minerr_fix * 3) &
                  (mdf * mdf / torch.clamp(chord_sq, min=1e-30)
                   < 100000.0))
    dsx, dsy = wx - a.sx, wy - a.sy
    dex, dey = wx - a.ex, wy - a.ey
    dss = fp.fma(dsx, dsx, dsy * dsy)
    dse = fp.fma(dex, dex, dey * dey)
    split = ((a.polyid != 0) & has_w
             & (a.end_index - a.start_index >= MINNINDEX - 1)
             & (a.start_count <= 1) & (a.end_count <= 1)
             & (md >= minerr_fix) & curv_keep
             & (dss >= MINEDGELEN * MINEDGELEN)
             & (dse >= MINEDGELEN * MINEDGELEN))

    # deterministic allocation: rank split segments by id
    ranks = torch.cumsum(split.to(_I32), 0, dtype=_I32)
    split = split & (a.count + ranks < cap)
    ranks = torch.cumsum(split.to(_I32), 0, dtype=_I32)
    gn = torch.where(split, a.count + ranks, cap).to(_I32)
    new_count = (a.count + split.to(_I32).sum()).to(_I32)

    # new segment gn covers [wn, end]; old g truncates to [start, wn]
    sx2 = set_drop(a.sx, gn, wx)
    sy2 = set_drop(a.sy, gn, wy)
    ex2 = set_drop(a.ex, gn, a.ex)
    ey2 = set_drop(a.ey, gn, a.ey)
    sidx2 = set_drop(a.start_index, gn, wn)
    eidx2 = set_drop(a.end_index, gn, a.end_index)
    left2 = set_drop(a.left_ptr, gn, seg_id)
    right2 = set_drop(a.right_ptr, gn, a.right_ptr)
    polyid2 = set_drop(a.polyid, gn, a.polyid)
    level2 = set_drop(a.level, gn, md)
    npix2 = set_drop(a.npix, gn, zi)
    sc2 = set_drop(a.start_count, gn, zi)
    ec2 = set_drop(a.end_count, gn, zi)

    # old right neighbour's left pointer -> gn (oclpolyline.cl:614)
    gr_tgt = torch.where(split & (a.right_ptr != 0), a.right_ptr, cap)
    left2 = set_drop(left2, gr_tgt, gn)

    # update the split segments in place
    ex2 = torch.where(split, wx, ex2)
    ey2 = torch.where(split, wy, ey2)
    eidx2 = torch.where(split, wn, eidx2)
    right2 = torch.where(split, gn, right2)

    return a._replace(sx=sx2, sy=sy2, ex=ex2, ey=ey2, start_index=sidx2,
                      end_index=eidx2, left_ptr=left2, right_ptr=right2,
                      start_count=sc2, end_count=ec2, polyid=polyid2,
                      npix=npix2, level=level2, count=new_count)


def _pass3(a: SegmentArena, lab, lc, live_px, num):
    """pass3: the slots past their segment's split move one right-pointer
    hop."""
    move = live_px & (a.end_index[lc] < num) & (a.polyid[lc] != 0)
    return torch.where(move, a.right_ptr[lc], lab)


def mkpl_subdivide(arena: SegmentArena, label, number, minerror: float,
                   n_iters: int, comp: Compaction, group=None):
    """Iterative max-deviation subdivision (mkpl_pass1/2/3,
    oclpolyline.cl:509-646; host loop N=16, oclpolyline.c:186-216), over the
    compacted slot list.  Returns (arena, lsid label image).

    group: a dist.mesh.TileGroup whose first tile holds the inputs (the
    width-tiled path).  Each round's per-slot work then runs by slot range
    over its tiles, as the JAX package's XLA form runs it under shard_map:
    the chord distances and the two (cap,) segment tables (reduced with
    group.pmax and group.pmin), and pass3, whose label ranges come back
    together by group.all_gather.  pass2 runs whole on each device of the
    group.  Integer reductions: the result equals the unsharded one bit for
    bit, on the first tile's device."""
    h, w = label.shape
    n = h * w
    dev = label.device
    live = comp.valid()
    p_s = torch.clamp(comp.idx, 0, n - 1)
    pl = p_s.long()
    px = (p_s % w).to(_F32)
    py = (p_s // w).to(_F32)
    num = torch.where(live, number.reshape(-1)[pl], 0).to(_I32)
    lab = torch.where(live, label.reshape(-1)[pl], 0).to(_I32)
    minerr_fix = int(minerror * FIX)
    n_slots = px.shape[0]
    a = arena

    if group is None:
        slot_l = torch.arange(n_slots, dtype=_I32, device=dev)
        for _ in range(n_iters - 1):
            lc, live_px, dist, maxdist = _chord_max(a, lab, px, py)
            winner = _winner(a.cap, lab, lc, live_px, dist, maxdist, slot_l,
                             n_slots)
            a = _split(a, maxdist, winner, px, py, num, minerr_fix)
            lab = _pass3(a, lab, lc, live_px, num)
    else:
        a, lab = _subdivide_by_range(group, a, lab, px, py, num,
                                     minerr_fix, n_iters)

    out = torch.zeros((n + 1,), dtype=_I32, device=dev)
    out.scatter_(0, torch.where(live, p_s, n).long(), lab)
    return a, out[:n].reshape(h, w)


def _subdivide_by_range(group, a: SegmentArena, lab, px, py, num,
                        minerr_fix: int, n_iters: int):
    """mkpl_subdivide's rounds by slot range over `group`'s tiles.  What a
    tile receives by broadcast or collective is shared with the tiles on
    its device and only read; pass2 runs once per device.  Returns (arena,
    labels) on the first tile's device."""
    n_slots = px.shape[0]
    cap = a.cap
    nt = group.n_tiles
    pxs, pys, nums, labs = (group.broadcast(t) for t in (px, py, num, lab))
    arenas = [SegmentArena(*f) for f in
              zip(*(group.broadcast(t) for t in a))]
    ranges = [group.slot_range(i, n_slots) for i in range(nt)]
    slot_ls = [torch.arange(lo, hi, dtype=_I32, device=d)
               for (lo, hi), d in zip(ranges, group.devices)]
    for _ in range(n_iters - 1):
        own = [(labs[i][lo:hi], pxs[i][lo:hi], pys[i][lo:hi], nums[i][lo:hi])
               for i, (lo, hi) in enumerate(ranges)]
        keys = [_chord_max(arenas[i], l, x, y)
                for i, (l, x, y, _) in enumerate(own)]
        maxdist = group.pmax([k[3] for k in keys])
        winner = group.pmin([
            _winner(cap, own[i][0], lc, live_px, dist, maxdist[i], slot_ls[i],
                    n_slots)
            for i, (lc, live_px, dist, _) in enumerate(keys)])
        split = {}
        for i, d in enumerate(group.devices):
            if d not in split:
                split[d] = _split(arenas[i], maxdist[i], winner[i], pxs[i],
                                  pys[i], nums[i], minerr_fix)
            arenas[i] = split[d]
        labs = group.all_gather([
            _pass3(arenas[i], own[i][0], lc, live_px, own[i][3])
            for i, (lc, live_px, _, _) in enumerate(keys)], 0)
    return arenas[0], labs[0]

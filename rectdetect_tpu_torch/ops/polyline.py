"""Polyline vectorization: binary edge image -> refined line segments (port
of rectdetect_tpu/ops/polyline.py, slot-space path).

Mirrors oclpolyline_execute (oclpolyline.c:218-309): strings morphology
(kernel K3), one arc walk (ops/chain.py) replacing CCL, breakLoops, arc
numbering and labelpl, the arc size filter and dense relabel in slot
space, the one-segment-per-arc arena (mkpl_pass0), 15 rounds of
max-deviation subdivision (mkpl_pass1-3, ops/mkpl.py) and least-squares
refinement with corner snapping (refine_pass0-3).  The lsList of the
reference is the fixed-capacity SoA `SegmentArena` (ops/mkpl.py) with
slot 0 unused; ids are deterministic (min-flat-index tie-breaks,
prefix-sum allocation).

Float expressions carry XLA's multiply-add contraction (ops/fp.py).  The
float segment sums of `refine` run in slot order per segment (a stable
sort by segment, then a sequential segmented sum), so two runs give the
same bits on the GPU too.

Port choices (equal output, see config.py): no small-capacity branches
(`strings_small_factor`, `arc_small_factor`), no small-component pre-kill
(`walk_prefilter_factor`; the JAX package skips it when sharded too).  `mkpl_pallas` selects the subdivision: 1 (the
default) goes through kernel #14 (ops/hopper_mkpl.py), which launches the
CUDA kernel for a CUDA frame and runs the plain form (ops/mkpl.py) for a
CPU one; 0 runs the plain form on either device.  The JAX package's size
conditions for its kernel (slot cap <= 16384, arena cap >= slot cap) do
not apply: the CUDA kernel allocates ids exactly as the plain form does,
arena overflow included.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.ops import fp, hopper_mkpl, mkpl
from rectdetect_tpu_torch.ops.chain import set_drop, arc_chain_sparse
from rectdetect_tpu_torch.ops.compact import Compaction, compact_mask, compact_subset
from rectdetect_tpu_torch.ops.hopper_morph import strings_chain
from rectdetect_tpu_torch.ops.mkpl import SegmentArena, seg_scatter

_I32 = torch.int32
_F32 = torch.float32


def _seg_sum_f(cap: int, tgt, val):
    """Float sum into cap slots at `tgt` (target cap drops), adding each
    segment's values in slot order: deterministic on every device."""
    order = torch.sort(tgt, stable=True).indices
    lengths = torch.bincount(tgt.long(), minlength=cap + 1)
    sums = torch.segment_reduce(val[order], "sum", lengths=lengths,
                                unsafe=True, initial=0.0)
    return sums[:cap]


def mkpl_init(label, number, cap: int, comp: Compaction) -> SegmentArena:
    """The initial one-segment-per-arc arena (mkpl_pass0a/0b,
    oclpolyline.cl:439-506).  An arc survives (polyid != 0) iff it has
    exactly one number==1 pixel and >= 2 pixels."""
    h, w = label.shape
    n = h * w
    dev = label.device
    live = comp.valid()
    p_s = torch.clamp(comp.idx, 0, n - 1)
    pl = p_s.long()
    lbl = torch.where(live, label.reshape(-1)[pl], 0).to(_I32)
    num = torch.where(live, number.reshape(-1)[pl], 0).to(_I32)
    flat = p_s

    valid = (lbl > 0) & (lbl < cap)
    tgt = torch.where(valid, lbl, cap)
    one = torch.ones_like(lbl)
    zero = torch.zeros_like(lbl)
    starts = torch.where(valid & (num == 1), lbl, cap)

    npix = seg_scatter(cap, tgt, torch.where(valid, one, zero), "add", 0)
    start_count = seg_scatter(cap, starts, one, "add", 0)
    end_index = seg_scatter(cap, tgt, torch.where(valid, num, zero), "max", 0)
    count = torch.max(torch.where(valid, lbl, zero)).to(_I32)

    sp = seg_scatter(cap, starts, flat, "min", n)
    sp_ok = sp < n
    spc = torch.clamp(sp, 0, n - 1)
    sx = torch.where(sp_ok, (spc % w).to(_F32), 0.0)
    sy = torch.where(sp_ok, (spc // w).to(_F32), 0.0)

    # endCoords: the min-flat-index pixel reaching the max number
    is_end = valid & (num == end_index[torch.clamp(lbl, 0, cap - 1).long()]) \
        & (num > 0)
    ends = torch.where(is_end, lbl, cap)
    ep = seg_scatter(cap, ends, flat, "min", n)
    end_count = seg_scatter(cap, ends, one, "add", 0)
    ep_ok = ep < n
    epc = torch.clamp(ep, 0, n - 1)
    ex = torch.where(ep_ok, (epc % w).to(_F32), 0.0)
    ey = torch.where(ep_ok, (epc // w).to(_F32), 0.0)

    seg_id = torch.arange(cap, dtype=_I32, device=dev)
    alive = (start_count == 1) & (npix >= 2) & (end_count >= 1) & (seg_id > 0)
    polyid = torch.where(alive, seg_id, 0).to(_I32)
    zeros = torch.zeros((cap,), dtype=_I32, device=dev)
    return SegmentArena(
        sx=sx, sy=sy, ex=ex, ey=ey,
        start_index=zeros, end_index=end_index,
        left_ptr=zeros, right_ptr=zeros,
        start_count=start_count, end_count=end_count,
        polyid=polyid, npix=npix, level=zeros, count=count)


def refine(arena: SegmentArena, label, comp: Compaction) -> SegmentArena:
    """Least-squares endpoint refinement + corner snapping (refine_pass0..3,
    oclpolyline.cl:680-809), as a centred linear regression of the
    perpendicular offset on the chord position per segment."""
    h, w = label.shape
    n = h * w
    cap = arena.cap
    live = comp.valid()
    p_s = torch.clamp(comp.idx, 0, n - 1)
    lab = torch.where(live, label.reshape(-1)[p_s.long()], 0)
    px = (p_s % w).to(_F32)
    py = (p_s // w).to(_F32)
    lc = torch.clamp(lab, 0, cap - 1).long()
    valid = (lab > 0) & (lab < cap)
    tgt = torch.where(valid, lab, cap)
    zf = torch.zeros_like(px)

    dirx = torch.round(arena.ex - arena.sx)
    diry = torch.round(arena.ey - arena.sy)
    vdx = -diry
    vdy = dirx
    c = fp.fma(dirx, dirx, diry * diry)            # distSquSE

    sxr = torch.round(arena.sx)
    syr = torch.round(arena.sy)
    r_dx, r_dy = dirx[lc], diry[lc]
    vx = px - sxr[lc]
    vy = py - syr[lc]
    ax0 = fp.fma(vx, r_dx, vy * r_dy)
    ay = fp.fma(vy, r_dx, -(vx * r_dy))            # v . (-diry, dirx)

    nseg = _seg_sum_f(cap, tgt, torch.where(valid, 1.0, zf))
    s_x = _seg_sum_f(cap, tgt, torch.where(valid, ax0, zf))
    s_y = _seg_sum_f(cap, tgt, torch.where(valid, ay, zf))
    nz = torch.clamp(nseg, min=1.0)
    m_x = s_x / nz
    m_y = s_y / nz
    dx0 = ax0 - m_x[lc]
    dy0 = ay - m_y[lc]
    var = _seg_sum_f(cap, tgt, torch.where(valid, dx0 * dx0, zf))
    cov = _seg_sum_f(cap, tgt, torch.where(valid, dx0 * dy0, zf))

    # rdet == 0 in the reference <=> c == 0, n == 0, or integer variance 0
    ok = (arena.polyid != 0) & (nseg > 0) & (c > 0) & (var > 0.25)
    zc = torch.zeros_like(c)
    as0 = torch.where(ok, cov / torch.clamp(var, min=1e-20), zc)
    as1 = torch.where(ok, fp.fma(-as0, m_x, m_y) / torch.clamp(c, min=1e-20),
                      zc)

    sx = fp.fma(vdx, as1, arena.sx)
    sy = fp.fma(vdy, as1, arena.sy)
    s01 = as0 + as1
    ex = fp.fma(vdx, s01, arena.ex)
    ey = fp.fma(vdy, s01, arena.ey)

    # pass3: snap adjacent endpoints to the line-line intersection
    # (oclpolyline.cl:772-809), from pre-snap coordinates
    rp = torch.clamp(arena.right_ptr, 0, cap - 1).long()
    u0, u1 = sx[rp], sy[rp]
    u2, u3 = ex[rp], ey[rp]
    d = fp.fma(ex - sx, u3 - u1, -((ey - sy) * (u2 - u0)))
    nq = fp.fma(sy - u1, u2 - u0, -((sx - u0) * (u3 - u1)))
    small = torch.abs(d) < 1e-6
    q = nq / torch.where(small, torch.ones_like(d), d)
    wx = fp.fma(q, ex - sx, sx)
    wy = fp.fma(q, ey - sy, sy)
    midx = (ex + u0) * 0.5
    midy = (ey + u1) * 0.5
    far = (fp.hypot(wx - ex, wy - ey) > 10.0) & \
          (fp.hypot(wx - u0, wy - u1) > 10.0)
    use_mid = small | far
    nxx = torch.where(use_mid, midx, wx)
    nyy = torch.where(use_mid, midy, wy)

    applies = (arena.polyid != 0) & (arena.right_ptr != 0)
    ex2 = torch.where(applies, nxx, ex)
    ey2 = torch.where(applies, nyy, ey)
    h_tgt = torch.where(applies, arena.right_ptr, cap)
    sx2 = set_drop(sx, h_tgt, nxx)
    sy2 = set_drop(sy, h_tgt, nyy)
    return arena._replace(sx=sx2, sy=sy2, ex=ex2, ey=ey2)


def polyline_execute(edge_binary, minerror: float, size_thre: int, cap: int,
                     cfg: PipelineConfig = DEFAULT_CONFIG,
                     return_comp: bool = False, group=None):
    """Binary edge image (H,W) int32 -> (SegmentArena, lsid (H,W) int32),
    and with return_comp also the arc Compaction, which covers every
    lsid > 0 pixel (the hypotheses' pair table gathers through it).
    group: a dist.mesh.TileGroup whose first tile holds the image; the arc
    walk's doublings and the subdivision then run by slot range over its
    tiles (the JAX package's axis_name), with the same result."""
    arena, dense, number, comp_arc = mkpl_inputs(edge_binary, size_thre, cap,
                                                 cfg, group)
    subdivide = (hopper_mkpl.mkpl_subdivide if cfg.mkpl_pallas
                 else mkpl.mkpl_subdivide)
    arena, lsid = subdivide(arena, dense, number, minerror, cfg.mkpl_iters,
                            comp_arc, group)
    arena = refine(arena, lsid, comp_arc)
    if return_comp:
        return arena, lsid, comp_arc
    return arena, lsid


def mkpl_inputs(edge_binary, size_thre: int, cap: int,
                cfg: PipelineConfig = DEFAULT_CONFIG, group=None):
    """Everything before the subdivision: strings morphology (K3
    "poly_branch", with its bridge2 stage under bridge_gap2), the arc walk
    (its doublings by slot range over `group`'s tiles, if given) and
    grouping, the one-segment-per-arc arena.  Returns (arena, dense arc-id
    image, number image, arc Compaction), the subdivision's inputs."""
    if not cfg.sparse_factor:
        raise NotImplementedError("the port runs the slot-space polyline "
                                  "tail only (sparse_factor > 0)")
    h, w = edge_binary.shape
    n = h * w
    sp = max(4096, n // cfg.strings_sparse_factor)
    strings = strings_chain(edge_binary, "poly_branch", cfg.bridge_gap2)

    comp0 = compact_mask((strings != 0).reshape(-1), sp)
    cyc_cap = max(1024, n // cfg.cycle_sparse_factor)
    walk = arc_chain_sparse(strings, comp0, cfg.number_doublings, cyc_cap,
                            group)
    sp_arc = max(4096, n // cfg.arc_sparse_factor)
    dense_a, number_a, comp_arc = _arc_group(walk, comp0, size_thre, sp_arc,
                                             n)

    # the dense/number images mkpl reads through comp_arc
    tgt_a = torch.where(comp_arc.valid(), torch.clamp(comp_arc.idx, 0, n - 1),
                        n).long()
    dense = torch.zeros((n + 1,), dtype=_I32, device=strings.device)
    dense.scatter_(0, tgt_a, dense_a)
    number = torch.zeros((n + 1,), dtype=_I32, device=strings.device)
    number.scatter_(0, tgt_a, number_a)
    dense = dense[:n].reshape(h, w)
    number = number[:n].reshape(h, w)
    return mkpl_init(dense, number, cap, comp_arc), dense, number, comp_arc


def _arc_group(walk_out, comp_w: Compaction, size_thre: int, sp_arc: int,
               n: int):
    """Arc grouping in the walk's slot space (replaces label_arcs, calcSize,
    filterSize and relabel, oclpolyline.cl:312-420): arcs longer than
    size_thre keep, each ranked by its root (min flat index) in flat order.
    Returns per-arc-slot dense id and number, and the arc compaction."""
    number_w, _, live_w, _, chainlen_w, arcmin_w = walk_out
    Sw = comp_w.cap
    p_w = torch.clamp(comp_w.idx, 0, n - 1)
    keep = live_w & (number_w > 0) & (chainlen_w > size_thre)
    root_slot = comp_w.slot_of[torch.clamp(arcmin_w, 0, n).long()]
    keep = keep & (root_slot < Sw)          # root beyond comp cap: drop arc
    is_root = keep & (p_w == arcmin_w)
    rank = torch.cumsum(is_root.to(_I32), 0, dtype=_I32)
    dense_w = torch.where(keep, rank[torch.clamp(root_slot, 0, Sw - 1).long()],
                          0).to(_I32)
    comp_arc = compact_subset(comp_w, dense_w > 0, sp_arc)
    slot_a = comp_w.slot_of[torch.clamp(comp_arc.idx, 0, n).long()]
    sa = torch.clamp(slot_a, 0, Sw - 1).long()
    a_ok = comp_arc.valid()
    dense_a = torch.where(a_ok, dense_w[sa], 0).to(_I32)
    number_a = torch.where(a_ok, number_w[sa], 0).to(_I32)
    return dense_a, number_a, comp_arc

"""The rect pipeline: frame -> detected rectangles with their 3D pose (port
of rectdetect_tpu/pipeline/rect.py: rect_frame, and rect_frames for a
stack of frames).

Mirrors oclrect.c:262-381 and executeCPUTask (oclrect.c:1049-1226): the
weak/strong edge labels (strings morphology, kernel K3; exact labels, K4;
the strength pair with the segmented scan, #10, or under
EXTENDED_CONFIG K3's bridge2 variant and the staged strength filters with
their rescue rounds), the edge-limited blur
(#12) and quantize + despeckle (#5) of the packed-Lab plane, the region
merge (merge mask #6, links CCL #9, despeckle2 #8), the boundary labels
(mark_boundary, K4 on its foreground), the polylines of the strong edges,
the two hypothesis sources: region boundaries (pair table with distinct
bids #7, probes, clipping) and whole polylines, then the quad reduction
(#15) and the pose (its own kernel) of every group, the screen test and
the result's sanitising.  `rect_hypotheses` runs the chain up to the
hypotheses, `rect_geometry` the rest, `rect_frame` both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.geometry import pose, quad
from rectdetect_tpu_torch.geometry.clip import clip_segments
from rectdetect_tpu_torch.ops import ccl, hopper_hyp, hopper_pose, reduce_ls
from rectdetect_tpu_torch.ops.compact import Compaction, compact_mask
from rectdetect_tpu_torch.ops.hopper_blblur import blblur
from rectdetect_tpu_torch.ops.hopper_ccl import label_components
from rectdetect_tpu_torch.ops.hopper_despeckle2 import sizes_despeckle2
from rectdetect_tpu_torch.ops.hopper_links import label_merge
from rectdetect_tpu_torch.ops.hopper_merge_mask import junction_merge_mask
from rectdetect_tpu_torch.ops.hopper_morph import strings_chain
from rectdetect_tpu_torch.ops.hopper_quant import quantize_despeckle
from rectdetect_tpu_torch.ops.mkpl import SegmentArena
from rectdetect_tpu_torch.ops.polyline import polyline_execute
from rectdetect_tpu_torch.ops.regions import mark_boundary
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend


class RectResult(NamedTuple):
    """Detected rectangles; fixed capacity 2G with a valid mask (the
    reference returns a dynamic rect_t list, oclrect.h:5-15)."""
    c2: torch.Tensor      # (2G,4,2) float32 image corners, top-left first
    c3: torch.Tensor      # (2G,4,3) float32 3D corners (unit-side scale)
    value: torch.Tensor   # (2G,) float32 pose residual, inf where not valid
    status: torch.Tensor  # (2G,) int32 bit0: looks like a screen;
    #                       bit1: polyline source
    valid: torch.Tensor   # (2G,) bool: the hypothesis survived reduction


class RectHypotheses(NamedTuple):
    """rect_hypotheses' result: the stage maps and the hypotheses."""
    mask: torch.Tensor      # (H,W) int32 0/1 merge mask
    seg: torch.Tensor       # (H,W) int32 region labels
    boundary: torch.Tensor  # (H,W) int32 boundary labels, -1 elsewhere
    lsid: torch.Tensor      # (H,W) int32 segment id per polyline pixel
    segs: torch.Tensor      # (2G,K,2,2) float32 member segments
    valid: torch.Tensor     # (2G,K) bool
    status: torch.Tensor    # (2G,) int32: 0 region source, 2 polyline source


def weak_strong_labels(edge_bin: torch.Tensor, edge_thin: torch.Tensor,
                       cfg: PipelineConfig = DEFAULT_CONFIG,
                       return_strings: bool = False):
    """Weak/strong edge labeling (oclrect.c:262-312): stringify, label,
    strength-filter at both thresholds.  Returns (weak_lbl, strong_lbl),
    (H,W) int32 each: a surviving pixel keeps its component label (the
    component's minimum flat index), a filtered interior pixel is -1.
    With return_strings also the stringified ("rect" variant) map that
    was labelled.

    With strength_rescue_rounds = 0 this is the JAX package's
    `rect_strength_dense` branch, the dense strength pair with the
    segmented scan (#10).  With rescue rounds (EXTENDED_CONFIG) it is the
    staged form: the strings' slot list (compact_mask at the sparse_factor
    capacity), calc_strength and filter_strength over it, and
    rescue_filtered after the weak filter and again after the strong one,
    which the JAX package's rect_tail runs after the region smoothing; the
    staged form has no kernel in either package.  bridge_gap2 runs K3 with
    its bridge2 stage.  The labels come from the exact K4; the JAX
    package's CPU path labels with a fixed-pass CCL and its TPU path with
    capped pieces, which the exact labels are the converged form of."""
    s = rect_strings(edge_bin, cfg)
    weak, strong = strength_labels(s, edge_thin, cfg)
    if return_strings:
        return weak, strong, s
    return weak, strong


def rect_strings(edge_bin: torch.Tensor,
                 cfg: PipelineConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """The K3 part of weak_strong_labels: the "rect" strings of edge_bin
    ([B,]H,W) int32 0/1, bridge2 under bridge_gap2; a stack is one
    launch."""
    if not cfg.sparse_factor or not (cfg.strength_rescue_rounds or
                                     cfg.rect_strength_dense):
        raise NotImplementedError("the port runs the dense strength pair "
                                  "or, with rescue rounds, the staged form "
                                  "(sparse_factor > 0; rect_strength_dense=1 "
                                  "without rescue rounds)")
    return strings_chain(edge_bin, "rect", cfg.bridge_gap2)


def strength_labels(s: torch.Tensor, edge_thin: torch.Tensor,
                    cfg: PipelineConfig = DEFAULT_CONFIG):
    """The labels-and-strength part of weak_strong_labels, one frame: K4's
    labels of the strings map s (H,W) and the strength filters over them
    (slot lists at the frame's own capacity).  Returns (weak_lbl,
    strong_lbl)."""
    rounds = cfg.strength_rescue_rounds
    ih, iw = s.shape
    sp = max(4096, ih * iw // cfg.sparse_factor)
    lbl = label_components(s, 0)
    if rounds:
        scomp = compact_mask((s != 0).reshape(-1), sp)
        st = ccl.calc_strength(edge_thin, lbl, cfg.strength_scale, scomp)
        weak = ccl.rescue_filtered(
            lbl, ccl.filter_strength(lbl, st, cfg.strength_weak, scomp),
            rounds)
        strong = ccl.rescue_filtered(
            weak, ccl.filter_strength(weak, st, cfg.strength_strong, scomp),
            rounds)
    else:
        weak, strong = ccl.strength_filter_pair_dense(
            edge_thin, lbl, sp, cfg.strength_weak, cfg.strength_strong,
            cfg.strength_scale)
    return weak, strong


def region_smoothing(packed0: torch.Tensor, weak_lbl: torch.Tensor,
                     edge_thin: torch.Tensor,
                     cfg: PipelineConfig = DEFAULT_CONFIG):
    """Edge-limited blur + quantize + despeckle (oclrect.c:286-303) of the
    packed-Lab plane, limited by the weak edges.  Returns (blurred,
    despeck), ([B,]H,W) int32 packed Lab each; a stack of B frames is one
    call of each kernel."""
    weak_bin = (weak_lbl > 0).to(torch.int32)
    blurred = blblur(packed0, weak_bin, cfg.blblur_iters)
    n = cfg.quantize_levels
    despeck = quantize_despeckle(blurred, edge_thin, n, n, n)
    return blurred, despeck


def region_merge(despeck: torch.Tensor, strong_lbl: torch.Tensor,
                 cfg: PipelineConfig = DEFAULT_CONFIG):
    """Merge masks, region CCL and small-region cleanup (oclrect.c:314-336):
    the merge mask of the strong edges (#6), the exact region labels over
    the merge links (#9), then regions of <= despeckle2_thre pixels absorbed
    (#8).  Returns (mask, seg), ([B,]H,W) int32 each; seg holds
    min-flat-index region labels of each frame; a stack of B frames is one
    call of each kernel."""
    mask = junction_merge_mask(strong_lbl)
    seg = label_merge(despeck, mask, strong_lbl)
    return mask, sizes_despeckle2(seg, cfg.despeckle2_thre)


def boundary_labels(seg: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG):
    """Boundary labeling (oclrect.c:340-342) on the boundary_comp=1 path:
    mark_boundary, the boundary foreground compacted into
    max(4096, H*W // boundary_sparse_factor) slots, and exact 8-connected
    labels of the marked pixels (K4, background -1).  Foreground pixels
    beyond the compaction's capacity become -1, as on the JAX package's TPU
    path (pallas_ccl._label_sparse); a kept pixel's component minimum comes
    first in flat order, so it is kept too.  Returns (boundary (H,W) int32,
    the Compaction)."""
    if not (cfg.sparse_factor and cfg.boundary_comp) or \
            cfg.boundary_tpu_sparse:
        raise NotImplementedError("the port runs the compacted boundary "
                                  "labels only (sparse_factor > 0, "
                                  "boundary_comp=1, boundary_tpu_sparse "
                                  "off)")
    ih, iw = seg.shape
    n = ih * iw
    spb = max(4096, n // cfg.boundary_sparse_factor)
    bmark = mark_boundary(seg)
    bcomp = compact_mask((bmark != -1).reshape(-1), spb)
    lbl = label_components(bmark, -1)
    kept = (bcomp.slot_of[:n] < spb).reshape(ih, iw)
    return torch.where(kept, lbl, -1), bcomp


def hypotheses(arena: SegmentArena, lsid: torch.Tensor,
               boundary: torch.Tensor, iw: int, ih: int,
               cfg: PipelineConfig, comp: Compaction, bcomp: Compaction):
    """Both hypothesis sources (oclrect.c:1064-1217) -> (segs (2G,K,2,2)
    float32, valid (2G,K) bool, status (2G,) int32), G = max_groups, K =
    max_group_segs.  comp: the polyline's arc compaction; bcomp: the
    boundary compaction (boundary_labels)."""
    gmax = cfg.max_groups
    k = cfg.max_group_segs
    nentry = iw * ih * 4 // 5
    table = reduce_ls.pair_bbox_table(boundary, lsid, nentry, comp)
    flat2dense, _, roots = reduce_ls.densify_labels_sparse(
        boundary, bcomp, gmax, bg=-1)

    # source A: region boundaries (oclrect.c:1064-1171)
    ids_a, mv_a, counts = reduce_ls.probe_members(
        boundary, arena, gmax, flat2dense, k, cfg.probe_n, cfg.probe_dist,
        by_length=bool(cfg.members_by_length))
    group_ok_a = counts[1:] >= 4                        # oclrect.c:1108
    seg_xy = torch.stack([arena.sx, arena.sy, arena.ex, arena.ey], dim=1)
    raw_a = seg_xy[ids_a.long()]                        # (G,K,4)
    segid_a = roots[1:][:, None].expand_as(ids_a)       # flat root label
    hsh = reduce_ls.hash_slot(ids_a, segid_a, nentry).long()
    own_ls = table.owner_lsid[hsh]
    own_bid = table.owner_bid[hsh]
    bb = table.bb[hsh]                                  # (G,K,4)
    boxes = torch.stack([iw - bb[..., 0], ih - bb[..., 2], bb[..., 1],
                         bb[..., 3]], dim=-1).to(torch.float32)
    clipped = clip_segments(raw_a, boxes)
    owned = (own_ls == ids_a) & (own_bid == segid_a)
    empty = own_ls == 0
    # owner match -> clipped (dropped where the clip rejects); another
    # owner -> unclipped; empty slot -> dropped (oclrect.c:1116-1131)
    use = torch.where(owned[..., None], clipped, raw_a)
    valid_a = mv_a & group_ok_a[:, None] & ~empty & \
        ~(owned & torch.isnan(clipped[..., 0]))
    segs_a = torch.nan_to_num(use).reshape(gmax, k, 2, 2)

    # source B: whole polylines (oclrect.c:1175-1217)
    ids_b, mv_b = reduce_ls.chain_members(
        arena, gmax, k, cfg.ls_min_len_polyline,
        by_length=bool(cfg.members_by_length))
    segs_b = seg_xy[ids_b.long()].reshape(gmax, k, 2, 2)

    dev = lsid.device
    status = torch.cat([torch.zeros((gmax,), dtype=torch.int32, device=dev),
                        torch.full((gmax,), 2, dtype=torch.int32,
                                   device=dev)])
    return (torch.cat([segs_a, segs_b]), torch.cat([valid_a, mv_b]), status)


def rect_hypotheses(bgr: torch.Tensor,
                    cfg: PipelineConfig = DEFAULT_CONFIG) -> RectHypotheses:
    """BGR (H,W,3) uint8 frame, on the CPU or a CUDA device -> the stage
    maps and the hypotheses that quad reduction reads (the JAX package's
    rect_tail up to _hypotheses)."""
    fe = edge_frontend(bgr, cfg)
    return tail_hypotheses(fe.packed0, fe.edge_thin, fe.edge_bin, cfg)


def tail_hypotheses(packed0: torch.Tensor, edge_thin: torch.Tensor,
                    edge_bin: torch.Tensor,
                    cfg: PipelineConfig = DEFAULT_CONFIG) -> RectHypotheses:
    """rect_hypotheses from the front-end's products (packed Lab, the
    thinned edge magnitude and its binary map), one frame."""
    return tail_hypotheses_frames(packed0[None], edge_thin[None],
                                  edge_bin[None], cfg)[0]


def tail_hypotheses_frames(packed0: torch.Tensor, edge_thin: torch.Tensor,
                           edge_bin: torch.Tensor,
                           cfg: PipelineConfig = DEFAULT_CONFIG
                           ) -> list[RectHypotheses]:
    """tail_hypotheses of a (B,H,W) stack of front-end products, one
    RectHypotheses a frame.  The dense stages run once on the stack: K3
    (rect_strings), region_smoothing (#12, #5) and region_merge (#6, #9,
    #8).  What rests on slot lists and per-frame capacities runs frame by
    frame: the labels and strength filters, the boundary labels, the
    polylines and the hypotheses."""
    strings = rect_strings(edge_bin, cfg)
    weak_lbl, strong_lbl = (torch.stack(m) for m in zip(*(
        strength_labels(s, et, cfg) for s, et in zip(strings, edge_thin))))
    _, despeck = region_smoothing(packed0, weak_lbl, edge_thin, cfg)
    masks, segs = region_merge(despeck, strong_lbl, cfg)
    ih, iw = edge_bin.shape[-2:]
    out = []
    for mask, seg, strong in zip(masks, segs, strong_lbl):
        boundary, bcomp = boundary_labels(seg, cfg)
        arena, lsid, comp = polyline_execute(
            (strong > 0).to(torch.int32), cfg.minerror_rect,
            cfg.size_thre_rect, cfg.ls_cap_for(iw, ih), cfg,
            return_comp=True)
        hyp = hypotheses(arena, lsid, boundary, iw, ih, cfg, comp, bcomp)
        out.append(RectHypotheses(mask, seg, boundary, lsid, *hyp))
    return out


def rect_geometry(segs: torch.Tensor, valid: torch.Tensor,
                  status: torch.Tensor, iw: int, ih: int, tan_aov: float,
                  cfg: PipelineConfig = DEFAULT_CONFIG) -> RectResult:
    """The hypotheses -> RectResult (the reduction and pose of
    rect_geometry_tail, rectdetect_tpu/pipeline/rect.py:355-379): each group
    reduced to a quad (#15), its pose (the pose kernel), the screen test,
    status bit 0, then the sanitising: a group whose pose residual is not
    finite is not valid, and a group that is not valid gets value inf and
    zero corners.  `hyp_pallas` selects the kernels on a CUDA device (1,
    the default) or the plain versions (0); a CPU tensor always takes the
    plain versions.  tan_aov: tan of half the horizontal angle of view,
    divided into iw/2 in float32."""
    if cfg.hyp_pallas:
        reduce_fn, pose_fn = hopper_hyp.reduce_groups, \
            hopper_pose.pose_estimate
    else:
        reduce_fn, pose_fn = quad.reduce_groups, pose.pose_estimate
    corners, ok = reduce_fn(segs, valid, cfg.hull_max_vertices)
    c2, c3, val = pose_fn(corners, iw, ih, tan_aov, cfg.cg_iters,
                          cfg.cg_line_search_iters)
    screen = pose.looks_like_a_screen(c2, c3, val, cfg.accept_value,
                                      cfg.aspect_limit,
                                      cfg.offset_ratio_limit)
    status = status | screen.to(torch.int32)
    # degenerate groups carry NaN through the pose; sanitise so that
    # reductions over the fixed-capacity result are safe
    ok = ok & torch.isfinite(val)
    val = torch.where(ok, val, float("inf"))
    c2 = torch.where(ok[:, None, None], torch.nan_to_num(c2), 0.0)
    c3 = torch.where(ok[:, None, None], torch.nan_to_num(c3), 0.0)
    return RectResult(c2=c2, c3=c3, value=val, status=status, valid=ok)


def rect_tail(packed0: torch.Tensor, edge_thin: torch.Tensor,
              edge_bin: torch.Tensor, tan_aov: float,
              cfg: PipelineConfig = DEFAULT_CONFIG) -> RectResult:
    """rect_frame from the front-end's products (the JAX package's
    rect_tail)."""
    hyp = tail_hypotheses(packed0, edge_thin, edge_bin, cfg)
    ih, iw = edge_bin.shape
    return rect_geometry(hyp.segs, hyp.valid, hyp.status, iw, ih, tan_aov,
                         cfg)


def rect_geometry_tail(strong_bin: torch.Tensor, boundary: torch.Tensor,
                       tan_aov: float, cfg: PipelineConfig = DEFAULT_CONFIG,
                       group=None) -> RectResult:
    """Polylines, hypotheses and pose from the whole frame's strong-edge map
    (int32 0/1) and boundary labels (oclrect.c:361-381 + executeCPUTask;
    rectdetect_tpu/pipeline/rect.py:rect_geometry_tail), for the width-tiled
    path (dist/tile.py), which computes both maps on its tiles.  The
    boundary groups are numbered in flat order of their roots, as the JAX
    package's dense branch (densify_labels) numbers them: through a
    compaction of every boundary pixel, which holds the frame, so nothing
    is dropped (rect_frame's boundary_labels drops the pixels past its
    capacity; the two agree below it).  group: the tiled path's
    TileGroup, whose first tile holds both maps; the polylines' arc walk
    and subdivision run by slot range over its tiles (polyline_execute),
    the rest on the first tile's device."""
    ih, iw = strong_bin.shape
    arena, lsid, comp = polyline_execute(
        strong_bin, cfg.minerror_rect, cfg.size_thre_rect,
        cfg.ls_cap_for(iw, ih), cfg, return_comp=True, group=group)
    bcomp = compact_mask((boundary != -1).reshape(-1), ih * iw)
    segs, valid, status = hypotheses(arena, lsid, boundary, iw, ih, cfg,
                                     comp, bcomp)
    return rect_geometry(segs, valid, status, iw, ih, tan_aov, cfg)


def rect_frame(bgr: torch.Tensor, tan_aov: float,
               cfg: PipelineConfig = DEFAULT_CONFIG) -> RectResult:
    """BGR (H,W,3) uint8 frame, on the CPU or a CUDA device -> RectResult.
    A (B,H,W,3) stack goes to rect_frames."""
    if bgr.dim() != 3:
        raise NotImplementedError("rect_frame takes one (H,W,3) frame; "
                                  "rect_frames takes a (B,H,W,3) stack")
    hyp = rect_hypotheses(bgr, cfg)
    ih, iw = bgr.shape[:2]
    return rect_geometry(hyp.segs, hyp.valid, hyp.status, iw, ih, tan_aov,
                         cfg)


def stack_results(results):
    """A list of per-frame NamedTuples -> one of the same type whose fields
    are the frames' fields stacked on a leading axis."""
    return type(results[0])(*(torch.stack(f) for f in zip(*results)))


def rect_frames(frames: torch.Tensor, tan_aov: float,
                cfg: PipelineConfig = DEFAULT_CONFIG) -> RectResult:
    """Batched throughput mode (the JAX package's rect_frames): frames
    (B,H,W,3) uint8, on the CPU or a CUDA device -> RectResult with a
    leading B axis; each frame's slice equals rect_frame on that frame bit
    for bit.  The dense stages run once on the stack, one launch of each
    kernel's batch form for all B frames: the front end (K1, K2), K3's
    rect strings, region_smoothing (blblur #12, quant_despeckle #5) and
    region_merge (merge_mask #6, the links CCL #9, despeckle2 #8).  The
    rest runs frame by frame on the same device and stream: the labels
    and strength filters, the boundary labels, the polylines, the
    hypotheses and the geometry rest on slot lists and capacities of a
    frame, and the polyline stage reads the device from the host
    (ops/polyline.py)."""
    if frames.dim() != 4 or frames.shape[0] < 1:
        raise ValueError(f"rect_frames takes a (B,H,W,3) stack, got "
                         f"{tuple(frames.shape)}")
    fe = edge_frontend(frames, cfg)
    ih, iw = frames.shape[1:3]
    return stack_results([
        rect_geometry(h.segs, h.valid, h.status, iw, ih, tan_aov, cfg)
        for h in tail_hypotheses_frames(fe.packed0, fe.edge_thin,
                                        fe.edge_bin, cfg)])


def stage_maps(bgr: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG):
    """The stages of rect_hypotheses up to the polylines of the strong
    edges, kept: returns (images, rect_strings), where `images` is
    rect_stage_images' dict and rect_strings the stringified map that the
    weak/strong labels come from (the calibration measures it)."""
    fe = edge_frontend(bgr, cfg)
    weak_lbl, strong_lbl, s = weak_strong_labels(fe.edge_bin, fe.edge_thin,
                                                 cfg, return_strings=True)
    blurred, despeck = region_smoothing(fe.packed0, weak_lbl, fe.edge_thin,
                                        cfg)
    mask, seg = region_merge(despeck, strong_lbl, cfg)
    boundary, _ = boundary_labels(seg, cfg)
    ih, iw = seg.shape
    _, lsid = polyline_execute(
        (strong_lbl > 0).to(torch.int32), cfg.minerror_rect,
        cfg.size_thre_rect, cfg.ls_cap_for(iw, ih), cfg)
    images = {
        "edge_thin": fe.edge_thin,          # oclrect.c:260
        "weak_labels": weak_lbl,            # oclrect.c:280
        "blblur": blurred,                  # oclrect.c:298
        "despeckled": despeck,              # oclrect.c:305
        "strong_labels": strong_lbl,        # oclrect.c:310
        "merge_mask": mask,                 # oclrect.c:323
        "regions": seg,                     # oclrect.c:338
        "boundary": boundary,               # oclrect.c:344
        "lsid": lsid,                       # oclrect.c:363
    }
    return images, s


def rect_stage_images(bgr: torch.Tensor,
                      cfg: PipelineConfig = DEFAULT_CONFIG) -> dict:
    """The intermediate stage images of the rect path, by name, for the
    debug dumps (utils.debug.StageDumper): the observability points the
    reference left as commented-out visualization hooks
    (oclrect.c:255-363).  The same nine maps as the JAX package's
    rect_stage_images, from the port's own stages: exact labels where the
    JAX CPU path runs a fixed-pass CCL, and the boundary pixels past the
    boundary compaction dropped to -1, as rect_hypotheses sees them."""
    return stage_maps(bgr, cfg)[0]


# renderer kind per stage, for utils.debug.StageDumper
STAGE_KINDS = {
    "edge_thin": "gray", "weak_labels": "labels", "blblur": "packed",
    "despeckled": "packed", "strong_labels": "labels",
    "merge_mask": "binary", "regions": "labels", "boundary": "labels",
    "lsid": "labels",
}


def live_rects(res: RectResult) -> list[dict]:
    """Host side: the surviving hypotheses as a list of dicts (the rect_t
    list consumption, rect.cpp:107-121)."""
    c2, c3, val, stat, ok = (t.cpu().numpy() for t in res)
    return [{"c2": c2[i], "c3": c3[i], "value": float(val[i]),
             "status": int(stat[i])} for i in range(c2.shape[0]) if ok[i]]

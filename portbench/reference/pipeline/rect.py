"""The rect pipeline's per-pixel stages after the front end, up to the
region labels (the port's pipeline/rect.py as it stood, frozen; frame.py
composes them into whole frames, and reference/upstream/ takes the rest).

Mirrors oclrect.c:262-336: the weak/strong edge labels (strings
morphology, kernel K3; exact labels, K4; the strength pair with the
segmented scan, #10, or under EXTENDED_CONFIG K3's bridge2 variant and the
staged strength filters with their rescue rounds), the edge-limited blur
(#12) and quantize + despeckle (#5) of the packed-Lab plane, and the
region merge (merge mask #6, links CCL #9, despeckle2 #8).
"""

from __future__ import annotations

import torch

from portbench.reference.config import DEFAULT_CONFIG, PipelineConfig
from portbench.reference.ops import ccl
from portbench.reference.ops.compact import compact_mask
from portbench.reference.ops.plain_kernels import (blblur,
                                                   junction_merge_mask,
                                                   label_components,
                                                   label_merge,
                                                   quantize_despeckle,
                                                   sizes_despeckle2,
                                                   strings_chain)


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
    (slot lists of every pixel: no capacity).  Returns (weak_lbl,
    strong_lbl)."""
    rounds = cfg.strength_rescue_rounds
    ih, iw = s.shape
    sp = ih * iw
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

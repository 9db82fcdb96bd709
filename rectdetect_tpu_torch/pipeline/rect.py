"""The rect pipeline's edge labeling and region smoothing (port of part of
rectdetect_tpu/pipeline/rect.py:rect_tail).

Mirrors oclrect.c:262-312: the weak/strong edge labels (strings
morphology, kernel K3; exact labels, K4; the strength pair with the
segmented scan, #10), then the edge-limited blur (#12) and quantize +
despeckle (#5) of the packed-Lab plane.  Together they give the maps the
region merge reads: weak_lbl, strong_lbl, blurred and despeck.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.ops import ccl
from rectdetect_tpu_torch.ops.hopper_blblur import blblur
from rectdetect_tpu_torch.ops.hopper_ccl import label_components
from rectdetect_tpu_torch.ops.hopper_morph import strings_chain
from rectdetect_tpu_torch.ops.hopper_quant import quantize_despeckle


def weak_strong_labels(edge_bin: torch.Tensor, edge_thin: torch.Tensor,
                       cfg: PipelineConfig = DEFAULT_CONFIG):
    """Weak/strong edge labeling (oclrect.c:262-312): stringify, label,
    strength-filter at both thresholds.  Returns (weak_lbl, strong_lbl),
    (H,W) int32 each: a surviving pixel keeps its component label (the
    component's minimum flat index), a filtered interior pixel is -1.

    Only the JAX package's `rect_strength_dense` branch is ported.  Its
    labels come from the exact K4; the JAX package's CPU path labels with a
    fixed-pass CCL and its TPU path with capped pieces, which the exact
    labels are the converged form of."""
    if not (cfg.sparse_factor and cfg.rect_strength_dense):
        raise NotImplementedError("the port runs the dense strength pair "
                                  "only (sparse_factor > 0, "
                                  "rect_strength_dense=1)")
    if cfg.strength_rescue_rounds:
        raise NotImplementedError("strength_rescue_rounds is not ported yet")
    if cfg.bridge_gap2:
        raise NotImplementedError("bridge_gap2 is not ported yet")
    ih, iw = edge_bin.shape
    sp = max(4096, ih * iw // cfg.sparse_factor)
    s = strings_chain(edge_bin, "rect")
    lbl = label_components(s, 0)
    return ccl.strength_filter_pair_dense(edge_thin, lbl, sp,
                                          cfg.strength_weak,
                                          cfg.strength_strong,
                                          cfg.strength_scale)


def region_smoothing(packed0: torch.Tensor, weak_lbl: torch.Tensor,
                     edge_thin: torch.Tensor,
                     cfg: PipelineConfig = DEFAULT_CONFIG):
    """Edge-limited blur + quantize + despeckle (oclrect.c:286-303) of the
    packed-Lab plane, limited by the weak edges.  Returns (blurred,
    despeck), (H,W) int32 packed Lab each."""
    weak_bin = (weak_lbl > 0).to(torch.int32)
    blurred = blblur(packed0, weak_bin, cfg.blblur_iters)
    n = cfg.quantize_levels
    despeck = quantize_despeckle(blurred, edge_thin, n, n, n)
    return blurred, despeck

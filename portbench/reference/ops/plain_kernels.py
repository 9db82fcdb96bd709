"""The plain PyTorch forms of the port's hand-written per-pixel kernels, under
the names its pipeline imports them by.

In the port each of these names is a wrapper that launches a CUDA kernel
for a CUDA tensor and calls the plain form for a CPU tensor.  Here every
name is the plain form on any device, so the reference computes each
kernel's function with no kernel of the port.  The plain forms are the
port's own, frozen: those the wrappers' modules kept are copied below
(edgevec and edge magnitude, thinning) and in
ops/scan.py (the segmented scans); the rest live in the copied modules
and are re-exported.
"""

from __future__ import annotations

import torch

from portbench.reference.core.color import quantize_labf
from portbench.reference.ops import gradient, thin
from portbench.reference.ops.ccl import label_components_plain
from portbench.reference.ops.morphology import strings_chain
from portbench.reference.ops.regions import (blblur, junction_merge_mask,
                                             label_merge, quantize_despeckle,
                                             sizes_despeckle2)
from portbench.reference.ops.scan import seg_scan_sorted, seg_total_sorted

__all__ = ["blblur", "edge_front", "junction_merge_mask",
           "label_components", "label_merge", "quantize_despeckle",
           "seg_scan_sorted", "seg_total_sorted", "sizes_despeckle2",
           "strings_chain", "thinthres"]


def label_components(pix: torch.Tensor, bgc: int = 0) -> torch.Tensor:
    """K4: exact 8-connected equal-value labels, the component's minimum
    flat index, background bgc -> -1."""
    return label_components_plain(pix, bgc)


def edge_front(labb: torch.Tensor):
    """K1: labb ([B,]H,W,3) f32 -> (em, vec): edgevec of the L plane and
    the Lab edge magnitude of the re-quantized planes."""
    vec = gradient.edgevec(labb[..., 0])
    em = gradient.edge_lab(quantize_labf(labb))
    return em, vec


def thinthres(em: torch.Tensor, vec: torch.Tensor, mode: str = "thres",
              slack: float = 0.99, x0: int = 0):
    """K2: bicubic non-maximum suppression."""
    if mode == "thres":
        return thin.thinthres(em, vec, x0)
    if mode == "cubic":
        return thin.thincubic(em, vec, slack, x0)
    raise ValueError(f"unknown thinning mode {mode!r}")

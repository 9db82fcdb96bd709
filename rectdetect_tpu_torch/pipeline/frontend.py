"""Shared edge front-end: BGR frame -> thinned edge magnitude + binary map
(port of rectdetect_tpu/pipeline/frontend.py).

Mirrors the head of genGPUTask (oclrect.c:245-263) and the poly tool's
pipeline (poly.cpp:104-121): packed-Lab conversion (the closed form, or
with `color_exact` the reference's fixed-point LUT conversion), the
Gaussian blur per channel (r = blur_radius, 2 by default), K1 (edgevec +
Lab edge magnitude), K2 (bicubic NMS thinning).

A stack of frames (B,H,W,3) runs the same steps once on the stack: the
colour conversion and the blur are element-wise over the leading axis,
and K1 and K2 are one launch each of their batch forms.  Each frame's
slice equals the single-frame call on that frame bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.ops import blur
from rectdetect_tpu_torch.ops.hopper_grad import edge_front
from rectdetect_tpu_torch.ops.hopper_thin import thinthres


class EdgeFrontend(NamedTuple):
    """Each field has the frames' leading axis where the input has one."""
    packed0: torch.Tensor    # original packed Lab (H,W) int32
    labb: torch.Tensor       # blurred Lab float planes (H,W,3)
    edge_thin: torch.Tensor  # thinned edge magnitude (H,W) f32
    edge_bin: torch.Tensor   # (H,W) int32 0/1 of edge_thin > 0


def edge_frontend(bgr: torch.Tensor,
                  cfg: PipelineConfig = DEFAULT_CONFIG) -> EdgeFrontend:
    """bgr (H,W,3) or (B,H,W,3) uint8 on the CPU or a CUDA device."""
    if bgr.dim() not in (3, 4) or bgr.shape[-1] != 3:
        raise ValueError(f"edge_frontend takes (H,W,3) or (B,H,W,3) frames, "
                         f"got {tuple(bgr.shape)}")
    if cfg.color_exact:
        # bit parity with the reference's fixed-point LUT conversion
        packed0 = color.bgr_to_packed_exact(bgr)
        labq = color.unpack_labf(packed0)
    else:
        lab = color.bgr_to_labf(bgr)
        labq = color.quantize_labf(lab)      # = unpack(pack(lab)) centers
        packed0 = color.pack_lab(lab)
    labb = torch.stack([blur.gaussian_blur(labq[..., c], cfg.blur_radius)
                        for c in range(3)], dim=-1)
    em, vec = edge_front(labb)
    edge_thin = thinthres(em, vec)
    edge_bin = (edge_thin > 0).to(torch.int32)
    return EdgeFrontend(packed0, labb, edge_thin, edge_bin)

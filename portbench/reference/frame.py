"""The reference's whole frames: rect and poly detection of camera frames.
The per-pixel stages run in plain PyTorch on any device (the frozen copy
of the port's plain path in this package, with no kernel and nothing else
of the port, and no capacity); the polylines, the hypotheses, their
reduction and the pose run on the host in NumPy with upstream's semantics,
written apart from the port (reference/upstream/).

`lowp=True` is the control: the same computation with every float stage's
result rounded to bfloat16 (the Lab planes, the blurred planes, the edge
magnitude and direction, the thinned edge map, and the outputs' corners,
3D corners, residuals and segment end points), the precision below the
float32 the configurations state.  A comparison that cannot tell it from
the float32 reference tells nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.core import color
from portbench.reference.ops import blur, ccl
from portbench.reference.ops.plain_kernels import (edge_front,
                                                   label_components,
                                                   thinthres)
from portbench.reference.pipeline.rect import (rect_strings, region_merge,
                                               region_smoothing,
                                               strength_labels)
from portbench.reference.upstream.polyline import (live_segments,
                                                   polyline_execute)
from portbench.reference.upstream.rect import rect_tail


class EdgeFrontend(NamedTuple):
    packed0: torch.Tensor    # original packed Lab (H,W) int32
    labb: torch.Tensor       # blurred Lab float planes (H,W,3)
    edge_thin: torch.Tensor  # thinned edge magnitude (H,W) f32
    edge_bin: torch.Tensor   # (H,W) int32 0/1 of edge_thin > 0


def _round(t: torch.Tensor, lowp: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if lowp else t


def frontend(bgr: torch.Tensor, cfg, lowp: bool = False) -> EdgeFrontend:
    """The port's edge_frontend on one (H,W,3) uint8 frame."""
    if cfg.color_exact:
        packed0 = color.bgr_to_packed_exact(bgr)
        labq = color.unpack_labf(packed0)
    else:
        lab = _round(color.bgr_to_labf(bgr), lowp)
        labq = color.quantize_labf(lab)
        packed0 = color.pack_lab(lab)
    labb = _round(torch.stack([blur.gaussian_blur(labq[..., c],
                                                  cfg.blur_radius)
                               for c in range(3)], dim=-1), lowp)
    em, vec = edge_front(labb)
    edge_thin = _round(thinthres(_round(em, lowp), _round(vec, lowp)), lowp)
    return EdgeFrontend(packed0, labb, edge_thin,
                        (edge_thin > 0).to(torch.int32))


def _bf16(a, lowp: bool):
    """A float64 array rounded through bfloat16 where lowp."""
    if not lowp:
        return a
    return torch.from_numpy(np.asarray(a, np.float64)).to(
        torch.bfloat16).to(torch.float64).numpy()


def rect_frame(bgr: torch.Tensor, tan_aov: float, cfg,
               lowp: bool = False) -> list[dict]:
    """rect_frame of one (H,W,3) uint8 frame -> its rectangles {c2, c3,
    value, status}."""
    fe = frontend(bgr, cfg, lowp)
    s = rect_strings(fe.edge_bin, cfg)
    weak, strong = strength_labels(s, fe.edge_thin, cfg)
    _, despeck = region_smoothing(fe.packed0, weak, fe.edge_thin, cfg)
    _, seg = region_merge(despeck, strong, cfg)
    rects = rect_tail(seg.cpu().numpy().astype(np.int64),
                      (strong > 0).cpu().numpy().astype(np.int64), tan_aov,
                      cfg.minerror_rect, cfg.size_thre_rect)
    for r in rects:
        r["c2"], r["c3"] = _bf16(r["c2"], lowp), _bf16(r["c3"], lowp)
        r["value"] = float(_bf16(r["value"], lowp))
    return rects


def poly_frame(bgr: torch.Tensor, cfg, minerror: float, size_thre: int,
               strength: int, lowp: bool = False) -> list[dict]:
    """poly_frame of one frame -> its live segments {x0, y0, x1, y1}."""
    fe = frontend(bgr, cfg, lowp)
    lbl = label_components(fe.edge_bin, 0)
    st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale)
    filtered = ccl.filter_strength(lbl, st, strength)
    if cfg.strength_rescue_rounds:
        filtered = ccl.rescue_filtered(lbl, filtered,
                                       cfg.strength_rescue_rounds)
    edge = (filtered > 0).cpu().numpy().astype(np.int64)
    segs, _ = polyline_execute(edge, minerror, size_thre)
    live = live_segments(segs)
    for d in live:
        for k in ("x0", "y0", "x1", "y1"):
            d[k] = float(_bf16(d[k], lowp))
    return live

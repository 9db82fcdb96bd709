"""The poly pipeline: frame -> refined line segments (port of
rectdetect_tpu/pipeline/poly.py).

Mirrors poly.cpp:104-123 / vidpoly.cpp:151-166: edge front-end (K1, K2),
exact labels of the thinned edge map (K4), the weak-edge strength filter,
then the polyline stage (K3, the arc walk, subdivision, refinement).
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.ops import ccl, polyline
from rectdetect_tpu_torch.ops.hopper_ccl import label_components
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.rect import stack_results


def poly_frame(bgr: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG,
               minerror: float = 1.0, size_thre: int = 20,
               strength: int = 500):
    """BGR (H,W,3) uint8 -> (SegmentArena, lsid (H,W) int32), on the
    device of `bgr`.

    Defaults are the poly tool's (poly.cpp:120-123); vidpoly uses
    strength=2000, size_thre=10 (vidpoly.cpp:158-166).  The JAX package
    labels the weak edges with round-capped pieces on the TPU and a
    fixed-pass CCL on the CPU; the port's labels are exact, which is the
    converged result those approximate.  strength_rescue_rounds (the
    EXTENDED_CONFIG accuracy extension) repairs the filter's output
    (ccl.rescue_filtered), and bridge_gap2 runs the polyline's K3 with its
    bridge2 stage."""
    if bgr.dim() != 3:
        raise ValueError("poly_frame takes one (H,W,3) frame; poly_frames "
                         "takes a (B,H,W,3) stack")
    return _poly_tail(edge_frontend(bgr, cfg), cfg, minerror, size_thre,
                      strength)


def poly_frames(frames: torch.Tensor, cfg: PipelineConfig = DEFAULT_CONFIG,
                minerror: float = 1.0, size_thre: int = 20,
                strength: int = 500):
    """poly_frame on a (B,H,W,3) uint8 stack -> (SegmentArena with a
    leading B axis on every field, lsid (B,H,W) int32); each frame's slice
    equals poly_frame on that frame bit for bit.  The front end runs once
    on the stack (K1 and K2 one launch each), the rest frame by frame."""
    if frames.dim() != 4 or frames.shape[0] < 1:
        raise ValueError(f"poly_frames takes a (B,H,W,3) stack, got "
                         f"{tuple(frames.shape)}")
    fe = edge_frontend(frames, cfg)
    outs = [_poly_tail(type(fe)(*(f[i] for f in fe)), cfg, minerror,
                       size_thre, strength) for i in range(frames.shape[0])]
    return (stack_results([a for a, _ in outs]),
            torch.stack([lsid for _, lsid in outs]))


def _poly_tail(fe, cfg, minerror, size_thre, strength):
    """poly_frame after the front end, on one frame's EdgeFrontend."""
    h, w = fe.edge_bin.shape
    lbl = label_components(fe.edge_bin, 0)
    st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale)
    filtered = ccl.filter_strength(lbl, st, strength)
    if cfg.strength_rescue_rounds:
        filtered = ccl.rescue_filtered(lbl, filtered,
                                       cfg.strength_rescue_rounds)
    edge = (filtered > 0).to(torch.int32)
    cap = cfg.ls_cap_for(w, h)
    return polyline.polyline_execute(edge, minerror, size_thre, cap, cfg)


def live_segments(arena):
    """Host-side convenience: dicts for live segments keyed by arena id
    (mirrors the poly.cpp:137-154 drawing walk)."""
    a = {k: v.cpu().numpy() for k, v in arena._asdict().items()}
    out = []
    for g in range(1, int(a["count"]) + 1):
        if a["polyid"][g] == 0:
            continue
        out.append({"id": g,
                    "x0": float(a["sx"][g]), "y0": float(a["sy"][g]),
                    "x1": float(a["ex"][g]), "y1": float(a["ey"][g]),
                    "left": int(a["left_ptr"][g]),
                    "right": int(a["right_ptr"][g])})
    return out

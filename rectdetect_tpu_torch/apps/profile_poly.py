"""Where a poly frame's time, and a rect frame's time, go on a CUDA card.

Usage: python -m rectdetect_tpu_torch.apps.profile_poly [frames] [image]

Without an image it runs bench.synth_frame(720, 1280, seed=0) (run from
the repository root), with DEFAULT_CONFIG.  Prints, for the CUDA device 0:
  * per-stage CUDA-event medians over `frames` frames (default 20):
    front-end, labels + strength filter, polyline stage, whole poly
    frame; the rect path's edge labeling (weak_strong_labels), region
    smoothing (blblur + quantize/despeckle), region merge, boundary
    labels, polylines of the strong edges, hypotheses, quad reduction
    (#15), pose, the whole geometry tail (reduction, pose, screen test,
    sanitising), the whole rect_hypotheses and the whole rect_frame;
  * for the poly frame, the region path (front-end, edge labeling,
    region smoothing), rect_hypotheses, its hypotheses stage alone, the
    geometry tail and rect_frame, a torch.profiler table of the ops with
    the most device time over 5 runs, the summed kernel time, the kernel
    launches per run and the device idle share of the profiled wall time
    (1 - kernel time / wall time).
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from rectdetect_tpu_torch.apps import common
from rectdetect_tpu_torch.apps.common import TAN_AOV


def _stages(bgr, cfg):
    from rectdetect_tpu_torch.ops import ccl, hopper_hyp, hopper_pose, polyline
    from rectdetect_tpu_torch.ops.hopper_ccl import label_components
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.rect import (
        boundary_labels, hypotheses, rect_geometry, region_merge,
        region_smoothing, weak_strong_labels)

    h, w = bgr.shape[:2]
    state = {}

    def frontend():
        state["fe"] = edge_frontend(bgr, cfg)

    def labels():
        fe = state["fe"]
        lbl = label_components(fe.edge_bin, 0)
        st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale)
        state["edge"] = (ccl.filter_strength(lbl, st, cfg.strength_poly)
                         > 0).to(torch.int32)

    def tail():
        polyline.polyline_execute(state["edge"], cfg.minerror_poly,
                                  cfg.size_thre_poly, cfg.ls_cap_for(w, h),
                                  cfg)

    def edge_labeling():
        fe = state["fe"]
        state["weak"], state["strong"] = weak_strong_labels(
            fe.edge_bin, fe.edge_thin, cfg)

    def smoothing():
        fe = state["fe"]
        state["despeck"] = region_smoothing(fe.packed0, state["weak"],
                                            fe.edge_thin, cfg)[1]

    def merge():
        state["seg"] = region_merge(state["despeck"], state["strong"],
                                    cfg)[1]

    def boundary():
        state["boundary"], state["bcomp"] = boundary_labels(state["seg"],
                                                            cfg)

    def rect_polyline():
        state["pl"] = polyline.polyline_execute(
            (state["strong"] > 0).to(torch.int32), cfg.minerror_rect,
            cfg.size_thre_rect, cfg.ls_cap_for(w, h), cfg, return_comp=True)

    def hyp():
        arena, lsid, comp = state["pl"]
        state["hyp"] = hypotheses(arena, lsid, state["boundary"], w, h, cfg,
                                  comp, state["bcomp"])

    def reduce():
        segs, valid, _ = state["hyp"]
        state["corners"] = hopper_hyp.reduce_groups(
            segs, valid, cfg.hull_max_vertices)[0]

    def pose():
        hopper_pose.pose_estimate(state["corners"], w, h, TAN_AOV,
                                  cfg.cg_iters, cfg.cg_line_search_iters)

    def geometry():
        rect_geometry(*state["hyp"], w, h, TAN_AOV, cfg)

    return (("front-end (colour, blur, K1, K2)", frontend),
            ("labels + strength (K4)", labels),
            ("polyline (K3, walk, mkpl, refine)", tail),
            ("rect edge labeling (K3, K4, #10)", edge_labeling),
            ("rect region smoothing (#12, #5)", smoothing),
            ("rect region merge (#6, #9, #8)", merge),
            ("rect boundary labels (K4)", boundary),
            ("rect polylines of the strong edges", rect_polyline),
            ("rect hypotheses (#7, tables, members)", hyp),
            ("rect quad reduction (#15)", reduce),
            ("rect pose (pose kernel)", pose),
            ("rect geometry: reduction, pose, screen", geometry))


def _profile(name, fn, runs=5):
    """torch.profiler over `runs` calls of fn: the top ops by device time,
    kernel time, launches and idle share per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    print(f"--- {name}")
    print(events.table(sort_by=attr, row_limit=25))
    kernels = [e for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    dev_us = sum(getattr(e, attr) for e in kernels)
    launches = sum(e.count for e in kernels)
    if not kernels or dev_us <= 0:
        print(f"{name}: profiled {runs} runs: wall {wall_ms:.3f} ms; device "
              "kernel time not measured (the profiler traced no kernels)")
        return
    print(f"{name}: profiled {runs} runs: wall {wall_ms / runs:.3f} ms, "
          f"device kernel time {dev_us / 1e3 / runs:.3f} ms, device idle "
          f"share {1.0 - dev_us / 1e3 / wall_ms:.4f}, "
          f"{launches / runs:.0f} kernel launches per run")


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        sys.exit("profile_poly needs a CUDA card")
    frames = int(argv[1]) if len(argv) >= 2 else 20
    if len(argv) >= 3:
        img = common.load_image_bgr(argv[2])
    else:
        from bench import synth_frame
        img = synth_frame(720, 1280, seed=0)

    from rectdetect_tpu_torch.config import DEFAULT_CONFIG
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.poly import poly_frame
    from rectdetect_tpu_torch.pipeline.rect import (rect_frame,
                                                    rect_hypotheses,
                                                    region_smoothing,
                                                    weak_strong_labels)

    dev = torch.device("cuda", 0)
    bgr = torch.from_numpy(img).to(dev)
    cfg = DEFAULT_CONFIG
    stages = _stages(bgr, cfg) + (
        ("whole frame (poly_frame)", lambda: poly_frame(bgr, cfg)),
        ("rect_hypotheses (frame -> hypotheses)",
         lambda: rect_hypotheses(bgr, cfg)),
        ("rect_frame (frame -> rectangles)",
         lambda: rect_frame(bgr, TAN_AOV, cfg)))
    for _ in range(3):
        for _, fn in stages:
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name, _ in stages}
    for _ in range(frames):
        for name, fn in stages:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    print(f"{torch.cuda.get_device_name(0)}; frame {img.shape[1]}x"
          f"{img.shape[0]}; CUDA-event medians over {frames} frames:")
    for name, ts in times.items():
        print(f"  {name:42s} {statistics.median(ts):9.3f} ms "
              f"(min {min(ts):.3f}, max {max(ts):.3f})")

    def region_path():
        fe = edge_frontend(bgr, cfg)
        weak, _ = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
        region_smoothing(fe.packed0, weak, fe.edge_thin, cfg)

    _profile("poly_frame", lambda: poly_frame(bgr, cfg))
    _profile("edge_frontend -> weak_strong_labels -> region_smoothing",
             region_path)
    _profile("rect_hypotheses", lambda: rect_hypotheses(bgr, cfg))
    named = dict(stages)
    _profile("hypotheses", named["rect hypotheses (#7, tables, members)"])
    _profile("rect geometry", named["rect geometry: reduction, pose, screen"])
    _profile("rect_frame", lambda: rect_frame(bgr, TAN_AOV, cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())

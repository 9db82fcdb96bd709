"""Whether a frame overflows one of the port's capacities that can change
what it detects: the strength pair's rows and the boundary compaction (a
copy of the port's kernel check's overflow_flags), the segment arena
(ls_cap_for), the hypothesis groups (max_groups: every boundary component
takes a group, every polyline chain another) and a group's members
(max_group_segs).  Each is read from the program's own public stage
functions on the frame; past a capacity the port drops what does not fit,
and upstream, whose lists grow, does not.  A run whose checked frames
overflow any of them is not correct."""

from __future__ import annotations

import numpy as np
import torch


def _chains(arena) -> tuple[int, int]:
    """(number of polyline chains, most segments longer than 32 px in a
    chain), source B's groups and members."""
    a = {k: v.cpu().numpy() for k, v in arena._asdict().items()}
    live = a["polyid"] != 0
    heads = [i for i in range(1, int(a["count"]) + 1)
             if live[i] and a["left_ptr"][i] <= 0]
    most = 0
    for i in heads:
        n, j = 0, i
        while j > 0:
            n += (a["sx"][j] - a["ex"][j]) ** 2 + \
                (a["sy"][j] - a["ey"][j]) ** 2 > 32.0 ** 2
            j = int(a["right_ptr"][j])
        most = max(most, n)
    return len(heads), most


def rect_flags(bgr: torch.Tensor, cfg) -> dict:
    from rectdetect_tpu_torch.ops import hopper_morph, reduce_ls, regions
    from rectdetect_tpu_torch.ops.polyline import polyline_execute
    from rectdetect_tpu_torch.ops.shifts import interior_mask
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.rect import (boundary_labels,
                                                    region_merge,
                                                    region_smoothing,
                                                    weak_strong_labels)
    h, w = bgr.shape[:2]
    n = h * w
    fe = edge_frontend(bgr, cfg)
    s = hopper_morph.strings_chain(fe.edge_bin, "rect", cfg.bridge_gap2)
    rows = int(((s > 0) & interior_mask(h, w, 1, s.device)).sum())
    weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
    despeck = region_smoothing(fe.packed0, weak, fe.edge_thin, cfg)[1]
    seg = region_merge(despeck, strong, cfg)[1]
    marks = int((regions.mark_boundary(seg) != -1).sum())
    boundary, bcomp = boundary_labels(seg, cfg)
    flat = boundary.reshape(-1)
    groups = int(((flat == torch.arange(n, dtype=flat.dtype,
                                        device=flat.device))
                  & (flat >= 0)).sum())
    cap = cfg.ls_cap_for(w, h)
    arena, _ = polyline_execute((strong > 0).to(torch.int32),
                                cfg.minerror_rect, cfg.size_thre_rect, cap,
                                cfg)
    gmax = max(cfg.max_groups, groups)
    table = reduce_ls.densify_labels_sparse(boundary, bcomp, gmax, bg=-1)[0]
    counts = reduce_ls.probe_members(boundary, arena, gmax, table,
                                     cfg.max_group_segs, cfg.probe_n,
                                     cfg.probe_dist)[2]
    chains, chain_most = _chains(arena)
    members = max(int(counts.max()), chain_most)
    sp = max(4096, n // cfg.sparse_factor)
    spb = max(4096, n // cfg.boundary_sparse_factor)
    segs = int(arena.count)
    return {"strength_rows": rows, "strength_cap": sp,
            "strength_overflow": rows > sp, "boundary_pixels": marks,
            "boundary_cap": spb, "boundary_overflow": marks > spb,
            "groups": groups, "chains": chains, "max_groups": cfg.max_groups,
            "groups_overflow": max(groups, chains) > cfg.max_groups,
            "members": members, "max_group_segs": cfg.max_group_segs,
            "members_overflow": members > cfg.max_group_segs,
            "segments": segs, "segments_cap": cap,
            "segments_overflow": segs >= cap - 1}


def poly_flags(bgr: torch.Tensor, cfg, config: dict) -> dict:
    from rectdetect_tpu_torch.pipeline.poly import poly_frame
    h, w = bgr.shape[:2]
    cap = cfg.ls_cap_for(w, h)
    arena, _ = poly_frame(bgr, cfg, config["minerror"], config["size_thre"],
                          config["strength"])
    segs = int(arena.count)
    return {"segments": segs, "segments_cap": cap,
            "segments_overflow": segs >= cap - 1}


def flags(entry: str, bgr, cfg, config: dict) -> dict:
    return rect_flags(bgr, cfg) if entry == "rect" else \
        poly_flags(bgr, cfg, config)


def overflowing(all_flags) -> list[str]:
    """The capacities that any of the frames' flags shows overflowing."""
    return sorted({k[:-len("_overflow")] for f in all_flags
                   for k, v in f.items() if k.endswith("_overflow") and v})


def summary(all_flags) -> dict:
    """The largest reading of each count over the frames."""
    keys = {k for f in all_flags for k, v in f.items()
            if not k.endswith("_overflow")}
    return {k: int(np.max([f[k] for f in all_flags if k in f]))
            for k in sorted(keys)}

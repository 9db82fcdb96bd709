"""Per-device, per-resolution capacity calibration, kept in a plan file
like the reference's autotune plan (port of
rectdetect_tpu/runtime/calibrate.py).

The reference allocates its lists dynamically; the port's slot lists and
segment arena have fixed capacities, and a scene denser than they allow
loses what lies past them.  `calibrate` measures the foreground densities
of sample frames, derives capacities with a safety margin and saves them
under the key `<device kind>|<H>x<W>`; `load_calibrated_config` applies
them at start-up (loadPlan, rect.cpp:86); `plan_fits` says whether a frame
fits a plan.

The port keeps the capacities that can change its output: sparse_factor,
strings_sparse_factor, boundary_sparse_factor, arc_sparse_factor,
cycle_sparse_factor, ls_capacity and max_groups.  It does not measure the
densities that size only the switches it drops (the edge, run and
walk-survivor densities), and its kernels' tiles are fixed when they are
built, so nothing of the JAX package's kernel autotune carries over.

The plan file is `plan_torch.txt` in the working directory: the JAX
package's `plan.txt` holds TPU sections of its own.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.runtime import native

PLAN_PATH = "plan_torch.txt"
MARGIN = 1.6
# plan_fits' margin over a frame's densities
HEADROOM = 1.1
# the capacities calibrate() writes, in the order it writes them
KEPT = ("sparse_factor", "strings_sparse_factor", "boundary_sparse_factor",
        "arc_sparse_factor", "cycle_sparse_factor", "ls_capacity",
        "max_groups")
# the plan keys load_calibrated_config() applies: the kept capacities and
# the fields the port carries but does not read (switches it drops, TPU
# block geometry), so that a JAX-written section applies unchanged
APPLIED = KEPT + (
    "rect_strings_small", "strings_small_factor", "arc_small_factor",
    "region_run_factor", "walk_prefilter_factor", "ccl_bh", "pieces_bh",
    "merge_bh", "boundary_bh", "grad_bh", "thin_bh", "morph_bh", "quant_bh",
    "bids_bh", "blblur_block", "blblur_fuse")


def _density(count, n: int) -> float:
    """The float32 mean of a 0/1 map of n pixels, `count` of them set, as
    XLA computes it: count times the float32 reciprocal of n, which is not
    always the correctly rounded count / n."""
    return float(np.float32(int(count)) * np.float32(1.0 / n))


def _frame_densities(bgr: torch.Tensor, cfg: PipelineConfig) -> dict:
    from rectdetect_tpu_torch.ops.chain import arc_chain_sparse
    from rectdetect_tpu_torch.ops.compact import compact_mask
    from rectdetect_tpu_torch.ops.hopper_morph import strings_chain
    from rectdetect_tpu_torch.pipeline.rect import stage_maps

    one = dataclasses.replace(
        cfg, sparse_factor=1, strings_sparse_factor=1,
        boundary_sparse_factor=1, arc_sparse_factor=1, cycle_sparse_factor=1)
    st, srect = stage_maps(bgr, one)
    ih, iw = srect.shape
    n = ih * iw
    bflat = st["boundary"].reshape(-1)
    roots = (bflat == torch.arange(n, dtype=bflat.dtype,
                                   device=bflat.device)) & (bflat >= 0)
    strong_bin = (st["strong_labels"] > 0).to(torch.int32)
    strings = strings_chain(strong_bin, "poly_branch", cfg.bridge_gap2)
    comp = compact_mask((strings != 0).reshape(-1), n)
    # only the walk's cycle flags are read, and they do not depend on the
    # cycle sub-list's capacity
    cyc = arc_chain_sparse(strings, comp, cfg.number_doublings, 1024)[3]
    lsid = st["lsid"]
    return {"rect_d": _density((srect != 0).sum(), n),
            "strings_d": _density((strings != 0).sum(), n),
            "boundary_d": _density((bflat >= 0).sum(), n),
            "arcs_d": _density((lsid > 0).sum(), n),
            "n_arcs": int(lsid.max()),
            "cyc_d": _density(cyc.sum(), n),
            "groups": int(roots.sum())}


def _densities(bgr_frames, cfg: PipelineConfig = DEFAULT_CONFIG) -> dict:
    """The largest per-frame foreground densities of the sample frames, on
    the port's own path with every slot list at one slot a pixel (the
    arena at the capacity of `cfg`): the stringified "rect" map (sizes
    sparse_factor), the polyline strings (strings_sparse_factor), the
    boundary marks (boundary_sparse_factor), the arc pixels
    (arc_sparse_factor) and the number of segments (ls_capacity), the
    pixels on cycles (cycle_sparse_factor), and the boundary components,
    the hypothesis groups (max_groups).  Below overflow this is what the
    JAX package's _densities computes on its dense path."""
    out = dict.fromkeys(("rect_d", "strings_d", "boundary_d", "arcs_d",
                         "n_arcs", "cyc_d", "groups"), 0)
    for f in bgr_frames:
        for k, v in _frame_densities(torch.as_tensor(f), cfg).items():
            out[k] = max(out[k], v)
    return out


def _key(device_kind: str, h: int, w: int) -> str:
    return f"{device_kind}|{h}x{w}".replace(" ", "_")


def kind_of(dev) -> str:
    """The plan key's device part: the CUDA device's name, or "cpu"."""
    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def factor_for(density: float, cap: int = 64) -> int:
    """The slot-list factor whose list, H*W // factor, holds `density`
    with the margin, between 1 and `cap`."""
    d = min(max(density * MARGIN, 1e-4), 1.0)
    return max(1, min(cap, int(1.0 / d)))


def calibrate(bgr_frames, cfg: PipelineConfig = DEFAULT_CONFIG,
              plan_path: str = PLAN_PATH) -> PipelineConfig:
    """Measure the densities of the sample frames ((H,W,3) uint8 BGR
    tensors on the device to calibrate for), derive the capacities, save
    them in the section of the frames' device and size (other entries of
    the section and other sections kept) and return the calibrated
    config."""
    frames = [torch.as_tensor(f) for f in bgr_frames]
    h, w = frames[0].shape[:2]
    d = _densities(frames, cfg)
    new = dataclasses.replace(
        cfg,
        sparse_factor=factor_for(d["rect_d"], cap=16),
        strings_sparse_factor=factor_for(d["strings_d"], cap=24),
        boundary_sparse_factor=factor_for(d["boundary_d"], cap=32),
        arc_sparse_factor=factor_for(d["arcs_d"], cap=128),
        cycle_sparse_factor=factor_for(d["cyc_d"], cap=256),
        ls_capacity=int(min(max(d["n_arcs"] * 4 * MARGIN, 4096), 262144)),
        # the reference's group list is dynamic: cover the measured
        # boundary components, rounded up to 64, at most 2048
        max_groups=int(min(2048, max(cfg.max_groups,
                                     -(-int(d["groups"] * MARGIN) // 64)
                                     * 64))))
    key = _key(kind_of(frames[0].device), h, w)
    entries = native.plan_load(plan_path, key)
    entries.update({k: str(getattr(new, k)) for k in KEPT})
    native.plan_save(plan_path, key, entries)
    return new


def plan_fits(cfg: PipelineConfig, bgr: torch.Tensor) -> bool:
    """Does this frame's foreground fit the config's slot capacities?  A
    plan calibrated on a sparse scene class would truncate a denser one.
    Checks the stringified "rect" and "poly_branch" densities of the edge
    map against sparse_factor and strings_sparse_factor, and the strong
    edges' density, which bounds the arc pixels from above, against the
    arc list.  The strong edges come from the exact labels of the "rect"
    strings (K4), uncapped and without rescue rounds, as in the JAX
    package, which runs a fixed-pass CCL here, whose converged form the
    exact labels are; the strings take K3's bridge2 stage under
    bridge_gap2.  Callers recalibrate when
    it returns False (apps.rect) or warn (apps.vidrect)."""
    from rectdetect_tpu_torch.ops import ccl
    from rectdetect_tpu_torch.ops.hopper_ccl import label_components
    from rectdetect_tpu_torch.ops.hopper_morph import strings_chain
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend

    if not cfg.sparse_factor:
        return True
    fe = edge_frontend(torch.as_tensor(bgr), cfg)
    srect = strings_chain(fe.edge_bin, "rect", cfg.bridge_gap2)
    spoly = strings_chain(fe.edge_bin, "poly_branch", cfg.bridge_gap2)
    h, w = srect.shape
    n = h * w
    lbl = label_components(srect, 0)
    st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale)
    weak = ccl.filter_strength(lbl, st, cfg.strength_weak)
    strong = ccl.filter_strength(weak, st, cfg.strength_strong)
    rect_d = _density((srect != 0).sum(), n)
    poly_d = _density((spoly != 0).sum(), n)
    strong_d = _density((strong > 0).sum(), n)
    arc_cap_d = max(4096, n // cfg.arc_sparse_factor) / n
    return (rect_d * HEADROOM <= 1.0 / cfg.sparse_factor and
            poly_d * HEADROOM <= 1.0 / cfg.strings_sparse_factor and
            strong_d * HEADROOM <= arc_cap_d)


def plan_section(h: int, w: int, device,
                 plan_path: str = PLAN_PATH) -> dict[str, str]:
    """The plan's entries for `device` at HxW, {} when it has none."""
    return native.plan_load(plan_path, _key(kind_of(device), h, w))


def load_calibrated_config(h: int, w: int, device,
                           cfg: PipelineConfig = DEFAULT_CONFIG,
                           plan_path: str = PLAN_PATH,
                           verbose: bool = False) -> PipelineConfig:
    """`cfg` with the plan's section for `device` at HxW applied, or `cfg`
    itself when there is none (loadPlan)."""
    key = _key(kind_of(device), h, w)
    entries = plan_section(h, w, device, plan_path)
    if verbose:
        print(f"calibrate: applying plan [{key}]" if entries
              else f"calibrate: no plan entry for {key}", file=sys.stderr)
    return dataclasses.replace(
        cfg, **{k: int(entries[k]) for k in APPLIED if k in entries})


def show_plan(plan_path: str = PLAN_PATH) -> None:
    """Print the plan file as a table (showPlan, oclhelper.c:443-462)."""
    p = pathlib.Path(plan_path)
    if not p.exists():
        print(f"no plan at {plan_path}")
        return
    section = None
    rows = {}
    for line in p.read_text().splitlines():
        line = line.strip()
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1]
            rows[section] = {}
        elif section and " " in line:
            k, v = line.split(None, 1)
            rows[section][k] = v
    keys = sorted({k for r in rows.values() for k in r})
    wid = max((len(s) for s in rows), default=10)
    print(f"{'device|res':{wid}}  " + "  ".join(keys))
    for sec in sorted(rows):
        print(f"{sec:{wid}}  " + "  ".join(
            f"{rows[sec].get(k, '-'):>{len(k)}}" for k in keys))


def clear_plan(plan_path: str = PLAN_PATH) -> None:
    """Delete the plan file (clearPlan, oclhelper.c:529-553)."""
    pathlib.Path(plan_path).unlink(missing_ok=True)
    print(f"cleared {plan_path}")


def main(argv=None) -> int:
    """python -m rectdetect_tpu_torch.runtime.calibrate [--clear |
    --kernels]: show the plan (showPlan), delete it (clearPlan), or, for
    --kernels, say that there is nothing to tune (rect.cpp:86-101)."""
    argv = sys.argv if argv is None else argv
    if "--clear" in argv:
        clear_plan()
    elif "--kernels" in argv:
        print("tune_kernels: the port's kernel tiles are fixed when the "
              "kernels are built (chosen with kernel_sweep.py); nothing to "
              "tune, plan unchanged")
        show_plan()
    else:
        show_plan()
    return 0


if __name__ == "__main__":
    sys.exit(main())

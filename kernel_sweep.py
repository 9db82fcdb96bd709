#!/usr/bin/env python3
"""Time kernels of rectdetect_tpu_torch/csrc at other values of their
compile-time constants, in turns, on the 720p inputs of
bench.synth_frame(720, 1280, seed=0).

    python3 kernel_sweep.py [hyp] [morph] [quant] [thin] [despeckle2]
                            [thin-phases] [despeckle2-phases]

(all seven without an argument).  hyp: hyp.cu at 1, 2, 4 and 8 threads
per hull candidate (kLanes), on the 720p hypotheses and the seed-0
384-group corpus.  morph: morph.cu's output tile (kTileRows rows x
kTileWords 32-pixel words), poly_branch on the poly path's
strength-filtered edges and rect on the rect path's edge_bin.  quant:
quant_despeckle.cu's tile rows and rows per pass, and its level-code
table switched off (kMaxLevels = 0: one division per channel and pixel),
on the rect path's blurred colours and thinned edges.  thin: thin.cu's
output tile (kTileCols x kTileRows pixels, kRowsPerPass rows of threads)
in both modes on the 720p edge magnitude and vectors, each build held
bit-equal to the shipped kernel (which chip_smoke.py holds to the plain
version).  despeckle2: despeckle2.cu's tile rows, rows per pass and table
size (2^kSlotBits slots) on the rect path's 720p region labels.
thin-phases and despeckle2-phases: the shipped kernel beside copies that
return at the end of each of its phases (CUTS; `if (h > 0) return;`
before the phase's first line, so nothing before it is dead code), on
the same inputs; a cut copy's output is not the function's and is not
checked.

Run from the root of a checkout, on a machine with one CUDA card and nvcc.
Each setting is a copy of csrc/ under build/kernel_sweep/<kernel>/<n>/
with the constants substituted, built into a library of its own, all
builds at once; each build's output is held equal to the plain version's
before it is timed.  The first setting of each kernel is the shipped one.
Prints the card's name and power limit, then one JSON object: for each
kernel and input, each setting's device ms per call in each of 3 turns
(chip_smoke.device_ms, one turn of 10 calls per setting, the settings in
turn).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import chip_smoke
from chip_smoke import ROOT, fail

# where a cut copy returns: (stem, name) -> the source line it returns
# before
CUTS = {
    ("thin", "launch"): "  const int x0 = blockIdx.x * kTileCols;",
    ("thin", "window"):
        "#pragma unroll\n  for (int i = tid; i < kWinRows * kCells",
    ("thin", "window, cells"): "  const int x = x0 + threadIdx.x;",
    ("despeckle2", "launch"): "  const cg::grid_group grid = cg::this_grid();",
    ("despeckle2", "A"): "  grid.sync();\n\n  // B:",
    ("despeckle2", "A, barrier"): "  // B: the counts added",
    ("despeckle2", "A, barrier, B, barrier"): "  // C: the absorption",
}

SWEEPS = {
    "hyp": ("hyp", [{"kLanes": n} for n in (4, 1, 2, 8)]),
    "morph": ("morph", [{"kTileRows": r, "kTileWords": w} for r, w in (
        (32, 4), (16, 4), (64, 4), (32, 2), (32, 8), (16, 8), (8, 8))]),
    "quant": ("quant_despeckle", [
        {"kTileRows": r, "kRowsPerPass": p} for r, p in (
            (16, 8), (32, 8), (32, 16), (8, 8), (16, 4), (16, 16))]
        + [{"kMaxLevels": 0}]),
    "thin": ("thin", [
        {"kTileCols": c, "kTileRows": r, "kRowsPerPass": p} for c, r, p in (
            (32, 16, 8), (32, 8, 8), (32, 32, 8), (32, 16, 4), (32, 32, 16),
            (64, 16, 4), (64, 8, 8), (64, 16, 8))]),
    "despeckle2": ("despeckle2", [
        {"kTileRows": r, "kRowsPerPass": p, "kSlotBits": b} for r, p, b in (
            (64, 8, 7), (32, 8, 6), (32, 4, 6), (64, 8, 6), (64, 4, 7),
            (64, 16, 7), (128, 8, 7), (128, 16, 7))]),
}
for _stem in ("thin", "despeckle2"):
    SWEEPS[f"{_stem}-phases"] = (_stem, [{}] + [
        {"cut": name} for (stem, name) in CUTS if stem == _stem])


def label(setting: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in setting.items()) or "shipped"


def build_at(build_mod, kernel, n, setting):
    """The library of csrc/ with `setting`'s constants substituted in
    kernel's source (each must be defined once), and its launch counter."""
    stem = SWEEPS[kernel][0]
    out_dir = os.path.join(ROOT, "build", "kernel_sweep", kernel, str(n))
    src = os.path.join(out_dir, "csrc")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "rectdetect_tpu_torch", "csrc"), src)
    path = os.path.join(src, f"{stem}.cu")
    with open(path) as f:
        text = f.read()
    for name, value in setting.items():
        if name == "cut":
            marker = CUTS[stem, value]
            if text.count(marker) != 1:
                fail(f"{stem}.cu does not hold the line of cut {value!r} "
                     f"once")
            text = text.replace(marker, "  if (h > 0) return;\n" + marker)
            continue
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            fail(f"{stem}.cu does not define {name} once")
    with open(path, "w") as f:
        f.write(text)
    lib = chip_smoke.build_kernels(build_mod, src, out_dir, (stem,))
    lib.rd_launch_count.restype = build_mod.QUERIES["rd_launch_count"][1]
    return lib, types.SimpleNamespace(launch_count=lib.rd_launch_count)


def hyp_entry(torch, lib):
    """hyp_fn(segs, valid, max_vertices, short_ratio2) -> (corners, ok)
    through lib's rd_hyp."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rd_hyp.argtypes = [P, P, P, P, I, I, I, F, P]
    lib.rd_hyp.restype = ctypes.c_int

    def hyp_fn(segs, valid, max_vertices, short_ratio2):
        g, k = valid.shape
        corners = torch.empty((g, 4, 2), dtype=torch.float32,
                              device=segs.device)
        ok = torch.empty((g,), dtype=torch.bool, device=segs.device)
        if lib.rd_hyp(segs.data_ptr(), valid.data_ptr(), corners.data_ptr(),
                      ok.data_ptr(), g, k, max_vertices, short_ratio2,
                      chip_smoke.stream_of(torch)):
            fail("a hyp build did not launch")
        return corners, ok

    return hyp_fn


def morph_entry(torch, lib):
    """strings_fn(edge, variant) through lib's rd_strings_chain."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rd_strings_chain.argtypes = [P, P, I, I, I, P]
    lib.rd_strings_chain.restype = ctypes.c_int

    def strings_fn(edge, variant):
        h, w = edge.shape
        out = torch.empty_like(edge)
        if lib.rd_strings_chain(edge.data_ptr(), out.data_ptr(), h, w,
                                {"rect": 0, "poly_branch": 1}[variant],
                                chip_smoke.stream_of(torch)):
            fail("a K3 build did not launch")
        return out

    return strings_fn


def quant_entry(torch, lib):
    """quant_fn(packed, emag, n0, n1, n2) through lib's
    rd_quant_despeckle."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rd_quant_despeckle.argtypes = [P, P, P, I, I, I, I, I, P]
    lib.rd_quant_despeckle.restype = ctypes.c_int

    def quant_fn(packed, emag, n0, n1, n2):
        h, w = packed.shape
        out = torch.empty_like(packed)
        if lib.rd_quant_despeckle(packed.data_ptr(), emag.data_ptr(),
                                  out.data_ptr(), h, w, n0, n1, n2,
                                  chip_smoke.stream_of(torch)):
            fail("a quant_despeckle build did not launch")
        return out

    return quant_fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card")
    kernels = sys.argv[1:] or list(SWEEPS)
    unknown = [k for k in kernels if k not in SWEEPS]
    if unknown:
        fail(f"unknown kernels {unknown}; choose from {list(SWEEPS)}")
    sys.path.insert(0, ROOT)
    from bench import synth_frame
    from rectdetect_tpu_torch import parity
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG as cfg
    from rectdetect_tpu_torch.geometry import quad
    from rectdetect_tpu_torch.ops import (_build, ccl, fp, hopper_blblur,
                                          hopper_ccl, hopper_grad,
                                          hopper_links, hopper_merge_mask,
                                          hopper_thin, morphology, regions)
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.rect import (rect_hypotheses,
                                                    region_smoothing,
                                                    weak_strong_labels)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    jobs = [(k, n, s) for k in kernels for n, s in enumerate(SWEEPS[k][1])]
    with ThreadPoolExecutor(8) as pool:
        futures = [pool.submit(build_at, _build, *job) for job in jobs]
        built = {(k, n): f.result() for (k, n, _), f in zip(jobs, futures)}

    # each kernel's inputs: name -> (call(fn), the plain result, equal)
    bgr = torch.from_numpy(synth_frame(720, 1280, seed=0)).to(dev)
    inputs = {}
    if "hyp" in kernels:
        hyp = rect_hypotheses(bgr, cfg)
        corpus = [torch.from_numpy(a).to(dev) for a in parity.segment_groups(
            0, 2 * cfg.max_groups, cfg.max_group_segs, 1.0)]
        hv = cfg.hull_max_vertices
        sr2 = fp.f32(quad.SHORT_RATIO * quad.SHORT_RATIO)
        inputs["hyp"] = (hyp_entry, {
            name: (lambda fn, s=segs, v=valid: fn(s, v, hv, sr2),
                   quad.reduce_groups(segs, valid, hv))
            for name, segs, valid in (
                ("720p hypotheses", hyp.segs, hyp.valid),
                ("corpus seed 0", *corpus))}, chip_smoke.same_quads)
    fe = edge_frontend(bgr, cfg)
    if "morph" in kernels:
        lbl = hopper_ccl.label_components(fe.edge_bin, 0)
        st = ccl.calc_strength(fe.edge_thin, lbl, cfg.strength_scale)
        edge = (ccl.filter_strength(lbl, st, 500) > 0).to(torch.int32)
        inputs["morph"] = (morph_entry, {
            f"{v} on {name}": (lambda fn, p=pix, v=v: fn(p, v),
                               morphology.strings_chain(pix, v))
            for v, name, pix in (
                ("poly_branch", "the strength-filtered edges", edge),
                ("rect", "edge_bin", fe.edge_bin))},
            lambda torch, a, b: torch.equal(a, b))
    if "quant" in kernels:
        weak, _ = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
        blurred = hopper_blblur.blblur(fe.packed0, (weak > 0).to(torch.int32),
                                       cfg.blblur_iters)
        q = cfg.quantize_levels
        inputs["quant"] = (quant_entry, {
            "blurred, edge_thin": (
                lambda fn: fn(blurred, fe.edge_thin, q, q, q),
                regions.quantize_despeckle(blurred, fe.edge_thin, q, q, q))},
            lambda torch, a, b: torch.equal(a, b))

    if "thin" in kernels or "thin-phases" in kernels:
        em, vec = hopper_grad.edge_front(fe.labb)
        inputs["thin"] = (chip_smoke.bind_thin, {
            f"{mode}, 720p em and vec": (
                lambda fn, m=mode: fn(em, vec, m),
                hopper_thin.thinthres(em, vec, mode))
            for mode in ("thres", "cubic")},
            lambda torch, a, b: torch.equal(a, b))
    if "despeckle2" in kernels or "despeckle2-phases" in kernels:
        weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
        despeck = region_smoothing(fe.packed0, weak, fe.edge_thin, cfg)[1]
        seg0 = hopper_links.label_merge(
            despeck, hopper_merge_mask.junction_merge_mask(strong), strong)
        thre = cfg.despeckle2_thre
        inputs["despeckle2"] = (chip_smoke.bind_despeckle2, {
            "720p region labels": (
                lambda fn: fn(seg0, thre),
                regions.sizes_despeckle2(seg0, thre))},
            lambda torch, a, b: torch.equal(a, b))

    result = {"card": smi.stdout.strip()}
    for kernel in kernels:
        entry, cases, same = inputs[kernel.removesuffix("-phases")]
        settings = SWEEPS[kernel][1]
        fns = {n: (entry(torch, built[kernel, n][0]), built[kernel, n][1])
               for n in range(len(settings))}
        result[kernel] = {}
        for name, (call, want) in cases.items():
            for n, (fn, _) in fns.items():
                if "cut" not in settings[n] and not same(torch, call(fn),
                                                         want):
                    fail(f"{kernel} at {label(settings[n])} on {name} "
                         f"differs from the plain version")
            sweep = {n: [] for n in fns}
            for _ in range(3):
                for n, (fn, counter) in fns.items():
                    times, per_call = chip_smoke.device_ms(
                        torch, counter, lambda: call(fn), turns=1)
                    if per_call != 1:
                        fail(f"{kernel} at {label(settings[n])}: {per_call} "
                             f"kernels per call")
                    sweep[n].append(times[0])
            result[kernel][name] = {label(settings[n]): ts
                                    for n, ts in sweep.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

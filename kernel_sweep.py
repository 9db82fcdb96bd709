#!/usr/bin/env python3
"""Time kernels of rectdetect_tpu_torch/csrc at other values of their
compile-time constants, in turns, on the 720p inputs of
bench.synth_frame(720, 1280, seed=0).

    python3 kernel_sweep.py [hyp] [morph] [quant] [thin] [despeckle2]
                            [merge_mask] [seg_scan] [distinct_bids]
                            [edge_front] [thin-phases]
                            [despeckle2-phases] [merge_mask-phases]
                            [seg_scan-phases] [distinct_bids-phases]
                            [edge_front-phases]
                            [distinct_bids-parent-phases]
                            [edge_front-parent-phases]

(all but the last two without an argument).  hyp: hyp.cu at 1, 2, 4 and
8 threads per hull candidate (kLanes), on the 720p hypotheses and the
seed-0 384-group corpus.  morph: morph.cu's output tile (kTileRows rows x
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
merge_mask: merge_mask.cu's output tile (kTileRows rows x kTileWords
32-pixel words) on the rect path's 720p strong labels.  seg_scan:
scan.cu's seg_total block size and items a thread (kTotalThreads x
kTotalItems elements a tile) on the 720p strength table.  distinct_bids:
distinct_bids.cu's tile (kTileRows x kTileCols pixels), block size
(kThreads) and its stores as __stcs (kStreamStores = 1) on the rect
path's 720p boundary ids.
edge_front: edge_front.cu's tile (kTileCols columns of threads,
kRowsPerThread rows each, kThreads a block) on the 720p blurred Lab
planes, each build held bit-equal to the shipped kernel.  The -phases sweeps: the shipped kernel beside copies that
return at the end of each of its phases (CUTS; `if (h > 0) return;`, or
`n` where the kernel has no `h`, before the phase's first line, so
nothing before it is dead code), on the same inputs; a cut copy's output
is not the function's and is not checked.  distinct_bids-parent-phases
and edge_front-parent-phases: the same for the parent commit's
distinct_bids.cu and edge_front.cu (one thread a pixel), from
build/parent/ (a git archive of the parent, see chip_smoke.py), with the
cuts whose line that source holds; a cut that ends inside a pixel's work
stores one value of it, so that the work stays.

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
    ("merge_mask", "launch"): "  // load: all of a warp's pixels first",
    ("merge_mask", "load"): "  // junction: ANY, END and CORE",
    ("merge_mask", "load, junction"): "  // dilate: one thread per tile word",
    ("merge_mask", "load, junction, dilate"):
        "  // store: one warp per tile word",
    ("scan", "launch"): "  // A: scan each tile, publish its descriptor",
    ("scan", "A"): "  grid.sync();\n\n  // B: the totals",
    ("scan", "A, barrier"): "  // B: the totals, the tiles in reverse",
    ("scan", "A, barrier, looks"):
        "    __syncthreads();\n    const int base = t * kTotalTile",
    # a cut after a phase that only fills shared memory reads one of its
    # arrays, as the rest of the kernel would: shared arrays that no code
    # reads are dropped by the compiler, and the work that fills them
    ("distinct_bids", "launch"): "  // stage: a warp a row",
    ("distinct_bids", "staging"): (
        "  // bits and row lists: a warp a",
        "  if (h > 0) {\n    if (ids[warp][lane] < 0) out[0] = 1;\n"
        "    return;\n  }\n"),
    ("distinct_bids", "staging, bits, lists"): (
        "  // merge and store: a warp an output word",
        "  if (h > 0) {\n    if (bits[warp][0] == 1u && "
        "lists[warp][lane].x < 0) out[0] = 1;\n    return;\n  }\n"),
    ("edge_front", "launch"): "  // stage: staged pixel (r, c)",
    ("edge_front", "staging"): (
        "  // vec: edgevec on L, the 5x5 taps",
        "  if (h > 0) {\n    if (raw[threadIdx.y][threadIdx.x] + "
        "qnt[2][threadIdx.y][threadIdx.x] < -1.0f) em[0] = 0.0f;\n"
        "    return;\n  }\n"),
    ("edge_front", "staging, vec"): (
        "  // em: edge_lab on the quantized",
        "  if (h > 0) {\n    if (qnt[1][threadIdx.y][threadIdx.x] < -1.0f) "
        "em[0] = 0.0f;\n    return;\n  }\n"),
    # the kernels these replaced (one thread a pixel), for the
    # -parent-phases sweeps; a cut that ends inside the pixel's work stores
    # one value that depends on it, so the compiler keeps that work
    ("distinct_bids", "parent: launch"):
        "  for (int i = tid; i < kTW * kTW; i += rd::kBlockX * rd::kBlockY) {",
    ("distinct_bids", "parent: staging"): (
        "  const long long n = (long long)h * w;",
        "  if (h > 0) {\n    if (tile[tid] < 0) out[0] = 1;\n    return;\n"
        "  }\n"),
    ("edge_front", "parent: launch"): "  // ---- edgevec on L",
    ("edge_front", "parent: vec taps"): (
        "  const float ivlen = __fmaf_rn(vx, vx, vy * vy);\n"
        "  // correctly rounded 1/sqrt",
        "  if (h > 0) { em[(size_t)y * w + x] = vx + vy; return; }\n"),
    ("edge_front", "parent: vec taps, rs"): (
        "  const bool big = ivlen > 1e-10f;\n  const size_t p",
        "  if (h > 0) { em[(size_t)y * w + x] = rs; return; }\n"),
    ("edge_front", "parent: vec taps, rs, vec stores"):
        "  // ---- edge_lab on the quantized planes",
    ("thin", "launch"): "  const int x0 = blockIdx.x * kTileCols;",
    ("thin", "window"):
        "#pragma unroll\n  for (int i = tid; i < kWinRows * kCells",
    ("thin", "window, cells"): "  const int x = x0 + threadIdx.x;",
    ("despeckle2", "launch"): "  const cg::grid_group grid = cg::this_grid();",
    ("despeckle2", "A"): "  grid.sync();\n\n  // B:",
    ("despeckle2", "A, barrier"): "  // B: the counts added",
    ("despeckle2", "A, barrier, B, barrier"): "  // C: the absorption",
}
# the cut's guard variable, where the kernel has no `h`
GUARD = {"scan": "n"}


def cut_of(stem: str, name: str) -> tuple[str, str]:
    """(the source line a cut returns before, the code it inserts there):
    CUTS[stem, name], a line alone taking `if (<guard> > 0) return;`."""
    cut = CUTS[stem, name]
    if isinstance(cut, tuple):
        return cut
    return cut, f"  if ({GUARD.get(stem, 'h')} > 0) return;\n"


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
    "merge_mask": ("merge_mask", [
        {"kTileRows": r, "kTileWords": w} for r, w in (
            (64, 2), (32, 4), (32, 8), (64, 4), (128, 2), (64, 1), (128, 1),
            (16, 8))]),
    "seg_scan": ("scan", [
        {"kTotalThreads": t, "kTotalItems": i} for t, i in (
            (256, 4), (128, 4), (512, 4), (1024, 4), (128, 8), (256, 8))]),
    "distinct_bids": ("distinct_bids", [
        {"kTileRows": r, "kTileCols": c, "kThreads": t, "kStreamStores": z}
        for r, c, t, z in (
            (8, 32, 256, 0), (8, 32, 256, 1), (8, 32, 128, 0),
            (8, 32, 128, 1), (4, 32, 128, 1), (16, 32, 256, 1),
            (8, 64, 256, 1), (16, 64, 256, 1), (16, 32, 128, 1))]),
    "edge_front": ("edge_front", [
        {"kTileCols": c, "kRowsPerThread": r, "kThreads": t}
        for c, r, t in (
            (64, 4, 256), (32, 4, 128), (32, 4, 256), (32, 2, 128),
            (32, 2, 256), (32, 8, 128), (64, 2, 128), (64, 4, 128),
            (64, 2, 256))]
),
}
for _kernel, _stem in (("thin", "thin"), ("despeckle2", "despeckle2"),
                       ("merge_mask", "merge_mask"), ("seg_scan", "scan"),
                       ("distinct_bids", "distinct_bids"),
                       ("edge_front", "edge_front")):
    SWEEPS[f"{_kernel}-phases"] = (_stem, [{}] + [
        {"cut": name} for (stem, name) in CUTS
        if stem == _stem and not name.startswith("parent")])
for _kernel in ("distinct_bids", "edge_front"):
    SWEEPS[f"{_kernel}-parent-phases"] = (_kernel, [{"src": "parent"}] + [
        {"src": "parent", "cut": name} for (stem, name) in CUTS
        if stem == _kernel and name.startswith("parent")])
PARENT = os.path.join(ROOT, "build", "parent")


def settings_of(kernel: str) -> list:
    """SWEEPS[kernel]'s settings; of the parent's, those whose cut line
    the parent's source holds once."""
    stem, settings = SWEEPS[kernel]
    if not settings[0].get("src"):
        return settings
    path = os.path.join(PARENT, "rectdetect_tpu_torch", "csrc", f"{stem}.cu")
    if not os.path.exists(path):
        fail(f"{kernel} needs the parent's {path}")
    with open(path) as f:
        text = f.read()
    return [s for s in settings
            if "cut" not in s or text.count(cut_of(stem, s["cut"])[0]) == 1]


def label(setting: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in setting.items()) or "shipped"


def build_at(build_mod, kernel, n, setting):
    """The library of csrc/ (the parent's where setting["src"] is
    "parent") with `setting`'s constants substituted in kernel's source
    (each must be defined once), and its launch counter."""
    stem = SWEEPS[kernel][0]
    out_dir = os.path.join(ROOT, "build", "kernel_sweep", kernel, str(n))
    src = os.path.join(out_dir, "csrc")
    origin = PARENT if setting.get("src") == "parent" else ROOT
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(os.path.join(origin, "rectdetect_tpu_torch", "csrc"), src)
    path = os.path.join(src, f"{stem}.cu")
    with open(path) as f:
        text = f.read()
    for name, value in setting.items():
        if name == "src":
            continue
        if name == "cut":
            marker, code = cut_of(stem, value)
            if text.count(marker) != 1:
                fail(f"{stem}.cu does not hold the line of cut {value!r} "
                     f"once")
            text = text.replace(marker, code + marker)
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
    """strings_fn(edge, variant) through lib's rd_strings_chain (one
    frame)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    frames = getattr(lib, "frame_counts", {}).get("morph", True)
    lib.rd_strings_chain.argtypes = [P, P, I, I, *([I] if frames else []),
                                     I, I, I, I, P]
    lib.rd_strings_chain.restype = ctypes.c_int

    def strings_fn(edge, variant):
        h, w = edge.shape
        out = torch.empty_like(edge)
        if lib.rd_strings_chain(edge.data_ptr(), out.data_ptr(), h, w,
                                *([1] if frames else []),
                                {"rect": 0, "poly_branch": 1}[variant], 0,
                                0, w, chip_smoke.stream_of(torch)):
            fail("a K3 build did not launch")
        return out

    return strings_fn


def quant_entry(torch, lib):
    """quant_fn(packed, emag, n0, n1, n2) through lib's
    rd_quant_despeckle (one frame)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    frames = getattr(lib, "frame_counts", {}).get("quant_despeckle", True)
    lib.rd_quant_despeckle.argtypes = [P, P, P, I, I,
                                       *([I] if frames else []), I, I, I, P]
    lib.rd_quant_despeckle.restype = ctypes.c_int

    def quant_fn(packed, emag, n0, n1, n2):
        h, w = packed.shape
        out = torch.empty_like(packed)
        if lib.rd_quant_despeckle(packed.data_ptr(), emag.data_ptr(),
                                  out.data_ptr(), h, w,
                                  *([1] if frames else []), n0, n1, n2,
                                  chip_smoke.stream_of(torch)):
            fail("a quant_despeckle build did not launch")
        return out

    return quant_fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card")
    kernels = sys.argv[1:] or [k for k in SWEEPS if "parent" not in k]
    unknown = [k for k in kernels if k not in SWEEPS]
    if unknown:
        fail(f"unknown kernels {unknown}; choose from {list(SWEEPS)}")
    sys.path.insert(0, ROOT)
    from bench import synth_frame
    from rectdetect_tpu_torch import parity
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG as cfg
    from rectdetect_tpu_torch.geometry import quad
    from rectdetect_tpu_torch.ops import (_build, ccl, fp, hopper_bids,
                                          hopper_blblur, hopper_ccl,
                                          hopper_grad, hopper_links,
                                          hopper_merge_mask, hopper_morph,
                                          hopper_scan, hopper_thin,
                                          morphology, regions)
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.rect import (boundary_labels,
                                                    rect_hypotheses,
                                                    region_merge,
                                                    region_smoothing,
                                                    weak_strong_labels)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    plan = {k: settings_of(k) for k in kernels}
    jobs = [(k, n, s) for k in kernels for n, s in enumerate(plan[k])]
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
    if any(k.startswith("merge_mask") for k in kernels):
        _, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
        inputs["merge_mask"] = (chip_smoke.bind_merge_mask, {
            "720p strong labels": (
                lambda fn: fn(strong), regions.junction_merge_mask(strong))},
            lambda torch, a, b: torch.equal(a, b))
    if any(k.startswith("seg_scan") for k in kernels):
        lbl_r = hopper_ccl.label_components(
            hopper_morph.strings_chain(fe.edge_bin, "rect"), 0)
        sp = max(4096, 720 * 1280 // cfg.sparse_factor)
        thre = max(cfg.strength_weak, cfg.strength_strong)
        skey, sval, _ = ccl.strength_table(fe.edge_thin, lbl_r, sp, thre,
                                           cfg.strength_scale)
        inputs["seg_scan"] = (chip_smoke.bind_seg_total, {
            "720p strength table": (
                lambda fn: fn(skey, sval, thre),
                hopper_scan.seg_total_plain(skey, sval, thre))},
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

    if any(k.startswith("distinct_bids") for k in kernels):
        weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
        despeck = region_smoothing(fe.packed0, weak, fe.edge_thin, cfg)[1]
        boundary = boundary_labels(region_merge(despeck, strong, cfg)[1],
                                   cfg)[0]
        inputs["distinct_bids"] = (chip_smoke.bind_distinct_bids, {
            "720p boundary ids": (
                lambda fn: fn(boundary),
                torch.stack(hopper_bids.distinct_bids_plain(boundary)))},
            lambda torch, a, b: torch.equal(a, b))
    if any(k.startswith("edge_front") for k in kernels):
        inputs["edge_front"] = (chip_smoke.bind_edge_front, {
            "720p blurred Lab": (lambda fn: fn(fe.labb),
                                 hopper_grad.edge_front(fe.labb))},
            lambda torch, a, b: all(torch.equal(x, y) for x, y in zip(a, b)))

    result = {"card": smi.stdout.strip()}
    for kernel in kernels:
        entry, cases, same = inputs[kernel.removesuffix("-phases")
                                    .removesuffix("-parent")]
        settings = plan[kernel]
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

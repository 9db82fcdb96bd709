#!/usr/bin/env python3
"""Drive the PyTorch port's poly path and the rect path's region maps once
on a CUDA card, at 1280x720, and check them end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA.  Phases (any failed check exits non-zero before
the final line):
  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from rectdetect_tpu_torch/csrc, timed;
  3. each of the eight kernels (K1 edge_front, K2 thinthres, K3
     strings_chain, K4 label_components, mkpl, seg_scan, blblur,
     quant_despeckle) against its plain PyTorch version on the card, at
     the real 720p intermediates of bench.synth_frame(720, 1280, seed=0),
     with kernel and plain times (CUDA-event medians); mkpl also under
     arena overflow;
  4. the main paths, each with every launch count set to 0 just before it
     and read just after: pipeline.poly.poly_frame with DEFAULT_CONFIG
     (held bit for bit against the mkpl_pallas=0 run and against the JAX
     fixture tests/data/poly_720p_synth.npz), and pipeline.rect
     weak_strong_labels -> region_smoothing (held against
     tests/data/rect_regions_720p_synth.npz); each path must launch its
     kernels, and a second run must be bit-identical;
  5. the DEFAULT_CONFIG frame time beside the mkpl_pallas=0 frame time,
     timed in turns, and the region stages' time (CUDA-event medians).
The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 720, 1280
# K1/K2 float outputs: bit-equal is expected (same operations, same fused
# multiply-adds); the plain version's float64 emulation of a fused
# multiply-add can round twice on a tie, so the contract is the Pallas
# kernels' tolerance
FLOAT_ATOL = 2e-4
# arena floats against the JAX fixture: bit-equal is expected, the stated
# limit is the port's arena tolerance
ARENA_ATOL = 1e-4
# the least time of a kernel: bytes over the H100 SXM's memory rate,
# operations over its float32 rate outside the tensor cores (NVIDIA's data
# sheet; it gives no int32 rate, and the H100 runs int32 no faster, so
# integer work counted at this rate stays a lower bound)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(msg, flush=True)


def digest(t) -> str:
    a = t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype="<i4").tobytes()).hexdigest()


def cuda_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card and does not fall back to the CPU")
    sys.path.insert(0, ROOT)
    try:
        from bench import synth_frame
        from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
        from rectdetect_tpu_torch.core import color
        from rectdetect_tpu_torch.ops import (_build, blur, ccl, hopper_blblur,
                                              hopper_ccl, hopper_grad,
                                              hopper_mkpl, hopper_morph,
                                              hopper_quant, hopper_scan,
                                              hopper_thin, mkpl, polyline,
                                              regions)
        from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
        from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame
        from rectdetect_tpu_torch.pipeline.rect import (region_smoothing,
                                                        weak_strong_labels)
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    phase("phase 1 card (nvidia-smi name, power.limit):")
    phase(card)
    phase(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.lib()
    phase(f"phase 2 build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({len(_build.sources())} sources, nvcc {' '.join(_build.NVCC_FLAGS)})")

    # ---- 3. kernels against their plain versions ------------------------
    bgr = torch.from_numpy(synth_frame(H, W, seed=0)).to(dev)
    lab = color.bgr_to_labf(bgr)
    labq = color.quantize_labf(lab)
    labb = torch.stack([blur.gaussian_blur(labq[..., c], 2)
                        for c in range(3)], dim=-1).contiguous()
    records = []

    def record(name, src, replaces, err, ms, plain_ms, nbytes, ops):
        """nbytes: each input read once and each output written once;
        ops: a lower bound on the operations this run's data needs."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        records.append({"name": name, "route": "cuda",
                        "source": f"rectdetect_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": None,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "library_ms": None})
        phase(f"phase 3 {name}: max_abs_err {err!r}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {max(t_bytes, t_ops):.6f} ms "
              f"({nbytes} B, {ops} ops)")

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def arena_equal(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in a._fields)

    em, vec = hopper_grad.edge_front(labb)
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    torch.cuda.synchronize()
    err = max((em - em_p).abs().max().item(), (vec - vec_p).abs().max().item())
    nbits = int((em != em_p).sum() + (vec != vec_p).sum())
    phase(f"phase 3 edge_front: {nbits} float outputs differ in any bit")
    if not err <= FLOAT_ATOL:
        fail(f"edge_front: kernel and plain differ by {err} > {FLOAT_ATOL}")
    # ops: per pixel three channel gradients (2 differences, 2 squares
    # each), their sum and sqrt, and the unit edge vector: >= 25
    record("edge_front", "edge_front.cu",
           "rectdetect_tpu/ops/pallas_grad.py:48", err,
           cuda_ms(torch, lambda: hopper_grad.edge_front(labb), 20),
           cuda_ms(torch, lambda: hopper_grad.edge_front_plain(labb), 5),
           nb(labb, em, vec), 25 * H * W)

    thin = hopper_thin.thinthres(em, vec)
    thin_p = hopper_thin.thin_plain(em, vec)
    torch.cuda.synchronize()
    err = (thin - thin_p).abs().max().item()
    nbin = int(((thin > 0) != (thin_p > 0)).sum())
    phase(f"phase 3 thinthres: {int((thin != thin_p).sum())} outputs differ "
          f"in any bit, {nbin} differ in edge_thin > 0")
    if not err <= FLOAT_ATOL or nbin:
        fail(f"thinthres: max diff {err}, {nbin} edge_bin pixels differ")
    # ops: >= the two non-maximum compares per pixel
    record("thinthres", "thin.cu", "rectdetect_tpu/ops/pallas_thin.py:43",
           err, cuda_ms(torch, lambda: hopper_thin.thinthres(em, vec), 20),
           cuda_ms(torch, lambda: hopper_thin.thin_plain(em, vec), 5),
           nb(em, vec, thin), 2 * H * W)

    edge_bin = (thin > 0).to(torch.int32)
    lbl = hopper_ccl.label_components(edge_bin, 0)
    lbl_p = hopper_ccl.label_components_plain(edge_bin, 0)
    ndiff = int((lbl != lbl_p).sum())
    phase(f"phase 3 label_components: {ndiff} labels differ "
          f"(edge_bin density {edge_bin.float().mean().item():.4f})")
    if ndiff:
        fail(f"label_components: {ndiff} labels differ from the plain version")
    # ops: >= one label decision per pixel
    record("label_components", "ccl.cu",
           "rectdetect_tpu/ops/pallas_ccl.py:101", 0.0,
           cuda_ms(torch, lambda: hopper_ccl.label_components(edge_bin, 0), 20),
           cuda_ms(torch, lambda: hopper_ccl.label_components_plain(
               edge_bin, 0), 3), nb(edge_bin, lbl), H * W)

    st = ccl.calc_strength(thin, lbl)
    edge = (ccl.filter_strength(lbl, st, 500) > 0).to(torch.int32)
    for variant in ("rect", "poly_branch"):
        s = hopper_morph.strings_chain(edge, variant)
        s_p = hopper_morph.strings_chain_plain(edge, variant)
        ndiff = int((s != s_p).sum())
        phase(f"phase 3 strings_chain[{variant}]: {ndiff} pixels differ")
        if ndiff:
            fail(f"strings_chain[{variant}]: {ndiff} pixels differ")
    # ops: >= one decision per pixel
    record("strings_chain", "morph.cu",
           "rectdetect_tpu/ops/pallas_morph.py:40", 0.0,
           cuda_ms(torch, lambda: hopper_morph.strings_chain(
               edge, "poly_branch"), 20),
           cuda_ms(torch, lambda: hopper_morph.strings_chain_plain(
               edge, "poly_branch"), 5), 2 * nb(edge), H * W)

    # mkpl at the poly path's own arc compaction, then under overflow
    cfg = DEFAULT_CONFIG
    cap = cfg.ls_cap_for(W, H)
    arena0, dense, number, comp = polyline.mkpl_inputs(edge, 20, cap, cfg)

    def run_mkpl(fn, arena):
        return fn(arena, dense, number, 1.0, cfg.mkpl_iters, comp)

    got = run_mkpl(hopper_mkpl.mkpl_subdivide, arena0)
    want = run_mkpl(mkpl.mkpl_subdivide, arena0)
    torch.cuda.synchronize()
    ok = arena_equal(got[0], want[0]) and torch.equal(got[1], want[1])
    n_live = int(comp.n)
    count0, count = int(arena0.count), int(got[0].count)
    phase(f"phase 3 mkpl: arena and lsid bit-equal to the plain version: "
          f"{ok} (slots {comp.cap}, live {n_live}, arena cap {cap}, "
          f"count {count0} -> {count})")
    if not ok:
        fail("mkpl: kernel and plain subdivision differ")
    small = (count0 + count) // 2
    if not count0 < small - 1 < count - 1:
        fail(f"mkpl: no overflow case between counts {count0} and {count}")
    a_small = polyline.mkpl_inputs(edge, 20, small, cfg)[0]
    got_s = run_mkpl(hopper_mkpl.mkpl_subdivide, a_small)
    want_s = run_mkpl(mkpl.mkpl_subdivide, a_small)
    torch.cuda.synchronize()
    ok = (arena_equal(got_s[0], want_s[0]) and torch.equal(got_s[1], want_s[1])
          and int(got_s[0].count) == small - 1)
    phase(f"phase 3 mkpl overflow: arena cap {small}, count "
          f"{int(got_s[0].count)}, bit-equal to the plain version: {ok}")
    if not ok:
        fail("mkpl under arena overflow differs from the plain version")
    rounds = cfg.mkpl_iters - 1
    # bytes: slot list, dense and number at the live slots, the arena's
    # 13 fields in and out, lsid out; ops: >= 20 per live slot and round
    # (the chord distance)
    record("mkpl", "mkpl.cu", "rectdetect_tpu/ops/pallas_mkpl.py:68", 0.0,
           cuda_ms(torch, lambda: run_mkpl(hopper_mkpl.mkpl_subdivide,
                                           arena0), 20),
           cuda_ms(torch, lambda: run_mkpl(mkpl.mkpl_subdivide, arena0), 3),
           nb(comp.idx) + 8 * n_live + 2 * 13 * 4 * cap + nb(got[1]),
           20 * rounds * n_live)

    # the strength pair's segmented totals at 720p, on the rect strings
    fe = edge_frontend(bgr, cfg)
    s_rect = hopper_morph.strings_chain(fe.edge_bin, "rect")
    lbl_r = hopper_ccl.label_components(s_rect, 0)
    sp = max(4096, H * W // cfg.sparse_factor)
    thre = max(cfg.strength_weak, cfg.strength_strong)
    skey, sval, _ = ccl.strength_table(fe.edge_thin, lbl_r, sp, thre,
                                       cfg.strength_scale)
    tot = hopper_scan.seg_total_sorted(skey, sval, thre)
    tot_p = hopper_scan.seg_total_plain(skey, sval, thre)
    ndiff = int((tot != tot_p).sum())
    phase(f"phase 3 seg_scan: {ndiff} of {sp} segment totals differ "
          f"({int((skey < H * W).sum())} live rows)")
    if ndiff:
        fail(f"seg_scan: {ndiff} totals differ from the plain version")
    # the timed function is seg_total_sorted: keys and values read once,
    # the totals written once; ops: a combine per element to sum each run
    # and one more to spread its total
    record("seg_scan", "scan.cu", "rectdetect_tpu/ops/pallas_scan.py:55",
           0.0,
           cuda_ms(torch, lambda: hopper_scan.seg_total_sorted(
               skey, sval, thre), 20),
           cuda_ms(torch, lambda: hopper_scan.seg_total_plain(
               skey, sval, thre), 5), nb(skey, sval, tot), 2 * sp)

    weak, _ = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
    weak_bin = (weak > 0).to(torch.int32)
    iters = cfg.blblur_iters
    blurred = hopper_blblur.blblur(fe.packed0, weak_bin, iters)
    blurred_p = regions.blblur(fe.packed0, weak_bin, iters)
    ndiff = int((blurred != blurred_p).sum())
    phase(f"phase 3 blblur: {ndiff} pixels differ ({iters} iterations)")
    if ndiff:
        fail(f"blblur: {ndiff} pixels differ from the plain version")
    # ops: a window's tap count depends on the edge map alone, so it is
    # needed once per axis (1 per pixel); each channel's window sum needs
    # at least a running-sum add and a difference of two running sums per
    # pixel and pass, whatever the taps, and the average one division
    record("blblur", "blblur.cu", "rectdetect_tpu/ops/pallas_blblur.py:223",
           0.0,
           cuda_ms(torch, lambda: hopper_blblur.blblur(
               fe.packed0, weak_bin, iters), 20),
           cuda_ms(torch, lambda: regions.blblur(fe.packed0, weak_bin, iters),
                   3), nb(fe.packed0, weak_bin, blurred),
           2 * H * W + 2 * iters * 3 * 3 * H * W)

    n = cfg.quantize_levels
    despeck = hopper_quant.quantize_despeckle(blurred, fe.edge_thin, n, n, n)
    despeck_p = regions.quantize_despeckle(blurred, fe.edge_thin, n, n, n)
    ndiff = int((despeck != despeck_p).sum())
    phase(f"phase 3 quant_despeckle: {ndiff} pixels differ")
    if ndiff:
        fail(f"quant_despeckle: {ndiff} pixels differ from the plain version")
    # ops: >= quantizing each pixel once (5 per channel)
    record("quant_despeckle", "quant_despeckle.cu",
           "rectdetect_tpu/ops/pallas_morph.py:157", 0.0,
           cuda_ms(torch, lambda: hopper_quant.quantize_despeckle(
               blurred, fe.edge_thin, n, n, n), 20),
           cuda_ms(torch, lambda: regions.quantize_despeckle(
               blurred, fe.edge_thin, n, n, n), 5),
           nb(blurred, fe.edge_thin, despeck), 15 * H * W)

    # ---- 4. the main paths -----------------------------------------------
    counters = {"edge_front": hopper_grad, "thinthres": hopper_thin,
                "strings_chain": hopper_morph,
                "label_components": hopper_ccl, "mkpl": hopper_mkpl,
                "seg_scan": hopper_scan, "blblur": hopper_blblur,
                "quant_despeckle": hopper_quant}
    launches = {}

    def drive(path, names, fn):
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in counters.items()}
        phase(f"phase 4 {path} launches: {json.dumps(counts)}")
        idle = [k for k in names if counts[k] < 1]
        if idle:
            fail(f"{path} did not launch {idle}")
        launches.update({k: counts[k] for k in names})
        return out

    front = ["edge_front", "thinthres", "strings_chain", "label_components"]
    arena, lsid = drive("poly_frame", front + ["mkpl"],
                        lambda: poly_frame(bgr, cfg))
    arena2, lsid2 = poly_frame(bgr, cfg)
    arena_p, lsid_p = poly_frame(bgr, PipelineConfig(mkpl_pallas=0))
    torch.cuda.synchronize()
    same = arena_equal(arena, arena2) and torch.equal(lsid, lsid2)
    same_p = arena_equal(arena, arena_p) and torch.equal(lsid, lsid_p)
    phase(f"phase 4 poly_frame second run bit-identical: {same}; "
          f"bit-identical to the mkpl_pallas=0 run: {same_p}")
    if not (same and same_p):
        fail("poly_frame runs on the card differ")

    if tuple(lsid.shape) != (H, W) or lsid.dtype != torch.int32:
        fail(f"lsid has shape {tuple(lsid.shape)} dtype {lsid.dtype}")
    for f in ("sx", "sy", "ex", "ey"):
        if not torch.isfinite(getattr(arena, f)).all():
            fail(f"arena.{f} has non-finite values")

    fx = np.load(os.path.join(ROOT, "tests", "data", "poly_720p_synth.npz"))
    phase(f"phase 4 poly fixture: {json.loads(str(fx['meta']))['reference']}")
    lbl_f = hopper_ccl.label_components(fe.edge_bin, 0)
    st_f = ccl.calc_strength(fe.edge_thin, lbl_f, cfg.strength_scale)
    edge_f = (ccl.filter_strength(lbl_f, st_f, 500) > 0).to(torch.int32)
    strings = hopper_morph.strings_chain(edge_f, "poly_branch")
    ref_bits = np.unpackbits(fx["edge_bin_bits"])[:H * W].reshape(H, W)
    n_eb = int((fe.edge_bin.cpu().numpy() != ref_bits).sum())
    stage = {
        "packed0_equal": digest(fe.packed0) == str(fx["packed0_sha256"]),
        "edge_bin_mismatch": n_eb,
        "edge_bin_equal": digest(fe.edge_bin) == str(fx["edge_bin_sha256"]),
        "strings_equal": digest(strings) == str(fx["strings_sha256"]),
        "lsid_equal": digest(lsid) == str(fx["lsid_sha256"]),
        "count": int(arena.count), "count_ref": int(fx["count"]),
    }
    segs = {s["id"]: s for s in live_segments(arena)}
    a = {k: v.cpu().numpy() for k, v in arena._asdict().items()}
    n_ref = len(fx["seg_id"])
    n_int, n_bits, worst = 0, 0, 0.0
    for i, g in enumerate(fx["seg_id"].tolist()):
        if g not in segs:
            continue
        n_int += all(int(a[f][g]) == int(fx[f][i])
                     for f in ("start_index", "end_index", "left_ptr",
                               "right_ptr", "start_count", "end_count",
                               "polyid", "npix", "level"))
        d = max(abs(float(a[f][g]) - float(fx[f][i]))
                for f in ("sx", "sy", "ex", "ey"))
        n_bits += d == 0.0
        worst = max(worst, d)
    stage.update(live_segments=len(segs), live_segments_ref=n_ref,
                 segments_int_equal=n_int, segments_float_bit_equal=n_bits,
                 max_endpoint_diff=worst)
    phase(f"phase 4 poly_frame vs fixture: {json.dumps(stage)}")
    if not (stage["packed0_equal"] and stage["edge_bin_equal"]
            and stage["strings_equal"] and stage["lsid_equal"]
            and stage["count"] == stage["count_ref"]
            and len(segs) == n_int == n_ref and worst <= ARENA_ATOL):
        fail("poly_frame differs from the JAX fixture")

    def region_path():
        fe_r = edge_frontend(bgr, cfg)
        weak_r, strong_r = weak_strong_labels(fe_r.edge_bin, fe_r.edge_thin,
                                              cfg)
        return (weak_r, strong_r,
                *region_smoothing(fe_r.packed0, weak_r, fe_r.edge_thin, cfg))

    maps = drive("weak_strong_labels -> region_smoothing",
                 front + ["seg_scan", "blblur", "quant_despeckle"],
                 region_path)
    maps2 = region_path()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(maps, maps2))
    phase(f"phase 4 region maps second run bit-identical: {same}")
    if not same:
        fail("two runs of the region path on the card differ")
    rx = np.load(os.path.join(ROOT, "tests", "data",
                              "rect_regions_720p_synth.npz"))
    phase(f"phase 4 region fixture: {json.loads(str(rx['meta']))['reference']}")
    names = ("weak_lbl", "strong_lbl", "blurred", "despeck")
    region = {f"{k}_equal": digest(m) == str(rx[f"{k}_sha256"])
              for k, m in zip(names, maps)}
    for k, m in zip(("weak", "strong"), maps[:2]):
        ref = np.unpackbits(rx[f"{k}_bits"])[:H * W].reshape(H, W)
        region[f"{k}_gt0_mismatch"] = int(
            ((m > 0).cpu().numpy() != ref.astype(bool)).sum())
        region[f"{k}_count"] = int((m > 0).sum())
    phase(f"phase 4 region maps vs fixture: {json.dumps(region)}")
    if not all(v for k, v in region.items() if k.endswith("_equal")) or \
            region["weak_gt0_mismatch"] or region["strong_gt0_mismatch"]:
        fail("the region maps differ from the JAX fixture")
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    # ---- 5. frame and stage times ---------------------------------------
    cfg_p = PipelineConfig(mkpl_pallas=0)
    for _ in range(3):
        poly_frame(bgr, cfg)
        poly_frame(bgr, cfg_p)
    torch.cuda.synchronize()
    times = {"DEFAULT_CONFIG": [], "mkpl_pallas=0": []}
    walls = []
    for i in range(40):
        name, c = (("DEFAULT_CONFIG", cfg) if i % 4 in (0, 3)
                   else ("mkpl_pallas=0", cfg_p))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        start.record()
        poly_frame(bgr, c)
        end.record()
        end.synchronize()
        if c is cfg:
            walls.append((time.perf_counter() - w0) * 1e3)
        times[name].append(start.elapsed_time(end))
    for name, ts in times.items():
        phase(f"phase 5 poly_frame 720p {name}: median "
              f"{statistics.median(ts):.3f} ms (CUDA events, {len(ts)} "
              f"frames in turns, min {min(ts):.3f}, max {max(ts):.3f})")
    phase(f"phase 5 poly_frame DEFAULT_CONFIG host wall median "
          f"{statistics.median(walls):.3f} ms")
    fe_t = edge_frontend(bgr, cfg)
    weak_t, _ = weak_strong_labels(fe_t.edge_bin, fe_t.edge_thin, cfg)
    for name, fn, reps in (
            ("weak_strong_labels", lambda: weak_strong_labels(
                fe_t.edge_bin, fe_t.edge_thin, cfg), 20),
            ("region_smoothing", lambda: region_smoothing(
                fe_t.packed0, weak_t, fe_t.edge_thin, cfg), 20),
            ("edge_frontend -> weak_strong_labels -> region_smoothing",
             region_path, 20)):
        phase(f"phase 5 {name} 720p: median {cuda_ms(torch, fn, reps):.3f} "
              f"ms (CUDA events, {reps} runs)")
    phase(f"phase 5 peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; card {card}")

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

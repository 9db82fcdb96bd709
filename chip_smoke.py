#!/usr/bin/env python3
"""Drive the PyTorch port's poly path once on a CUDA card, at 1280x720, and
check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA.  Phases (any failed check exits non-zero before
the final line):
  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from rectdetect_tpu_torch/csrc, timed;
  3. each kernel (K1 edge_front, K2 thinthres, K3 strings_chain, K4
     label_components) against its plain PyTorch version on the card, at
     the shapes of the real 720p intermediates of bench.synth_frame(720,
     1280, seed=0), with kernel and plain times (CUDA-event medians);
  4. pipeline.poly.poly_frame on cuda:0 with PipelineConfig(mkpl_pallas=0):
     every kernel's launch count must rise, a second run must be
     bit-identical, and each stage is held against the JAX reference
     fixture tests/data/poly_720p_synth.npz (tools/make_torch_fixture.py);
  5. time per 720p frame, the CUDA-event median over 20 frames.
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
EDGE_BIN_MAX_FRAC = 1e-4       # of the fixture's edge_bin pixels
SEG_MIN_MATCH = 0.99           # of the fixture's live segments, within 1 px


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
        from rectdetect_tpu_torch.config import PipelineConfig
        from rectdetect_tpu_torch.core import color
        from rectdetect_tpu_torch.ops import (_build, blur, ccl, hopper_ccl,
                                              hopper_grad, hopper_morph,
                                              hopper_thin)
        from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
        from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame
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

    def record(name, src, replaces, err, ms, plain_ms):
        records.append({"name": name, "route": "cuda",
                        "source": f"rectdetect_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": None,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        phase(f"phase 3 {name}: max_abs_err {err!r}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms")

    em, vec = hopper_grad.edge_front(labb)
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    torch.cuda.synchronize()
    err = max((em - em_p).abs().max().item(), (vec - vec_p).abs().max().item())
    nbits = int((em != em_p).sum() + (vec != vec_p).sum())
    phase(f"phase 3 edge_front: {nbits} float outputs differ in any bit")
    if not err <= FLOAT_ATOL:
        fail(f"edge_front: kernel and plain differ by {err} > {FLOAT_ATOL}")
    record("edge_front", "edge_front.cu",
           "rectdetect_tpu/ops/pallas_grad.py:48", err,
           cuda_ms(torch, lambda: hopper_grad.edge_front(labb), 20),
           cuda_ms(torch, lambda: hopper_grad.edge_front_plain(labb), 5))

    thin = hopper_thin.thinthres(em, vec)
    thin_p = hopper_thin.thin_plain(em, vec)
    torch.cuda.synchronize()
    err = (thin - thin_p).abs().max().item()
    nbin = int(((thin > 0) != (thin_p > 0)).sum())
    phase(f"phase 3 thinthres: {int((thin != thin_p).sum())} outputs differ "
          f"in any bit, {nbin} differ in edge_thin > 0")
    if not err <= FLOAT_ATOL or nbin:
        fail(f"thinthres: max diff {err}, {nbin} edge_bin pixels differ")
    record("thinthres", "thin.cu", "rectdetect_tpu/ops/pallas_thin.py:43",
           err, cuda_ms(torch, lambda: hopper_thin.thinthres(em, vec), 20),
           cuda_ms(torch, lambda: hopper_thin.thin_plain(em, vec), 5))

    edge_bin = (thin > 0).to(torch.int32)
    lbl = hopper_ccl.label_components(edge_bin, 0)
    lbl_p = hopper_ccl.label_components_plain(edge_bin, 0)
    ndiff = int((lbl != lbl_p).sum())
    phase(f"phase 3 label_components: {ndiff} labels differ "
          f"(edge_bin density {edge_bin.float().mean().item():.4f})")
    if ndiff:
        fail(f"label_components: {ndiff} labels differ from the plain version")
    record("label_components", "ccl.cu",
           "rectdetect_tpu/ops/pallas_ccl.py:101", 0.0,
           cuda_ms(torch, lambda: hopper_ccl.label_components(edge_bin, 0), 20),
           cuda_ms(torch, lambda: hopper_ccl.label_components_plain(
               edge_bin, 0), 3))

    st = ccl.calc_strength(thin, lbl)
    edge = (ccl.filter_strength(lbl, st, 500) > 0).to(torch.int32)
    for variant in ("rect", "poly_branch"):
        s = hopper_morph.strings_chain(edge, variant)
        s_p = hopper_morph.strings_chain_plain(edge, variant)
        ndiff = int((s != s_p).sum())
        phase(f"phase 3 strings_chain[{variant}]: {ndiff} pixels differ")
        if ndiff:
            fail(f"strings_chain[{variant}]: {ndiff} pixels differ")
    record("strings_chain", "morph.cu",
           "rectdetect_tpu/ops/pallas_morph.py:40", 0.0,
           cuda_ms(torch, lambda: hopper_morph.strings_chain(
               edge, "poly_branch"), 20),
           cuda_ms(torch, lambda: hopper_morph.strings_chain_plain(
               edge, "poly_branch"), 5))

    # ---- 4. the main path -----------------------------------------------
    cfg = PipelineConfig(mkpl_pallas=0)
    counters = {"edge_front": hopper_grad, "thinthres": hopper_thin,
                "strings_chain": hopper_morph,
                "label_components": hopper_ccl}
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    arena, lsid = poly_frame(bgr, cfg)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in counters.items()}
    phase(f"phase 4 poly_frame launches: {json.dumps(launches)}")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    idle = [k for k, v in launches.items() if v < 1]
    if idle:
        fail(f"poly_frame did not launch {idle}")

    arena2, lsid2 = poly_frame(bgr, cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(arena, f), getattr(arena2, f))
               for f in arena._fields) and torch.equal(lsid, lsid2)
    phase(f"phase 4 second run bit-identical: {same}")
    if not same:
        fail("two poly_frame runs on the card differ")

    if tuple(lsid.shape) != (H, W) or lsid.dtype != torch.int32:
        fail(f"lsid has shape {tuple(lsid.shape)} dtype {lsid.dtype}")
    for f in ("sx", "sy", "ex", "ey"):
        if not torch.isfinite(getattr(arena, f)).all():
            fail(f"arena.{f} has non-finite values")

    fx = np.load(os.path.join(ROOT, "tests", "data", "poly_720p_synth.npz"))
    phase(f"phase 4 fixture: {json.loads(str(fx['meta']))['reference']}")
    fe = edge_frontend(bgr, cfg)
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
        "strings_count": int((strings != 0).sum()),
        "strings_count_ref": int(fx["strings_count"]),
        "lsid_equal": digest(lsid) == str(fx["lsid_sha256"]),
        "count": int(arena.count), "count_ref": int(fx["count"]),
    }
    segs = {s["id"]: s for s in live_segments(arena)}
    a = {k: v.cpu().numpy() for k, v in arena._asdict().items()}
    n_ref = len(fx["seg_id"])
    n_int, n_match, worst = 0, 0, 0.0
    for i, g in enumerate(fx["seg_id"].tolist()):
        if g not in segs:
            continue
        ints = all(int(a[f][g]) == int(fx[f][i])
                   for f in ("start_index", "end_index", "left_ptr",
                             "right_ptr", "start_count", "end_count",
                             "polyid", "npix", "level"))
        d = max(abs(float(a[f][g]) - float(fx[f][i]))
                for f in ("sx", "sy", "ex", "ey"))
        n_int += ints
        n_match += ints and d <= 1.0
        worst = max(worst, d)
    stage.update(live_segments=len(segs), live_segments_ref=n_ref,
                 segments_int_equal=n_int, segments_matched_1px=n_match,
                 max_endpoint_diff=worst)
    phase(f"phase 4 vs fixture: {json.dumps(stage)}")
    if n_eb > EDGE_BIN_MAX_FRAC * H * W:
        fail(f"edge_bin differs from the fixture at {n_eb} pixels")
    if n_match < SEG_MIN_MATCH * n_ref or len(segs) == 0:
        fail(f"{n_match} of {n_ref} fixture segments matched within 1 px")

    # ---- 5. frame time --------------------------------------------------
    for _ in range(3):
        poly_frame(bgr, cfg)
    torch.cuda.synchronize()
    times, walls = [], []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        start.record()
        poly_frame(bgr, cfg)
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - w0) * 1e3)
        times.append(start.elapsed_time(end))
    phase(f"phase 5 poly_frame 720p: median {statistics.median(times):.3f} ms "
          f"(CUDA events, min {min(times):.3f}, max {max(times):.3f}); host "
          f"wall median {statistics.median(walls):.3f} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"card {card}")

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

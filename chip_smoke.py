#!/usr/bin/env python3
"""Drive the PyTorch port's poly path and rect path (rect_frame, frame ->
rectangles with their pose) once on a CUDA card, at 1280x720, and check
them end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA.  Phases (any failed check exits non-zero before
the final line):
  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from rectdetect_tpu_torch/csrc, timed;
  3. each of the fourteen kernels (K1 edge_front, K2 thinthres, K3
     strings_chain, K4 label_components, mkpl, seg_scan, blblur,
     quant_despeckle, merge_mask, label_merge, despeckle2, distinct_bids,
     hyp, pose) against its plain PyTorch version on the card, at the real
     720p intermediates of bench.synth_frame(720, 1280, seed=0), with
     the plain versions' times (CUDA-event medians); mkpl also under arena
     overflow, hyp (ok equal, corners equal with NaN in the same places)
     also on two 384-group corpora, pose also on 384
     projected rectangles and degenerate quads; for every kernel its
     device time per call (CUDA events around 10 back-to-back calls that
     the host queued while the device slept, 3 turns) beside the time of
     one whole wrapper call, and its kernels per call by the kernel
     library's own counter, held exactly; blblur's fused round counts F
     in turns; mkpl's device time at 0, 1 and 15 rounds; K3's device time
     on each variant's own input (poly_branch on the poly path's
     strength-filtered edges, rect on the rect path's edge_bin), K4's on
     each of its three inputs on the main paths (the poly path's
     edge_bin, the rect strings, the boundary marks), quant_despeckle's
     on the rect path's blurred colours and thinned edges, and hyp's on
     the 720p hypotheses and the seed-0 corpus; nvcc's -Xptxas -v lines
     of thin.cu, despeckle2.cu, morph.cu, quant_despeckle.cu, mkpl.cu,
     links_ccl.cu, ccl.cu and hyp.cu; K2 in both modes; and, where
     build/parent/ holds a git archive of the parent commit, the parent's
     thin and despeckle2 kernels held bit-equal to these and timed in
     turns with them, and the parent despeckle2's memset, histogram and
     absorption timed one by one;
  4. the main paths, each with every launch count set to 0 just before it
     and read just after, and the kernel library's own count of kernels
     held equal to the kernels its wrappers launched (7 for poly_frame,
     37 for rect_frame):
     pipeline.poly.poly_frame with DEFAULT_CONFIG
     (held bit for bit against the mkpl_pallas=0 run and against the JAX
     fixture tests/data/poly_720p_synth.npz), pipeline.rect
     weak_strong_labels -> region_smoothing (held against
     tests/data/rect_regions_720p_synth.npz), and pipeline.rect
     rect_hypotheses, frame -> hypotheses (held against
     tests/data/rect_hyp_720p_synth.npz), and pipeline.rect.rect_frame,
     frame -> RectResult (hyp and pose launched once each; held
     bit for bit against the hyp_pallas=0 run and against
     tests/data/rect_frame_720p_synth.npz: valid and status equal, the
     accepted corner sets matched one to one within 2 px); each path must
     launch its kernels, and a second run must be bit-identical;
  5. the DEFAULT_CONFIG frame time beside the mkpl_pallas=0 frame time,
     timed in turns, the rect stages' times and the rect_frame time and
     frame rate (CUDA-event medians).
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
# pose value and 3D corners, relative: the kernel runs the plain version's
# float operations, so bit-equal is expected; 12 CG iterations can grow an
# ulp of difference, which this bound would still admit
POSE_RTOL = 1e-3
# lower bounds on the float operations of one evaluation of the pose
# objective (csrc/pose.cu quad_value: 185 on floats); a jet with N seed
# directions does at least 2N more for each operation on the value except
# the two constant subtractions and the two floors
POSE_VALUE_OPS = 185
POSE_JET_OPS_PER_DIR = 2 * (POSE_VALUE_OPS - 4)
# the least time of a kernel: bytes over the H100 SXM's memory rate,
# operations over its float32 rate outside the tensor cores (NVIDIA's data
# sheet; it gives no int32 rate, and the H100 runs int32 no faster, so
# integer work counted at this rate stays a lower bound)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# kernels per 720p frame of the smoke run by the library's counter
POLY_FRAME_KERNELS = 7
RECT_FRAME_KERNELS = 37


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


def device_ms(torch, build_mod, fn, calls: int = 10, turns: int = 3):
    """Device time per call of fn(), after one warm-up call: CUDA events
    around `calls` back-to-back calls, `turns` times.  The host queues each
    turn's calls while the device sleeps (torch.cuda._sleep), and the start
    event must still be pending when the last call is queued, so no host
    gap falls between the calls.  Returns (ms per call of each turn,
    kernels launched per call by the library's own counter)."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    times, made = [], 0
    n0 = build_mod.launch_count()
    for _ in range(turns):
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            ahead = not start.query()
            end.synchronize()
            made += calls
            if ahead:
                break
            cycles *= 2
        else:
            fail("the host could not queue the calls ahead of the device")
        times.append(start.elapsed_time(end) / calls)
    return times, (build_mod.launch_count() - n0) / made


def same_quads(torch, a, b) -> bool:
    """Two (corners, ok) results of the quad reduction: ok equal, and every
    corner equal with NaN in the same places."""
    return (torch.equal(a[1], b[1])
            and torch.equal(a[0].isnan(), b[0].isnan())
            and torch.equal(a[0].nan_to_num(), b[0].nan_to_num()))


def ptxas_lines(log: str) -> list[str]:
    """nvcc -Xptxas=-v's lines per kernel: the entry, its registers and
    shared memory, its stack and spills."""
    keep = ("Compiling entry", "Used", "spill")
    return [" ".join(line.split()) for line in log.splitlines()
            if any(k in line for k in keep)]


def build_kernels(build_mod, src, out_dir, names):
    """Compile csrc files `names` (with launches.cu, the launch counter)
    from the directory `src` in parallel, link them in `out_dir` into one
    library of their own, and load it."""
    import ctypes
    out = os.path.join(out_dir, "libkernels.so")
    objs = []
    procs = []
    for name in (*names, "launches"):
        obj = os.path.join(out_dir, f"{name}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [build_mod._nvcc(), *build_mod.COMPILE_FLAGS, "-c", "-o", obj,
             os.path.join(src, f"{name}.cu")], stderr=subprocess.PIPE,
            text=True))
    for proc in procs:
        if proc.wait(timeout=600) != 0:
            fail(f"the kernels of {src} do not build: {proc.stderr.read()}")
    res = subprocess.run([build_mod._nvcc(), *build_mod.LINK_FLAGS, "-o", out,
                          *objs], capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"the kernels of {src} do not link: {res.stderr}")
    return ctypes.CDLL(out)


def stream_of(torch):
    return torch.cuda.current_stream().cuda_stream


# the parent's despeckle2 part by part, where its csrc/despeckle2.cu is
# the memset, histogram kernel and absorption kernel version: this source
# includes the parent's, so its kernels are in reach
PARENT_DESPECKLE2_PARTS = r"""
#include "despeckle2.cu"

extern "C" int rd_parent_memset(void* sizes, int n, void* stream) {
  return (int)cudaMemsetAsync(sizes, 0, sizeof(int) * (size_t)n,
                              (cudaStream_t)stream);
}

extern "C" int rd_parent_sizes(const void* label, void* sizes, int n,
                               void* stream) {
  sizes_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int*)label, (int*)sizes, n);
  return (int)cudaGetLastError();
}

extern "C" int rd_parent_absorb(const void* label, const void* sizes,
                                void* out, int h, int w, int thre,
                                void* stream) {
  absorb_kernel<<<rd::pixel_grid(h, w), rd::pixel_block(), 0,
                  (cudaStream_t)stream>>>((const int*)label,
                                          (const int*)sizes, (int*)out, h, w,
                                          thre);
  return (int)cudaGetLastError();
}
"""


def bind_thin(torch, lib):
    """thin_fn(em, vec, mode) through lib's rd_thin."""
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rd_thin.argtypes = [P, P, P, I, I, I, F, P]
    lib.rd_thin.restype = ctypes.c_int

    def thin_fn(em, vec, mode):
        h, w = em.shape
        out = torch.empty_like(em)
        err = lib.rd_thin(em.data_ptr(), vec.data_ptr(), out.data_ptr(), h,
                          w, int(mode == "cubic"), 0.99, stream_of(torch))
        if err:
            fail(f"rd_thin of {lib._name} did not launch (error {err})")
        return out

    return thin_fn


def bind_despeckle2(torch, lib):
    """despeckle2_fn(label, thre) through lib's rd_despeckle2."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rd_despeckle2.argtypes = [P, P, P, I, I, I, P]
    lib.rd_despeckle2.restype = ctypes.c_int

    def despeckle2_fn(label, thre):
        h, w = label.shape
        out = torch.empty_like(label)
        sizes = torch.empty((h * w,), dtype=torch.int32, device=label.device)
        err = lib.rd_despeckle2(label.data_ptr(), sizes.data_ptr(),
                                out.data_ptr(), h, w, thre, stream_of(torch))
        if err:
            fail(f"rd_despeckle2 of {lib._name} did not launch (error "
                 f"{err})")
        return out

    return despeckle2_fn


def parent_kernels(torch, build_mod):
    """The thin and despeckle2 kernels of the parent commit, for timing in
    turns with this tree's: built from build/parent/ (a git archive of the
    parent, unpacked there by hand; absent from a plain checkout, and then
    None) into one library with the parent's C signatures and its own
    launch counter.  Returns (thin_fn(em, vec, mode), despeckle2_fn(label,
    thre), parts): parts maps the parent despeckle2's memset, histogram
    and absorption to calls of their own (None unless the parent's source
    has those kernels)."""
    import ctypes
    src = os.path.join(ROOT, "build", "parent", "rectdetect_tpu_torch",
                       "csrc")
    if not os.path.isdir(src):
        return None
    with open(os.path.join(src, "despeckle2.cu")) as f:
        split = "absorb_kernel" in f.read()
    d2 = "despeckle2"
    if split:
        d2 = "despeckle2_parts"
        with open(os.path.join(src, f"{d2}.cu"), "w") as f:
            f.write(PARENT_DESPECKLE2_PARTS)
    lib = build_kernels(build_mod, src, os.path.join(ROOT, "build", "parent"),
                        ("thin", d2))
    parts = None
    if split:
        P, I = ctypes.c_void_p, ctypes.c_int
        for name, args in (("rd_parent_memset", [P, I, P]),
                           ("rd_parent_sizes", [P, P, I, P]),
                           ("rd_parent_absorb", [P, P, P, I, I, I, P])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int

        def check(err, what):
            if err:
                fail(f"the parent's {what} did not launch (error {err})")

        def parts_for(label, thre):
            """The three parts on label: the memset and the histogram
            work on a scratch table of their own, the absorption reads
            the sizes that one histogram run counted first."""
            h, w = label.shape
            s = stream_of(torch)
            sizes = torch.zeros((h * w,), dtype=torch.int32,
                                device=label.device)
            check(lib.rd_parent_sizes(label.data_ptr(), sizes.data_ptr(),
                                      h * w, s), "histogram kernel")
            scratch = torch.zeros_like(sizes)
            out_t = torch.empty_like(label)
            return {
                "memset": lambda: check(lib.rd_parent_memset(
                    scratch.data_ptr(), h * w, s), "memset"),
                "sizes_kernel": lambda: check(lib.rd_parent_sizes(
                    label.data_ptr(), scratch.data_ptr(), h * w, s),
                    "histogram kernel"),
                "absorb_kernel": lambda: check(lib.rd_parent_absorb(
                    label.data_ptr(), sizes.data_ptr(), out_t.data_ptr(), h,
                    w, thre, s), "absorption kernel")}
        parts = parts_for
    return bind_thin(torch, lib), bind_despeckle2(torch, lib), parts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card and does not fall back to the CPU")
    sys.path.insert(0, ROOT)
    try:
        from bench import synth_frame
        from rectdetect_tpu_torch.apps.common import TAN_AOV
        from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
        from rectdetect_tpu_torch.core import color
        from rectdetect_tpu_torch.ops import (_build, blur, ccl,
                                              hopper_bids,
                                              hopper_blblur, hopper_ccl,
                                              hopper_despeckle2, hopper_grad,
                                              hopper_hyp, hopper_links,
                                              hopper_merge_mask, hopper_mkpl,
                                              hopper_morph, hopper_pose,
                                              hopper_quant, hopper_scan,
                                              hopper_thin, mkpl, polyline,
                                              regions)
        from rectdetect_tpu_torch import parity
        from rectdetect_tpu_torch.geometry import pose, quad
        from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
        from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame
        from rectdetect_tpu_torch.pipeline.rect import (
            boundary_labels, hypotheses, rect_frame, rect_geometry,
            rect_hypotheses, region_merge, region_smoothing,
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

    def record(name, src, replaces, err, fn, plain_ms, nbytes, ops,
               kernels=1):
        """fn: one wrapper call at the main path's shapes, launching
        `kernels` kernels; nbytes: each input read once and each output
        written once; ops: a lower bound on the operations this run's data
        needs.  "ms" is the device time per call (device_ms, the median of
        its turns), "wrapper_ms" the CUDA-event time of one whole call."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        times, per_call = device_ms(torch, _build, fn)
        if per_call != kernels:
            fail(f"{name}: {per_call} kernel launches per call by the "
                 f"library's counter, not {kernels}")
        ms = statistics.median(times)
        wrapper = cuda_ms(torch, fn, 20)
        records.append({"name": name, "route": "cuda",
                        "source": f"rectdetect_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": None,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "library_ms": None, "device_ms": times,
                        "wrapper_ms": wrapper, "kernels_per_call": kernels})
        phase(f"phase 3 {name}: max_abs_err {err!r}  device {ms:.4f} ms per "
              f"call (CUDA events, 10 back-to-back calls, 3 turns: "
              f"{[round(t, 5) for t in times]})  wrapper {wrapper:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {max(t_bytes, t_ops):.6f} ms "
              f"({nbytes} B, {ops} ops)  {kernels} kernels per call "
              f"(library counter)")

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
           lambda: hopper_grad.edge_front(labb),
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
           err, lambda: hopper_thin.thinthres(em, vec),
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
           lambda: hopper_ccl.label_components(edge_bin, 0),
           cuda_ms(torch, lambda: hopper_ccl.label_components_plain(
               edge_bin, 0), 3), nb(edge_bin, lbl), H * W, kernels=3)

    st = ccl.calc_strength(thin, lbl)
    edge = (ccl.filter_strength(lbl, st, 500) > 0).to(torch.int32)
    cfg = DEFAULT_CONFIG
    fe = edge_frontend(bgr, cfg)
    # K3 on each variant's own input: poly_branch on the poly path's
    # strength-filtered edges, rect on the rect path's edge_bin
    k3_inputs = {"poly_branch": edge, "rect": fe.edge_bin}
    for variant, pix in k3_inputs.items():
        s = hopper_morph.strings_chain(pix, variant)
        s_p = hopper_morph.strings_chain_plain(pix, variant)
        ndiff = int((s != s_p).sum())
        phase(f"phase 3 strings_chain[{variant}]: {ndiff} pixels differ "
              f"({int(s_p.sum())} string pixels of "
              f"{int((pix != 0).sum())} edge pixels)")
        if ndiff:
            fail(f"strings_chain[{variant}]: {ndiff} pixels differ")
    # ops: >= one decision per pixel
    record("strings_chain", "morph.cu",
           "rectdetect_tpu/ops/pallas_morph.py:40", 0.0,
           lambda: hopper_morph.strings_chain(edge, "poly_branch"),
           cuda_ms(torch, lambda: hopper_morph.strings_chain_plain(
               edge, "poly_branch"), 5), 2 * nb(edge), H * W,
           kernels=hopper_morph.KERNELS)

    # mkpl at the poly path's own arc compaction, then under overflow
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
           lambda: run_mkpl(hopper_mkpl.mkpl_subdivide, arena0),
           cuda_ms(torch, lambda: run_mkpl(mkpl.mkpl_subdivide, arena0), 3),
           nb(comp.idx) + 8 * n_live + 2 * 13 * 4 * cap + nb(got[1]),
           20 * rounds * n_live)

    # the redesigned kernels (csrc/thin.cu, csrc/despeckle2.cu,
    # csrc/morph.cu, csrc/quant_despeckle.cu, csrc/mkpl.cu,
    # csrc/links_ccl.cu, csrc/ccl.cu, csrc/hyp.cu): their registers and
    # spills; mkpl's device time at 0, 1 and all rounds (the fixed cost and
    # the cost per round); thin and despeckle2 timed in turns with the
    # parent commit's kernels where they were brought along (build/parent/)
    parent = parent_kernels(torch, _build)
    redesign = {"card": card, "ptxas": {
        k: ptxas_lines(_build.ptxas_log.get(k, "not rebuilt in this run"))
        for k in ("thin.cu", "despeckle2.cu", "morph.cu",
                  "quant_despeckle.cu", "mkpl.cu", "links_ccl.cu", "ccl.cu",
                  "hyp.cu")}}
    for k, lines in redesign["ptxas"].items():
        for line in lines:
            phase(f"phase 3 ptxas {k}: {line}")

    def in_turns(this_call, parent_call):
        """Device and wrapper ms of one turn each of parent, this, this,
        parent."""
        out = {"order": "parent, this, this, parent", "device_ms": [],
               "wrapper_ms": []}
        for call in (parent_call, this_call, this_call, parent_call):
            out["device_ms"].append(
                device_ms(torch, _build, call, turns=1)[0][0])
            out["wrapper_ms"].append(cuda_ms(torch, call, 10))
        return out

    # K2 in both modes: within FLOAT_ATOL of the plain version with
    # edge_thin > 0 equal, bit-equal to the parent's kernel, in turns
    redesign["thin"] = {}
    for mode in ("thres", "cubic"):
        def call(mode=mode):
            return hopper_thin.thinthres(em, vec, mode)
        got = call()
        want = hopper_thin.thin_plain(em, vec, mode)
        err_m = (got - want).abs().max().item()
        entry = {"max_abs_err": err_m,
                 "edge_thin_differ": int(((got > 0) != (want > 0)).sum()),
                 "bits_differ_from_plain": int((got != want).sum())}
        if not err_m <= FLOAT_ATOL or entry["edge_thin_differ"]:
            fail(f"thinthres[{mode}] differs from the plain version: "
                 f"{entry}")
        if parent is not None:
            def parent_call(mode=mode):
                return parent[0](em, vec, mode)
            if not torch.equal(parent_call(), got):
                fail(f"thinthres[{mode}]: the parent's kernel differs")
            entry["parent_bit_equal"] = True
            entry["parent_turns"] = in_turns(call, parent_call)
        redesign["thin"][mode] = entry
        phase(f"phase 3 thinthres[{mode}]: {json.dumps(entry)}")

    split = {
        f"rounds {iters - 1}": device_ms(
            torch, _build, lambda: hopper_mkpl.mkpl_subdivide(
                arena0, dense, number, 1.0, iters, comp))[0]
        for iters in (1, 2, cfg.mkpl_iters)}
    redesign["mkpl_rounds_device_ms"] = split
    phase(f"phase 3 mkpl device ms per call by rounds (CUDA events, 10 "
          f"back-to-back calls, 3 turns): {json.dumps(split)}")

    # K3 on each variant's own input
    redesign["strings_chain_inputs"] = {}
    for variant, pix in k3_inputs.items():
        def call(pix=pix, variant=variant):
            return hopper_morph.strings_chain(pix, variant)
        times, per_call = device_ms(torch, _build, call)
        if per_call != hopper_morph.KERNELS:
            fail(f"strings_chain[{variant}]: {per_call} kernels per call by "
                 f"the library's counter, not {hopper_morph.KERNELS}")
        entry = {"edge_pixels": int((pix != 0).sum()), "device_ms": times,
                 "bound_ms": 2 * nb(pix) / HBM_BYTES_PER_S * 1e3}
        redesign["strings_chain_inputs"][variant] = entry
        phase(f"phase 3 strings_chain[{variant}]: {json.dumps(entry)}")

    # the strength pair's segmented totals at 720p, on the rect strings
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
           lambda: hopper_scan.seg_total_sorted(skey, sval, thre),
           cuda_ms(torch, lambda: hopper_scan.seg_total_plain(
               skey, sval, thre), 5), nb(skey, sval, tot), 2 * sp,
           kernels=6)

    weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
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
           lambda: hopper_blblur.blblur(fe.packed0, weak_bin, iters),
           cuda_ms(torch, lambda: regions.blblur(fe.packed0, weak_bin, iters),
                   3), nb(fe.packed0, weak_bin, blurred),
           2 * H * W + 2 * iters * 3 * 3 * H * W,
           kernels=hopper_blblur.launch_count(iters))

    # blblur (csrc/blblur.cu): every fused round count against the plain
    # version, then their device time and kernels per call in turns
    for f in hopper_blblur.TILES:
        if not torch.equal(hopper_blblur.blblur_fused(
                fe.packed0, weak_bin, iters, f), blurred_p):
            fail(f"blblur with {f} fused rounds differs from the plain "
                 f"version")
    sweep = {f: [] for f in hopper_blblur.TILES}
    for _ in range(3):
        for f in hopper_blblur.TILES:
            times, per_call = device_ms(torch, _build, lambda: hopper_blblur.
                                        blblur_fused(fe.packed0, weak_bin,
                                                     iters, f), turns=1)
            if per_call != hopper_blblur.launch_count(iters, f):
                fail(f"blblur with {f} fused rounds launched {per_call} "
                     f"kernels per call by the library's counter, not "
                     f"{hopper_blblur.launch_count(iters, f)}")
            sweep[f].append(times[0])
    redesign["blblur_fuse_sweep"] = {
        f: {"tile": hopper_blblur.TILES[f], "device_ms": ts,
            "kernels_per_call": hopper_blblur.launch_count(iters, f),
            "wrapper_ms": cuda_ms(torch, lambda: hopper_blblur.blblur_fused(
                fe.packed0, weak_bin, iters, f), 10)}
        for f, ts in sweep.items()}
    best = min(sweep, key=lambda f: statistics.median(sweep[f]))
    phase(f"phase 3 blblur F sweep: "
          f"{json.dumps(redesign['blblur_fuse_sweep'])} (CUDA events, 10 "
          f"back-to-back calls, 3 turns); F = {hopper_blblur.FUSE} in use, "
          f"fastest F in this run: {best}")

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
           lambda: hopper_quant.quantize_despeckle(
               blurred, fe.edge_thin, n, n, n),
           cuda_ms(torch, lambda: regions.quantize_despeckle(
               blurred, fe.edge_thin, n, n, n), 5),
           nb(blurred, fe.edge_thin, despeck), 15 * H * W,
           kernels=hopper_quant.KERNELS)

    redesign["quant_despeckle"] = {
        "on_edge": int((fe.edge_thin >= 1e-6).sum())}

    # the region merge's kernels on the maps the rect path gives them
    mask = hopper_merge_mask.junction_merge_mask(strong)
    mask_p = regions.junction_merge_mask(strong)
    ndiff = int((mask != mask_p).sum())
    phase(f"phase 3 merge_mask: {ndiff} pixels differ "
          f"({int(mask.sum())} mask pixels)")
    if ndiff:
        fail(f"merge_mask: {ndiff} pixels differ from the plain version")
    # ops: >= one decision per pixel
    record("merge_mask", "merge_mask.cu",
           "rectdetect_tpu/ops/pallas_morph.py:391", 0.0,
           lambda: hopper_merge_mask.junction_merge_mask(strong),
           cuda_ms(torch, lambda: regions.junction_merge_mask(strong), 3),
           nb(strong, mask), H * W)

    seg0 = hopper_links.label_merge(despeck, mask, strong)
    seg0_p = regions.label_merge(despeck, mask, strong)
    ndiff = int((seg0 != seg0_p).sum())
    phase(f"phase 3 label_merge: {ndiff} labels differ "
          f"({int(torch.unique(seg0).numel())} regions)")
    if ndiff:
        fail(f"label_merge: {ndiff} labels differ from the plain version")
    # bytes: colours, mask and edges read, labels written; ops: >= one
    # link decision per pixel
    record("label_merge", "links_ccl.cu",
           "rectdetect_tpu/ops/pallas_ccl.py:471", 0.0,
           lambda: hopper_links.label_merge(despeck, mask, strong),
           cuda_ms(torch, lambda: regions.label_merge(despeck, mask, strong),
                   3), nb(despeck, mask, strong, seg0), H * W, kernels=3)

    thre2 = cfg.despeckle2_thre
    seg = hopper_despeckle2.sizes_despeckle2(seg0, thre2)
    seg_p = regions.sizes_despeckle2(seg0, thre2)
    ndiff = int((seg != seg_p).sum())
    phase(f"phase 3 despeckle2: {ndiff} labels differ "
          f"({int((seg != seg0).sum())} pixels absorbed)")
    if ndiff:
        fail(f"despeckle2: {ndiff} labels differ from the plain version")
    # ops: >= one histogram add and one size test per pixel
    record("despeckle2", "despeckle2.cu",
           "rectdetect_tpu/ops/pallas_morph.py:597", 0.0,
           lambda: hopper_despeckle2.sizes_despeckle2(seg0, thre2),
           cuda_ms(torch, lambda: regions.sizes_despeckle2(seg0, thre2), 3),
           nb(seg0, seg), 2 * H * W, kernels=hopper_despeckle2.KERNELS)

    # despeckle2 in turns with the parent's kernels, bit-equal to them, and
    # the parent's three parts (memset, histogram, absorption) one by one
    def d2_call():
        return hopper_despeckle2.sizes_despeckle2(seg0, thre2)
    entry = {"regions": int(torch.unique(seg0).numel()),
             "absorbed": int((seg != seg0).sum())}
    if parent is not None:
        def parent_call():
            return parent[1](seg0, thre2)
        if not torch.equal(parent_call(), seg):
            fail("despeckle2: the parent's kernels differ")
        entry["parent_bit_equal"] = True
        entry["parent_turns"] = in_turns(d2_call, parent_call)
        if parent[2] is not None:
            entry["parent_parts_device_ms"] = {
                name: device_ms(torch, _build, fn)[0]
                for name, fn in parent[2](seg0, thre2).items()}
    redesign["despeckle2"] = entry
    phase(f"phase 3 despeckle2: {json.dumps(entry)}")

    boundary, _ = boundary_labels(seg, cfg)
    bids = hopper_bids.distinct_bids(boundary)
    bids_p = hopper_bids.distinct_bids_plain(boundary)
    ndiff = sum(int((a != b).sum()) for a, b in zip(bids, bids_p))
    phase(f"phase 3 distinct_bids: {ndiff} slot values differ "
          f"({int((boundary >= 0).sum())} boundary pixels)")
    if ndiff:
        fail(f"distinct_bids: {ndiff} slot values differ from the plain "
             f"version")
    # bytes: the ids read once, the 4 slot maps written; ops: >= one
    # decision per pixel
    record("distinct_bids", "distinct_bids.cu",
           "rectdetect_tpu/ops/pallas_morph.py:519", 0.0,
           lambda: hopper_bids.distinct_bids(boundary),
           cuda_ms(torch, lambda: hopper_bids.distinct_bids_plain(boundary),
                   3), nb(boundary, *bids), H * W)

    # K4 on each of its inputs on the main paths: the poly path's edge_bin
    # (the row above), the rect strings (weak_strong_labels) and the
    # boundary marks (boundary_labels, background -1)
    redesign["label_components_inputs"] = {}
    k4_inputs = {"edge_bin": (edge_bin, 0), "rect strings": (s_rect, 0),
                 "boundary marks": (regions.mark_boundary(seg), -1)}
    for name, (pix, bgc) in k4_inputs.items():
        def call(pix=pix, bgc=bgc):
            return hopper_ccl.label_components(pix, bgc)
        got = call()
        ndiff = int((got != hopper_ccl.label_components_plain(pix, bgc))
                    .sum())
        entry = {"foreground": int((pix != bgc).sum()),
                 "components": int((got == torch.arange(
                     H * W, device=dev).reshape(H, W)).sum()),
                 "labels_differ": ndiff}
        if ndiff:
            fail(f"label_components on {name}: {ndiff} labels differ from "
                 f"the plain version")
        times, per_call = device_ms(torch, _build, call)
        if per_call != 3:
            fail(f"label_components on {name}: {per_call} kernels per call "
                 f"by the library's counter, not 3")
        entry["device_ms"] = times
        redesign["label_components_inputs"][name] = entry
        phase(f"phase 3 label_components on {name}: {json.dumps(entry)}")

    def top(t, where):
        """The largest of t where `where` holds, 0.0 if nowhere."""
        t = t[where]
        return t.max().item() if t.numel() else 0.0

    # the quad reduction on the 720p hypotheses and on two corpora of 384
    # groups (the 720p frame fills 6 of its 384)
    hyp = rect_hypotheses(bgr, cfg)
    corpora = [("720p hypotheses", hyp.segs, hyp.valid)] + [
        (f"corpus seed {sd} scale {sc}",
         *(torch.from_numpy(a).to(dev) for a in parity.segment_groups(
             sd, 2 * cfg.max_groups, cfg.max_group_segs, sc)))
        for sd, sc in ((0, 1.0), (2, 0.03))]
    hv = cfg.hull_max_vertices
    err = 0.0
    for name, segs_c, valid_c in corpora:
        corners, ok = hopper_hyp.reduce_groups(segs_c, valid_c, hv)
        corners_p, ok_p = quad.reduce_groups(segs_c, valid_c, hv)
        torch.cuda.synchronize()
        e = top((corners - corners_p).abs(), ok & ok_p)
        nbits = int((corners == corners_p).sum() +
                    (corners.isnan() & corners_p.isnan()).sum())
        phase(f"phase 3 hyp {name}: ok equal {torch.equal(ok, ok_p)} "
              f"({int(ok.sum())} of {ok.numel()} groups ok); corners where "
              f"ok max_abs_err {e!r}; {nbits} of {corners.numel()} corner "
              f"values bit-equal")
        if not same_quads(torch, (corners, ok), (corners_p, ok_p)):
            fail(f"hyp on {name}: ok differs or the corners are not equal "
                 f"with NaN in the same places ({nbits} of "
                 f"{corners.numel()} equal)")
        err = max(err, e)

    def hull_ops(segs_c, valid_c):
        """A lower bound on the hull's pair tests: each step the winner is
        tested against every other valid endpoint and each other candidate
        at least once (2 (n - 1) tests of 9 operations), over the steps
        each group's walk takes (its vertex count, at most hv - 1)."""
        sq = ((segs_c[..., 1, :] - segs_c[..., 0, :]) ** 2).sum(-1)
        v = quad.remove_short(sq, valid_c & (sq > 0))
        n = 2 * v.sum(-1)
        pts = segs_c.reshape(segs_c.shape[0], -1, 2)
        _, hvalid = quad.jarvis_hull(pts[..., 0], pts[..., 1],
                                     v.repeat_interleave(2, dim=-1), hv)
        steps = hvalid.sum(-1).clamp(max=hv - 1)
        return int((steps * 2 * (n - 1).clamp(min=0) * 9).sum())

    corners, ok = hopper_hyp.reduce_groups(hyp.segs, hyp.valid, hv)
    record("hyp", "hyp.cu", "rectdetect_tpu/ops/pallas_hyp.py:69", err,
           lambda: hopper_hyp.reduce_groups(hyp.segs, hyp.valid, hv),
           cuda_ms(torch, lambda: quad.reduce_groups(hyp.segs, hyp.valid,
                                                     hv), 5),
           nb(hyp.segs, hyp.valid, corners, ok),
           hull_ops(hyp.segs, hyp.valid))

    # hyp on the 720p hypotheses and the seed-0 corpus
    redesign["hyp_inputs"] = {}
    for name, segs_c, valid_c in corpora[:2]:
        def call(segs_c=segs_c, valid_c=valid_c):
            return hopper_hyp.reduce_groups(segs_c, valid_c, hv)
        times, per_call = device_ms(torch, _build, call)
        if per_call != 1:
            fail(f"hyp on {name}: {per_call} kernels per call by the "
                 f"library's counter, not 1")
        entry = {"groups": int(valid_c.any(1).sum()), "device_ms": times}
        redesign["hyp_inputs"][name] = entry
        phase(f"phase 3 hyp on {name}: {json.dumps(entry)}")

    # the pose on the 720p quads and on 384 projected rectangles and
    # degenerate quads
    quads = [("720p quads", corners)] + [
        ("projected rectangles", torch.from_numpy(parity.pose_quads(
            0, 336, 48, W, H, TAN_AOV)).to(dev))]
    pose_args = (W, H, TAN_AOV, cfg.cg_iters, cfg.cg_line_search_iters)
    err = 0.0
    for name, q in quads:
        got = hopper_pose.pose_estimate(q, *pose_args)
        want = pose.pose_estimate(q, *pose_args)
        torch.cuda.synchronize()
        screens = [pose.looks_like_a_screen(*r, cfg.accept_value,
                                            cfg.aspect_limit,
                                            cfg.offset_ratio_limit)
                   for r in (got, want)]
        same_nan = all(torch.equal(a.isnan(), b.isnan())
                       for a, b in zip(got[1:], want[1:]))
        rel = [top((a - b).abs() / b.abs().clamp(min=1e-6),
                   a.isfinite() & b.isfinite())
               for a, b in zip(got[1:], want[1:])]
        nbits = [int((a == b).sum() + (a.isnan() & b.isnan()).sum())
                 for a, b in zip(got[1:], want[1:])]
        away = (want[2] - cfg.accept_value).abs() > 1e-3
        n_screen = int((screens[0] != screens[1])[away].sum())
        phase(f"phase 3 pose {name}: c2 equal {torch.equal(got[0], want[0])}; "
              f"NaN in the same places {same_nan}; c3 max rel diff "
              f"{rel[0]!r} ({nbits[0]} of {got[1].numel()} bit-equal); value "
              f"max rel diff {rel[1]!r} ({nbits[1]} of {got[2].numel()} "
              f"bit-equal); screen bits differ at {n_screen} groups with "
              f"value > 1e-3 from accept_value ({int(screens[1].sum())} "
              f"screens)")
        if not (torch.equal(got[0], want[0]) and same_nan
                and max(rel) <= POSE_RTOL and n_screen == 0):
            fail(f"pose on {name} differs from the plain version")
        err = max([err] + [top((a - b).abs(), a.isfinite() & b.isfinite())
                           for a, b in zip(got[1:], want[1:])])
    g = corners.shape[0]
    # per (group, mode): the gradient jets, one line-search jet per step
    # (a taken candidate's jet serves the next step) and the value at each
    # search's last candidate
    n_jet4 = cfg.cg_iters + 1
    n_jet1 = cfg.cg_iters * cfg.cg_line_search_iters
    pose_ops = 2 * g * (n_jet4 * (POSE_VALUE_OPS + 4 * POSE_JET_OPS_PER_DIR)
                        + n_jet1 * (POSE_VALUE_OPS + POSE_JET_OPS_PER_DIR)
                        + cfg.cg_iters * POSE_VALUE_OPS)
    c2_t, c3_t, val_t = hopper_pose.pose_estimate(corners, *pose_args)
    record("pose", "pose.cu", "rectdetect_tpu/geometry/pose.py:205", err,
           lambda: hopper_pose.pose_estimate(corners, *pose_args),
           cuda_ms(torch, lambda: pose.pose_estimate(corners, *pose_args), 3),
           nb(corners, c2_t, c3_t, val_t), pose_ops)
    phase(f"phase 3 redesign: {json.dumps(redesign)}")

    # ---- 4. the main paths -----------------------------------------------
    counters = {"edge_front": hopper_grad, "thinthres": hopper_thin,
                "strings_chain": hopper_morph,
                "label_components": hopper_ccl, "mkpl": hopper_mkpl,
                "seg_scan": hopper_scan, "blblur": hopper_blblur,
                "quant_despeckle": hopper_quant,
                "merge_mask": hopper_merge_mask, "label_merge": hopper_links,
                "despeckle2": hopper_despeckle2,
                "distinct_bids": hopper_bids, "hyp": hopper_hyp,
                "pose": hopper_pose}
    launches = {}

    def drive(path, names, fn, kernels_per_run=None):
        """fn() with the counts set to 0 just before it and read just
        after; kernels_per_run: the library's count the path must make."""
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        _build.expected_kernels.clear()
        n0 = _build.launch_count()
        out = fn()
        torch.cuda.synchronize()
        kernels = _build.launch_count() - n0
        want = sum(_build.expected_kernels.values())
        counts = {name: mod.launches for name, mod in counters.items()}
        phase(f"phase 4 {path} launches: {json.dumps(counts)}; kernels "
              f"{kernels} by the library's counter, {want} expected "
              f"({json.dumps(_build.expected_kernels)})")
        idle = [k for k in names if counts[k] < 1]
        if idle:
            fail(f"{path} did not launch {idle}")
        if kernels != want:
            fail(f"{path} launched {kernels} kernels by the library's "
                 f"counter, not the {want} its wrappers launched")
        if kernels_per_run is not None and kernels != kernels_per_run:
            fail(f"{path} launched {kernels} kernels by the library's "
                 f"counter, not {kernels_per_run}")
        launches.update({k: counts[k] for k in names})
        return out

    front = ["edge_front", "thinthres", "strings_chain", "label_components"]
    arena, lsid = drive("poly_frame", front + ["mkpl"],
                        lambda: poly_frame(bgr, cfg), POLY_FRAME_KERNELS)
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

    hyp = drive("rect_hypotheses", [k for k in counters
                                    if k not in ("hyp", "pose")],
                lambda: rect_hypotheses(bgr, cfg))
    hyp2 = rect_hypotheses(bgr, cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(hyp, hyp2))
    phase(f"phase 4 rect_hypotheses second run bit-identical: {same}")
    if not same:
        fail("two runs of rect_hypotheses on the card differ")
    if tuple(hyp.segs.shape) != (2 * cfg.max_groups, cfg.max_group_segs, 2,
                                 2) or not torch.isfinite(hyp.segs).all():
        fail(f"segs: shape {tuple(hyp.segs.shape)} or non-finite values")
    hx = np.load(os.path.join(ROOT, "tests", "data",
                              "rect_hyp_720p_synth.npz"))
    phase(f"phase 4 hypotheses fixture: "
          f"{json.loads(str(hx['meta']))['reference']}")
    hstage = {f"{k}_equal": digest(getattr(hyp, k)) == str(hx[f"{k}_sha256"])
              for k in ("mask", "seg", "boundary", "lsid")}
    valid_np = hyp.valid.cpu().numpy()
    hstage.update(
        valid_equal=bool((valid_np == hx["valid"]).all()),
        status_equal=bool((hyp.status.cpu().numpy() == hx["status"]).all()),
        groups=int(valid_np.any(1).sum()),
        groups_ref=int(hx["valid"].any(1).sum()),
        members=int(valid_np.sum()),
        segs_bit_equal=int((hyp.segs.cpu().numpy() == hx["segs"]).sum()),
        segs_max_diff=float(np.abs(hyp.segs.cpu().numpy()
                                   - hx["segs"]).max()))
    phase(f"phase 4 rect_hypotheses vs fixture: {json.dumps(hstage)}")
    if not (all(v for k, v in hstage.items() if k.endswith("_equal"))
            and hstage["segs_max_diff"] <= ARENA_ATOL):
        fail("rect_hypotheses differs from the JAX fixture")

    res = drive("rect_frame", list(counters),
                lambda: rect_frame(bgr, TAN_AOV, cfg), RECT_FRAME_KERNELS)
    once = {k: launches[k] for k in ("hyp", "pose")}
    if once != {"hyp": 1, "pose": 1}:
        fail(f"rect_frame launched hyp and pose {once} times, not once each")
    res2 = rect_frame(bgr, TAN_AOV, cfg)
    res_p = rect_frame(bgr, TAN_AOV, PipelineConfig(hyp_pallas=0))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(res, res2))
    same_p = all(torch.equal(x, y) for x, y in zip(res, res_p))
    phase(f"phase 4 rect_frame second run bit-identical: {same}; "
          f"bit-identical to the hyp_pallas=0 run: {same_p}")
    if not (same and same_p):
        fail("rect_frame runs on the card differ")
    n_groups = 2 * cfg.max_groups
    if tuple(res.c2.shape) != (n_groups, 4, 2) or \
            tuple(res.c3.shape) != (n_groups, 4, 3) or \
            not all(torch.isfinite(t).all() for t in (res.c2, res.c3)) or \
            not torch.isfinite(res.value[res.valid]).all():
        fail("rect_frame: wrong shapes or non-finite values")
    rf = np.load(os.path.join(ROOT, "tests", "data",
                              "rect_frame_720p_synth.npz"))
    phase(f"phase 4 rect_frame fixture: "
          f"{json.loads(str(rf['meta']))['reference']}")
    valid_np = res.valid.cpu().numpy()
    c2_np = res.c2.cpu().numpy()
    both = valid_np & rf["valid"]
    mine = parity.accepted_corner_sets(c2_np, valid_np)
    ref = parity.accepted_corner_sets(rf["c2"], rf["valid"])
    n_match, only_port, only_ref = parity.match_sets(mine, ref)
    fstage = {
        "valid_equal": bool((valid_np == rf["valid"]).all()),
        "status_equal": bool((res.status.cpu().numpy() == rf["status"]).all()),
        "valid": int(valid_np.sum()),
        "screens": int((res.status.cpu().numpy() & 1).sum()),
        "c2_max_diff": float(np.abs(c2_np - rf["c2"])[both].max())
        if both.any() else 0.0,
        "value_max_diff": float(np.abs(res.value.cpu().numpy()[both]
                                       - rf["value"][both]).max())
        if both.any() else 0.0,
        "corner_sets": len(mine), "corner_sets_ref": len(ref),
        "matched": n_match, "port_only": only_port, "ref_only": only_ref}
    phase(f"phase 4 rect_frame vs fixture: {json.dumps(fstage)}")
    if not (fstage["valid_equal"] and fstage["status_equal"]
            and only_port == 0 and only_ref == 0 and n_match == len(ref)):
        fail("rect_frame differs from the JAX fixture")
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
    weak_t, strong_t = weak_strong_labels(fe_t.edge_bin, fe_t.edge_thin, cfg)
    despeck_t = region_smoothing(fe_t.packed0, weak_t, fe_t.edge_thin,
                                 cfg)[1]
    seg_t = region_merge(despeck_t, strong_t, cfg)[1]
    boundary_t, bcomp_t = boundary_labels(seg_t, cfg)
    arena_t, lsid_t, comp_t = polyline.polyline_execute(
        (strong_t > 0).to(torch.int32), cfg.minerror_rect, cfg.size_thre_rect,
        cfg.ls_cap_for(W, H), cfg, return_comp=True)
    for name, fn, reps in (
            ("weak_strong_labels", lambda: weak_strong_labels(
                fe_t.edge_bin, fe_t.edge_thin, cfg), 20),
            ("region_smoothing", lambda: region_smoothing(
                fe_t.packed0, weak_t, fe_t.edge_thin, cfg), 20),
            ("edge_frontend -> weak_strong_labels -> region_smoothing",
             region_path, 20),
            ("region_merge", lambda: region_merge(despeck_t, strong_t, cfg),
             20),
            ("boundary_labels", lambda: boundary_labels(seg_t, cfg), 20),
            ("polyline_execute (strong edges)", lambda: polyline.polyline_execute(
                (strong_t > 0).to(torch.int32), cfg.minerror_rect,
                cfg.size_thre_rect, cfg.ls_cap_for(W, H), cfg,
                return_comp=True), 20),
            ("hypotheses", lambda: hypotheses(
                arena_t, lsid_t, boundary_t, W, H, cfg, comp_t, bcomp_t), 20),
            ("rect_hypotheses (frame -> hypotheses)",
             lambda: rect_hypotheses(bgr, cfg), 20)):
        phase(f"phase 5 {name} 720p: median {cuda_ms(torch, fn, reps):.3f} "
              f"ms (CUDA events, {reps} runs)")
    corners_t, _ = hopper_hyp.reduce_groups(hyp.segs, hyp.valid, hv)
    for name, fn in (
            ("quad reduction (hyp)", lambda: hopper_hyp.reduce_groups(
                hyp.segs, hyp.valid, hv)),
            ("pose", lambda: hopper_pose.pose_estimate(corners_t,
                                                       *pose_args)),
            ("rect_geometry (hypotheses -> RectResult)",
             lambda: rect_geometry(hyp.segs, hyp.valid, hyp.status, W, H,
                                   TAN_AOV, cfg))):
        phase(f"phase 5 {name} 720p: median {cuda_ms(torch, fn, 20):.3f} ms "
              f"(CUDA events, 20 runs)")
    for _ in range(3):
        rect_frame(bgr, TAN_AOV, cfg)
    torch.cuda.synchronize()
    times, walls = [], []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        start.record()
        rect_frame(bgr, TAN_AOV, cfg)
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - w0) * 1e3)
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    phase(f"phase 5 rect_frame 720p DEFAULT_CONFIG: median {med:.3f} ms "
          f"(CUDA events, 20 frames, min {min(times):.3f}, max "
          f"{max(times):.3f}); host wall median "
          f"{statistics.median(walls):.3f} ms; {1000.0 / med:.2f} frames/s; "
          f"card {card}")
    phase(f"phase 5 peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; card {card}")

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
     of distinct_bids.cu, edge_front.cu, merge_mask.cu, scan.cu,
     thin.cu, despeckle2.cu, morph.cu, quant_despeckle.cu, mkpl.cu,
     links_ccl.cu, ccl.cu and hyp.cu; K2 in both modes; edge_front's
     1/sqrt: __frsqrt_rn against the float64 form on every float32 above
     1e-10 (a failure if any differs);
     distinct_bids' count of pixels whose window holds an id; and, where
     build/parent/ holds a git archive of the parent commit, the
     parent's distinct_bids and edge_front held bit-equal to these and
     timed in turns with them;
  4. the main paths, each with every launch count set to 0 just before it
     and read just after, and the kernel library's own count of kernels
     held equal to the kernels its wrappers launched (7 for poly_frame,
     32 for rect_frame):
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
     frame rate (CUDA-event medians);
  6. the photograph corpus (docs/photo_corpus, 25 photos at 448x336):
     each calibrated on itself (runtime/calibrate.calibrate, a temporary
     plan), plan_fits, then rect_frame at its calibrated config, held
     against tests/data/photo_corpus.npz (the JAX package's calibrate
     and rect path): densities and kept capacities equal, the accepted
     corner sets matched one to one within 2 px with none on one side
     only; per photo the first stage whose digest differs, and
     calibrate's and rect_frame's CUDA-event times; the first photo's
     calibrate and rect_frame driven with the launch counts (32 kernels);
     on the photo with the most boundary components (max_groups above
     192), distinct_bids, mkpl and hyp held bit-equal to their plain
     versions at its calibrated capacities.  Then the video detectors:
     VideoRectDetector and VideoPolyDetector over 30 frames of
     bench.synth_frame(720, 1280, seed 0..29), each poll bit-identical to
     a direct rect_frame / poly_frame on the same frame, the library's
     counter at 30 x 32 and 30 x 7 kernels, and the enqueue/poll loop's
     frame rate beside 30 sequential direct calls.  Then
     rect_stage_images of the 720p frame on the card against the CPU, and
     StageDumper writing its nine PNGs;
  7. EXTENDED_CONFIG (bridge_gap2, strength_rescue_rounds=3) and the other
     off-default capabilities: K3's bridge2 variant, both variants,
     bit-equal to its plain version on the 720p inputs and the staircase
     map of tests/data/extended.npz, one kernel a call, its device time
     in turns with bridge2 off and its nvcc -Xptxas -v lines (its own
     record on the kernels line); the 720p rect_frame and poly_frame
     under EXTENDED_CONFIG held against tests/data/extended.npz (valid and
     status equal, corners within 2 px, weak/strong maps and the arena
     equal), each driven with the launch counts (31 kernels for
     rect_frame: the staged strength filters have no seg_scan; 7 for
     poly_frame), a bit-identical rerun, and both frames' times in turns
     with DEFAULT_CONFIG's (default, extended, extended, default); the
     seed-66 shallow-slope scene of tests/test_accuracy_fixes.py, each
     quad within 3 px of its ground truth; the 25 photographs calibrated
     from EXTENDED_CONFIG against tests/data/photo_corpus_ext.npz, and
     how many more corner sets than DEFAULT_CONFIG's they give; the exact
     LUT colour path, the front end at color_exact and blur radius 5, the
     blur at radii 0-40, the recursive blur, rescue_filtered,
     color_reassign and rand_field on the card against the CPU;
  8. the width-tiled path (dist/tile.py), every tile on the one card
     (TileGroup([cuda:0] * N)): the x0/w_total offset forms of K3 (rect,
     poly_branch, bridge2), merge_mask, blblur and the links CCL, and K2
     at a frame column, bit-equal to their plain versions at the 720p
     tile shapes of the left, an interior and the right tile of four and
     at an odd x0, each call's kernels held by the library's counter,
     each form's device time in turns with the kernel on the whole frame
     (their own records on the kernels line, launches from the run
     below); the slot-range form of mkpl (rd_mkpl_setup, rd_mkpl_keys,
     rd_mkpl_splits) at the 720p strong-edge arena over 1 to 4 ranges,
     bit-equal to one rd_mkpl launch and to the plain form by slot range,
     on that arena and on one that overflows, each call's kernels held
     exactly, each range count's device time in turns with the one launch
     and each entry point's at 4 ranges (their own records on the kernels
     line); rect_step_tiled over 4 tiles driven with the launch counts,
     held exactly (tiled_kernels: 25 a tile, 4 on the first, and the
     slot-range mkpl's 2 + 2 x 15 a tile), with the plain subdivision
     barred from the card (every offset form launched, seg_scan and
     despeckle2 not); its RectResult bit-equal to rect_frame's at 720p
     over 2 and 4 tiles and at 3840x2160 over 4 (calibrated on itself,
     with the capacities' overflow flags: a difference below them fails),
     each call's kernels held exactly, and the tiled and single frame
     medians in turns; poly_step_tiled at 720p over 4 tiles equal to
     poly_frame, its kernels held exactly; over distinct cards where the
     machine has more than one (else a line says so);
     TiledVideoRectDetector over 6 720p frames, each poll equal to direct
     rect_step_tiled and rect_frame calls;
  9. the stream axis, every mesh entry on the one card: the batch forms of
     K1 and K2 (one launch for b frames, grid z = frame) at b = 4 on the
     720p frames of seeds 0-3, bit-equal to four b = 1 calls and within
     2e-4 of the plain versions, and the batch forms of the rect tail's
     dense kernels (K3 rect, blblur, quant_despeckle, merge_mask, the
     links CCL, despeckle2) on those frames' own maps, bit-equal to four
     b = 1 calls and to their plain versions; device ms in turns with the
     four single calls (their own records on the kernels line);
     rect_frames and poly_frames at B = 4 driven with the launch counts
     (68 = 32 B - 20 (B - 1) and 22 = 7 B - 2 (B - 1) kernels), every
     frame bit-equal to its per-frame call, frames/s in turns with
     per-frame calls; rect_frames_sharded over a 4 x 1 mesh on 8 frames
     driven with its count (176 = 4 rows x 44), it and
     poly_frames_sharded bit-equal to per-frame calls; the StreamSupervisor: 8
     streams over 4 entries with entry 2 failing after its first frame
     (quarantined, its streams re-placed, every collected frame equal to
     rect_frame) and the default worker loop's frames/s over 2 streams
     beside direct calls; `python -m rectdetect_tpu_torch.dist.multihost_sim
     2 1 720x1280 cuda` (two ranks on the card over gloo, both parity
     lines, its own time limit); dryrun_multichip over 2 x 2 entries;
 10. the native host runtime (runtime/native.py, no kernel): the host
     libraries built from nothing with g++ (-O3 -march=native) into a
     directory of their own, timed, and the `pkg-config --exists
     opencv4` probe, which decides whether librectrt_video.so (the C++
     frame pump) builds and so FramePump's backend ("cv2" where the
     machine has only the cv2 wheel); the library's plan forms against
     the plain ones on phase 6's plan and on a synthetic one; the host
     packed Lab of all 2^24 colours against core/color.py's packing on
     the card (each field within 1, at most 0.1% of colours differing;
     one thread bit-equal to all); at 720p the host's ms (median of 10)
     against the card's bgr_to_labf+pack_lab (CUDA events), beside the
     card's name and power limit and the host's CPU and cores; the frame
     pump on a lossless .avi (FFV1, else HFYU or png) of 6 random frames,
     every frame equal to the source in order, and in realtime mode a
     strictly increasing run ending with the last frame.  The H100's
     machine (PR 19: NVIDIA H100 80GB HBM3, 700.00 W) has only the cv2
     wheel, so it builds librectrt_core.so alone (2.24 s) and runs the
     cv2 pump; 2336 colours differ there, host 11.036 ms against the
     card's 1.6585 ms at 720p.
The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
RECT_FRAME_KERNELS = 32
# of those, the kernels rect_frames launches once for its whole stack: K1,
# K2, K3 (rect), blblur's 11, quant_despeckle, merge_mask, the links CCL's
# 3 and despeckle2
RECT_STACK_KERNELS = 20
# frames of the video phase
VIDEO_FRAMES = 30
# frames a turn of phase 7's frame times (default, extended, extended,
# default)
EXT_TURN_FRAMES = 10
# phase 8's large frame (height, width), over 4 tiles, and the frames a
# turn of its frame times
TILED_BIG = (2160, 3840)
TILED_TURN_FRAMES = 5
# the links CCL's and K4's kernels a call (tile, seam and flatten)
LINKS_KERNELS = 3
K4_KERNELS = 3
# the slot-range form of mkpl: its entry points, and the bytes a round
# moves per live position and per segment (csrc/mkpl.cu's header)
MKPL_ENTRIES = ("rd_mkpl_setup", "rd_mkpl_keys", "rd_mkpl_splits")
MKPL_BYTES_PER_LIVE = 40
MKPL_BYTES_PER_SEGMENT = 60
# phase 9's batch (frames per rect_frames call; the sharded runs take
# twice as many) and the multi-process simulation's time limit in seconds
STREAM_BATCH = 4
SIM_TIMEOUT = 300
# phase 10: the share of the 2^24 colours on which the host packing may
# differ from core/color.py's on the card (each field by at most 1), the
# lossless codecs tried in turn for the pump's file, its frames and the
# longest wait of a pump call
PACK_DIFFER_SHARE = 1e-3
LOSSLESS_CODECS = ("FFV1", "HFYU", "png ")
PUMP_FRAMES = 6
PUMP_TIMEOUT_MS = 5000


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
    lib = ctypes.CDLL(out)
    lib.frame_counts = {name: takes_frame_count(src, name) for name in names}
    return lib


def takes_frame_count(src, name) -> bool:
    """Whether csrc file `name` of the directory `src` has the batch form's
    entry point (a frame count after h, w: edge_front and thin since the
    stream axis; morph, blblur, quant_despeckle, merge_mask, links_ccl
    and despeckle2 since the batched rect tail; not before)."""
    with open(os.path.join(src, f"{name}.cu")) as f:
        text = f.read()
    return re.search(r'extern "C" int rd_\w+\([^)]*int h,\s*int w, int b,',
                     text) is not None


def stream_of(torch):
    return torch.cuda.current_stream().cuda_stream


# every float32 x from lo on, count of them: __frsqrt_rn(x), which
# csrc/edge_front.cu's unit_rsqrt takes, against the float64 1/sqrt
# rounded once to float32, which the plain version (gradient._rsqrt) and
# the parent kernel take; counts the x where the two differ and keeps the
# smallest
RSQRT_CHECK = r"""
#include <cuda_runtime.h>

__global__ void rsqrt_check(unsigned lo, unsigned long long count,
                            unsigned long long* bad, unsigned* first) {
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < count; i += step) {
    const unsigned u = lo + (unsigned)i;
    const float x = __uint_as_float(u);
    const float ref = (float)(1.0 / sqrt((double)x));
    if (__float_as_uint(__frsqrt_rn(x)) != __float_as_uint(ref)) {
      atomicAdd(bad, 1ull);
      atomicMin(first, u);
    }
  }
}

extern "C" int rd_rsqrt_check(unsigned lo, unsigned long long count,
                              void* bad, void* first, void* stream) {
  rsqrt_check<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      lo, count, (unsigned long long*)bad, (unsigned*)first);
  return (int)cudaGetLastError();
}
"""


def rsqrt_mismatches(torch, build_mod):
    """(floats checked, floats where __frsqrt_rn differs from the float64
    form, the smallest such float or None): every float32 above 1e-10f,
    +inf included, the inputs edge_front's `big` branch can meet."""
    import ctypes
    out_dir = os.path.join(ROOT, "build", "rsqrt_check")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "rsqrt_check.cu")
    with open(src, "w") as f:
        f.write(RSQRT_CHECK)
    so = os.path.join(out_dir, "librsqrt_check.so")
    res = subprocess.run([build_mod._nvcc(), *build_mod.COMPILE_FLAGS,
                          "-shared", "-o", so, src], capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        fail(f"the 1/sqrt check does not build: {res.stderr}")
    lib = ctypes.CDLL(so)
    P = ctypes.c_void_p
    lib.rd_rsqrt_check.argtypes = [ctypes.c_uint, ctypes.c_ulonglong, P, P,
                                   P]
    lib.rd_rsqrt_check.restype = ctypes.c_int
    lo = int(np.float32(1e-10).view(np.uint32)) + 1
    count = 0x7F800000 - lo + 1
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    first = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    if lib.rd_rsqrt_check(lo, count, bad.data_ptr(), first.data_ptr(),
                          stream_of(torch)):
        fail("the 1/sqrt check did not launch")
    n_bad = int(bad.item())
    x = None
    if n_bad:
        x = float(np.uint32(first.item() & 0xFFFFFFFF).view(np.float32))
    return count, n_bad, x


def bind_thin(torch, lib):
    """thin_fn(em, vec, mode) through lib's rd_thin (one frame)."""
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    frames = getattr(lib, "frame_counts", {}).get("thin", True)
    lib.rd_thin.argtypes = [P, P, P, I, I, *([I] if frames else []), I, F,
                            I, P]
    lib.rd_thin.restype = ctypes.c_int

    def thin_fn(em, vec, mode):
        h, w = em.shape
        out = torch.empty_like(em)
        err = lib.rd_thin(em.data_ptr(), vec.data_ptr(), out.data_ptr(), h,
                          w, *([1] if frames else []), int(mode == "cubic"),
                          0.99, 0, stream_of(torch))
        if err:
            fail(f"rd_thin of {lib._name} did not launch (error {err})")
        return out

    return thin_fn


def bind_despeckle2(torch, lib):
    """despeckle2_fn(label, thre) through lib's rd_despeckle2 (one
    frame)."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    frames = getattr(lib, "frame_counts", {}).get("despeckle2", True)
    lib.rd_despeckle2.argtypes = [P, P, P, I, I, *([I] if frames else []),
                                  I, P]
    lib.rd_despeckle2.restype = ctypes.c_int

    def despeckle2_fn(label, thre):
        h, w = label.shape
        out = torch.empty_like(label)
        sizes = torch.empty((h * w,), dtype=torch.int32, device=label.device)
        err = lib.rd_despeckle2(label.data_ptr(), sizes.data_ptr(),
                                out.data_ptr(), h, w,
                                *([1] if frames else []), thre,
                                stream_of(torch))
        if err:
            fail(f"rd_despeckle2 of {lib._name} did not launch (error "
                 f"{err})")
        return out

    return despeckle2_fn


def bind_merge_mask(torch, lib):
    """merge_mask_fn(strong) through lib's rd_merge_mask (one frame)."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    frames = getattr(lib, "frame_counts", {}).get("merge_mask", True)
    lib.rd_merge_mask.argtypes = [P, P, I, I, *([I] if frames else []), I,
                                  I, P]
    lib.rd_merge_mask.restype = ctypes.c_int

    def merge_mask_fn(strong):
        h, w = strong.shape
        out = torch.empty_like(strong)
        err = lib.rd_merge_mask(strong.data_ptr(), out.data_ptr(), h, w,
                                *([1] if frames else []), 0, w,
                                stream_of(torch))
        if err:
            fail(f"rd_merge_mask of {lib._name} did not launch (error {err})")
        return out

    return merge_mask_fn


def bind_seg_total(torch, lib):
    """seg_total_fn(key, val, cap) through lib's rd_seg_total."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rd_seg_total.argtypes = [P, P, P, P, I, I, P]
    lib.rd_seg_total.restype = ctypes.c_int
    lib.rd_seg_total_scratch_words.argtypes = [I]
    lib.rd_seg_total_scratch_words.restype = ctypes.c_int

    def seg_total_fn(key, val, cap):
        n = key.shape[0]
        out = torch.empty_like(val)
        scratch = torch.empty((lib.rd_seg_total_scratch_words(n),),
                              dtype=torch.int32, device=key.device)
        err = lib.rd_seg_total(key.data_ptr(), val.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), n, cap, stream_of(torch))
        if err:
            fail(f"rd_seg_total of {lib._name} did not launch (error {err})")
        return out

    return seg_total_fn


def bind_distinct_bids(torch, lib):
    """distinct_bids_fn(boundary) -> (4, H, W) slots through lib's
    rd_distinct_bids."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rd_distinct_bids.argtypes = [P, P, I, I, P]
    lib.rd_distinct_bids.restype = ctypes.c_int

    def distinct_bids_fn(boundary):
        h, w = boundary.shape
        out = torch.empty((4, h, w), dtype=torch.int32,
                          device=boundary.device)
        err = lib.rd_distinct_bids(boundary.data_ptr(), out.data_ptr(), h, w,
                                   stream_of(torch))
        if err:
            fail(f"rd_distinct_bids of {lib._name} did not launch (error "
                 f"{err})")
        return out

    return distinct_bids_fn


def bind_edge_front(torch, lib):
    """edge_front_fn(labb) -> (em, vec) through lib's rd_edge_front (one
    frame)."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    frames = getattr(lib, "frame_counts", {}).get("edge_front", True)
    lib.rd_edge_front.argtypes = [P, P, P, I, I, *([I] if frames else []), P]
    lib.rd_edge_front.restype = ctypes.c_int

    def edge_front_fn(labb):
        h, w = labb.shape[:2]
        em = torch.empty((h, w), dtype=torch.float32, device=labb.device)
        vec = torch.empty((h, w, 2), dtype=torch.float32, device=labb.device)
        err = lib.rd_edge_front(labb.data_ptr(), em.data_ptr(),
                                vec.data_ptr(), h, w,
                                *([1] if frames else []), stream_of(torch))
        if err:
            fail(f"rd_edge_front of {lib._name} did not launch (error {err})")
        return em, vec

    return edge_front_fn


def parent_kernels(torch, build_mod):
    """The distinct_bids and edge_front kernels of the parent commit, for
    timing in turns with this tree's: built from build/parent/ (a git
    archive of the parent, unpacked there by hand; absent from a plain
    checkout, and then None) into one library with its own launch
    counter.  Returns {"distinct_bids": distinct_bids_fn(boundary),
    "edge_front": edge_front_fn(labb)}."""
    src = os.path.join(ROOT, "build", "parent", "rectdetect_tpu_torch",
                       "csrc")
    if not os.path.isdir(src):
        return None
    lib = build_kernels(build_mod, src, os.path.join(ROOT, "build", "parent"),
                        ("distinct_bids", "edge_front"))
    return {"distinct_bids": bind_distinct_bids(torch, lib),
            "edge_front": bind_edge_front(torch, lib)}


def cuda_timed(torch, fn):
    """(fn()'s result, its CUDA-event time in ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def photo_corpus(torch, dev, card, cfg0, drive, counters,
                 fixture="photo_corpus.npz", label="phase 6",
                 kernels=RECT_FRAME_KERNELS, absent=(), dense_kernels=True,
                 plan_out=None):
    """Phase 6, the photographs (phase 7 from EXTENDED_CONFIG, against
    photo_corpus_ext.npz): each photo of docs/photo_corpus calibrated on
    itself from cfg0 (a temporary plan), plan_fits, then rect_frame at
    the calibrated config, held against tests/data/<fixture> (the JAX
    package's calibrate and rect path): kept capacities and densities
    equal, the accepted corner sets matched one to one within 2 px, none
    on one side only; the first photo's calibrate and rect_frame driven
    with the launch counts (`kernels` a rect_frame, the kernels `absent`
    launched by neither).  With dense_kernels,
    on the photo with the most boundary components, distinct_bids, mkpl
    and hyp are held bit-equal to their plain versions at its calibrated
    capacities.  With plan_out, the plan the photos wrote is copied
    there.  Returns the rows, one a photo."""
    import shutil
    import tempfile

    from rectdetect_tpu_torch import parity
    from rectdetect_tpu_torch.apps.common import TAN_AOV, load_image_bgr
    from rectdetect_tpu_torch.core import color
    from rectdetect_tpu_torch.geometry import quad
    from rectdetect_tpu_torch.ops import (hopper_bids, hopper_hyp,
                                          hopper_mkpl, mkpl, polyline)
    from rectdetect_tpu_torch.pipeline.rect import (rect_frame,
                                                    rect_hypotheses,
                                                    rect_stage_images)
    from rectdetect_tpu_torch.runtime import calibrate as cal

    px = np.load(os.path.join(ROOT, "tests", "data", fixture))
    names = [str(n) for n in px["names"]]
    dnames = [str(k) for k in px["density_names"]]
    kept = [str(k) for k in px["kept"]]
    if kept != list(cal.KEPT) or len(names) != 25:
        fail(f"photo fixture: kept {kept}, {len(names)} photos")
    stage_names = [str(k) for k in px["stage_names"]]
    misses, dense_photo, rows = [], None, []
    with tempfile.TemporaryDirectory() as td:
        plan = os.path.join(td, "plan_torch.txt")
        for i, name in enumerate(names):
            p = name[:-4] + "/"
            bgr = torch.from_numpy(load_image_bgr(
                os.path.join(ROOT, "docs", "photo_corpus", name))).to(dev)
            ih, iw = bgr.shape[:2]
            dens = cal._densities([bgr], cfg0)
            if i == 0:
                cfg = drive(f"calibrate (photo, {label})",
                            [k for k in counters
                             if k not in ("distinct_bids", "hyp", "pose",
                                          *absent)],
                            lambda: cal.calibrate([bgr], cfg0, plan))
            cfg, t_cal = cuda_timed(torch, lambda: cal.calibrate(
                [bgr], cfg0, plan))
            fits = cal.plan_fits(cfg, bgr)
            caps = [getattr(cfg, k) for k in kept]
            if i == 0:
                drive(f"rect_frame (photo, calibrated, {label})",
                      [k for k in counters if k not in absent],
                      lambda: rect_frame(bgr, TAN_AOV, cfg), kernels)
            rect_frame(bgr, TAN_AOV, cfg)
            torch.cuda.synchronize()
            res, t_rf = cuda_timed(torch, lambda: rect_frame(bgr, TAN_AOV,
                                                             cfg))
            ok, match = fixture_rows_match(parity, res, px, p)
            st = rect_stage_images(bgr, cfg)
            got_stages = {
                "packed0": color.pack_lab(color.bgr_to_labf(bgr)),
                "edge_bin": (st["edge_thin"] > 0).to(torch.int32),
                "weak": st["weak_labels"], "strong": st["strong_labels"],
                "mask": st["merge_mask"], "seg": st["regions"],
                "boundary": st["boundary"], "lsid": st["lsid"]}
            differ = [k for k, h in zip(stage_names, px[p + "stage_sha256"])
                      if digest(got_stages[k]) != str(h)]
            ref_bits = np.unpackbits(px[p + "edge_bin_bits"])[
                :ih * iw].reshape(ih, iw)
            n_edge = int((got_stages["edge_bin"].cpu().numpy()
                          != ref_bits).sum())
            row = {"photo": name, "capacities": dict(zip(kept, caps)),
                   "capacities_equal": caps == px[p + "capacities"].tolist(),
                   "densities_differ": {
                       k: [dens[k], v] for k, v in
                       zip(dnames, px[p + "densities"].tolist())
                       if dens[k] != v},
                   "groups": dens["groups"], "plan_fits": fits,
                   **{k: match[k] for k in (
                       "valid_equal", "status_equal", "corner_sets",
                       "corner_sets_ref", "matched", "port_only",
                       "ref_only")},
                   "first_stage_differing": differ[0] if differ else None,
                   "stages_differing": differ,
                   "edge_bin_pixels_differing": n_edge,
                   "calibrate_ms": t_cal, "rect_frame_ms": t_rf}
            rows.append(row)
            phase(f"{label} photo {json.dumps(row)}; card {card}")
            if not (row["capacities_equal"] and ok):
                misses.append(name)
            if cfg.max_groups > 192 and (
                    dense_photo is None or dens["groups"] > dense_photo[2]):
                dense_photo = (name, bgr, dens["groups"], cfg)
        if plan_out is not None:
            shutil.copy(plan, plan_out)
    phase(f"{label} photos: {sum(r['matched'] for r in rows)} corner sets "
          f"matched of {sum(r['corner_sets_ref'] for r in rows)}; "
          f"calibrate median {statistics.median(r['calibrate_ms'] for r in rows):.3f} ms, "
          f"rect_frame median {statistics.median(r['rect_frame_ms'] for r in rows):.3f} ms "
          f"(CUDA events, 448x336, one call each); card {card}")
    if misses:
        fail(f"photos {misses} differ from the JAX fixture {fixture}")
    if not dense_kernels:
        return rows
    if dense_photo is None:
        fail("no photo calibrated max_groups above 192")

    # the kernels at the densest photo's calibrated capacities
    name, bgr, groups, cfg = dense_photo
    ih, iw = bgr.shape[:2]
    hyp = rect_hypotheses(bgr, cfg)
    bids = hopper_bids.distinct_bids(hyp.boundary)
    bids_p = hopper_bids.distinct_bids_plain(hyp.boundary)
    n_bids = sum(int((a != b).sum()) for a, b in zip(bids, bids_p))
    st = rect_stage_images(bgr, cfg)
    strong = (st["strong_labels"] > 0).to(torch.int32)
    cap = cfg.ls_cap_for(iw, ih)
    arena0, dense, number, comp = polyline.mkpl_inputs(
        strong, cfg.size_thre_rect, cap, cfg)
    args = (dense, number, cfg.minerror_rect, cfg.mkpl_iters, comp)
    got = hopper_mkpl.mkpl_subdivide(arena0, *args)
    want = mkpl.mkpl_subdivide(arena0, *args)
    mk_equal = (all(torch.equal(getattr(got[0], f), getattr(want[0], f))
                    for f in got[0]._fields) and torch.equal(got[1], want[1]))
    hv = cfg.hull_max_vertices
    q = hopper_hyp.reduce_groups(hyp.segs, hyp.valid, hv)
    q_p = quad.reduce_groups(hyp.segs, hyp.valid, hv)
    hyp_equal = (torch.equal(q[1], q_p[1])
                 and torch.equal(q[0].isnan(), q_p[0].isnan())
                 and torch.equal(q[0].nan_to_num(), q_p[0].nan_to_num()))
    torch.cuda.synchronize()
    entry = {"photo": name, "groups": groups, "max_groups": cfg.max_groups,
             "G": int(hyp.segs.shape[0]),
             "groups_with_members": int(hyp.valid.any(1).sum()),
             "distinct_bids_values_differ": n_bids,
             "mkpl_arena_cap": cap, "mkpl_count": int(got[0].count),
             "mkpl_live_slots": int(comp.n), "mkpl_bit_equal": mk_equal,
             "hyp_ok_groups": int(q[1].sum()), "hyp_bit_equal": hyp_equal}
    phase(f"phase 6 kernels at a calibrated G: {json.dumps(entry)}")
    if n_bids or not mk_equal or not hyp_equal:
        fail(f"distinct_bids, mkpl or hyp at {name}'s calibrated "
             f"capacities differ from the plain versions")
    return rows


def video(torch, dev, card, cfg, drive, counters):
    """Phase 6, the video detectors: VideoRectDetector and VideoPolyDetector
    over VIDEO_FRAMES 720p frames of bench.synth_frame (seeds 0..29), each
    poll's result bit-identical to a direct call on the same frame, the
    library's counter at the kernels per frame times the frames, and the
    enqueue/poll loop's frame rate beside sequential direct calls."""
    from bench import synth_frame
    from rectdetect_tpu_torch.apps.common import TAN_AOV
    from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame
    from rectdetect_tpu_torch.pipeline.rect import live_rects, rect_frame
    from rectdetect_tpu_torch.pipeline.video import (VideoPolyDetector,
                                                     VideoRectDetector)

    frames = [synth_frame(H, W, seed=s) for s in range(VIDEO_FRAMES)]
    paths = (
        ("VideoRectDetector", RECT_FRAME_KERNELS,
         lambda: VideoRectDetector(TAN_AOV, cfg, device=dev),
         lambda f: live_rects(rect_frame(f, TAN_AOV, cfg)), list(counters)),
        ("VideoPolyDetector", POLY_FRAME_KERNELS,
         lambda: VideoPolyDetector(cfg, device=dev),
         lambda f: live_segments(poly_frame(f, cfg, 1.0, 10, 2000)[0]),
         ["edge_front", "thinthres", "strings_chain", "label_components",
          "mkpl"]))
    for name, per_frame, make, direct, names in paths:
        def run_direct():
            return [direct(torch.from_numpy(f).to(dev)) for f in frames]

        def run_loop(det):
            out, t_enq, t_poll = [], 0.0, 0.0
            det.enqueue(frames[0])
            for f in frames[1:] + [None]:
                t0 = time.perf_counter()
                if f is not None:
                    det.enqueue(f)
                t1 = time.perf_counter()
                out.append(det.poll())
                t_enq += t1 - t0
                t_poll += time.perf_counter() - t1
            return out, t_enq, t_poll

        det = make()
        run_loop(det)                            # warm-up
        run_direct()
        torch.cuda.synchronize()
        n = VIDEO_FRAMES
        rates = {"enqueue/poll loop": [], "direct calls": []}
        runs = []
        # in turns: direct, loop (driven with the launch counts), loop,
        # direct
        for turn in range(4):
            t0 = time.perf_counter()
            if turn in (0, 3):
                runs.append(run_direct())
                key = "direct calls"
            elif turn == 1:
                runs.append(drive(f"{name} ({n} frames)", names,
                                  lambda: run_loop(det),
                                  per_frame * n))
                key = "enqueue/poll loop"
            else:
                runs.append(run_loop(det))
                key = "enqueue/poll loop"
            rates[key].append(n / (time.perf_counter() - t0))
        want = runs[0]
        same = all(len(r) == len(want) and all(
            same_results(a, b) for a, b in zip(r, want))
            for r in (runs[1][0], runs[2][0], runs[3]))
        t_enq, t_poll = runs[1][1], runs[1][2]
        phase(f"phase 6 {name}: {n} polls bit-identical to direct calls: "
              f"{same}; host frames/s in turns (direct, loop, loop, "
              f"direct): {json.dumps(rates)}; in the driven loop enqueue "
              f"{t_enq * 1e3 / n:.2f} ms a frame, poll "
              f"{t_poll * 1e3 / n:.2f} ms; card {card}")
        if not same:
            fail(f"{name}: a poll differs from the direct call")


def same_results(a, b) -> bool:
    """Two host lists of rectangles or segments, equal bit for bit."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            return False
        for k in x:
            if not np.array_equal(np.asarray(x[k]), np.asarray(y[k])):
                return False
    return True


def stage_images(torch, bgr, cfg):
    """Phase 6, the stage images: rect_stage_images of the 720p frame on the
    card against the same call on the CPU (integer maps equal, edge_thin
    within FLOAT_ATOL with edge_thin > 0 equal), and StageDumper writing
    all nine as PNGs."""
    import tempfile

    from rectdetect_tpu_torch.pipeline.rect import (STAGE_KINDS,
                                                    rect_stage_images)
    from rectdetect_tpu_torch.utils.debug import StageDumper

    card_maps = rect_stage_images(bgr, cfg)
    t0 = time.perf_counter()
    cpu_maps = rect_stage_images(bgr.cpu(), cfg)
    t_cpu = time.perf_counter() - t0
    diff = {}
    for k, v in card_maps.items():
        a, b = v.cpu(), cpu_maps[k]
        if k == "edge_thin":
            diff[k] = [float((a - b).abs().max()),
                       int(((a > 0) != (b > 0)).sum())]
        else:
            diff[k] = int((a != b).sum())
    with tempfile.TemporaryDirectory() as td:
        dumper = StageDumper(td)
        for k, v in card_maps.items():
            dumper.add(k, STAGE_KINDS[k], v)
        written = [os.path.basename(p) for p in dumper.flush()
                   if os.path.getsize(p) > 0]
    phase(f"phase 6 rect_stage_images {bgr.shape[1]}x{bgr.shape[0]}, card "
          f"against CPU ({t_cpu:.1f} "
          f"s on the host): {json.dumps(diff)}; StageDumper wrote "
          f"{written}")
    if (any(v for k, v in diff.items() if k != "edge_thin")
            or diff["edge_thin"][0] > FLOAT_ATOL or diff["edge_thin"][1]
            or len(written) != len(STAGE_KINDS)):
        fail("rect_stage_images on the card differs from the CPU, or the "
             "dump is incomplete")


# kernels per 720p EXTENDED_CONFIG rect_frame: the staged strength filters
# (rescue rounds) have no kernel, so seg_scan (#10) does not run
RECT_FRAME_KERNELS_EXT = RECT_FRAME_KERNELS - 1
# the seed-66 scene's quads against their ground truth
# (tests/test_accuracy_fixes.py::test_shallow_slope_quad_detected_end_to_end)
GT_TOL = 3.0


def fixture_rows_match(parity, res, fx, p):
    """rect_frame's RectResult against a fixture's valid rows under key
    prefix p: valid and status equal, the accepted corner sets matched one
    to one within 2 px.  Returns (ok, the record)."""
    n = int(fx[p + "n_slots"])
    rows = fx[p + "rows"]
    valid_ref = np.zeros(n, bool)
    valid_ref[rows] = True
    c2_ref = np.zeros((n, 4, 2), np.float32)
    c2_ref[rows] = fx[p + "c2"]
    valid = res.valid.cpu().numpy()
    mine = parity.accepted_corner_sets(res.c2.cpu().numpy(), valid)
    ref = parity.accepted_corner_sets(c2_ref, valid_ref)
    matched, port_only, ref_only = parity.match_sets(mine, ref, 2.0)
    rec = {"valid_equal": valid.shape == valid_ref.shape
           and bool((valid == valid_ref).all()),
           "status_equal": valid.shape == valid_ref.shape
           and bool((res.status.cpu().numpy()[rows] == fx[p + "status"])
                    .all()),
           "valid": int(valid.sum()), "corner_sets": len(mine),
           "corner_sets_ref": len(ref), "matched": matched,
           "port_only": port_only, "ref_only": ref_only}
    return (rec["valid_equal"] and rec["status_equal"] and port_only == 0
            and ref_only == 0 and matched == len(ref)), rec


def arena_matches(arena, lsid, fx, p):
    """poly_frame's arena and lsid against a fixture's live segments under
    key prefix p, bit for bit."""
    a = {k: v.cpu().numpy() for k, v in arena._asdict().items()}
    live = np.nonzero(a["polyid"][:int(a["count"]) + 1])[0]
    ok = (digest(lsid) == str(fx[p + "lsid_sha256"])
          and int(a["count"]) == int(fx[p + "count"])
          and np.array_equal(live, fx[p + "seg_id"])
          and all(np.array_equal(a[f][live], fx[p + f]) for f in (
              "start_index", "end_index", "left_ptr", "right_ptr",
              "start_count", "end_count", "polyid", "npix", "level", "sx",
              "sy", "ex", "ey")))
    return ok, {"count": int(a["count"]), "live_segments": len(live),
                "live_segments_ref": len(fx[p + "seg_id"])}


def extended(torch, dev, card, bgr, k3_inputs, drive, counters, record,
             records, rows_default):
    """Phase 7, EXTENDED_CONFIG and the other off-default capabilities:
    K3's bridge2 variant against its plain version (720p inputs and the
    staircase map), timed in turns with the plain variant; the 720p
    EXTENDED_CONFIG rect_frame and poly_frame against
    tests/data/extended.npz, with their launch counts, a bit-identical
    rerun and their times in turns with DEFAULT_CONFIG's; the seed-66
    scene; the photographs from EXTENDED_CONFIG against
    tests/data/photo_corpus_ext.npz; the exact colour path, the front end
    at color_exact and blur radius 5, the blur at radii 0-40 and the other
    plain off-default operations on the card against the CPU."""
    from rectdetect_tpu_torch import parity
    from rectdetect_tpu_torch.apps.common import TAN_AOV
    from rectdetect_tpu_torch.config import (DEFAULT_CONFIG, EXTENDED_CONFIG,
                                             PipelineConfig)
    from rectdetect_tpu_torch.core import color
    from rectdetect_tpu_torch.ops import (_build, blur, ccl, hopper_morph,
                                          rand, regions)
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.poly import poly_frame
    from rectdetect_tpu_torch.pipeline.rect import (rect_frame,
                                                    weak_strong_labels)

    ext = EXTENDED_CONFIG
    fx = np.load(os.path.join(ROOT, "tests", "data", "extended.npz"))
    meta = json.loads(str(fx["meta"]))
    h, w = bgr.shape[:2]

    # K3 bridge2: bit-equal to the plain version on the 720p inputs and the
    # staircase, one kernel a call; device ms in turns with bridge2 off
    stair = torch.from_numpy(fx["k3/staircase/in"]).to(dev)
    k3 = {"card": card, "ptxas": [
        line for line in ptxas_lines(_build.ptxas_log.get(
            "morph.cu", "not rebuilt in this run"))]}
    for name, pix in (*k3_inputs.items(), ("staircase", stair)):
        for variant in (("rect", "poly_branch") if name == "staircase"
                        else (name,)):
            got = hopper_morph.strings_chain(pix, variant, True)
            want = hopper_morph.strings_chain_plain(pix, variant, True)
            torch.cuda.synchronize()
            nd = int((got != want).sum())
            k3[f"{variant} on {name}: pixels differing"] = nd
            k3[f"{variant} on {name}: string pixels"] = [
                int(want.sum()), int(hopper_morph.strings_chain_plain(
                    pix, variant).sum())]
            if nd:
                fail(f"strings_chain[{variant}, bridge2] differs from the "
                     f"plain version on {name} at {nd} pixels")
    for variant, pix in k3_inputs.items():
        turns = []
        for b2 in (False, True, True, False):
            times, per_call = device_ms(
                torch, _build,
                lambda b2=b2: hopper_morph.strings_chain(pix, variant, b2),
                turns=1)
            if per_call != hopper_morph.KERNELS:
                fail(f"strings_chain[{variant}, bridge2={b2}]: {per_call} "
                     f"kernels per call")
            turns.append(times[0])
        k3[f"{variant} device ms (bridge2 off, on, on, off)"] = turns
        k3[f"{variant} bound_ms"] = 2 * pix.numel() * 4 / HBM_BYTES_PER_S * 1e3
    phase(f"phase 7 strings_chain bridge2: {json.dumps(k3)}")
    edge = k3_inputs["poly_branch"]
    # replaces _morph_kernel (pallas_morph.py:40) in its bridge2 branch
    record("strings_chain_bridge2", "morph.cu",
           "rectdetect_tpu/ops/pallas_morph.py:118", 0.0,
           lambda: hopper_morph.strings_chain(edge, "poly_branch", True),
           cuda_ms(torch, lambda: hopper_morph.strings_chain_plain(
               edge, "poly_branch", True), 5),
           2 * edge.numel() * 4, h * w, kernels=hopper_morph.KERNELS,
           label="phase 7")
    b2_record = records[-1]

    # the 720p EXTENDED_CONFIG frames against the fixture
    phase(f"phase 7 fixture: {json.dumps(meta['s720'])}")
    no_scan = [k for k in counters if k != "seg_scan"]
    res = drive("rect_frame (EXTENDED_CONFIG)", no_scan,
                lambda: rect_frame(bgr, TAN_AOV, ext), RECT_FRAME_KERNELS_EXT)
    if counters["seg_scan"].launches:
        fail("the EXTENDED_CONFIG rect_frame launched seg_scan")
    k3_launches = counters["strings_chain"].launches
    b2_record["launches"] = k3_launches
    res2 = rect_frame(bgr, TAN_AOV, ext)
    fe = edge_frontend(bgr, ext)
    weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin, ext)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(res, res2))
    ok, rec = fixture_rows_match(parity, res, fx, "s720/")
    rec.update(second_run_bit_identical=same,
               strings_chain_launches=k3_launches,
               weak_equal=digest(weak) == str(fx["s720/weak_sha256"]),
               strong_equal=digest(strong) == str(fx["s720/strong_sha256"]))
    for k, m in (("weak", weak), ("strong", strong)):
        ref = np.unpackbits(fx[f"s720/{k}_bits"])[:h * w].reshape(h, w)
        rec[f"{k}_gt0_mismatch"] = int(((m > 0).cpu().numpy()
                                        != ref.astype(bool)).sum())
    phase(f"phase 7 rect_frame 720p EXTENDED_CONFIG vs fixture: "
          f"{json.dumps(rec)}")
    if not (ok and same and k3_launches == 2):
        fail("the EXTENDED_CONFIG rect_frame differs from the JAX fixture, "
             "from its rerun, or did not run K3 twice")
    arena, lsid = drive("poly_frame (EXTENDED_CONFIG)",
                        ["edge_front", "thinthres", "strings_chain",
                         "label_components", "mkpl"],
                        lambda: poly_frame(bgr, ext), POLY_FRAME_KERNELS)
    arena2, lsid2 = poly_frame(bgr, ext)
    torch.cuda.synchronize()
    same = torch.equal(lsid, lsid2) and all(
        torch.equal(getattr(arena, f), getattr(arena2, f))
        for f in arena._fields)
    ok, rec = arena_matches(arena, lsid, fx, "s720/poly/")
    rec["second_run_bit_identical"] = same
    phase(f"phase 7 poly_frame 720p EXTENDED_CONFIG vs fixture: "
          f"{json.dumps(rec)}")
    if not (ok and same):
        fail("the EXTENDED_CONFIG poly_frame differs from the JAX fixture or "
             "from its rerun")

    # frame times in turns: default, extended, extended, default
    for c in (DEFAULT_CONFIG, ext):
        for _ in range(2):
            rect_frame(bgr, TAN_AOV, c)
            poly_frame(bgr, c)
    torch.cuda.synchronize()
    times = {f"{p} {n}": [] for p in ("rect_frame", "poly_frame")
             for n in ("DEFAULT_CONFIG", "EXTENDED_CONFIG")}
    for n, c in (("DEFAULT_CONFIG", DEFAULT_CONFIG), ("EXTENDED_CONFIG", ext),
                 ("EXTENDED_CONFIG", ext), ("DEFAULT_CONFIG", DEFAULT_CONFIG)):
        for _ in range(EXT_TURN_FRAMES):
            times[f"rect_frame {n}"].append(cuda_timed(
                torch, lambda: rect_frame(bgr, TAN_AOV, c))[1])
            times[f"poly_frame {n}"].append(cuda_timed(
                torch, lambda: poly_frame(bgr, c))[1])
    for k, ts in times.items():
        phase(f"phase 7 {k} 720p: median {statistics.median(ts):.3f} ms "
              f"(CUDA events, {len(ts)} frames in turns default, extended, "
              f"extended, default; min {min(ts):.3f}, max {max(ts):.3f}); "
              f"card {card}")

    # the seed-66 scene
    s66 = torch.from_numpy(fx["s66/bgr"]).to(dev)
    res = rect_frame(s66, TAN_AOV, ext)
    ok, rec = fixture_rows_match(parity, res, fx, "s66/")
    c2 = res.c2.cpu().numpy()[res.valid.cpu().numpy()]
    rec["best_err_per_quad"] = [min((parity.corner_err(c, g) for c in c2),
                                    default=None) for g in fx["s66/quads"]]
    arena, lsid = poly_frame(s66, ext)
    rec["poly_arena_equal"] = arena_matches(arena, lsid, fx, "s66/poly/")[0]
    phase(f"phase 7 seed-66 scene EXTENDED_CONFIG: {json.dumps(rec)}; the "
          f"JAX package: {json.dumps(meta['s66']['rect_frame'])}")
    if not (ok and rec["poly_arena_equal"] and all(
            e is not None and e <= GT_TOL for e in rec["best_err_per_quad"])):
        fail("the seed-66 scene differs from the JAX fixture or misses a quad")

    # the photographs from EXTENDED_CONFIG
    rows = photo_corpus(torch, dev, card, ext, drive, counters,
                        fixture="photo_corpus_ext.npz", label="phase 7",
                        kernels=RECT_FRAME_KERNELS_EXT, absent=("seg_scan",),
                        dense_kernels=False)
    n_ext = sum(r["corner_sets"] for r in rows)
    n_def = sum(r["corner_sets"] for r in rows_default)
    per = {r["photo"]: r["corner_sets"] - d["corner_sets"]
           for r, d in zip(rows, rows_default)
           if r["corner_sets"] != d["corner_sets"]}
    phase(f"phase 7 photos: EXTENDED_CONFIG {n_ext} corner sets, "
          f"DEFAULT_CONFIG {n_def}, {n_ext - n_def} more; by photo "
          f"{json.dumps(per)}")

    # the plain off-default operations on the card against the CPU
    host = bgr.cpu()
    out = {"packed_exact_equal": torch.equal(
        color.bgr_to_packed_exact(bgr).cpu(), color.bgr_to_packed_exact(host))}
    cfg5 = PipelineConfig(color_exact=True, blur_radius=5)
    fc, fh = edge_frontend(bgr, cfg5), edge_frontend(host, cfg5)
    out["front_end_color_exact_r5"] = {
        "packed0_equal": torch.equal(fc.packed0.cpu(), fh.packed0),
        "labb_equal": torch.equal(fc.labb.cpu(), fh.labb),
        "edge_thin_max_diff": float((fc.edge_thin.cpu()
                                     - fh.edge_thin).abs().max()),
        "edge_bin_differ": int((fc.edge_bin.cpu() != fh.edge_bin).sum())}
    plane = fh.labb[..., 0].contiguous()
    out["blur_radii_equal"] = {
        r: torch.equal(blur.gaussian_blur(plane.to(dev), r).cpu(),
                       blur.gaussian_blur(plane, r))
        for r in (0, 1, 3, 7, 31, 40)}
    small = torch.from_numpy(fx["blur/in"])
    out["blur_iir_max_diff"] = float((blur.gaussian_blur_iir(
        small.to(dev), 5.0).cpu() - blur.gaussian_blur_iir(small, 5.0))
        .abs().max())
    pre = torch.from_numpy(fx["rescue/random/pre"])
    filt = torch.from_numpy(fx["rescue/random/filtered"])
    out["rescue_equal"] = torch.equal(
        ccl.rescue_filtered(pre.to(dev), filt.to(dev)).cpu(),
        ccl.rescue_filtered(pre, filt))
    out["color_reassign_equal"] = torch.equal(
        regions.color_reassign(fh.packed0.to(dev), fh.edge_bin.to(dev) - 1)
        .cpu(), regions.color_reassign(fh.packed0, fh.edge_bin - 1))
    out["rand_field_equal"] = torch.equal(
        rand.rand_field(h * w, 7, dev).cpu(), rand.rand_field(h * w, 7))
    phase(f"phase 7 off-default operations, card against CPU at 720p: "
          f"{json.dumps(out)}")
    fr = out["front_end_color_exact_r5"]
    if not (out["packed_exact_equal"] and fr["packed0_equal"]
            and fr["labb_equal"] and fr["edge_thin_max_diff"] <= FLOAT_ATOL
            and fr["edge_bin_differ"] == 0
            and all(out["blur_radii_equal"].values())
            and out["blur_iir_max_diff"] <= 1e-5 and out["rescue_equal"]
            and out["color_reassign_equal"] and out["rand_field_equal"]):
        fail("an off-default operation differs between the card and the CPU")


def same_result(torch, a, b) -> bool:
    """Two RectResults on the card, every field equal bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def turns_of(torch, fns: dict, frames: int):
    """CUDA-event ms of `frames` calls of each of the two functions, in
    turns a, b, b, a; returns {name: [ms, ...]}."""
    (na, fa), (nb, fb) = fns.items()
    for f in (fa, fb):
        f()
    torch.cuda.synchronize()
    times = {na: [], nb: []}
    for name, f in ((na, fa), (nb, fb), (nb, fb), (na, fa)):
        for _ in range(frames):
            times[name].append(cuda_timed(torch, f)[1])
    return times


def overflow_flags(bgr, cfg):
    """Where rect_frame's capacities cut what the tiled path keeps whole:
    the strength pair's rows (the strings' interior labelled pixels, past
    max(4096, H*W // sparse_factor)) and the boundary compaction (the
    marked boundary pixels, past max(4096, H*W // boundary_sparse_factor)).
    Below both, the two paths compute the same function."""
    from rectdetect_tpu_torch.ops import hopper_morph, regions
    from rectdetect_tpu_torch.ops.shifts import interior_mask
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.rect import (region_merge,
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
    sp = max(4096, n // cfg.sparse_factor)
    spb = max(4096, n // cfg.boundary_sparse_factor)
    return {"strength_rows": rows, "strength_cap": sp,
            "strength_overflow": rows > sp, "boundary_pixels": marks,
            "boundary_cap": spb, "boundary_overflow": marks > spb}


def tiled_kernels(n: int, cfg, poly: bool = False) -> int:
    """Kernels one rect_step_tiled (poly_step_tiled) call over n tiles
    launches: on each tile K1, K2, K3 (rect), K4 for the strings and for
    the boundary, blblur, quant_despeckle, merge_mask and the links CCL
    (poly: K1, K2 and K4); then on the first tile K3 (poly_branch),
    distinct_bids, hyp and pose (poly: K3), and mkpl, whose slot-range
    form runs over n > 1 tiles."""
    from rectdetect_tpu_torch.ops import (hopper_blblur, hopper_mkpl,
                                          hopper_morph, hopper_quant)
    mk = hopper_mkpl.kernels(n if n > 1 else None, cfg.mkpl_iters)
    if poly:
        return n * (2 + K4_KERNELS) + hopper_morph.KERNELS + mk
    per_tile = (2 + hopper_morph.KERNELS + 2 * K4_KERNELS
                + hopper_blblur.launch_count(cfg.blblur_iters)
                + hopper_quant.KERNELS + 1 + LINKS_KERNELS)
    return n * per_tile + hopper_morph.KERNELS + 3 + mk


def counted(torch, build_mod, fn):
    """(fn(), the kernels it launched by the library's counter)."""
    torch.cuda.synchronize()
    n0 = build_mod.launch_count()
    out = fn()
    torch.cuda.synchronize()
    return out, build_mod.launch_count() - n0


def launch_times(torch, build_mod, fn, names):
    """fn() once, after a warm-up call, with a CUDA event before and after
    each launch of the entry points `names`, the whole call queued while
    the device sleeps (as device_ms).  Returns {name: [ms of each
    launch]}."""
    orig = build_mod.launch
    marks = []

    def launch(name, device, *args, **kw):
        if name not in names:
            return orig(name, device, *args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        orig(name, device, *args, **kw)
        end.record()
        marks.append((name, start, end))

    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        marks.clear()
        torch.cuda._sleep(cycles)
        build_mod.launch = launch
        try:
            fn()
        finally:
            build_mod.launch = orig
        ahead = bool(marks) and not marks[0][1].query()
        torch.cuda.synchronize()
        if ahead:
            break
        cycles *= 2
    else:
        fail("the host could not queue the launches ahead of the device")
    out = {}
    for name, start, end in marks:
        out.setdefault(name, []).append(start.elapsed_time(end))
    return out


def mkpl_ranges(torch, dev, card, strong, cfg):
    """Phase 8, the slot-range form of mkpl (#14) at the 720p strong-edge
    arena (the rect path's polylines): over 1 to 4 ranges of one card,
    arena and lsid bit-equal to one rd_mkpl launch and to the plain form
    by slot range, on the arena and on one that overflows, each call's
    kernels held exactly; each range count's device time per call in
    turns with the one launch, and the host's time to queue a call over
    1 and 4 ranges; each entry point's device time per launch
    at 4 ranges (CUDA events around each launch of a call queued while the
    device sleeps) in turns with the one launch.  Returns the entry
    points' records (launches filled in by the caller) and a summary."""
    from rectdetect_tpu_torch.dist.mesh import TileGroup
    from rectdetect_tpu_torch.ops import _build, hopper_mkpl, mkpl, polyline

    h, w = strong.shape
    cap = cfg.ls_cap_for(w, h)
    iters = cfg.mkpl_iters
    rounds = iters - 1
    sb = (strong > 0).to(torch.int32)
    arena0, dense, number, comp = polyline.mkpl_inputs(
        sb, cfg.size_thre_rect, cap, cfg)

    def run(a, g=None, fn=hopper_mkpl.mkpl_subdivide, it=iters):
        return fn(a, dense, number, cfg.minerror_rect, it, comp, g)

    def same(x, y):
        return torch.equal(x[1], y[1]) and all(
            torch.equal(getattr(x[0], f), getattr(y[0], f))
            for f in x[0]._fields)

    # the counts before each round, from the one launch at 0..rounds rounds
    counts = [int(run(arena0, it=r + 1)[0].count) for r in range(iters)]
    count0, count = counts[0], counts[-1]
    small = (count0 + count) // 2
    if not count0 < small - 1 < count - 1:
        fail(f"mkpl ranges: no overflow case between counts {count0} and "
             f"{count}")
    a_small = polyline.mkpl_init(dense, number, small, comp)
    checks = {}
    for label, a in (("arena", arena0), ("overflow", a_small)):
        want = run(a)
        checks[label] = {}
        for k in range(1, 5):
            g = TileGroup([dev] * k)
            got, made = counted(torch, _build, lambda: run(a, g))
            plain = run(a, g, mkpl.mkpl_subdivide)
            eq1, eq2 = same(got, want), same(got, plain)
            checks[label][k] = {"equal_one_launch": eq1, "equal_plain": eq2,
                                "kernels": made,
                                "count": int(got[0].count)}
            if not (eq1 and eq2) or made != hopper_mkpl.kernels(k, iters):
                fail(f"mkpl over {k} slot ranges ({label}): "
                     f"{checks[label][k]}, not bit-equal or not "
                     f"{hopper_mkpl.kernels(k, iters)} kernels")
        if label == "overflow" and int(want[0].count) != small - 1:
            fail(f"mkpl ranges: the arena of cap {small} did not overflow")
    lab = dense.reshape(-1)[comp.idx[comp.valid()].long()]
    live = int(((lab > 0) & (lab <= count0)
                & (arena0.polyid[lab.clamp(0, cap - 1).long()] != 0)).sum())
    phase(f"phase 8 mkpl slot ranges at the 720p strong-edge arena (slots "
          f"{comp.cap}, live {live}, arena cap {cap}, count {count0} -> "
          f"{count}; overflow cap {small}): {json.dumps(checks)}")

    # each range count's whole call in turns with the one launch; one call
    # a timing, since ten calls of up to 128 launches each overrun the
    # launch queue and the host waits on the device
    whole = {}
    for k in range(1, 5):
        g = TileGroup([dev] * k)
        turns = []
        for f in (lambda: run(arena0), lambda: run(arena0, g),
                  lambda: run(arena0, g), lambda: run(arena0)):
            turns.append(device_ms(torch, _build, f, calls=1, turns=1)[0][0])
        whole[k] = {"device_ms (one, ranges, ranges, one)": turns}
    # the host's time to queue one call (the launches and the reductions)
    for k in (1, 4):
        g = TileGroup([dev] * k)
        run(arena0, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(arena0, g)
        whole[k]["host_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    phase(f"phase 8 mkpl slot ranges, device ms per call (CUDA events around "
          f"one call queued while the device slept): {json.dumps(whole)}; "
          f"card {card}")

    # each entry point at 4 ranges, in turns with the one launch
    g4 = TileGroup([dev] * 4)
    one_ms, per_entry = [], {e: [] for e in MKPL_ENTRIES}
    n_launch = {}
    for turn in ("one", "ranges", "ranges", "one"):
        if turn == "one":
            one_ms.append(device_ms(torch, _build, lambda: run(arena0),
                                    calls=1, turns=1)[0][0])
            continue
        t = launch_times(torch, _build, lambda: run(arena0, g4),
                         MKPL_ENTRIES)
        for e in MKPL_ENTRIES:
            per_entry[e].append(sum(t[e]))
            n_launch[e] = len(t[e])
    plain_ms = cuda_ms(torch, lambda: run(arena0, g4, mkpl.mkpl_subdivide),
                       3)
    valid = int(comp.n)
    segs = sum(c + 1 for c in counts[:-1])
    work = {
        # bytes: the slot list, dense and number at the valid slots, the
        # five position tables and the runs written, lsid at the others
        "rd_mkpl_setup": (4 * comp.cap + 8 * valid + 20 * live
                          + 8 * (count0 + 1) + 4 * (valid - live), live),
        # per round ~40 B a live position, then lsid; >= 20 operations a
        # position and round (the chord distance)
        "rd_mkpl_keys": (MKPL_BYTES_PER_LIVE * live * rounds + 4 * live,
                         20 * live * rounds),
        # ~60 B per segment and round, the segments 0..count of each round
        "rd_mkpl_splits": (MKPL_BYTES_PER_SEGMENT * segs, 20 * segs),
    }
    records = []
    for e in MKPL_ENTRIES:
        nbytes, ops = work[e]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        ms = statistics.median(per_entry[e])
        records.append({
            "name": e[3:], "route": "cuda",
            "source": "rectdetect_tpu_torch/csrc/mkpl.cu",
            "replaces": "rectdetect_tpu/ops/pallas_mkpl.py:68",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "device_ms": per_entry[e],
            "launches_per_call": n_launch[e],
            "ms_per_launch": ms / n_launch[e],
            "ms_is": "device ms that one 720p call over 4 slot ranges "
                     "spends in this entry point, summed over its launches; "
                     "plain_ms is the whole plain call by slot range",
            "one_launch_ms (turns 1, 4)": one_ms})
        phase(f"phase 8 mkpl slot ranges {e}: {ms:.4f} ms per call in "
              f"{n_launch[e]} launches ({ms / n_launch[e]:.5f} ms each; "
              f"turns {[round(x, 5) for x in per_entry[e]]}), one rd_mkpl "
              f"launch {[round(x, 5) for x in one_ms]} ms in turns, plain "
              f"by slot range {plain_ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.6f} ms ({nbytes} B, {ops} ops); card "
              f"{card}")
    keys_ms = statistics.median(per_entry["rd_mkpl_keys"])
    split_ms = statistics.median(per_entry["rd_mkpl_splits"])
    summary = {"checks": checks, "whole_call": whole, "live": live,
               "counts": counts, "one_launch_ms": one_ms,
               "per_round_ms": (keys_ms + split_ms) / max(1, rounds),
               "per_call_ms": sum(statistics.median(v)
                                  for v in per_entry.values()),
               "plain_ms": plain_ms}
    phase(f"phase 8 mkpl slot ranges at 4 ranges: {summary['per_call_ms']:.4f}"
          f" ms per call in its launches, {summary['per_round_ms']:.5f} ms a "
          f"round (keys and splits, all 4 tiles); card {card}")
    return records, summary


def tiled(torch, dev, card, bgr, drive, counters, record, records):
    """Phase 8, the width-tiled path (dist/tile.py) on one card, every tile
    on it (TileGroup([cuda:0] * N)): the x0/w_total offset forms of K3
    (rect, poly_branch, bridge2), merge_mask, blblur and the links CCL,
    and K2's frame-column form, bit-equal to their plain versions at the
    720p tile shapes of the left, an interior and the right tile of four
    and at an odd x0, each call's kernels held by the library's counter,
    each form's device time in turns with the kernel on the whole frame;
    the slot-range form of mkpl (mkpl_ranges); rect_step_tiled driven with
    the launch counts, held exactly, the plain subdivision barred from the
    card, and equal to rect_frame at 720p over 2 and 4 tiles and at
    3840x2160 over 4 (calibrated on itself; the capacities' overflow flags
    beside), each call's kernels held, with the frame medians in turns;
    poly_step_tiled at 720p over 4 tiles equal to poly_frame, its kernels
    held; both over distinct cards where there are several;
    TiledVideoRectDetector's polls equal to direct calls."""
    import tempfile

    from bench import synth_frame
    from rectdetect_tpu_torch.apps.common import TAN_AOV
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG
    from rectdetect_tpu_torch.core import color
    from rectdetect_tpu_torch.dist import tile as dtile
    from rectdetect_tpu_torch.dist.mesh import TileGroup
    from rectdetect_tpu_torch.ops import (_build, blur, ccl, hopper_blblur,
                                          hopper_ccl, hopper_grad,
                                          hopper_links, hopper_merge_mask,
                                          hopper_mkpl, hopper_morph,
                                          hopper_thin, mkpl, regions)
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.poly import poly_frame
    from rectdetect_tpu_torch.pipeline.rect import (live_rects, rect_frame,
                                                    region_merge,
                                                    region_smoothing,
                                                    weak_strong_labels)
    from rectdetect_tpu_torch.pipeline.video import TiledVideoRectDetector
    from rectdetect_tpu_torch.runtime import calibrate as cal

    cfg = DEFAULT_CONFIG
    h, w = bgr.shape[:2]
    n_t = 4
    wl = w // n_t
    g4 = TileGroup([dev] * n_t)
    fe = edge_frontend(bgr, cfg)
    lbl = hopper_ccl.label_components(fe.edge_bin, 0)
    edge = (ccl.filter_strength(lbl, ccl.calc_strength(fe.edge_thin, lbl),
                                500) > 0).to(torch.int32)
    weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
    weak_bin = (weak > 0).to(torch.int32)
    despeck = region_smoothing(fe.packed0, weak, fe.edge_thin, cfg)[1]
    mask = region_merge(despeck, strong, cfg)[0]
    odd_x0 = wl + 1

    def positions(halo):
        """(name, x0, slice start) of the left, an interior and the right
        tile of four widened by `halo`, and of a window at an odd x0."""
        return (("left", -halo, None), ("interior", wl - halo, wl - halo),
                ("right", 3 * wl - halo, None),
                ("odd x0", odd_x0, odd_x0))

    def window(t, halo, x0, start, fill):
        """t's columns x0 .. x0 + wl + 2 halo - 1 (fill beyond the frame),
        as halo_exchange_w widens a tile."""
        if start is not None:
            return t[:, start:start + wl + 2 * halo].contiguous()
        return dtile.halo_exchange_w(
            g4, g4.split(t), halo, fill="const",
            fill_value=fill)[0 if x0 < 0 else n_t - 1]

    # (name, source, TPU kernel, halo, fill, kernels per call, the wrapper
    # on a window at x0, its plain version, the window's inputs)
    forms = [
        ("strings_chain_x0", "morph.cu",
         "rectdetect_tpu/ops/pallas_morph.py:40", 12, 0, hopper_morph.KERNELS,
         lambda x0, e: hopper_morph.strings_chain(e, "rect", False, x0, w),
         lambda x0, e: hopper_morph.strings_chain_plain(e, "rect", False, x0,
                                                        w), (fe.edge_bin,)),
        ("strings_chain_x0[poly_branch]", "morph.cu",
         "rectdetect_tpu/ops/pallas_morph.py:40", 12, 0, hopper_morph.KERNELS,
         lambda x0, e: hopper_morph.strings_chain(e, "poly_branch", False,
                                                  x0, w),
         lambda x0, e: hopper_morph.strings_chain_plain(
             e, "poly_branch", False, x0, w), (edge,)),
        ("strings_chain_x0[bridge2]", "morph.cu",
         "rectdetect_tpu/ops/pallas_morph.py:118", 12, 0,
         hopper_morph.KERNELS,
         lambda x0, e: hopper_morph.strings_chain(e, "rect", True, x0, w),
         lambda x0, e: hopper_morph.strings_chain_plain(e, "rect", True, x0,
                                                        w), (fe.edge_bin,)),
        ("merge_mask_x0", "merge_mask.cu",
         "rectdetect_tpu/ops/pallas_morph.py:391", 12, -1, 1,
         lambda x0, s_: hopper_merge_mask.junction_merge_mask(s_, x0, w),
         lambda x0, s_: regions.junction_merge_mask(s_, x0, w), (strong,)),
        ("blblur_x0", "blblur.cu", "rectdetect_tpu/ops/pallas_blblur.py:223",
         5 * cfg.blblur_iters + 6, 0,
         hopper_blblur.launch_count(cfg.blblur_iters),
         lambda x0, p, e: hopper_blblur.blblur(p, e, cfg.blblur_iters, x0, w),
         lambda x0, p, e: regions.blblur(p, e, cfg.blblur_iters, x0, w),
         (fe.packed0, weak_bin)),
        ("label_merge_x0", "links_ccl.cu",
         "rectdetect_tpu/ops/pallas_ccl.py:471", 0, 0, 3,
         lambda x0, p, m, e: hopper_links.label_merge(p, m, e, x0, w),
         lambda x0, p, m, e: regions.label_merge(p, m, e, x0, w),
         (despeck, mask, strong)),
    ]
    whole = {"strings_chain_x0": lambda: hopper_morph.strings_chain(
                 fe.edge_bin, "rect"),
             "merge_mask_x0": lambda: hopper_merge_mask.junction_merge_mask(
                 strong),
             "blblur_x0": lambda: hopper_blblur.blblur(
                 fe.packed0, weak_bin, cfg.blblur_iters),
             "label_merge_x0": lambda: hopper_links.label_merge(
                 despeck, mask, strong)}
    checks, new_records = {}, {}
    for name, src, replaces, halo, fill, kernels, fn, plain, ins in forms:
        entry = {}
        for pos, x0, start in positions(halo):
            if halo == 0 and start is None:
                # the links CCL runs on the tile itself
                start = 0 if pos == "left" else 3 * wl
                x0 = start
            wins = [window(t, halo, x0, start, fill) for t in ins]
            n0 = _build.launch_count()
            got = fn(x0, *wins)
            torch.cuda.synchronize()
            made = _build.launch_count() - n0
            want = plain(x0, *wins)
            nd = int((got != want).sum())
            entry[pos] = {"x0": x0, "shape": list(wins[0].shape),
                          "differ": nd, "kernels": made}
            if nd or made != kernels:
                fail(f"{name} at the {pos} tile (x0 {x0}): {nd} pixels "
                     f"differ from the plain version, {made} kernels, not "
                     f"{kernels}")
        checks[name] = entry
        if name not in whole:
            continue
        # the interior tile's call, timed in turns with the whole frame's
        x0 = wl - halo if halo else wl
        wins = [window(t, halo, x0, x0, fill) for t in ins]
        turns = []
        for f in (lambda: fn(x0, *wins), whole[name], whole[name],
                  lambda: fn(x0, *wins)):
            turns.append(device_ms(torch, _build, f, turns=1)[0][0])
        entry["device_ms (tile, frame, frame, tile)"] = turns
        out_b = wins[0].numel() * 4
        record(name, src, replaces, 0.0, lambda: fn(x0, *wins),
               cuda_ms(torch, lambda: plain(x0, *wins), 3),
               sum(t.numel() * t.element_size() for t in wins) + out_b,
               wins[0].numel(), kernels=kernels, label="phase 8")
        new_records[name] = records[-1]
    # K2 at a frame column (the tiled front end's thinthres), on the
    # interior tile's widened em and vec
    labq = color.quantize_labf(color.bgr_to_labf(bgr)).permute(2, 0, 1)
    wide = dtile.halo_exchange_w(g4, g4.split(labq, axis=2), 16)[1]
    labb = torch.stack([blur.gaussian_blur(wide[c], cfg.blur_radius)
                        for c in range(3)], dim=-1)
    em, vec = hopper_grad.edge_front(labb)
    x0 = wl - 16
    got = hopper_thin.thinthres(em, vec, x0=x0)
    want = hopper_thin.thin_plain(em, vec, x0=x0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    nbin = int(((got > 0) != (want > 0)).sum())
    checks["thinthres_x0"] = {"x0": x0, "shape": list(em.shape),
                              "max_abs_err": err, "edge_bin_differ": nbin,
                              "bits_differ": int((got != want).sum())}
    if not err <= FLOAT_ATOL or nbin:
        fail(f"thinthres at x0 {x0}: max diff {err}, {nbin} edge_bin pixels")
    record("thinthres_x0", "thin.cu", "rectdetect_tpu/ops/pallas_thin.py:43",
           err, lambda: hopper_thin.thinthres(em, vec, x0=x0),
           cuda_ms(torch, lambda: hopper_thin.thin_plain(em, vec, x0=x0), 3),
           em.numel() * 4 * 4, 2 * em.numel(), label="phase 8")
    new_records["thinthres_x0"] = records[-1]
    phase(f"phase 8 offset forms against their plain versions: "
          f"{json.dumps(checks)}; card {card}")

    # rect_step_tiled, the main path of this phase
    offset_mods = {"strings_chain_x0": hopper_morph,
                   "merge_mask_x0": hopper_merge_mask,
                   "blblur_x0": hopper_blblur,
                   "label_merge_x0": hopper_links,
                   "thinthres_x0": hopper_thin}
    names = [k for k in counters
             if k not in ("seg_scan", "despeckle2")]
    mk_records, mk_summary = mkpl_ranges(torch, dev, card, strong, cfg)
    tiles4 = g4.split(bgr)
    for mod in offset_mods.values():
        mod.offset_launches = 0
    # the plain subdivision may not run on the card in this run
    plain_mkpl = mkpl.mkpl_subdivide

    def no_plain(arena, label, *args, **kw):
        if label.is_cuda:
            fail("rect_step_tiled ran the plain subdivision on the card")
        return plain_mkpl(arena, label, *args, **kw)

    mkpl.mkpl_subdivide = no_plain
    try:
        res_t = drive("rect_step_tiled (phase 8, 720p, 4 tiles)", names,
                      lambda: dtile.rect_step_tiled(g4, tiles4, TAN_AOV,
                                                    cfg=cfg),
                      tiled_kernels(4, cfg))
    finally:
        mkpl.mkpl_subdivide = plain_mkpl
    entries = {e: _build.expected_kernels.get(e, 0) for e in MKPL_ENTRIES}
    phase(f"phase 8 mkpl slot-range launches in that run: "
          f"{json.dumps(entries)} (mkpl wrapper count "
          f"{counters['mkpl'].launches}, "
          f"{hopper_mkpl.kernels(4, cfg.mkpl_iters)} expected)")
    if (counters["mkpl"].launches != hopper_mkpl.kernels(4, cfg.mkpl_iters)
            or any(v < 1 for v in entries.values())):
        fail(f"rect_step_tiled over 4 tiles did not run the slot-range "
             f"form: {entries}")
    for rec in mk_records:
        rec["launches"] = entries["rd_" + rec["name"]]
        records.append(rec)
    offs = {k: m.offset_launches for k, m in offset_mods.items()}
    phase(f"phase 8 offset-form launches in that run: {json.dumps(offs)}")
    if any(v < 1 for v in offs.values()):
        fail(f"rect_step_tiled did not launch an offset form: {offs}")
    for k, rec in new_records.items():
        rec["launches"] = offs[k]
    if counters["seg_scan"].launches or counters["despeckle2"].launches:
        fail("rect_step_tiled launched seg_scan or despeckle2")
    res = rect_frame(bgr, TAN_AOV, cfg)
    torch.cuda.synchronize()
    if not same_result(torch, res_t, res):
        fail("rect_step_tiled at 720p over 4 tiles differs from rect_frame")
    out = {}
    for nt, frame, cfg_f, label in (
            (2, bgr, cfg, "720p"), (4, bgr, cfg, "720p"),
            (4, None, None, f"{TILED_BIG[1]}x{TILED_BIG[0]}")):
        if frame is None:
            frame = torch.from_numpy(synth_frame(*TILED_BIG, seed=0)).to(dev)
            with tempfile.TemporaryDirectory() as td:
                cfg_f = cal.calibrate([frame], cfg,
                                      os.path.join(td, "plan_torch.txt"))
        g = TileGroup([dev] * nt)
        tiles = g.split(frame)
        got, made = counted(torch, _build, lambda: dtile.rect_step_tiled(
            g, tiles, TAN_AOV, cfg=cfg_f))
        if made != tiled_kernels(nt, cfg_f):
            fail(f"rect_step_tiled at {label} over {nt} tiles launched "
                 f"{made} kernels, not {tiled_kernels(nt, cfg_f)}")
        want = rect_frame(frame, TAN_AOV, cfg_f)
        torch.cuda.synchronize()
        flags = overflow_flags(frame, cfg_f)
        eq = same_result(torch, got, want)
        times = turns_of(torch, {
            f"rect_step_tiled {nt} tiles": lambda: dtile.rect_step_tiled(
                g, tiles, TAN_AOV, cfg=cfg_f),
            "rect_frame": lambda: rect_frame(frame, TAN_AOV, cfg_f)},
            TILED_TURN_FRAMES)
        row = {"equal": eq, "kernels": made, "valid": int(want.valid.sum()),
               "valid_equal": torch.equal(got.valid, want.valid),
               "status_equal": torch.equal(got.status, want.status),
               "overflow": flags,
               "median_ms": {k: statistics.median(v)
                             for k, v in times.items()},
               "ms": times}
        if label != "720p":
            row["calibrated"] = {k: getattr(cfg_f, k) for k in cal.KEPT}
        out[f"{label} {nt} tiles"] = row
        phase(f"phase 8 rect_step_tiled {label} over {nt} tiles against "
              f"rect_frame: {json.dumps(row)}; card {card}")
        if not eq and not (flags["strength_overflow"]
                           or flags["boundary_overflow"]):
            fail(f"rect_step_tiled at {label} over {nt} tiles differs from "
                 f"rect_frame below the capacities' overflow")

    # poly_step_tiled against poly_frame
    (arena_t, lsid_t), made = counted(
        torch, _build,
        lambda: dtile.poly_step_tiled(g4, tiles4, cfg, 1.0, 20, 500))
    arena, lsid = poly_frame(bgr, cfg, 1.0, 20, 500)
    torch.cuda.synchronize()
    same = torch.equal(lsid_t, lsid) and all(
        torch.equal(getattr(arena_t, f), getattr(arena, f))
        for f in arena._fields)
    want_k = tiled_kernels(4, cfg, poly=True)
    phase(f"phase 8 poly_step_tiled 720p over 4 tiles: arena and lsid equal "
          f"to poly_frame's: {same} ({int(arena.count)} segments); {made} "
          f"kernels, {want_k} expected")
    if not same or made != want_k:
        fail("poly_step_tiled differs from poly_frame or launched "
             f"{made} kernels, not {want_k}")
    out["mkpl_ranges"] = mk_summary

    # the tiles on distinct cards, where the machine has them
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        nt = min(4, n_cards)
        gd = TileGroup([torch.device("cuda", i) for i in range(nt)])
        got, made = counted(torch, _build, lambda: dtile.rect_step_tiled(
            gd, gd.split(bgr), TAN_AOV, cfg=cfg))
        pa, pl = dtile.poly_step_tiled(gd, gd.split(bgr), cfg, 1.0, 20, 500)
        for i in range(nt):
            torch.cuda.synchronize(i)
        eq = same_result(torch, got, res) and torch.equal(pl, lsid) and all(
            torch.equal(getattr(pa, f), getattr(arena, f))
            for f in arena._fields)
        times = turns_of(torch, {
            f"rect_step_tiled {nt} cards": lambda: dtile.rect_step_tiled(
                gd, gd.split(bgr), TAN_AOV, cfg=cfg),
            "rect_frame": lambda: rect_frame(bgr, TAN_AOV, cfg)},
            TILED_TURN_FRAMES)
        row = {"equal": eq, "kernels": made,
               "median_ms": {k: statistics.median(v)
                             for k, v in times.items()}, "ms": times}
        out[f"720p {nt} cards"] = row
        phase(f"phase 8 rect_step_tiled and poly_step_tiled over {nt} "
              f"distinct cards: equal to rect_frame and poly_frame: {eq}; "
              f"{made} kernels, {tiled_kernels(nt, cfg)} expected; "
              f"{json.dumps(row)}; card {card}")
        if not eq or made != tiled_kernels(nt, cfg):
            fail(f"the tiled paths over {nt} distinct cards differ")
    else:
        phase("phase 8 one card visible: the tiled paths over distinct "
              "cards were not run")

    # the video detector over the tiles
    frames = [synth_frame(H, W, seed=s) for s in range(6)]
    det = TiledVideoRectDetector(TAN_AOV, g4, cfg)
    polls = []
    det.enqueue(frames[0])
    for f in frames[1:] + [None]:
        if f is not None:
            det.enqueue(f)
        polls.append(det.poll())
    direct = [live_rects(dtile.rect_step_tiled(
        g4, g4.split(torch.from_numpy(f).to(dev)), TAN_AOV, cfg=cfg))
        for f in frames]
    single = [live_rects(rect_frame(torch.from_numpy(f).to(dev), TAN_AOV,
                                    cfg)) for f in frames]
    ok = all(same_results(a, b) and same_results(a, c)
             for a, b, c in zip(polls, direct, single))
    phase(f"phase 8 TiledVideoRectDetector over {len(frames)} 720p frames, "
          f"4 tiles: polls equal to direct rect_step_tiled and rect_frame "
          f"calls: {ok} ({sum(len(p) for p in polls)} rectangles)")
    if not ok:
        fail("TiledVideoRectDetector: a poll differs from the direct call")
    return out


def same_rect_lists(a, b) -> bool:
    """Two live_rects lists equal, corners bit for bit."""
    return len(a) == len(b) and all(
        x["status"] == y["status"] and x["value"] == y["value"]
        and np.array_equal(x["c2"], y["c2"]) and np.array_equal(x["c3"],
                                                                y["c3"])
        for x, y in zip(a, b))


def streams(torch, dev, card, drive, counters, record, records):
    """Phase 9, the stream axis, every mesh entry on the one card: the
    batch forms of K1 and K2 at b = STREAM_BATCH on 720p frames (seeds
    0-3), bit-equal to b = 1 calls and within FLOAT_ATOL of the plain
    versions, and of K3, blblur, quant_despeckle, merge_mask, the links
    CCL and despeckle2 on those frames' maps, bit-equal to b = 1 calls
    and their plain versions; device ms in turns with four single calls
    (their own records on the kernels line); rect_frames and poly_frames
    at B = STREAM_BATCH driven with the launch counts (32 B -
    RECT_STACK_KERNELS (B - 1) and 7 B - 2 (B - 1)), bit-equal to
    per-frame calls, frames/s in turns with per-frame calls;
    rect_frames_sharded driven with its count, it and
    poly_frames_sharded over a 4 x 1 mesh on 8 frames bit-equal to
    per-frame calls; the StreamSupervisor: 8 streams
    over 4 entries, entry 2 failing after its first frame, quarantined
    and its streams re-placed, every collected frame equal to rect_frame,
    and the default worker loop's frames/s over 2 streams beside direct
    calls; multihost_sim with two ranks on the card over gloo; the dry run
    over a 2 x 2 mesh."""
    from bench import synth_frame
    from rectdetect_tpu_torch.apps.common import TAN_AOV
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG
    from rectdetect_tpu_torch.dist.dryrun import dryrun_multichip
    from rectdetect_tpu_torch.dist.mesh import make_mesh
    from rectdetect_tpu_torch.dist.stream import (StreamSupervisor,
                                                  poly_frames_sharded,
                                                  rect_frames_sharded)
    from rectdetect_tpu_torch.ops import (_build, hopper_blblur,
                                          hopper_despeckle2, hopper_grad,
                                          hopper_links, hopper_merge_mask,
                                          hopper_morph, hopper_quant,
                                          hopper_thin, regions)
    from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
    from rectdetect_tpu_torch.pipeline.poly import poly_frame, poly_frames
    from rectdetect_tpu_torch.pipeline.rect import (live_rects, rect_frame,
                                                    rect_frames,
                                                    strength_labels)

    cfg = DEFAULT_CONFIG
    b = STREAM_BATCH
    out = {"card": card}
    host = [synth_frame(H, W, seed=s) for s in range(2 * b)]
    frames = torch.from_numpy(np.stack(host)).to(dev)
    batch = frames[:b]

    # the batch forms of K1 and K2
    labb = edge_frontend(batch, cfg).labb.contiguous()
    em, vec = hopper_grad.edge_front(labb)
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    thin = hopper_thin.thinthres(em, vec)
    thin_p = hopper_thin.thin_plain(em, vec)
    singles = [hopper_grad.edge_front(labb[i]) for i in range(b)]
    thin_1 = [hopper_thin.thinthres(em[i], vec[i]) for i in range(b)]
    torch.cuda.synchronize()
    ef_equal = all(torch.equal(em[i], e) and torch.equal(vec[i], v)
                   for i, (e, v) in enumerate(singles))
    th_equal = all(torch.equal(thin[i], t) for i, t in enumerate(thin_1))
    ef_err = max((em - em_p).abs().max().item(),
                 (vec - vec_p).abs().max().item())
    th_err = (thin - thin_p).abs().max().item()
    out["batch_forms"] = {"edge_front_equal_to_single_calls": ef_equal,
                          "thinthres_equal_to_single_calls": th_equal,
                          "edge_front_max_abs_err": ef_err,
                          "thinthres_max_abs_err": th_err}
    if not (ef_equal and th_equal):
        fail("a batch form of K1 or K2 differs from its single-frame calls")
    if not (ef_err <= FLOAT_ATOL and th_err <= FLOAT_ATOL):
        fail(f"a batch form differs from its plain version: {ef_err}, "
             f"{th_err} > {FLOAT_ATOL}")

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    record(f"edge_front[b={b}]", "edge_front.cu",
           "rectdetect_tpu/ops/pallas_grad.py:48", ef_err,
           lambda: hopper_grad.edge_front(labb),
           cuda_ms(torch, lambda: hopper_grad.edge_front_plain(labb), 3),
           nb(labb, em, vec), 25 * H * W * b, label="phase 9")
    record(f"thinthres[b={b}]", "thin.cu",
           "rectdetect_tpu/ops/pallas_thin.py:43", th_err,
           lambda: hopper_thin.thinthres(em, vec),
           cuda_ms(torch, lambda: hopper_thin.thin_plain(em, vec), 3),
           nb(em, vec, thin), 2 * em.numel(), label="phase 9")
    forms = [("edge_front", lambda: hopper_grad.edge_front(labb),
              lambda: [hopper_grad.edge_front(labb[i]) for i in range(b)]),
             ("thinthres", lambda: hopper_thin.thinthres(em, vec),
              lambda: [hopper_thin.thinthres(em[i], vec[i])
                       for i in range(b)])]

    # the batch forms of the rect tail's dense kernels on the stack's own
    # maps, each bit-equal to b single calls and to its plain version
    fe_b = edge_frontend(batch, cfg)
    s_b = hopper_morph.strings_chain(fe_b.edge_bin, "rect")
    weak_b, strong_b = (torch.stack(m) for m in zip(*(
        strength_labels(s_b[i], fe_b.edge_thin[i], cfg) for i in range(b))))
    weak_bin = (weak_b > 0).to(torch.int32)
    iters, n, thre = cfg.blblur_iters, cfg.quantize_levels, \
        cfg.despeckle2_thre
    blurred = hopper_blblur.blblur(fe_b.packed0, weak_bin, iters)
    despeck = hopper_quant.quantize_despeckle(blurred, fe_b.edge_thin, n, n,
                                              n)
    mask = hopper_merge_mask.junction_merge_mask(strong_b)
    seg0 = hopper_links.label_merge(despeck, mask, strong_b)
    seg = hopper_despeckle2.sizes_despeckle2(seg0, thre)
    hw = b * H * W
    # record name, counter, source, replaces, kernel, plain version,
    # inputs, the kernel's output on them, kernels a call, ops (as phase 3
    # counts them for one frame, times b)
    tail = [
        ("strings_chain", "strings_chain", "morph.cu",
         "rectdetect_tpu/ops/pallas_morph.py:40",
         lambda e: hopper_morph.strings_chain(e, "rect"),
         lambda e: hopper_morph.strings_chain_plain(e, "rect"),
         (fe_b.edge_bin,), s_b, hopper_morph.KERNELS, hw),
        ("blblur", "blblur", "blblur.cu",
         "rectdetect_tpu/ops/pallas_blblur.py:223",
         lambda p, e: hopper_blblur.blblur(p, e, iters),
         lambda p, e: regions.blblur(p, e, iters), (fe_b.packed0, weak_bin),
         blurred, hopper_blblur.launch_count(iters),
         2 * hw + 2 * iters * 3 * 3 * hw),
        ("quantize_despeckle", "quant_despeckle", "quant_despeckle.cu",
         "rectdetect_tpu/ops/pallas_morph.py:157",
         lambda p, e: hopper_quant.quantize_despeckle(p, e, n, n, n),
         lambda p, e: regions.quantize_despeckle(p, e, n, n, n),
         (blurred, fe_b.edge_thin), despeck, hopper_quant.KERNELS, 15 * hw),
        ("junction_merge_mask", "merge_mask", "merge_mask.cu",
         "rectdetect_tpu/ops/pallas_morph.py:391",
         hopper_merge_mask.junction_merge_mask, regions.junction_merge_mask,
         (strong_b,), mask, 1, hw),
        ("label_merge", "label_merge", "links_ccl.cu",
         "rectdetect_tpu/ops/pallas_ccl.py:471", hopper_links.label_merge,
         regions.label_merge, (despeck, mask, strong_b), seg0, 3, hw),
        ("sizes_despeckle2", "despeckle2", "despeckle2.cu",
         "rectdetect_tpu/ops/pallas_morph.py:597",
         lambda l: hopper_despeckle2.sizes_despeckle2(l, thre),
         lambda l: regions.sizes_despeckle2(l, thre), (seg0,), seg,
         hopper_despeckle2.KERNELS, 2 * hw)]
    tail_rows, tail_counter = {}, {}
    for name, key, src, replaces, kernel, plain, args, got, k, ops in tail:
        singles = [kernel(*(a[i] for a in args)) for i in range(b)]
        want = plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(got[i], x) for i, x in enumerate(singles))
        ndiff = int((got != want).sum())
        tail_rows[name] = {"equal_to_single_calls": same,
                           "pixels_differ_from_plain": ndiff}
        if not same:
            fail(f"the batch form of {name} differs from its single-frame "
                 "calls")
        if ndiff:
            fail(f"the batch form of {name} differs from its plain version "
                 f"at {ndiff} pixels")
        tail_counter[f"{name}[b={b}]"] = key
        record(f"{name}[b={b}]", src, replaces, 0.0,
               lambda kernel=kernel, args=args: kernel(*args),
               cuda_ms(torch, lambda plain=plain, args=args: plain(*args), 3),
               nb(*args, got), ops, kernels=k, label="phase 9")
        forms.append((name, lambda kernel=kernel, args=args: kernel(*args),
                      lambda kernel=kernel, args=args: [
                          kernel(*(a[i] for a in args)) for i in range(b)]))
    out["batch_forms"]["rect_tail"] = tail_rows

    turns = {}
    for name, one_call, four_calls in forms:
        t = {"order": f"b={b}, {b} x b=1, {b} x b=1, b={b}", f"b={b}": [],
             f"{b} x b=1": []}
        for key, fn in ((f"b={b}", one_call), (f"{b} x b=1", four_calls),
                        (f"{b} x b=1", four_calls), (f"b={b}", one_call)):
            t[key].append(device_ms(torch, _build, fn, turns=1)[0][0])
        turns[name] = t
    out["batch_forms"]["device_ms_in_turns"] = turns
    phase(f"phase 9 batch forms at b={b}, 720p: {json.dumps(out['batch_forms'])}"
          f"; card {card}")

    # rect_frames and poly_frames at B = b
    want = [rect_frame(frames[i], TAN_AOV, cfg) for i in range(2 * b)]
    want_p = [poly_frame(frames[i], cfg) for i in range(2 * b)]
    hopper_morph.batch_launches = 0
    res = drive(f"rect_frames (phase 9, 720p, B={b})", list(counters),
                lambda: rect_frames(batch, TAN_AOV, cfg),
                RECT_FRAME_KERNELS * b - RECT_STACK_KERNELS * (b - 1))
    tail_counter.update({f"edge_front[b={b}]": "edge_front",
                         f"thinthres[b={b}]": "thinthres"})
    for rec in records:
        if rec["name"] == f"strings_chain[b={b}]":
            # K3 also runs once a frame (poly_branch) inside the polylines
            rec["launches"] = hopper_morph.batch_launches
        elif rec["name"] in tail_counter:
            rec["launches"] = counters[tail_counter[rec["name"]]].launches
    arena, lsid = drive(f"poly_frames (phase 9, 720p, B={b})",
                        ["edge_front", "thinthres", "strings_chain",
                         "label_components", "mkpl"],
                        lambda: poly_frames(batch, cfg),
                        POLY_FRAME_KERNELS * b - 2 * (b - 1))
    rect_eq = all(same_result(torch, type(res)(*(f[i] for f in res)), w)
                  for i, w in enumerate(want[:b]))
    poly_eq = all(torch.equal(lsid[i], l) and all(
        torch.equal(getattr(arena, f)[i], getattr(a, f))
        for f in a._fields) for i, (a, l) in enumerate(want_p[:b]))
    times = turns_of(torch, {
        f"rect_frames(B={b})": lambda: rect_frames(batch, TAN_AOV, cfg),
        f"{b} x rect_frame": lambda: [rect_frame(batch[i], TAN_AOV, cfg)
                                      for i in range(b)]}, 5)
    rates = {k: b * 1000.0 / statistics.median(v) for k, v in times.items()}
    out["frames"] = {"rect_frames_equal": rect_eq, "poly_frames_equal":
                     poly_eq, "valid": [int(w.valid.sum()) for w in want[:b]],
                     "ms": times, "frames_per_s": rates}
    phase(f"phase 9 rect_frames and poly_frames at B={b}, 720p: "
          f"{json.dumps(out['frames'])}; card {card}")
    if not (rect_eq and poly_eq):
        fail("rect_frames or poly_frames differs from the per-frame calls")

    # the sharded frames over a 4 x 1 mesh of the card: each row one
    # rect_frames call on its 2 frames
    mesh = make_mesh(4, 1, [dev] * 4)
    rows, per_row = 4, 2 * b // 4
    res_s = drive(f"rect_frames_sharded (phase 9, 720p, 4 x 1, {2 * b} "
                  "frames)", list(counters),
                  lambda: rect_frames_sharded(frames, TAN_AOV, mesh, cfg),
                  rows * (RECT_FRAME_KERNELS * per_row
                          - RECT_STACK_KERNELS * (per_row - 1)))
    arena_s, lsid_s = poly_frames_sharded(frames, mesh, cfg)
    torch.cuda.synchronize()
    sh_rect = all(same_result(torch, type(res_s)(*(f[i] for f in res_s)), w)
                  for i, w in enumerate(want))
    sh_poly = all(torch.equal(lsid_s[i], l) and all(
        torch.equal(getattr(arena_s, f)[i], getattr(a, f))
        for f in a._fields) for i, (a, l) in enumerate(want_p))
    times = turns_of(torch, {
        "rect_frames_sharded (4 x 1, 8 frames)": lambda: rect_frames_sharded(
            frames, TAN_AOV, mesh, cfg),
        "8 x rect_frame": lambda: [rect_frame(frames[i], TAN_AOV, cfg)
                                   for i in range(2 * b)]}, 3)
    out["sharded"] = {
        "rect_equal": sh_rect, "poly_equal": sh_poly, "ms": times,
        "frames_per_s": {k: 2 * b * 1000.0 / statistics.median(v)
                         for k, v in times.items()}}
    phase(f"phase 9 rect_frames_sharded and poly_frames_sharded over a 4 x 1 "
          f"mesh, 8 720p frames: {json.dumps(out['sharded'])}; card {card}")
    if not (sh_rect and sh_poly):
        fail("a sharded result differs from the per-frame calls")

    # the supervisor: entry 2 of 4 fails after its first frame
    rects = [live_rects(w) for w in want]
    default_run = StreamSupervisor(TAN_AOV, cfg, devices=[dev])._run
    cur, used = {}, [0]

    def flaky_run(bgr, device):
        if sup._assign[cur["sid"]] == 2:
            used[0] += 1
            if used[0] > 1:
                raise RuntimeError("injected card fault on entry 2")
        return default_run(bgr, device)

    sup = StreamSupervisor(TAN_AOV, cfg, devices=[dev] * 4,
                           run_fn=flaky_run)
    n_streams, placed, collected, dropped, wrong = 8, [], 0, 0, 0
    for rnd in range(2):
        for sid in range(n_streams):
            cur["sid"] = sid
            sup.submit(sid, host[sid])
        placed.append(dict(sup._assign))
        for sid in range(n_streams):
            got = sup.collect(sid)
            if got is None:
                dropped += 1
            else:
                collected += 1
                wrong += not same_rect_lists(got, rects[sid])
    sup_row = {"failures": sup.failures, "healthy_entries": len(
        sup.healthy_devices), "placement_by_round": placed,
        "collected": collected, "dropped": dropped, "differ": wrong}
    ok = ([f[0] for f in sup.failures] == [2] and wrong == 0
          and 2 not in sup._assign.values() and collected > 0)
    # the default loop's frames/s over 2 streams, beside direct calls
    sup2 = StreamSupervisor(TAN_AOV, cfg, devices=[dev])
    rounds = 10
    rate = {"supervisor loop (2 streams)": [], "direct calls": []}
    loop_ok = True
    for turn in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn in (1, 2):
            for r in range(rounds):
                for sid in range(2):
                    sup2.submit(sid, host[(r + sid) % len(host)])
                for sid in range(2):
                    got = sup2.collect(sid)
                    loop_ok &= got is not None and same_rect_lists(
                        got, rects[(r + sid) % len(host)])
            key = "supervisor loop (2 streams)"
        else:
            for r in range(rounds):
                for sid in range(2):
                    live_rects(rect_frame(torch.from_numpy(
                        host[(r + sid) % len(host)]).to(dev), TAN_AOV, cfg))
            key = "direct calls"
        rate[key].append(2 * rounds / (time.perf_counter() - t0))
    sup_row.update(loop_equal=loop_ok, frames_per_s_in_turns=rate)
    out["supervisor"] = sup_row
    phase(f"phase 9 StreamSupervisor, 8 streams over 4 entries of the card: "
          f"{json.dumps(sup_row, default=str)}; card {card}")
    if not (ok and loop_ok):
        fail("the StreamSupervisor did not quarantine entry 2 cleanly or "
             "served a frame that differs from rect_frame")

    # two ranks on the card over gloo
    t0 = time.perf_counter()
    try:
        sim = subprocess.run(
            [sys.executable, "-m", "rectdetect_tpu_torch.dist.multihost_sim",
             "2", "1", f"{H}x{W}", "cuda"], cwd=ROOT, capture_output=True,
            text=True, timeout=SIM_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"multihost_sim did not end within {SIM_TIMEOUT} s")
    lines = [ln for ln in sim.stdout.splitlines() if ln.startswith("[rank")]
    for ln in lines:
        phase(f"phase 9 multihost_sim {ln}; card {card}")
    parity = [ln for ln in lines if "parity vs rect_frame: OK" in ln
              and "(own OK)" in ln]
    tiled_ok = [ln for ln in lines if "equal to rect_frame: True" in ln]
    phase(f"phase 9 multihost_sim 2 ranks x 1 device, 720p, over gloo: exit "
          f"{sim.returncode} in {time.perf_counter() - t0:.1f} s")
    if sim.returncode != 0 or len(parity) != 2 or len(tiled_ok) != 2:
        fail(f"multihost_sim failed (exit {sim.returncode}):\n"
             f"{sim.stdout[-3000:]}\n{sim.stderr[-3000:]}")

    # the dry run over a 2 x 2 mesh of the card
    out["dryrun"] = dryrun_multichip([dev] * 4)
    phase(f"phase 9 dryrun_multichip: {json.dumps(out['dryrun'])}; "
          f"card {card}")
    return out


def host_model() -> str:
    """The host CPU's `model name` line (as /proc/cpuinfo gives it, which
    may be "unknown") and its core count."""
    model = "no model name line"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} cores"


def write_lossless(path, frames):
    """Write frames to an .avi with the first of LOSSLESS_CODECS this cv2
    can write; returns that codec."""
    import cv2
    h, w = frames[0].shape[:2]
    for codec in LOSSLESS_CODECS:
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), 10.0,
                             (w, h), True)
        if wr.isOpened():
            for f in frames:
                wr.write(f)
            wr.release()
            return codec
        wr.release()
    fail(f"this cv2 writes none of {LOSSLESS_CODECS}")


def pump_frames(native, path, sleep_s=0.0, **kw):
    """Every frame a FramePump over path returns, and its backend."""
    pump = native.FramePump(path, **kw)
    time.sleep(sleep_s)
    got = []
    for _ in range(4 * PUMP_FRAMES):
        f = pump.next(timeout_ms=PUMP_TIMEOUT_MS)
        if f is None:
            break
        got.append(f)
    pump.close()
    return got, pump.backend


def host_runtime(torch, dev, card, phase6_plan):
    """Phase 10, the native host runtime (runtime/native.py): a timed
    build of the host libraries from nothing and the opencv4 probe; the
    library's plan forms against the plain ones on phase 6's plan and a
    synthetic one; the host packed Lab of all 2^24 colours against
    core/color.py's packing on the card, and at 720p host ms against the
    card's; the frame pump on a lossless file, in order and in realtime
    mode."""
    from pathlib import Path

    from bench import synth_frame
    from rectdetect_tpu_torch.core import color
    from rectdetect_tpu_torch.runtime import native

    out = {"host": host_model()}
    rt = native.load()
    out["first_use_build_s"] = rt.build_seconds
    with tempfile.TemporaryDirectory() as td:
        keep = native.BUILD_ROOT
        native.BUILD_ROOT = Path(td)
        try:
            core, video, probe, seconds = native.build()
        finally:
            native.BUILD_ROOT = keep
    out.update(build_s=seconds, opencv4=probe,
               video_library=video is not None,
               pump_backend="native" if rt.video is not None else "cv2")
    phase(f"phase 10 host build: the host libraries from nothing in "
          f"{seconds:.2f} s (g++ {' '.join(native.CXX_FLAGS)}); "
          f"pkg-config --exists opencv4: {probe}, so librectrt_video.so "
          f"{'built' if video else 'not built'} and FramePump's backend is "
          f"{out['pump_backend']}; first use in this run compiled for "
          f"{rt.build_seconds:.2f} s; host {out['host']}")
    if probe != (video is not None) or probe != rt.opencv4:
        fail("the video library does not follow the opencv4 probe")

    # the plan file: phase 6's, and a synthetic one written by either form
    with open(phase6_plan) as f:
        names = [ln.rstrip("\n")[1:-1] for ln in f if ln.startswith("[")]
    plan_ok = bool(names) and all(
        native.plan_load(phase6_plan, n) == native.plan_load_plain(
            phase6_plan, n) != {} for n in names)
    sections = {"NVIDIA H100 80GB HBM3|720x1280": {"zeta": "1", "alpha": "2"},
                "cpu|144x192": {"sparse_factor": "7", "max_groups": "320"}}
    with tempfile.TemporaryDirectory() as td:
        for save in (native.plan_save, native.plan_save_plain):
            p = os.path.join(td, f"{save.__name__}.txt")
            for n, e in sections.items():
                save(p, n, e)
            save(p, "cpu|144x192", {"max_groups": "256"})
            want = dict(sections, **{"cpu|144x192": {"max_groups": "256"}})
            plan_ok &= all(native.plan_load(p, n) == e
                           and native.plan_load_plain(p, n) == e
                           for n, e in want.items())
            plan_ok &= native.plan_load(p, "cpu|1x1") == {}
    out["plan"] = {"phase6_sections": len(names), "forms_agree": plan_ok}
    phase(f"phase 10 plan file: {json.dumps(out['plan'])}")
    if not plan_ok:
        fail("the library's plan forms differ from the plain ones")

    # packed Lab of every colour, host against the card
    allc = np.ascontiguousarray(np.arange(1 << 24, dtype="<u4").view(
        np.uint8).reshape(4096, 4096, 4)[..., :3])
    host = native.bgr_to_packedlab_host(allc)
    threads_equal = bool(np.array_equal(
        native.bgr_to_packedlab_host(allc, n_threads=1), host))
    gpu = color.pack_lab(color.bgr_to_labf(
        torch.from_numpy(allc).to(dev))).cpu().numpy()
    field = max(int(np.abs(((host >> s) & m) - ((gpu >> s) & m)).max())
                for s, m in ((0, 4095), (12, 1023), (22, 1023)))
    differ = int((host != gpu).sum())
    out["packed_lab"] = {"colours": 1 << 24, "differ": differ,
                         "max_field_diff": field,
                         "threads_1_equal_all": threads_equal}
    phase(f"phase 10 packed Lab, host against core/color.py on the card: "
          f"{json.dumps(out['packed_lab'])}")
    if field > 1 or differ > PACK_DIFFER_SHARE * (1 << 24) or \
            not threads_equal:
        fail("the host packed Lab is off the card's by more than its "
             "tolerance, or depends on the thread count")

    # 720p: host ms (median of 10) against the card's (CUDA events)
    frame = synth_frame(H, W, seed=0)
    native.bgr_to_packedlab_host(frame)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        native.bgr_to_packedlab_host(frame)
        walls.append((time.perf_counter() - t0) * 1e3)
    x = torch.from_numpy(frame).to(dev)
    card_ms = cuda_ms(torch, lambda: color.pack_lab(color.bgr_to_labf(x)), 10)
    out["ms_720p"] = {"host": statistics.median(walls), "card": card_ms}
    phase(f"phase 10 packed Lab at 720p: host {out['ms_720p']['host']:.3f} ms "
          f"(median of 10, all threads; {out['host']}) against the card's "
          f"bgr_to_labf+pack_lab {card_ms:.4f} ms (CUDA events, median of "
          f"10); card {card}")

    # the frame pump on a lossless file
    r = np.random.default_rng(0)
    src = [r.integers(0, 256, (48, 64, 3), dtype=np.uint8)
           for _ in range(PUMP_FRAMES)]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "pump.avi")
        codec = write_lossless(path, src)
        got, backend = pump_frames(native, path)
        in_order = len(got) == len(src) and all(
            np.array_equal(g, s) for g, s in zip(got, src))
        late, _ = pump_frames(native, path, sleep_s=0.2, ring=2,
                              realtime=True)
    idx = [next((i for i, s in enumerate(src) if np.array_equal(g, s)), -1)
           for g in late]
    run_ok = (bool(idx) and idx[-1] == len(src) - 1
              and all(a < b for a, b in zip(idx, idx[1:])))
    out["pump"] = {"codec": codec, "backend": backend,
                   "lossless_frames": len(got), "in_order_equal": in_order,
                   "realtime_frames": idx}
    phase(f"phase 10 frame pump on a {codec!r} .avi of {len(src)} frames: "
          f"{json.dumps(out['pump'])}")
    if backend != out["pump_backend"] or not in_order or not run_ok:
        fail("the frame pump lost, reordered or changed a frame")
    return out


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
               kernels=1, label="phase 3"):
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
        phase(f"{label} {name}: max_abs_err {err!r}  device {ms:.4f} ms per "
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

    # the redesigned kernels (csrc/distinct_bids.cu, csrc/edge_front.cu,
    # csrc/merge_mask.cu, csrc/scan.cu, csrc/thin.cu, csrc/despeckle2.cu,
    # csrc/morph.cu, csrc/quant_despeckle.cu, csrc/mkpl.cu,
    # csrc/links_ccl.cu, csrc/ccl.cu, csrc/hyp.cu): their registers and
    # spills; distinct_bids and edge_front timed in turns with the parent
    # commit's kernels where they were brought along (build/parent/)
    parent = parent_kernels(torch, _build)
    redesign = {"card": card, "ptxas": {
        k: ptxas_lines(_build.ptxas_log.get(k, "not rebuilt in this run"))
        for k in ("distinct_bids.cu", "edge_front.cu", "merge_mask.cu",
                  "scan.cu", "thin.cu", "despeckle2.cu", "morph.cu",
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

    # edge_front in turns with the parent's kernel, bit-equal to it; and
    # the 1/sqrt forms held equal on every float of ivlen > 1e-10
    def ef_call():
        return hopper_grad.edge_front(labb)
    entry = {"bits_differ_from_plain": nbits}
    if parent is not None:
        def parent_call():
            return parent["edge_front"](labb)
        em_q, vec_q = parent_call()
        if not (torch.equal(em_q, em) and torch.equal(vec_q, vec)):
            fail("edge_front: the parent's kernel differs")
        entry["parent_bit_equal"] = True
        entry["parent_bits_differ_from_plain"] = int(
            (em_q != em_p).sum() + (vec_q != vec_p).sum())
        entry["parent_turns"] = in_turns(ef_call, parent_call)
    checked, n_bad, first_bad = rsqrt_mismatches(torch, _build)
    entry["rsqrt"] = {"floats_checked": checked, "differ": n_bad,
                      "first_differing": first_bad}
    redesign["edge_front"] = entry
    phase(f"phase 3 edge_front: {json.dumps(entry)}")
    if n_bad:
        fail(f"edge_front's __frsqrt_rn differs from the float64 1/sqrt on "
             f"{n_bad} floats above 1e-10 (first {first_bad!r})")

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

    # K2 in both modes: within FLOAT_ATOL of the plain version with
    # edge_thin > 0 equal
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
        redesign["thin"][mode] = entry
        phase(f"phase 3 thinthres[{mode}]: {json.dumps(entry)}")

    # mkpl's device time at 0, 1 and all rounds (the fixed cost and the
    # cost per round)
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
    for op in ("satsum", "max"):
        if not torch.equal(hopper_scan.seg_scan_sorted(skey, sval, op, thre),
                           hopper_scan.seg_scan_plain(skey, sval, op, thre)):
            fail(f"seg_scan_sorted[{op}] differs from the plain version")
    # the timed function is seg_total_sorted: keys and values read once,
    # the totals written once; ops: a combine per element to sum each run
    # and one more to spread its total
    record("seg_scan", "scan.cu", "rectdetect_tpu/ops/pallas_scan.py:55",
           0.0,
           lambda: hopper_scan.seg_total_sorted(skey, sval, thre),
           cuda_ms(torch, lambda: hopper_scan.seg_total_plain(
               skey, sval, thre), 5), nb(skey, sval, tot), 2 * sp,
           kernels=hopper_scan.TOTAL_KERNELS)

    # the strength table's shape
    entry = {"rows": sp, "live_rows": int((skey < H * W).sum()),
             "runs": int((skey[1:] != skey[:-1]).sum()) + 1}
    redesign["seg_scan"] = entry
    phase(f"phase 3 seg_scan: {json.dumps(entry)}")

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

    entry = {"edge_pixels": int((strong > 0).sum()),
             "mask_pixels": int(mask.sum())}
    redesign["merge_mask"] = entry
    phase(f"phase 3 merge_mask: {json.dumps(entry)}")

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

    redesign["despeckle2"] = {"regions": int(torch.unique(seg0).numel()),
                              "absorbed": int((seg != seg0).sum())}
    phase(f"phase 3 despeckle2: {json.dumps(redesign['despeckle2'])}")

    boundary, _ = boundary_labels(seg, cfg)
    bids = hopper_bids.distinct_bids(boundary)
    bids_p = hopper_bids.distinct_bids_plain(boundary)
    ndiff = sum(int((a != b).sum()) for a, b in zip(bids, bids_p))
    # the pixels whose 7x7 window holds an id: the only ones that merge
    # row lists (csrc/distinct_bids.cu)
    held = torch.nn.functional.max_pool2d(
        (boundary > 0).float()[None, None], 7, 1, 3)[0, 0] > 0
    phase(f"phase 3 distinct_bids: {ndiff} slot values differ "
          f"({int((boundary >= 0).sum())} boundary pixels, "
          f"{int(held.sum())} pixels whose window holds an id)")
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

    # distinct_bids in turns with the parent's kernel, bit-equal to it
    def db_call():
        return hopper_bids.distinct_bids(boundary)
    entry = {"ids": int((boundary > 0).sum()),
             "windows_holding_an_id": int(held.sum())}
    if parent is not None:
        def parent_call():
            return parent["distinct_bids"](boundary)
        if not torch.equal(parent_call(), torch.stack(bids)):
            fail("distinct_bids: the parent's kernel differs")
        entry["parent_bit_equal"] = True
        entry["parent_turns"] = in_turns(db_call, parent_call)
    redesign["distinct_bids"] = entry
    phase(f"phase 3 distinct_bids: {json.dumps(entry)}")

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

    # ---- 6. photographs, video, stage images ----------------------------
    host_dir = tempfile.TemporaryDirectory()
    phase6_plan = os.path.join(host_dir.name, "plan_torch.txt")
    rows_default = photo_corpus(torch, dev, card, cfg, drive, counters,
                                plan_out=phase6_plan)
    video(torch, dev, card, cfg, drive, counters)
    stage_images(torch, bgr, cfg)

    # ---- 7. EXTENDED_CONFIG and the other off-default capabilities -----
    extended(torch, dev, card, bgr, k3_inputs, drive, counters, record,
             records, rows_default)

    # ---- 8. the width-tiled path ---------------------------------------
    tiled(torch, dev, card, bgr, drive, counters, record, records)

    # ---- 9. the stream axis ---------------------------------------------
    streams(torch, dev, card, drive, counters, record, records)

    # ---- 10. the native host runtime -------------------------------------
    host_runtime(torch, dev, card, phase6_plan)
    host_dir.cleanup()

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

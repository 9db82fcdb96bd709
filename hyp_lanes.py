#!/usr/bin/env python3
"""Time the hyp kernel (rectdetect_tpu_torch/csrc/hyp.cu) at 1, 2, 4 and 8
threads per hull candidate, in turns, on the 720p hypotheses of
bench.synth_frame(720, 1280, seed=0) and on the seed-0 384-group corpus.

    python3 hyp_lanes.py

Run from the root of a checkout, on a machine with one CUDA card and nvcc.
Each lane count is a copy of csrc/ under build/hyp_lanes/<n>/ with hyp.cu's
kLanes set to n, built into a library of its own; each build's corners and
ok are held equal to the plain version's, NaN in the same places, before
it is timed.  Prints the card's name and power limit, then one JSON object:
for each input, each lane count's device ms per call in each of 3 turns
(chip_smoke.device_ms, one turn of 10 calls per lane count, the lane counts
in turn).
"""

from __future__ import annotations

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

LANES = (1, 2, 4, 8)
KLANES = r"constexpr int kLanes = \d+;"


def build_at(torch, build_mod, text, n):
    """hyp_fn and its library's launch counter, hyp.cu with kLanes = n."""
    out_dir = os.path.join(ROOT, "build", "hyp_lanes", str(n))
    src = os.path.join(out_dir, "csrc")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "rectdetect_tpu_torch", "csrc"), src)
    with open(os.path.join(src, "hyp.cu"), "w") as f:
        f.write(re.sub(KLANES, f"constexpr int kLanes = {n};", text))
    lib = chip_smoke.build_kernels(build_mod, src, out_dir, ("hyp",))
    lib.rd_launch_count.restype = build_mod.QUERIES["rd_launch_count"][1]
    return (chip_smoke.hyp_entry(torch, lib, f"hyp at {n} lanes"),
            types.SimpleNamespace(launch_count=lib.rd_launch_count))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card")
    sys.path.insert(0, ROOT)
    from bench import synth_frame
    from rectdetect_tpu_torch import parity
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG as cfg
    from rectdetect_tpu_torch.geometry import quad
    from rectdetect_tpu_torch.ops import _build, fp
    from rectdetect_tpu_torch.pipeline.rect import rect_hypotheses
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    with open(os.path.join(ROOT, "rectdetect_tpu_torch", "csrc",
                           "hyp.cu")) as f:
        text = f.read()
    if len(re.findall(KLANES, text)) != 1:
        fail("hyp.cu does not define kLanes once")
    with ThreadPoolExecutor(len(LANES)) as pool:
        futures = {n: pool.submit(build_at, torch, _build, text, n)
                   for n in LANES}
        kernels = {n: f.result() for n, f in futures.items()}

    hyp = rect_hypotheses(torch.from_numpy(synth_frame(720, 1280, seed=0))
                          .to(dev), cfg)
    corpus = [torch.from_numpy(a).to(dev) for a in parity.segment_groups(
        0, 2 * cfg.max_groups, cfg.max_group_segs, 1.0)]
    hv = cfg.hull_max_vertices
    sr2 = fp.f32(quad.SHORT_RATIO * quad.SHORT_RATIO)
    result = {}
    for name, segs, valid in (("720p hypotheses", hyp.segs, hyp.valid),
                              ("corpus seed 0", *corpus)):
        want = quad.reduce_groups(segs, valid, hv)
        for n, (hyp_fn, _) in kernels.items():
            if not chip_smoke.same_quads(torch, hyp_fn(segs, valid, hv, sr2),
                                         want):
                fail(f"hyp at {n} lanes on {name} differs from the plain "
                     f"version")
        sweep = {n: [] for n in LANES}
        for _ in range(3):
            for n, (hyp_fn, counter) in kernels.items():
                times, per_call = chip_smoke.device_ms(
                    torch, counter,
                    lambda: hyp_fn(segs, valid, hv, sr2), turns=1)
                if per_call != 1:
                    fail(f"hyp at {n} lanes: {per_call} kernels per call")
                sweep[n].append(times[0])
        result[name] = {"groups": int(valid.any(1).sum()),
                        "lanes_device_ms": sweep}
    print(json.dumps({"hyp_lanes": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

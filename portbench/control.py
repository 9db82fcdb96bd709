"""The control of the check that decides `correct`: the plain reference put
in the program's place and computed in the precision below the
configuration's float32 (portbench/reference/frame.py, lowp), compared
with the float32 reference by the cell's own comparison on as many frames
as a run checks.  Every number it reads is an upper reading of that
number's limit; a limit at or above it would let the control pass.

    python -m portbench.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed and, last, the smallest reading of each
number over the seeds beside the cell's limits.  It needs no card
(--device cpu), but at the cell's own sizes it belongs on one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import compare, harness, scenes


def control_numbers(cell: harness.Cell, seed: int, device) -> dict:
    """The control's numbers for one seed: the scenes of as many frames as
    a run checks, drawn from the seed."""
    t = cell.traffic
    h, w, n = int(t["height"]), int(t["width"]), int(t["ring"])
    rings = [scenes.ring(seed, n, h, w, device, first=c * n)
             for c in range(int(t["cameras"]))]
    k = int(t["sample_steps"]) * int(t["cameras"])
    rng = np.random.default_rng([*scenes.seed_words(seed), 23])
    ids = [int(i) for i in rng.choice(n * len(rings), size=min(k, n * len(rings)),
                                      replace=False)]
    ref = harness.reference_lives(cell, ids, rings, device, h, w)
    low = harness.reference_lives(cell, ids, rings, device, h, w, lowp=True)
    return compare.COMPARE[cell.config["entry"]](
        [(low[i], ref[i]) for i in ids])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args(argv)
    cell = harness.resolve(harness.load_benchmark(), a.workload)
    readings = []
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, a.device)
        readings.append(nums)
        print(json.dumps({"seed": seed, "control": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    low = {k: min(r[k] for r in readings) for k in readings[0]}
    print(json.dumps({"workload": a.workload, "control_min": low,
                      "limits": cell.config["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

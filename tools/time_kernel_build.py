#!/usr/bin/env python3
"""Time the port's kernel build two ways, on a machine with nvcc: the
build of rectdetect_tpu_torch/ops/_build.py (one nvcc process per source,
all started together, then one link) against one nvcc call that compiles
and links every source.

    python3 tools/time_kernel_build.py [rounds]

Each round times single, parallel, parallel, single, from nothing built,
into build/time_kernel_build/ (removed afterwards).  Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from rectdetect_tpu_torch.ops import _build  # noqa: E402


def single(out: Path) -> float:
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o",
                    str(out / "single.so"), *map(str, _build.sources())],
                   check=True, capture_output=True)
    return time.perf_counter() - t0


def parallel(out: Path) -> float:
    _build.BUILD_ROOT = out
    t0 = time.perf_counter()
    _build.build()
    return time.perf_counter() - t0


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    base = ROOT / "build" / "time_kernel_build"
    times = {"single": [], "parallel": []}
    try:
        for _ in range(rounds):
            for name in ("single", "parallel", "parallel", "single"):
                shutil.rmtree(base, ignore_errors=True)
                base.mkdir(parents=True)
                times[name].append((single if name == "single"
                                    else parallel)(base))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps({"sources": len(_build.sources()),
                      "cpus": os.cpu_count(), "seconds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

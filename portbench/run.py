"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer metrics from a traced run.  The run needs
as many CUDA devices as the cell's `chips`; without them it prints no
result and exits with 2.  It exits with 3, printing no result, if a module
of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# torch's CPU threads: the program drives the card from one host thread
THREADS = 2
# caches of compilers the program could use, at fixed paths in the checkout
CACHES = {"TRITON_CACHE_DIR": "build/portbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(CHECKOUT / v)
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))

    from portbench import harness
    cell = harness.resolve(harness.load_benchmark(), a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(THREADS)
    line, err = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                                 T_PROCESS, device="cuda:0")
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for s in err:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

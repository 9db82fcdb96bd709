"""One run of one cell: find the cell's files by name, make its scenes from
the seed, warm up, measure for the window, trace a steady stretch of it
where asked, check what the window produced against the plain reference,
and build the result line.

Set-up (`setup_s`) is everything from the start of the process to the
start of the window.  The window is a closed loop of driver steps for
`seconds`; what is in flight when it closes is drained and counts for
nothing but the check.  Every frame handed to the program in the window is
a candidate for the check, those drained after it too: a sample of the
driver's steps, drawn from the seed by reservoir sampling, is compared
with the reference once the window has closed, the device's peak memory
has been read and the program's state freed, and the checked frames'
capacities are read (portbench/capacity.py).  A run that checked no frame,
or whose checked frames overflow a capacity, is not correct.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import compare, scenes
from portbench.loops import Setting, Spans

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "rectdetect_tpu")
# seconds of warm-up at the least, every scene of the ring once at the least
WARM_SECONDS = 5.0
# where in the window the traced stretch starts, as a share of it
TRACE_AT = 0.5


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What metric readers read (portbench/metrics)."""
    seconds: float
    t_start: float
    t_end: float
    setup_s: float
    spans: Spans
    frames: list = field(default_factory=list)   # [Done] without results
    submitted: int = 0
    trace: dict | None = None


def read_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration and traffic
    files and the metrics it reports."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(read_json("configs", Path(configs[w["config"]]["file"]).stem))
    traffic = read_json("traffic", w["traffic"])
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if metric_applies(m, name)],
                [m for m in bench["per_layer"] if metric_applies(m, name)])


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


def driver_module(cell: Cell):
    drivers = cell.traffic["drivers"]
    entry = cell.config["entry"]
    if entry not in drivers:
        raise KeyError(f"traffic {cell.traffic['name']!r} has no driver for "
                       f"the {entry!r} entry path")
    return importlib.import_module(f"portbench.drivers.{drivers[entry]}")


def size_key(h: int, w: int) -> str:
    return f"{w}x{h}"


def pipeline_config(base, config: dict, h: int, w: int):
    """`base` (a DEFAULT_CONFIG) with the configuration's overrides and
    those of the frame size."""
    over = dict(config.get("overrides", {}))
    over.update(config.get("by_size", {}).get(size_key(h, w), {}))
    return dataclasses.replace(base, **over)


def tan_aov(config: dict) -> float:
    return math.tan(math.radians(config.get("aov_deg", 72) / 2))


def forbidden_modules() -> list[str]:
    """The modules loaded in this process whose top-level name is one the
    benchmark may not load, compared whole (rectdetect_tpu_torch is not
    rectdetect_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Reservoir:
    """A uniform sample of k items of a stream, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items = []
        self._n = 0
        self._rng = np.random.default_rng([*scenes.seed_words(seed), 17])

    def offer(self, item) -> None:
        self._n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self._rng.integers(0, self._n))
            if j < self.k:
                self.items[j] = item


def reference_lives(cell: Cell, scene_ids, rings, device, h: int, w: int,
                    lowp: bool = False) -> dict:
    """{scene: the reference's rectangles or live segments} for each scene,
    from the same host frames: the per-pixel stages in plain PyTorch on
    `device`, the rest on the host."""
    import torch

    from portbench.reference import frame
    from portbench.reference.config import DEFAULT_CONFIG as REF_DEFAULT
    cfg = pipeline_config(REF_DEFAULT, cell.config, h, w)
    n = len(rings[0])
    c = cell.config
    out = {}
    with torch.no_grad():
        for s in sorted(set(scene_ids)):
            f = torch.from_numpy(rings[s // n][s % n]).to(device)
            out[s] = frame.rect_frame(f, tan_aov(c), cfg, lowp) \
                if c["entry"] == "rect" else \
                frame.poly_frame(f, cfg, c["minerror"], c["size_thre"],
                                 c["strength"], lowp)
    return out


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_process: float, device="cuda") -> tuple[dict, list[str]]:
    """One run of `cell`; returns (the result line's object, the lines of
    the comparison for standard error)."""
    import torch

    from portbench import capacity
    from portbench import trace as tr
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG

    dev = torch.device(device)
    t = cell.traffic
    h, w = int(t["height"]), int(t["width"])
    cfg = pipeline_config(DEFAULT_CONFIG, cell.config, h, w)
    rings = [scenes.ring(seed, int(t["ring"]), h, w, dev,
                         first=c * int(t["ring"]))
             for c in range(int(t["cameras"]))]
    spans = Spans()
    setting = Setting(cfg, tan_aov(cell.config), cell.config, t, rings, dev,
                      spans)
    drv = driver_module(cell).make(setting)
    warm_until = time.perf_counter() + WARM_SECONDS
    steps = 0
    while steps < int(t["ring"]) or time.perf_counter() < warm_until:
        drv.step()
        steps += 1
    drv.drain()
    _sync(dev)
    if trace:
        tr.warm_profiler(drv.step)
        drv.drain()
        _sync(dev)

    wraps = tr.Wraps(spans)
    if trace:
        for m in cell.per_layer:
            mod = reader(m["name"])
            for module, attr in getattr(mod, "WRAPS", ()):
                wraps.add(module, attr, mod.SPAN)
    sample = Reservoir(int(t["sample_steps"]), seed)
    frames_per_step = int(t["cameras"])
    stretch, calls = None, tr.LibraryCalls()
    trace_steps = int(t["trace_steps"])
    stretch_frames = 0
    done = []
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    t_end = t_start + seconds
    submitted = 0
    try:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if trace and stretch is None and now - t_start >= \
                    TRACE_AT * seconds:
                _sync(dev)
                stretch = tr.Stretch()
                spans.annotate = True
                calls.on()
                stretch.start()
            out = drv.step()
            submitted += frames_per_step
            if spans.annotate:
                stretch_frames += frames_per_step
                if stretch_frames >= trace_steps * frames_per_step:
                    stretch.stop()
                    calls.off()
                    spans.annotate = False
            done.extend(out)
            if out:
                sample.offer(out)
        tail = drv.drain()
        _sync(dev)
        if tail:
            sample.offer(tail)
    finally:
        wraps.undo()
        calls.off()
    if spans.annotate:       # the window closed inside the stretch
        stretch.stop()
        spans.annotate = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run = Run(seconds, t_start, t_end, setup_s, spans,
              [d._replace(result=None) for d in done + tail], submitted)
    if stretch is not None:
        run.trace = tr.summarize(stretch.events(), stretch_frames, calls.calls)
    del drv, setting
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    picked = [d for step in sample.items for d in step]
    t_ref = time.perf_counter()
    ref = reference_lives(cell, [d.scene for d in picked], rings, dev, h, w)
    numbers = compare.COMPARE[cell.config["entry"]](
        [(d.result, ref[d.scene]) for d in picked])
    t_ref_end = time.perf_counter()
    n_ring = len(rings[0])
    with torch.no_grad():
        flags = [capacity.flags(cell.config["entry"], torch.from_numpy(
            rings[s // n_ring][s % n_ring]).to(dev), cfg, cell.config)
            for s in sorted({d.scene for d in picked})]
    over = capacity.overflowing(flags)
    correct, table = compare.judge(numbers, cell.config["limits"])
    correct = correct and bool(picked) and not over

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": submitted,
            "failed": submitted - len(done) - len(tail), "metrics": metrics,
            "device": dev_info}
    if run.trace is not None:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
        line["kernels"] = {k: run.trace[k] for k in (
            "kernels", "port_kernels", "library_kernels", "port_kernel_s",
            "port_bound_s", "frames")}
    line["capacity"] = {"overflowing": over, "frames": len(flags),
                        "largest": capacity.summary(flags)}
    line["checked"] = {"steps": len(sample.items), "frames": len(picked),
                       "scenes": sorted({d.scene for d in picked}),
                       "items": sum(len(d.result) for d in picked),
                       "reference_s": t_ref_end - t_ref}
    line["compared"] = table
    err = [f"capacity: {len(flags)} checked frames, overflowing "
           f"{over or 'none'}"]
    err += [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in table.items()]
    return line, err

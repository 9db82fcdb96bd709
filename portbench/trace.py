"""The traced run's instruments, all on the benchmark's side: ranges around
the program's stage functions, a record of the port's kernel library
calls, and a torch.profiler trace of a steady stretch of the window,
reduced to device busy time, launches, the port's kernels' time against
their bounds, and the idle gaps by the host range open during each."""

from __future__ import annotations

import functools
import importlib
import json
import os
import tempfile
from collections import defaultdict

from portbench import roofline, stats

# trace event categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# entries of each breakdown list
TOP = 10


class Wraps:
    """Replace functions where their callers look them up with a version
    that records a span (and, while tracing, a profiler range) around each
    call; undo restores them."""

    def __init__(self, spans):
        self._spans = spans
        self._saved = []

    def add(self, module: str, attr: str, span: str) -> None:
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        spans = self._spans

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with spans.span(span):
                return fn(*a, **k)

        self._saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)

    def undo(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


class LibraryCalls:
    """Record every call into the port's kernel library (_build.launch):
    entry point, arguments and kernels, while on."""

    def __init__(self):
        self.calls = []
        self._build = None
        self._orig = None

    def on(self) -> None:
        from rectdetect_tpu_torch.ops import _build
        self._build, self._orig = _build, _build.launch
        orig, calls = self._orig, self.calls

        def launch(name, device, *args, kernels=1):
            calls.append((name, args, kernels))
            return orig(name, device, *args, kernels=kernels)

        _build.launch = launch

    def off(self) -> None:
        if self._build is not None:
            self._build.launch = self._orig
            self._build = None


class Stretch:
    """torch.profiler over a stretch of steps, inside a range named
    portbench.stretch; its chrome trace goes to a temporary file that
    events() reads and deletes."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._rf = None

    def start(self) -> None:
        self._prof.start()
        self._rf = self._torch.profiler.record_function("portbench.stretch")
        self._rf.__enter__()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self._prof.stop()

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


def warm_profiler(step) -> None:
    """One profiled step, thrown away: the first profiler of a process
    starts its device tracing, which takes seconds, so set-up pays that
    and not the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step()
        torch.cuda.synchronize()


def _name(ev) -> str:
    """A device event's name for the breakdown: a kernel's base name, a
    copy's or memset's own, or its category where the trace gives none."""
    n = ev.get("name", "")
    if not n:
        return f"({ev.get('cat', 'device')})"
    return roofline.kernel_base(n) if ev.get("cat") == "kernel" else n


def summarize(events, frames: int, calls) -> dict | None:
    """The stretch's numbers from its trace events (chrome trace, times in
    microseconds), the frames handed to the program in it, and the kernel
    library calls recorded in it.  None where the trace holds no stretch
    range or no device work."""
    xs = [e for e in events if e.get("ph") == "X"]
    host = [e for e in xs if e.get("cat") == "user_annotation"]
    stretch = [e for e in host if e.get("name") == "portbench.stretch"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not stretch or not dev:
        return None
    lo = stretch[0]["ts"]
    hi = lo + stretch[0]["dur"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy_us = stats.busy(spans, lo, hi)
    kernels = [e for e in dev if e.get("cat") == "kernel"
               and lo <= e["ts"] < hi]
    port = [e for e in kernels if roofline.is_port_kernel(e["name"])]
    by_op = defaultdict(float)
    for e in dev:
        s, t = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if t > s:
            by_op[_name(e)] += (t - s) * 1e-6
    ranges = [e for e in host if e.get("name", "").startswith("portbench.")
              and e["name"] != "portbench.stretch"]
    by_gap = defaultdict(float)
    for s, t in stats.gaps(spans, lo, hi):
        mid = (s + t) / 2
        open_ = [e for e in ranges if e["ts"] <= mid < e["ts"] + e["dur"]]
        inner = min(open_, key=lambda e: e["dur"], default=None)
        name = inner["name"][len("portbench."):] if inner else "other host"
        by_gap[name] += (t - s) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "frames": frames,
        "kernels": len(kernels),
        "port_kernels": len(port),
        "port_kernel_s": sum(e["dur"] for e in port) * 1e-6,
        "library_kernels": sum(k for _, _, k in calls),
        "port_bound_s": sum(roofline.bound_seconds(n, a) for n, a, _ in calls),
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                            key=lambda x: -x[1])[:TOP],
    }

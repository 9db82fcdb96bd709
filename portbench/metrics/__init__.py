"""Metric readers, one module a metric, found by the metric's name in
BENCHMARK.json.  Each has read(run) -> a number, or None where the run
holds nothing to read (the harness then leaves the metric out), and may
have WRAPS: (module, attribute) pairs of the program that the traced run
wraps in a span named SPAN.  `run` is portbench.harness.Run."""

from __future__ import annotations


def in_window(run):
    """The frames whose result reached the host inside the window."""
    return [f for f in run.frames if f.t_done <= run.t_end]


def span_ms_per_frame(run, name: str):
    """Host ms a frame in spans `name` that started inside the window."""
    spans = run.spans.within(name, run.t_start, run.t_end)
    if not spans or not run.submitted:
        return None
    return sum(t - s for s, t in spans) * 1e3 / run.submitted

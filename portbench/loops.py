"""What the drivers share: the record of a finished frame, the spans the
benchmark records around its calls into the program, and the setting a
driver is made from."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, NamedTuple


class Done(NamedTuple):
    """A frame whose result reached the host."""
    frame: int        # its number in the run, from 0
    camera: int
    scene: int        # the scene index it was made from
    t_submit: float   # host clock when it was handed to the program
    t_done: float     # host clock when its result came back
    result: Any       # the host result: live rectangles or segments


class Spans:
    """Host-clock spans by name, kept in memory.  With `annotate` each span
    is also a torch.profiler range named portbench.<name>."""

    def __init__(self):
        self.by_name = defaultdict(list)
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.annotate:
            import torch
            rf = torch.profiler.record_function(f"portbench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.by_name[name].append((t0, t1))

    def within(self, name: str, lo: float, hi: float):
        """The spans of `name` that start in [lo, hi)."""
        return [s for s in self.by_name.get(name, ()) if lo <= s[0] < hi]


@dataclass
class Setting:
    """What a driver is made from: the program's config and angle of view,
    the benchmark's configuration and traffic files, the scenes of each
    camera as host arrays, the device and the spans recorder."""
    cfg: Any
    tan_aov: float
    config: dict
    traffic: dict
    rings: list        # [camera][k] -> (H,W,3) uint8 ndarray
    device: Any
    spans: Spans

    def scene_of(self, camera: int, k: int) -> int:
        return camera * len(self.rings[0]) + k % len(self.rings[0])


class VideoLoop:
    """One camera through an enqueue/poll detector, pipelined as vidrect
    and vidpoly run it: each step hands the next frame to `enqueue` and,
    once `in_flight` frames are queued, polls the oldest.  A closed loop:
    the next frame goes in only when the step before it is done."""

    def __init__(self, det, s: Setting):
        self._det = det
        self._s = s
        self._ring = s.rings[0]
        self._in_flight = int(s.traffic["in_flight"])
        self._queued = []
        self._n = 0

    def step(self) -> list[Done]:
        i = self._n
        self._n += 1
        k = i % len(self._ring)
        t0 = time.perf_counter()
        with self._s.spans.span("enqueue"):
            self._det.enqueue(self._ring[k])
        self._queued.append((i, k, t0))
        if len(self._queued) < self._in_flight:
            return []
        return [self._poll()]

    def _poll(self) -> Done:
        i, k, t0 = self._queued.pop(0)
        with self._s.spans.span("poll"):
            res = self._det.poll()
        return Done(i, 0, self._s.scene_of(0, k), t0, time.perf_counter(),
                    res)

    def drain(self) -> list[Done]:
        return [self._poll() for _ in range(len(self._queued))]

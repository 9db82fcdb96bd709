"""Double-buffered video detectors (port of rectdetect_tpu/pipeline/video.py,
one device).

The reference pipelines frame n's GPU work against frame n-1's CPU stage
with a two-page event system (oclrect_enqueueTask/pollTask,
oclrect.c:1248-1278; loop vidrect.cpp:159-205).  Here `enqueue` copies the
frame into one of two pinned host buffers, uploads it with a
non-blocking copy and queues the frame's path on the detector's own CUDA
stream; `poll` waits for the oldest frame in flight and turns its result
into the host list.  Each pinned buffer is reused only after the event
recorded behind its upload has passed.  The frame path still reads the
device from the host part way through (the polyline's segmented sums
size a bincount on the host), so `enqueue` returns only after that part
of the frame has run: the overlap with the caller's drawing and capture is
what remains after it.

With device="cpu", asked for explicitly, both run in step on the host.

`TiledVideoRectDetector` is the same pair over the width-tiled path
(dist/tile.py): each frame is uploaded to the first tile's device, cut into
its tiles there, and rect_step_tiled runs on the `TileGroup`.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame
from rectdetect_tpu_torch.pipeline.rect import live_rects, rect_frame


class _Pipelined:
    """enqueue/poll over `run(frame tensor)` and `host(result)`."""

    def __init__(self, device):
        self._dev = torch.device(device)
        self._pending = deque()
        if self._dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"no CUDA device for {self._dev}; pass "
                                   "device='cpu' to run on the host")
            self._stream = torch.cuda.Stream(self._dev)
            self._bufs = [None, None]
            self._copied = [None, None]
            self._n = 0

    def _run(self, frame: torch.Tensor):
        raise NotImplementedError

    def _host(self, result):
        raise NotImplementedError

    def enqueue(self, bgr: np.ndarray) -> None:
        """Queue one (H,W,3) uint8 BGR frame."""
        if self._dev.type != "cuda":
            self._pending.append(
                (self._run(torch.from_numpy(np.ascontiguousarray(bgr))
                           .to(self._dev)), None))
            return
        i = self._n & 1
        self._n += 1
        buf = self._bufs[i]
        if buf is None or tuple(buf.shape) != bgr.shape:
            buf = self._bufs[i] = torch.empty(bgr.shape, dtype=torch.uint8,
                                              pin_memory=True)
        elif self._copied[i] is not None:
            self._copied[i].synchronize()    # its last upload has run
        buf.numpy()[...] = bgr
        with torch.cuda.stream(self._stream):
            frame = buf.to(self._dev, non_blocking=True)
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record(self._stream)
            result = self._run(frame)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._pending.append((result, done))

    def poll(self):
        """Wait for the oldest frame in flight and return its host result;
        None if nothing is in flight."""
        if not self._pending:
            return None
        result, done = self._pending.popleft()
        if done is None:
            return self._host(result)
        done.synchronize()
        with torch.cuda.stream(self._stream):
            return self._host(result)


class VideoRectDetector(_Pipelined):
    """enqueue/poll pair mirroring oclrect_enqueueTask/pollTask: rect_frame
    per frame, poll gives live_rects' list."""

    def __init__(self, tan_aov: float, cfg: PipelineConfig = DEFAULT_CONFIG,
                 device="cuda"):
        super().__init__(device)
        self._tan = tan_aov
        self._cfg = cfg

    def _run(self, frame):
        return rect_frame(frame, self._tan, self._cfg)

    def _host(self, result):
        return live_rects(result)


class TiledVideoRectDetector(_Pipelined):
    """enqueue/poll over the width-tiled rect step: each frame's width is
    cut over `group`'s tiles (halo-exchanged stencils, the cross-tile CCLs,
    summed tables; dist/tile.py), the geometry tail runs on the first
    tile's device; poll gives live_rects' list.  For frames (4K and up)
    where one device cannot hold the pipeline at rate."""

    def __init__(self, tan_aov: float, group,
                 cfg: PipelineConfig = DEFAULT_CONFIG):
        super().__init__(group.devices[0])
        self._tan = tan_aov
        self._cfg = cfg
        self._group = group

    def enqueue(self, bgr: np.ndarray) -> None:
        w = bgr.shape[1]
        if w % self._group.n_tiles:
            raise ValueError(f"width {w} not divisible by "
                             f"{self._group.n_tiles} tiles")
        super().enqueue(bgr)

    def _run(self, frame):
        from rectdetect_tpu_torch.dist.tile import rect_step_tiled
        return rect_step_tiled(self._group, self._group.split(frame),
                               self._tan, cfg=self._cfg)

    def _host(self, result):
        return live_rects(result)


class VideoPolyDetector(_Pipelined):
    """The same pair over poly_frame; poll gives live_segments' list."""

    def __init__(self, cfg: PipelineConfig = DEFAULT_CONFIG,
                 minerror: float = 1.0, size_thre: int = 10,
                 strength: int = 2000, device="cuda"):
        super().__init__(device)
        self._cfg = cfg
        self._args = (minerror, size_thre, strength)

    def _run(self, frame):
        return poly_frame(frame, self._cfg, *self._args)

    def _host(self, result):
        return live_segments(result[0])


class FpsMeter:
    """Frames per second, reported about once a second
    (vidrect.cpp:194-199)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._t = clock()
        self._n = 0
        self._last = 0

    def tick(self) -> float | None:
        """Count a frame; returns the rate since the last report when more
        than a second has passed, else None."""
        self._n += 1
        t = self._clock()
        if t - self._t > 1.0:
            fps = (self._n - self._last) / (t - self._t)
            self._t = t
            self._last = self._n
            return fps
        return None

"""Stream/frame data parallelism (port of rectdetect_tpu/dist/stream.py).

A stack of frames is cut over the stream axis of a StreamMesh
(dist/mesh.py) and each row runs the single-device pipeline on its block.
Per-frame work is independent: nothing crosses devices but the frames in
and the results out.

The JAX package relies on asynchronous dispatch: a call returns at once
and the chips run side by side.  Here every distinct device has one host
worker thread (`worker`), which runs the work for that device under the
device's own CUDA stream, so the rows on different cards overlap, and rows
that share a card run in turn on its worker.  A job waits on the caller's
current stream of its device before it starts (an upload made there is
complete) and synchronizes its own stream before its future resolves, so
its tensors may be read from any stream.  A CUDA error inside a job
surfaces as the future's exception.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.dist.mesh import StreamMesh, visible_devices
from rectdetect_tpu_torch.pipeline.poly import poly_frames
from rectdetect_tpu_torch.pipeline.rect import (live_rects, rect_frame,
                                                rect_frames)

_workers: dict = {}
_streams: dict = {}
_workers_lock = threading.Lock()


def worker(device) -> ThreadPoolExecutor:
    """The single host worker of `device`, made on first use."""
    dev = torch.device(device)
    with _workers_lock:
        if dev not in _workers:
            _workers[dev] = ThreadPoolExecutor(
                1, thread_name_prefix=f"rectdetect-{dev}")
        return _workers[dev]


def _job(dev: torch.device, after, fn, args):
    if dev.type != "cuda":
        return fn(*args)
    with _workers_lock:
        if dev not in _streams:
            _streams[dev] = torch.cuda.Stream(dev)
        stream = _streams[dev]
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        stream.wait_stream(after)
        out = fn(*args)
    stream.synchronize()
    return out


def run_on(device, fn, *args) -> Future:
    """fn(*args) on `device`'s worker, under its CUDA stream; the future of
    its result."""
    dev = torch.device(device)
    after = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    return worker(dev).submit(_job, dev, after, fn, args)


def _sharded(frames, mesh: StreamMesh, fn, *args):
    blocks = mesh.stream_split(frames)
    futures = [run_on(blk.device, fn, blk, *args) for blk in blocks]
    return [f.result() for f in futures]


def rect_frames_sharded(frames, tan_aov: float, mesh: StreamMesh,
                        cfg: PipelineConfig = DEFAULT_CONFIG):
    """frames: (B, H, W, 3) uint8, B divisible by the mesh's stream count.
    Each stream row runs rect_frames on its block of B / n_stream frames,
    on the row's first device; returns a RectResult with a leading B axis
    on the mesh's first device."""
    res = _sharded(frames, mesh, rect_frames, tan_aov, cfg)
    return type(res[0])(*(mesh.gather(list(f)) for f in zip(*res)))


def poly_frames_sharded(frames, mesh: StreamMesh,
                        cfg: PipelineConfig = DEFAULT_CONFIG,
                        minerror: float = 1.0, size_thre: int = 20,
                        strength: int = 500):
    """The poly pipeline sharded the same way: (SegmentArena with a leading
    B axis on every field, lsid (B,H,W)) on the mesh's first device."""
    res = _sharded(frames, mesh, poly_frames, cfg, minerror, size_thre,
                   strength)
    arena = type(res[0][0])(*(mesh.gather(list(f))
                              for f in zip(*(a for a, _ in res))))
    return arena, mesh.gather([lsid for _, lsid in res])


class StreamSupervisor:
    """Fault-tolerant multi-stream serving (the JAX package's
    StreamSupervisor; the reference fails fast on any CL error,
    oclhelper.c:113-138).

    Each stream is pinned to one device and served there alone, so a
    failing card cannot stall the others.  A device whose dispatch
    (`run_fn`) or readback (`read_fn`) raises is quarantined and its
    streams move to the healthy device with the fewest streams (ties to
    the lowest index); frames in flight on it are dropped, as a dropped
    camera frame would be (the pipeline keeps no state between frames).

    `run_fn(bgr, device)` returns a handle and `read_fn(handle)` the host
    value.  By default run_fn submits the frame to the device's worker,
    which uploads it and runs rect_frame there under its own CUDA stream,
    and returns the concurrent.futures.Future; read_fn waits on it and
    returns live_rects' list, so a CUDA error raised in the job
    quarantines the device.  Tests inject failing stand-ins.  `devices`:
    default every visible CUDA device; ["cpu"] to serve on the host."""

    def __init__(self, tan_aov: float = 1.0,
                 cfg: PipelineConfig = DEFAULT_CONFIG, devices=None,
                 run_fn=None, read_fn=None, max_in_flight: int = 2):
        self._devices = list(devices if devices is not None
                             else visible_devices())
        if not self._devices:
            raise RuntimeError("StreamSupervisor: no CUDA device; pass "
                               "devices=['cpu'] to serve on the host")
        self._healthy = {i: True for i in range(len(self._devices))}
        self._assign: dict = {}              # stream id -> device index
        self._pending: dict = {}             # stream id -> [(index, handle)]
        self._max_in_flight = max_in_flight
        self._failures: list = []            # (device index, repr(err))
        if run_fn is None:
            def run_fn(bgr, device):
                dev = torch.device(device)

                def one(frame):
                    return rect_frame(torch.from_numpy(frame).to(dev),
                                      tan_aov, cfg)
                return run_on(dev, one, np.ascontiguousarray(bgr))
        if read_fn is None:
            def read_fn(fut):
                return live_rects(fut.result())
        self._run = run_fn
        self._read = read_fn

    # -- placement ---------------------------------------------------------

    def _load(self, di: int) -> int:
        return sum(1 for d in self._assign.values() if d == di)

    def _place(self, sid) -> int:
        alive = [i for i in self._healthy if self._healthy[i]]
        if not alive:
            raise RuntimeError("StreamSupervisor: no healthy devices left")
        di = self._assign.get(sid)
        if di is None or not self._healthy[di]:
            di = min(alive, key=lambda i: (self._load(i), i))
            self._assign[sid] = di
        return di

    def _quarantine(self, di: int, err: BaseException):
        self._healthy[di] = False
        self._failures.append((di, repr(err)))
        for sid, d in list(self._assign.items()):
            if d == di:
                del self._assign[sid]        # re-placed on next submit
                self._pending.pop(sid, None)  # in-flight frames dropped

    # -- serving -----------------------------------------------------------

    def submit(self, sid, bgr) -> bool:
        """Dispatch one frame of stream `sid`; returns False if the frame
        was shed (back-pressure).  Retries once on a fresh device if the
        first dispatch kills its device."""
        for _ in range(2):
            di = self._place(sid)
            q = self._pending.setdefault(sid, [])
            if len(q) >= self._max_in_flight:
                return False
            try:
                q.append((di, self._run(bgr, self._devices[di])))
                return True
            except Exception as e:          # noqa: BLE001 (device loss)
                self._quarantine(di, e)
        return False

    def collect(self, sid):
        """Wait for stream `sid`'s oldest frame in flight; returns the
        host-side result, or None if nothing is in flight (including
        frames lost to a quarantined device)."""
        q = self._pending.get(sid)
        if not q:
            return None
        di, handle = q.pop(0)
        try:
            return self._read(handle)
        except Exception as e:              # noqa: BLE001 (device loss)
            self._quarantine(di, e)
            return None

    @property
    def healthy_devices(self):
        return [self._devices[i] for i in self._healthy if self._healthy[i]]

    @property
    def failures(self):
        return list(self._failures)

"""Multi-process serving over torch.distributed (port of
rectdetect_tpu/dist/multihost.py).

The multi-host story is stream parallelism: every process (rank) ingests
its own streams and runs the per-frame pipeline on its own devices.  The
global stream axis is every rank's local devices in rank order; rank r
feeds the slots [lo, hi) of its own devices.  Per-frame work never crosses
processes, only frame ingest and results do.

Launch one process per host, each with the same coordinator address
(host:port of rank 0) and its own rank; `python -m
rectdetect_tpu_torch.dist.multihost_sim` runs the ranks on one machine
over loopback.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from rectdetect_tpu_torch.dist.mesh import make_mesh, visible_devices

# this process's devices, in slot order: every visible CUDA device unless
# init chose others (the CPU, or a share of the cards)
_local: list | None = None


def init(coordinator: str | None = None, num_hosts: int = 1,
         host_id: int = 0, devices=None) -> None:
    """Join the process group of `num_hosts` ranks over a TCP store at
    `coordinator` ("host:port" of rank 0); a no-op for one host.
    `devices`: the devices this rank serves, in slot order (a device may
    repeat); default every visible CUDA device.

    The backend is gloo, on host tensors.  Per-frame work never crosses
    processes: the collectives here carry only the slot map and host-side
    results, which the host reads anyway, so there is nothing for NCCL to
    move between cards.  NCCL would also refuse two ranks on one card,
    which is how one machine with one card runs several ranks."""
    global _local
    if devices is not None:
        _local = [torch.device(d) for d in devices]
    if num_hosts > 1:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_hosts, rank=host_id)


def local_devices() -> list:
    return list(_local) if _local is not None else visible_devices()


def device_map() -> tuple[list, int]:
    """(every rank's local device list in rank order, this rank), learned
    with all_gather_object; ([local devices], 0) outside a process
    group."""
    mine = [str(d) for d in local_devices()]
    if not (dist.is_available() and dist.is_initialized()):
        return [mine], 0
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, mine)
    return lists, dist.get_rank()


def global_stream_mesh(n_tile: int = 1):
    """Mesh over every rank's devices in rank order: (stream, tile).  The
    entries of other ranks name devices of their processes."""
    lists, _ = device_map()
    devs = [d for lst in lists for d in lst]
    return make_mesh(len(devs) // n_tile, n_tile, devs)


def local_stream_slots() -> tuple[int, int]:
    """The global stream slots this rank owns, [lo, hi): the frames this
    rank should ingest."""
    lists, rank = device_map()
    lo = sum(len(lst) for lst in lists[:rank])
    return lo, lo + len(lists[rank])


def run_streams(frame_sources, tan_aov, n_tile: int = 1, cfg=None):
    """Serve this rank's streams on its devices.

    frame_sources: callables () -> (H,W,3) uint8 BGR or None, one per local
    stream slot (e.g. runtime.native.FramePump.next).  Yields each batch's
    RectResult for the local slots (leading axis: the slots, in order),
    until a source runs dry.  One rank degenerates to batched
    multi-stream serving."""
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG
    from rectdetect_tpu_torch.dist.stream import rect_frames_sharded

    cfg = cfg or DEFAULT_CONFIG
    lo, hi = local_stream_slots()
    n_local = hi - lo
    if len(frame_sources) != n_local:
        raise ValueError(f"host owns {n_local} stream slots, "
                         f"got {len(frame_sources)} sources")
    mesh = make_mesh(n_local // n_tile, n_tile, local_devices())
    while True:
        frames = []
        for src in frame_sources:
            f = src()
            if f is None:
                return
            frames.append(f)
        yield rect_frames_sharded(torch.from_numpy(np.stack(frames)),
                                  tan_aov, mesh, cfg)

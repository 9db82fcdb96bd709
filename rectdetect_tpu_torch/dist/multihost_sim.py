"""Multi-process simulation of the stream-sharded pipeline: each rank is
one process that plays a host with its own devices, joins a
torch.distributed group over loopback (gloo) and serves its stream slots.

    python -m rectdetect_tpu_torch.dist.multihost_sim [n_ranks]
        [devices_per_rank] [HxW] [cpu|cuda] [timed_batches]

Defaults: 2 ranks, 1 device a rank, 72x96, cuda, 3 timed batches.  With
cuda, rank r's device i is CUDA device (r * devices_per_rank + i) mod the
visible count, so two ranks on a one-card machine share the card.  Two phases, each rank:

  1. its slots' frames (bench.synth_frame, one per global slot, seed = the
     slot) through rect_frames_sharded over its devices, each result
     bit-equal to rect_frame on the same frame, then the median of the
     timed batches as frames/s; the ranks' valid counts summed over gloo
     and each rank's own slots checked in the sum;
  2. one stream per rank, its frame width-tiled over the rank's devices
     (dist/tile.py rect_step_tiled), bit-equal to rect_frame.

One line per rank and phase; exit code 0 when every rank passed.
"""

from __future__ import annotations

import math
import os
import socket
import statistics
import subprocess
import sys
import time


def _say(line: str) -> None:
    """One line to stdout in one write: the ranks share the pipe."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (line + "\n").encode())


def _sync(devices) -> None:
    import torch
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def worker(rank: int, n_ranks: int, per_rank: int, res: str, kind: str,
           reps: int, port: int) -> int:
    import torch
    import torch.distributed as dist

    from bench import synth_frame
    from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
    from rectdetect_tpu_torch.dist import multihost
    from rectdetect_tpu_torch.dist.mesh import TileGroup, make_mesh
    from rectdetect_tpu_torch.dist.stream import rect_frames_sharded
    from rectdetect_tpu_torch.dist.tile import rect_step_tiled
    from rectdetect_tpu_torch.pipeline.rect import rect_frame

    torch.set_num_threads(1)
    if kind == "cuda":
        n_cards = torch.cuda.device_count()
        if not n_cards:
            raise RuntimeError("cuda asked for and no CUDA device visible")
        devs = [torch.device("cuda", (rank * per_rank + i) % n_cards)
                for i in range(per_rank)]
    else:
        devs = [torch.device("cpu")] * per_rank
    multihost.init(f"127.0.0.1:{port}", n_ranks, rank, devs)
    h, w = (int(v) for v in res.split("x"))
    tan = math.tan(math.radians(72) / 2)
    # the plain pose of every group is slow on the host: a narrow config
    # there, the default on the card
    cfg = DEFAULT_CONFIG if kind == "cuda" else PipelineConfig(max_groups=16)

    # ---- phase 1: the stream slots -------------------------------------
    gmesh = multihost.global_stream_mesh()
    lo, hi = multihost.local_stream_slots()
    n_global = gmesh.n_stream
    frames = torch.stack([torch.from_numpy(synth_frame(h, w, seed=s))
                          for s in range(lo, hi)])
    mesh = make_mesh(hi - lo, 1, devs)
    got = rect_frames_sharded(frames, tan, mesh, cfg)
    equal = all(
        all(torch.equal(a[i].cpu(), b.cpu()) for a, b in zip(
            got, rect_frame(frames[i].to(devs[i]), tan, cfg)))
        for i in range(hi - lo))
    times = []
    for _ in range(reps):
        _sync(devs)
        t0 = time.perf_counter()
        out = rect_frames_sharded(frames, tan, mesh, cfg)
        out.valid.cpu()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    counts = torch.zeros(n_global, dtype=torch.int64)
    counts[lo:hi] = got.valid.sum(dim=1).cpu()
    if n_ranks > 1:
        dist.all_reduce(counts)          # slot s from its owner only
    own = counts[lo:hi].tolist() == got.valid.sum(dim=1).cpu().tolist()
    _say(f"[rank {rank}] {n_global} global slots, slots [{lo}, {hi}) on "
         f"{', '.join(map(str, devs))}: batch of {hi - lo} frames at "
         f"{w}x{h} in {dt * 1e3:.3f} ms (median of {len(times)}) -> "
         f"{(hi - lo) / dt:.3f} frames/s; parity vs rect_frame: "
         f"{'OK' if equal else 'FAIL'}; valid counts of all slots "
         f"{counts.tolist()} (own {'OK' if own else 'FAIL'})")

    # ---- phase 2: one stream a rank, width-tiled over its devices -------
    cfg2 = PipelineConfig(ls_capacity=256, max_groups=16,
                          max_group_segs=16, number_doublings=10)
    group = TileGroup(devs)
    fr2 = torch.from_numpy(synth_frame(h, w, seed=100 + rank))
    res2 = rect_step_tiled(group, group.split(fr2.to(devs[0])), tan,
                           cfg=cfg2)
    ref = rect_frame(fr2.to(devs[0]), tan, cfg2)
    equal2 = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(res2, ref))
    _say(f"[rank {rank}] tiled step over {group.n_tiles} tiles: RectResult "
         f"equal to rect_frame: {equal2} ({int(ref.valid.sum())} valid)")
    if n_ranks > 1:
        dist.barrier()
        dist.destroy_process_group()
    return 0 if equal and own and equal2 else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) > 1 and argv[1] == "--worker":
        return worker(int(argv[2]), int(argv[3]), int(argv[4]), argv[5],
                      argv[6], int(argv[7]), int(argv[8]))
    n_ranks = int(argv[1]) if len(argv) > 1 else 2
    per_rank = int(argv[2]) if len(argv) > 2 else 1
    res = argv[3] if len(argv) > 3 else "72x96"
    kind = argv[4] if len(argv) > 4 else "cuda"
    reps = int(argv[5]) if len(argv) > 5 else 3
    if kind not in ("cpu", "cuda"):
        sys.exit(f"device kind {kind!r}: cpu or cuda")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rectdetect_tpu_torch.dist.multihost_sim",
         "--worker", str(r), str(n_ranks), str(per_rank), res, kind,
         str(reps), str(port)], cwd=root, env=env) for r in range(n_ranks)]
    try:
        rc = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("exit codes:", rc, flush=True)
    return max(abs(c) for c in rc)


if __name__ == "__main__":
    sys.exit(main())

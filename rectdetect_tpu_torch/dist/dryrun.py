"""The multi-device dry run (the counterpart of the JAX package's
__graft_entry__.dryrun_multichip): one detection step over an
n_stream x n_tile mesh, frames over the stream axis and each frame's width
over its row's tiles, held bit for bit against the single-device frame.

    python -m rectdetect_tpu_torch.dist.dryrun [n_devices | cpu N]

Without arguments every visible CUDA device is an entry; `cpu N` runs N
entries on the host.  On a one-card machine pass the card N times from
Python: dryrun_multichip([torch.device("cuda", 0)] * 4).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.dist import tile as dtile
from rectdetect_tpu_torch.dist.mesh import make_mesh, visible_devices
from rectdetect_tpu_torch.dist.stream import run_on
from rectdetect_tpu_torch.pipeline.rect import rect_frame


def dryrun_frames(n_stream: int, h: int, w: int) -> np.ndarray:
    """The dry run's scene, one copy a stream: one quad inside the left
    half and one crossing the middle column (the seam of two tiles), so
    the halo exchange and the cross-tile CCL seams decide a detection."""
    rng = np.random.default_rng(0)
    frames = np.full((n_stream, h, w, 3), 80, np.uint8)
    frames[:, 40:150, 60:200] = (200, 170, 60)
    yy, xx = np.mgrid[0:h, 0:w]
    q = ((xx - 0.3 * yy > w * 0.42) & (xx - 0.3 * yy < w * 0.72) &
         (yy + 0.1 * xx > h * 0.45) & (yy + 0.1 * xx < h * 0.92))
    frames[:, q] = (60, 180, 220)
    frames += rng.integers(0, 4, frames.shape).astype(np.uint8)
    return frames


def dryrun_multichip(devices, h: int = 256, w: int = 512) -> dict:
    """One step over the mesh of `devices`: n_tile = 2 when their count is
    even, else 1.  Each stream's frame runs rect_step_tiled on its row
    (halo 8) beside the front end's edge map labelled across the tiles
    (ccl_tiled) and its edge pixels summed over the tiles; the edge
    energy is that sum averaged over the streams.  Asserts some valid
    hypothesis and every stream's RectResult equal to rect_frame on the
    row's first device, bit for bit (the JAX dry run allows atol 1e-3 on
    the corners).  Prints the JAX dry run's line; returns its fields."""
    devices = [torch.device(d) for d in devices]
    n_tile = 2 if len(devices) % 2 == 0 else 1
    n_stream = len(devices) // n_tile
    mesh = make_mesh(n_stream, n_tile, devices)
    # calibrated-scale capacities for a 256x512 frame
    cfg = PipelineConfig(ls_capacity=2048, max_groups=64,
                         max_group_segs=32)
    wl = w // n_tile
    w = wl * n_tile
    frames = dryrun_frames(n_stream, h, w)
    tan_aov = math.tan(math.radians(72.0) / 2)

    def step(row, frame):
        tiles = row.split(torch.from_numpy(frame).to(row.devices[0]))
        _, eb = dtile.edge_frontend_tiled(row, tiles, 8, cfg)
        dtile.ccl_tiled(row, eb, 0)
        energy = row.psum([x.to(torch.float32).sum() for x in eb])[0]
        res = dtile.rect_step_tiled(row, tiles, tan_aov, halo=8, cfg=cfg)
        ref = rect_frame(torch.from_numpy(frame).to(row.devices[0]),
                         tan_aov, cfg)
        return res, float(energy), ref

    futures = [run_on(row.devices[0], step, row, frames[i])
               for i, row in enumerate(mesh.rows)]
    out = [f.result() for f in futures]
    nvalid = sum(int(res.valid.sum()) for res, _, _ in out)
    energy = float(np.mean([e for _, e, _ in out]))
    assert nvalid > 0, "multichip step detected nothing"
    for i, (res, _, ref) in enumerate(out):
        assert int(ref.valid.sum()) > 0
        for f in ref._fields:
            assert torch.equal(getattr(res, f).cpu(), getattr(ref, f).cpu()), \
                f"stream {i}: {f} differs from rect_frame"
    n_ref = int(out[0][2].valid.sum())
    print(f"dryrun_multichip: mesh=({n_stream} stream x {n_tile} tile), "
          f"frames={frames.shape}, valid hypotheses={nvalid}, "
          f"edge energy={energy:.3f}, "
          f"parity vs single-device: OK "
          f"({n_ref} accepted hypotheses match)", flush=True)
    return {"n_stream": n_stream, "n_tile": n_tile,
            "frames": list(frames.shape), "valid": nvalid,
            "edge_energy": energy, "accepted_per_stream": n_ref}


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) > 1 and argv[1] == "cpu":
        devices = ["cpu"] * (int(argv[2]) if len(argv) > 2 else 4)
    else:
        devices = visible_devices()
        if len(argv) > 1:
            devices = devices[:int(argv[1])]
        if not devices:
            sys.exit("no CUDA device; `cpu N` runs N entries on the host")
    dryrun_multichip(devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())

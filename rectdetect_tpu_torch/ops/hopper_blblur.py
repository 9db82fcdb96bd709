"""Kernel #12 blblur: the edge-limited blur, `iters` rounds of a horizontal
and a vertical pass over the packed-Lab plane.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_blblur.py:_pass_kernel
(blblur_pallas_blocked) and, since they compute the same function, its
whole-frame (_kernel) and fused (_fused_kernel) forms, whose block and
fuse arguments only tiled the frame for VMEM.  CUDA source: csrc/blblur.cu.
The function is bound by device memory, 12 B per pixel for all the passes
(input and edge map read once, result written once).  The kernel finds
every pixel's arm lengths once per call (they depend on the edge map
alone), then runs F rounds per launch in shared-memory tiles with a halo
of 4F pixels: 1 + ceil(iters / F) launches per call, F = FUSE, the
fastest of the compiled F on the H100 (chip_smoke.py's sweep).  Integer
arithmetic only: the result equals the plain version
(ops/regions.py:blblur) exactly.

The x0/w_total offset form of the width-tiled path (dist/tile.py) is the
same launches with the tile's global x and the frame's width: the arm
pass breaks the horizontal arms at the true frame border and tests the
vertical corner against it; the fused launches do not change.

A leading frame axis (B,H,W) is the batch form: the same 1 + ceil(iters /
F) launches for all B frames (grid z = frame, every arm, tile and halo
inside its own frame's plane), the counterpart of the JAX package's vmap
over the Pallas kernel in rect_frames; the offset form takes one frame.

`blblur` takes the plain version for CPU tensors and launches the kernel
for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import blblur as blblur_plain

launches = 0
# the launches of the x0/w_total offset form (counted in `launches` too)
offset_launches = 0

# rounds fused per launch, and the output tile (rows, columns) the kernel
# compiles for each (csrc/blblur.cu:fused)
TILES = {1: (32, 128), 2: (24, 128), 5: (48, 96), 10: (32, 48)}
FUSE = 1


def launch_count(iters: int, fuse: int = FUSE) -> int:
    """Kernel launches of one call: the arm pass and ceil(iters / fuse)
    fused launches (none for iters <= 0, which copies)."""
    return 0 if iters <= 0 else 1 + -(-iters // fuse)


def blblur_fused(packed: torch.Tensor, edge: torch.Tensor, iters: int,
                 fuse: int, x0: int = 0,
                 w_total: int | None = None) -> torch.Tensor:
    """The kernel with `fuse` rounds per launch (CUDA tensors only)."""
    if fuse not in TILES:
        raise ValueError(f"fuse must be one of {sorted(TILES)}, got {fuse}")
    lead, b, h, w = _build.frame_stack(packed, "packed", torch.int32)
    _build.check(edge, "edge", torch.int32, packed.shape)
    gx0, wt = _build.frame_columns(b, x0, w_total, w)
    out = torch.empty_like(packed)
    tmp = torch.empty_like(packed)
    arms = torch.empty((*lead, h, w), dtype=torch.int16, device=packed.device)
    _build.launch("rd_blblur", packed.device, packed.data_ptr(),
                  edge.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                  arms.data_ptr(), h, w, b, int(iters), int(fuse), gx0, wt,
                  kernels=launch_count(iters, fuse) if h and w else 0)
    _build.count(globals(), "launches")
    if x0 != 0 or w_total is not None:
        _build.count(globals(), "offset_launches")
    return out


def blblur(packed: torch.Tensor, edge: torch.Tensor, iters: int = 10,
           x0: int = 0, w_total: int | None = None) -> torch.Tensor:
    """packed ([B,]H,W) int32 packed Lab, edge ([B,]H,W) int32 0/1 ->
    ([B,]H,W) int32; B frames in the launches of one.  x0: the global x of
    column 0, w_total: the frame's width (None: W)."""
    if not _build.on_cuda(packed, edge):
        return blblur_plain(packed, edge, iters, x0, w_total)
    return blblur_fused(packed, edge, iters, FUSE, x0, w_total)

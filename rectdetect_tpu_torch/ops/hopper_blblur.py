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

`blblur` takes the plain version for CPU tensors and launches the kernel
for CUDA tensors; there is no other path.  The x0/w_total offset form of
the width-tiled multi-device path is not ported and raises.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import blblur as blblur_plain

launches = 0

# rounds fused per launch, and the output tile (rows, columns) the kernel
# compiles for each (csrc/blblur.cu:fused)
TILES = {1: (32, 128), 2: (24, 128), 5: (48, 96), 10: (32, 48)}
FUSE = 1


def launch_count(iters: int, fuse: int = FUSE) -> int:
    """Kernel launches of one call: the arm pass and ceil(iters / fuse)
    fused launches (none for iters <= 0, which copies)."""
    return 0 if iters <= 0 else 1 + -(-iters // fuse)


def blblur_fused(packed: torch.Tensor, edge: torch.Tensor, iters: int,
                 fuse: int) -> torch.Tensor:
    """The kernel with `fuse` rounds per launch (CUDA tensors only)."""
    global launches
    if fuse not in TILES:
        raise ValueError(f"fuse must be one of {sorted(TILES)}, got {fuse}")
    h, w = packed.shape
    _build.check(packed, "packed", torch.int32, (h, w))
    _build.check(edge, "edge", torch.int32, (h, w))
    out = torch.empty_like(packed)
    tmp = torch.empty_like(packed)
    arms = torch.empty((h, w), dtype=torch.int16, device=packed.device)
    _build.launch("rd_blblur", packed.device, packed.data_ptr(),
                  edge.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                  arms.data_ptr(), h, w, int(iters), int(fuse))
    launches += 1
    return out


def blblur(packed: torch.Tensor, edge: torch.Tensor, iters: int = 10,
           x0: int = 0, w_total: int | None = None) -> torch.Tensor:
    """packed (H,W) int32 packed Lab, edge (H,W) int32 0/1 -> (H,W) int32."""
    if x0 != 0 or w_total is not None:
        raise NotImplementedError("the x0/w_total offset form of blblur "
                                  "(width-tiled frames) is not ported")
    if not _build.on_cuda(packed, edge):
        return blblur_plain(packed, edge, iters)
    return blblur_fused(packed, edge, iters, FUSE)

"""Kernel #12 blblur: the edge-limited blur, `iters` rounds of a horizontal
and a vertical pass over the packed-Lab plane.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_blblur.py:_pass_kernel
(blblur_pallas_blocked) and, since they compute the same function, its
whole-frame (_kernel) and fused (_fused_kernel) forms, whose block and
fuse arguments only tiled the frame for VMEM.  CUDA source: csrc/blblur.cu,
one thread per pixel and one launch per pass (2 * iters per call).  The
function is bound by device memory, 12 B per pixel for all the passes
(input and edge map read once, result written once); this kernel moves
those 12 B in every pass.  Integer arithmetic only: the result equals the
plain version (ops/regions.py:blblur) exactly.

`blblur` takes the plain version for CPU tensors and launches the kernel
for CUDA tensors; there is no other path.  The x0/w_total offset form of
the width-tiled multi-device path is not ported and raises.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import blblur as blblur_plain

launches = 0


def blblur(packed: torch.Tensor, edge: torch.Tensor, iters: int = 10,
           x0: int = 0, w_total: int | None = None) -> torch.Tensor:
    """packed (H,W) int32 packed Lab, edge (H,W) int32 0/1 -> (H,W) int32."""
    global launches
    if x0 != 0 or w_total is not None:
        raise NotImplementedError("the x0/w_total offset form of blblur "
                                  "(width-tiled frames) is not ported")
    if not _build.on_cuda(packed, edge):
        return blblur_plain(packed, edge, iters)
    h, w = packed.shape
    _build.check(packed, "packed", torch.int32, (h, w))
    _build.check(edge, "edge", torch.int32, (h, w))
    out = torch.empty_like(packed)
    tmp = torch.empty_like(packed)
    _build.launch("rd_blblur", packed.device, packed.data_ptr(),
                  edge.data_ptr(), out.data_ptr(), tmp.data_ptr(), h, w,
                  int(iters))
    launches += 1
    return out

"""Kernel #8 despeckle2: region sizes, then regions of <= thre pixels take
the label of their largest 3x3 neighbour (calcSize + despeckle2,
oclrect.cl:336-371).

Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
_despeckle2_kernel (despeckle2_pallas) with the size pass before it.  CUDA
source: csrc/despeckle2.cu, a warp-aggregated atomicAdd histogram and one
thread per pixel for the absorption; bound by device memory (8 B per
pixel).

`sizes_despeckle2` takes the plain version (ops/regions.py) for a CPU
tensor and launches the kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import (
    sizes_despeckle2 as sizes_despeckle2_plain)

launches = 0


def sizes_despeckle2(label: torch.Tensor, thre: int = 16) -> torch.Tensor:
    """label (H,W) int32, values in [0, H*W) -> (H,W) int32."""
    global launches
    if not _build.on_cuda(label):
        return sizes_despeckle2_plain(label, thre)
    h, w = label.shape
    _build.check(label, "label", torch.int32, (h, w))
    out = torch.empty_like(label)
    sizes = torch.empty((h * w,), dtype=torch.int32, device=label.device)
    _build.launch("rd_despeckle2", label.device, label.data_ptr(),
                  sizes.data_ptr(), out.data_ptr(), h, w, int(thre),
                  kernels=2)
    launches += 1
    return out

"""Kernel #8 despeckle2: region sizes, then regions of <= thre pixels take
the label of their largest 3x3 neighbour (calcSize + despeckle2,
oclrect.cl:336-371).

Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
_despeckle2_kernel (despeckle2_pallas) with the size pass before it.  CUDA
source: csrc/despeckle2.cu, one cooperative launch in three phases two
grid barriers apart: per-tile tables of distinct labels zero and then add
the sizes (one global atomic per label and tile), and each pixel of a
small region reads its neighbours from the tile's shared-memory window;
bound by device memory (8 B per pixel).

A leading frame axis (B,H,W) is one launch of the batch form: the grid
stays at the co-resident bound and its blocks walk the B frames' tiles
between the same two barriers, each tile inside its own frame's planes
(labels, sizes, output), the counterpart of the JAX package's vmap over
the Pallas kernel in rect_frames.

`sizes_despeckle2` takes the plain version (ops/regions.py) for a CPU
tensor and launches the kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import (
    sizes_despeckle2 as sizes_despeckle2_plain)

# kernels launched per call
KERNELS = 1

launches = 0


def sizes_despeckle2(label: torch.Tensor, thre: int = 16) -> torch.Tensor:
    """label ([B,]H,W) int32, values in [0, H*W) -> ([B,]H,W) int32; B
    frames in one launch."""
    if not _build.on_cuda(label):
        return sizes_despeckle2_plain(label, thre)
    _, b, h, w = _build.frame_stack(label, "label", torch.int32)
    out = torch.empty_like(label)
    # scratch: the kernel zeroes the entries the labels name
    sizes = torch.empty((b * h * w,), dtype=torch.int32, device=label.device)
    _build.launch("rd_despeckle2", label.device, label.data_ptr(),
                  sizes.data_ptr(), out.data_ptr(), h, w, b, int(thre),
                  kernels=KERNELS)
    _build.count(globals(), "launches")
    return out

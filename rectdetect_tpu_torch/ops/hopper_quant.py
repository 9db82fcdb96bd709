"""Kernel #5 quant_despeckle: quantize the packed-Lab plane to n levels per
channel, then give on-edge pixels the nearest-colour off-edge 3x3
neighbour.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
_quant_despeckle_kernel (quant_despeckle_pallas).  CUDA source:
csrc/quant_despeckle.cu, one launch: each block quantizes its tile's
window (the tile and a one-pixel halo) once into shared memory, then
despeckles from there, so the quantized plane stays out of device memory;
bound by device memory (8 B read and 4 B written per pixel).  Its floats
are the jitted JAX composition's (ops/regions.py), so it equals the plain
version (ops/regions.py:quantize_despeckle) exactly.

A leading frame axis (B,H,W) is one launch of the batch form (grid z =
frame; a pixel's 3x3 neighbours stop at its own frame's border), the
counterpart of the JAX package's vmap over the Pallas kernel in
rect_frames.

`quantize_despeckle` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import (
    quantize_despeckle as quantize_despeckle_plain)

# kernels launched per call
KERNELS = 1

launches = 0


def quantize_despeckle(packed: torch.Tensor, edge_mag: torch.Tensor,
                       n0: int = 24, n1: int = 24,
                       n2: int = 24) -> torch.Tensor:
    """packed ([B,]H,W) int32, edge_mag ([B,]H,W) float32 -> ([B,]H,W)
    int32; B frames in one launch."""
    if not _build.on_cuda(packed, edge_mag):
        return quantize_despeckle_plain(packed, edge_mag, n0, n1, n2)
    _, b, h, w = _build.frame_stack(packed, "packed", torch.int32)
    _build.check(edge_mag, "edge_mag", torch.float32, packed.shape)
    out = torch.empty_like(packed)
    _build.launch("rd_quant_despeckle", packed.device, packed.data_ptr(),
                  edge_mag.data_ptr(), out.data_ptr(), h, w, b, int(n0),
                  int(n1), int(n2), kernels=KERNELS)
    _build.count(globals(), "launches")
    return out

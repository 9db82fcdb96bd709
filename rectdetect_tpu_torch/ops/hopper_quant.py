"""Kernel #5 quant_despeckle: quantize the packed-Lab plane to n levels per
channel, then give on-edge pixels the nearest-colour off-edge 3x3
neighbour.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
_quant_despeckle_kernel (quant_despeckle_pallas).  CUDA source:
csrc/quant_despeckle.cu, one thread per pixel that quantizes itself and
its neighbours on the fly, so the quantized plane stays out of device
memory; bound by device memory (12 B per pixel).  Its floats are the
jitted JAX composition's (ops/regions.py), so it equals the plain version
(ops/regions.py:quantize_despeckle) exactly.

`quantize_despeckle` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import (
    quantize_despeckle as quantize_despeckle_plain)

launches = 0


def quantize_despeckle(packed: torch.Tensor, edge_mag: torch.Tensor,
                       n0: int = 24, n1: int = 24,
                       n2: int = 24) -> torch.Tensor:
    """packed (H,W) int32, edge_mag (H,W) float32 -> (H,W) int32."""
    global launches
    if not _build.on_cuda(packed, edge_mag):
        return quantize_despeckle_plain(packed, edge_mag, n0, n1, n2)
    h, w = packed.shape
    _build.check(packed, "packed", torch.int32, (h, w))
    _build.check(edge_mag, "edge_mag", torch.float32, (h, w))
    out = torch.empty_like(packed)
    _build.launch("rd_quant_despeckle", packed.device, packed.data_ptr(),
                  edge_mag.data_ptr(), out.data_ptr(), h, w, int(n0),
                  int(n1), int(n2))
    launches += 1
    return out

"""Kernel #7 distinct_bids: up to 4 distinct positive boundary ids in each
pixel's 7x7 window, in scan order (the slot scan of reduceLS,
oclrect.cl:441-447).

Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
_distinct_bids_kernel (distinct_bids_pallas).  CUDA source:
csrc/distinct_bids.cu: 8 x 32 tiles staged with a 3-pixel halo; a tile
whose window holds no id writes zeros; elsewhere each staged row's taps
that hold an id are found from ballot bit words, the row lists (the
first <= 4 distinct ids of a row's 7 taps) are made once per staged
pixel, and each pixel whose window holds an id merges its rows' lists in
dy order.  Bound by device memory (4 B read and 16 B written per
pixel).

`distinct_bids` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.shifts import pad2d, shifted

launches = 0


def distinct_bids_plain(boundary: torch.Tensor) -> list[torch.Tensor]:
    """Up to 4 distinct positive ids of the 7x7 window (zero outside the
    frame), in (dy, dx) scan order; an id joins the first free slot unless
    a slot holds it already.  Returns 4 (H,W) int32 maps, 0 where a slot
    stays free."""
    h, w = boundary.shape
    bp = pad2d(boundary, 3, "zero")
    slots = [torch.zeros_like(boundary) for _ in range(4)]
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            b = shifted(bp, 3, dy, dx, h, w)
            fresh = b > 0
            for s in slots:
                fresh = fresh & (s != b)
            for i in range(4):
                put = fresh & (slots[i] == 0)
                slots[i] = torch.where(put, b, slots[i])
                fresh = fresh & ~put
    return slots


def distinct_bids(boundary: torch.Tensor) -> list[torch.Tensor]:
    """boundary (H,W) int32 ids, -1 background -> 4 slot maps (H,W) int32."""
    if not _build.on_cuda(boundary):
        return distinct_bids_plain(boundary)
    h, w = boundary.shape
    _build.check(boundary, "boundary", torch.int32, (h, w))
    out = torch.empty((4, h, w), dtype=torch.int32, device=boundary.device)
    _build.launch("rd_distinct_bids", boundary.device, boundary.data_ptr(),
                  out.data_ptr(), h, w)
    _build.count(globals(), "launches")
    return list(out.unbind(0))

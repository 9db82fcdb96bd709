"""Kernel #6 merge_mask: the positive junction map of the strong-edge
labels and the merge mask built on it (simpleJunction + mkMergeMask0/1,
oclrect.cl:74-95, 246-287).

Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
_merge_mask_kernel (merge_mask_pallas).  CUDA source: csrc/merge_mask.cu,
one thread per output pixel over shared-memory tiles of the "label > 0"
map and the junction code, so neither map reaches device memory; bound by
device memory (8 B per pixel).  The x0/w_total offset form of the
width-tiled path (dist/tile.py) is the same launch with the tile's global x
and the frame's width: only the junction's interior test sees them.

A leading frame axis (B,H,W) is one launch of the batch form (grid z =
frame; no dilation reaches across frames), the counterpart of the JAX
package's vmap over the Pallas kernel in rect_frames; the offset form
takes one frame.

`junction_merge_mask` takes the plain version (ops/regions.py) for a CPU
tensor and launches the kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import (
    junction_merge_mask as junction_merge_mask_plain)

launches = 0
# the launches of the x0/w_total offset form (counted in `launches` too)
offset_launches = 0


def junction_merge_mask(strong_lbl: torch.Tensor, x0: int = 0,
                        w_total: int | None = None) -> torch.Tensor:
    """strong_lbl ([B,]H,W) int32 (labels > 0 are edges) -> mask ([B,]H,W)
    int32 0/1; B frames in one launch.  x0: the global x of column 0,
    w_total: the frame's width (None: W)."""
    if not _build.on_cuda(strong_lbl):
        return junction_merge_mask_plain(strong_lbl, x0, w_total)
    _, b, h, w = _build.frame_stack(strong_lbl, "strong_lbl", torch.int32)
    gx0, wt = _build.frame_columns(b, x0, w_total, w)
    out = torch.empty_like(strong_lbl)
    _build.launch("rd_merge_mask", strong_lbl.device, strong_lbl.data_ptr(),
                  out.data_ptr(), h, w, b, gx0, wt)
    _build.count(globals(), "launches")
    if x0 != 0 or w_total is not None:
        _build.count(globals(), "offset_launches")
    return out

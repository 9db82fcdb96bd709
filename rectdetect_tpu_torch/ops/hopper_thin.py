"""K2 thinthres: bicubic non-max suppression of the edge magnitude.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_thin.py:_thin_kernel
(thinthres_pallas, and thincubic_pallas through `mode="cubic"`).  CUDA
source: csrc/thin.cu: each block stages its tile's em window (the tile and
the taps' reach, -3..+4, mirrored at the frame border) in shared memory
once, computes the fraction-free part of bicubicSub once per window cell,
and each pixel's four samples read their cells from there at tile-local
offsets; the TPU's 64 pre-rolled copies are not needed. A sample's position
x + k*vx is a float in frame columns, so its rounding depends on the
column: the width-tiled path (dist/tile.py) passes each widened tile's
frame column x0, which keeps its output bit-equal to the whole frame's (the
JAX package's tiled front end samples in tile columns). Its bound is device
memory (16 B per pixel), its time is set by the float work and the
shared-memory reads of the taps.

A leading frame axis ((B,H,W) and (B,H,W,2)) is one launch of the batch
form (grid z = frame, each frame's reflect-101 inside its own plane, x0
the same for every frame), the counterpart of the JAX package's vmap over
the Pallas kernel in rect_frames.

`thinthres` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build, thin

launches = 0
# the launches with a frame column x0 != 0 (counted in `launches` too)
offset_launches = 0


def thin_plain(em: torch.Tensor, vec: torch.Tensor, mode: str = "thres",
               slack: float = 0.99, x0: int = 0):
    """thin.thinthres / thin.thincubic (element-wise over a leading frame
    axis)."""
    if mode == "thres":
        return thin.thinthres(em, vec, x0)
    if mode == "cubic":
        return thin.thincubic(em, vec, slack, x0)
    raise ValueError(f"unknown thinning mode {mode!r}")


def thinthres(em: torch.Tensor, vec: torch.Tensor, mode: str = "thres",
              slack: float = 0.99, x0: int = 0):
    """em ([B,]H,W) f32, vec ([B,]H,W,2) f32 -> thinned magnitude ([B,]H,W)
    f32; B frames in one launch.  x0: the frame column of column 0."""
    if not _build.on_cuda(em, vec):
        return thin_plain(em, vec, mode, slack, x0)
    if mode not in ("thres", "cubic"):
        raise ValueError(f"unknown thinning mode {mode!r}")
    lead, b, h, w = _build.frame_stack(em, "em", torch.float32)
    _build.check(vec, "vec", torch.float32, (*lead, h, w, 2))
    if vec.data_ptr() % 8:
        raise ValueError("vec: the kernel reads it as float2, so it must be "
                         "8-byte aligned")
    if h < 5 or w < 5:
        raise ValueError(f"thinning needs a frame of at least 5x5, got {h}x{w}")
    out = torch.empty_like(em)
    _build.launch("rd_thin", em.device, em.data_ptr(), vec.data_ptr(),
                  out.data_ptr(), h, w, b, int(mode == "cubic"), float(slack),
                  int(x0))
    _build.count(globals(), "launches")
    if x0 != 0:
        _build.count(globals(), "offset_launches")
    return out

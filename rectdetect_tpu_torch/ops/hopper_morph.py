"""K3 strings_chain: junction -> connect -> stringify x2 [-> removeBranch].

Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:_morph_kernel
(morph_chain_pallas), variants "rect" and "poly_branch", each with or
without the bridge2 accuracy extension (simple_connect2 after the connect
stage, EXTENDED_CONFIG's bridge_gap2).  CUDA source: csrc/morph.cu, the
whole chain in one launch: each block keeps its tile's window as 32-pixel
bit words in shared memory and runs every stage there on a window that
shrinks by the stage's reach (a halo of 4 rows for "rect", 6 for
"poly_branch", 3 more with bridge2), so the map is read once and written
once.  The x0/w_total offset form of the width-tiled path (dist/tile.py)
is the same launch with the tile's global x and the frame's width as two
more arguments: the border guards and stringify's checkerboard parity are
then frame-global.

A leading frame axis (B,H,W) is one launch of the batch form (grid z =
frame, each frame's words, borders and parity inside its own plane), the
counterpart of the JAX package's vmap over the Pallas kernel in
rect_frames; the offset form takes one frame.

`strings_chain` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.morphology import (
    strings_chain as strings_chain_plain)

_VARIANTS = {"rect": 0, "poly_branch": 1}
# kernels launched per call, any variant, bridge2 or not
KERNELS = 1

launches = 0
# the launches of the x0/w_total offset form (counted in `launches` too)
offset_launches = 0
# the launches of the batch form with more than one frame (counted in
# `launches` too)
batch_launches = 0


def strings_chain(edge_bin: torch.Tensor, variant: str,
                  bridge2: bool = False, x0: int = 0,
                  w_total: int | None = None):
    """edge_bin ([B,]H,W) int32 0/1 -> strings map ([B,]H,W) int32 0/1; B
    frames in one launch.  x0: the global x of column 0, w_total: the
    frame's width (None: W)."""
    if not _build.on_cuda(edge_bin):
        return strings_chain_plain(edge_bin, variant, bridge2, x0, w_total)
    if variant not in _VARIANTS:
        raise ValueError(f"unknown strings variant {variant!r}")
    _, b, h, w = _build.frame_stack(edge_bin, "edge_bin", torch.int32)
    gx0, wt = _build.frame_columns(b, x0, w_total, w)
    out = torch.empty_like(edge_bin)
    _build.launch("rd_strings_chain", edge_bin.device, edge_bin.data_ptr(),
                  out.data_ptr(), h, w, b, _VARIANTS[variant],
                  int(bool(bridge2)), gx0, wt, kernels=KERNELS)
    _build.count(globals(), "launches")
    if b > 1:
        _build.count(globals(), "batch_launches")
    if x0 != 0 or w_total is not None:
        _build.count(globals(), "offset_launches")
    return out

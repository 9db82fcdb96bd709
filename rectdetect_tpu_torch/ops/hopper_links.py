"""Kernel #9 links CCL: the region merge's labels (labelxPreprocess +
labelMergeMain, oclrect.cl:289-334), the minimum flat index of each
4-connected component over the merge links, every pixel foreground.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_ccl.py:
_links_block_kernel with its seam union and resolve (label_links_blocked,
label_merge_exact).  CUDA source: csrc/links_ccl.cu, a block-based
union-find in three launches: each 16x32 tile evaluates its inner links
(regions.merge_pairs) from shared memory and unites them with
shared-memory atomics, writing each pixel's tile root; the links across
the tile seams unite the roots through device memory (atomicMin linking,
path halving); a last pass flattens.  Bound by the latency of dependent
loads and atomics.  Roots are component minima whatever order the atomics
run in, so the labels are exact and deterministic.  The x0/w_total offset form
of the width-tiled path (dist/tile.py) is the same three launches with
the tile's global x and the frame's width: only the links' interior
test sees them.

A leading frame axis (B,H,W) is the batch form: the same three launches
for all B frames (the tile pass's grid z and the seam and flatten passes'
grid y = frame), each frame's labels flat indices of its own plane, the
counterpart of the JAX package's vmap over the Pallas kernel in
rect_frames; the offset form takes one frame.

`label_merge` takes the plain version (ops/regions.py: merge_pairs +
label_links) for CPU tensors and launches the kernel for CUDA tensors;
there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.regions import label_merge as label_merge_plain

launches = 0
# the launches of the x0/w_total offset form (counted in `launches` too)
offset_launches = 0


def label_merge(packed: torch.Tensor, mask: torch.Tensor,
                edge_label: torch.Tensor, x0: int = 0,
                w_total: int | None = None) -> torch.Tensor:
    """packed ([B,]H,W) int32 colours, mask ([B,]H,W) int32 merge mask,
    edge_label ([B,]H,W) int32 (> 0 blocks) -> ([B,]H,W) int32 region
    labels (flat indices of each frame's own plane); B frames in the
    launches of one.  x0: the global x of column 0, w_total: the frame's
    width (None: W)."""
    if not _build.on_cuda(packed, mask, edge_label):
        return label_merge_plain(packed, mask, edge_label, x0, w_total)
    _, b, h, w = _build.frame_stack(packed, "packed", torch.int32)
    _build.check(mask, "mask", torch.int32, packed.shape)
    _build.check(edge_label, "edge_label", torch.int32, packed.shape)
    gx0, wt = _build.frame_columns(b, x0, w_total, w)
    out = torch.empty_like(packed)
    _build.launch("rd_label_merge", packed.device, packed.data_ptr(),
                  mask.data_ptr(), edge_label.data_ptr(), out.data_ptr(), h, w,
                  b, gx0, wt, kernels=3 if h and w else 0)
    _build.count(globals(), "launches")
    if x0 != 0 or w_total is not None:
        _build.count(globals(), "offset_launches")
    return out

"""K4 label_components: exact 8-connected equal-value CCL, labels = the
component's minimum flat index, background -1.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_ccl.py:_ccl_block_kernel
with its XLA seam union (_seam_union) and resolve (_resolve), i.e. what
label_components_exact and label_components_pieces compute.  CUDA source:
csrc/ccl.cu, a block-based union-find in three launches: each 16x32 tile
joins its row runs by a warp ballot and unites the runs of adjacent rows
(NW, N, NE) with shared-memory atomics, writing each pixel's tile root;
the links across the tile seams, both corner diagonals included, unite
the roots through device memory (atomicMin linking, path halving); a last
pass flattens.  It is bound by the latency of dependent loads and
atomics.  Roots are component minima whatever order the atomics run in,
so the labels are exact and deterministic, with no round cap: the TPU's
capped "pieces" form was a cost trade that the GPU does not need.

`label_components` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.ccl import label_components_plain

launches = 0


def label_components(pix: torch.Tensor, bgc: int = 0) -> torch.Tensor:
    """pix (H,W) int32 -> labels (H,W) int32."""
    if not _build.on_cuda(pix):
        return label_components_plain(pix, bgc)
    h, w = pix.shape
    _build.check(pix, "pix", torch.int32, (h, w))
    out = torch.empty_like(pix)
    _build.launch("rd_label_components", pix.device, pix.data_ptr(),
                  out.data_ptr(), h, w, int(bgc), kernels=3 if h and w else 0)
    _build.count(globals(), "launches")
    return out

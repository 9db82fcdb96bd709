"""Kernel #15 hyp: quad hypothesis reduction, each group of segments to one
quad (removeShortLS -> pickExternalLS -> pickLongestLS(4) -> sortByAngle ->
findCorners -> triangle, perimeter and convexity checks,
oclrect.c:1134-1151).

Replaces the TPU kernel rectdetect_tpu/ops/pallas_hyp.py:_hyp_kernel
(reduce_groups_pallas).  CUDA source: csrc/hyp.cu, one block per group:
the kept segments compacted, each hull step's pair tests spread over the
block (4 threads per candidate endpoint, a pair's sqrt only where its
cross product passes the perpendicular bound) with the step's first
maximum by one shared 64-bit atomicMax, every pickExternalLS test at
once and the greedy picks by bit masks; bound by operations (the hull's pair
tests), and on a frame's few filled groups by the latency of one group's
chain of steps.  Its float operations are the plain version's
(geometry/quad.py:reduce_groups), rounded once in the same order.

`reduce_groups` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.geometry import quad
from rectdetect_tpu_torch.ops import _build, fp

launches = 0


def reduce_groups(segs: torch.Tensor, valid: torch.Tensor,
                  max_vertices: int = 24):
    """segs (G,K,2,2) float32, valid (G,K) bool -> (corners (G,4,2)
    float32, ok (G,) bool), as quad.reduce_groups.  K and max_vertices at
    most 64."""
    if not _build.on_cuda(segs, valid):
        return quad.reduce_groups(segs, valid, max_vertices)
    g, k = valid.shape
    _build.check(segs, "segs", torch.float32, (g, k, 2, 2))
    _build.check(valid, "valid", torch.bool, (g, k))
    if not (1 <= k <= 64 and 1 <= max_vertices <= 64):
        raise ValueError(f"the hyp kernel takes 1..64 segments and hull "
                         f"vertices, got {k} and {max_vertices}")
    corners = torch.empty((g, 4, 2), dtype=torch.float32, device=segs.device)
    ok = torch.empty((g,), dtype=torch.bool, device=segs.device)
    _build.launch("rd_hyp", segs.device, segs.data_ptr(), valid.data_ptr(),
                  corners.data_ptr(), ok.data_ptr(), g, k, max_vertices,
                  fp.f32(quad.SHORT_RATIO * quad.SHORT_RATIO),
                  kernels=1 if g else 0)
    _build.count(globals(), "launches")
    return corners, ok

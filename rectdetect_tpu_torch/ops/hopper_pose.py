"""The pose kernel: 3D pose of each quad candidate by preconditioned
nonlinear CG on the rectangle objective, both normalization modes, the
better one kept (poseEstimation, oclrect.c:590-634).

The JAX package leaves the pose to XLA (rectdetect_tpu/geometry/pose.py),
which fuses its 2 modes x 12 CG iterations x 10 line-search steps into a
few loops; run eagerly, the same steps are ~10^5 small launches per frame.
CUDA source: csrc/pose.cu.  Bound by operations, and in time by one
problem's chain of dependent operations: each (group, mode) runs on 8
lanes of a warp, two for each seed direction e_i, which carry the jet
seeded with e_i and split the objective's two plane terms between them;
the CG vector steps are gathered by shuffles, and the line search takes
one jet per step.  Its float operations are the plain version's
(geometry/pose.py:pose_estimate), rounded once in the same order.

`pose_estimate` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.geometry import pose
from rectdetect_tpu_torch.ops import _build, fp

launches = 0


def pose_estimate(corners: torch.Tensor, iw: int, ih: int, tan_aov: float,
                  cg_iters: int = 12, ls_iters: int = 10):
    """corners (G,4,2) float32 -> (c2 (G,4,2), c3 (G,4,3), value (G,)), as
    pose.pose_estimate."""
    global launches
    if not _build.on_cuda(corners):
        return pose.pose_estimate(corners, iw, ih, tan_aov, cg_iters,
                                  ls_iters)
    g = corners.shape[0]
    _build.check(corners, "corners", torch.float32, (g, 4, 2))
    dev = corners.device
    c2 = torch.empty((g, 4, 2), dtype=torch.float32, device=dev)
    c3 = torch.empty((g, 4, 3), dtype=torch.float32, device=dev)
    value = torch.empty((g,), dtype=torch.float32, device=dev)
    # (iw/2)/tan_aov divided in float32 (the f32 quotient of two f32
    # values, rounded once from float64)
    focal = fp.f32(fp.f32(iw / 2) / fp.f32(tan_aov))
    _build.launch("rd_pose", dev, corners.data_ptr(), c2.data_ptr(),
                  c3.data_ptr(), value.data_ptr(), g, fp.f32(iw / 2),
                  fp.f32(ih / 2), focal, int(cg_iters), int(ls_iters))
    launches += 1
    return c2, c3, value

"""K1 edge_front: edgevec of the blurred L plane plus the Lab edge
magnitude of the re-quantized blurred planes.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_grad.py:_grad_kernel
(edge_front_pallas).  CUDA source: csrc/edge_front.cu: 16 x 64 tiles
staged in shared memory with reflect-101 applied while staging, each
staged pixel quantized once, each thread's rows read from registers; the
pass is bound by device memory (12 B read, 12 B written per pixel).

A leading frame axis (B,H,W,3) is one launch of the batch form (grid z =
frame, each frame's reflect-101 inside its own plane), the counterpart of
the JAX package's vmap over the Pallas kernel in rect_frames.

`edge_front` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.core.color import quantize_labf
from rectdetect_tpu_torch.ops import _build, gradient

launches = 0


def edge_front_plain(labb: torch.Tensor):
    """labb ([B,]H,W,3) f32 -> (em ([B,]H,W), vec ([B,]H,W,2)):
    edgevec(labb[..., 0]) and edge_lab(quantize_labf(labb)), as the XLA path
    computes them (element-wise over a leading frame axis)."""
    vec = gradient.edgevec(labb[..., 0])
    em = gradient.edge_lab(quantize_labf(labb))
    return em, vec


def edge_front(labb: torch.Tensor):
    """labb ([B,]H,W,3) f32 -> (em ([B,]H,W), vec ([B,]H,W,2)); B frames
    in one launch."""
    if not _build.on_cuda(labb):
        return edge_front_plain(labb)
    lead = tuple(labb.shape[:-3])
    h, w = labb.shape[-3:-1]
    b = _build.frames(lead, "labb")
    _build.check(labb, "labb", torch.float32, (*lead, h, w, 3))
    if h < 3 or w < 3:
        raise ValueError(f"edge_front needs a frame of at least 3x3, got {h}x{w}")
    em = torch.empty((*lead, h, w), dtype=torch.float32, device=labb.device)
    vec = torch.empty((*lead, h, w, 2), dtype=torch.float32,
                      device=labb.device)
    _build.launch("rd_edge_front", labb.device, labb.data_ptr(),
                  em.data_ptr(), vec.data_ptr(), h, w, b)
    _build.count(globals(), "launches")
    return em, vec

"""K2 thinthres: bicubic non-max suppression of the edge magnitude.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_thin.py:_thin_kernel
(thinthres_pallas, and thincubic_pallas through `mode="cubic"`).  CUDA
source: csrc/thin.cu, one thread per pixel with real gathers: the 64 taps
of its four samples lie within +-4 px and come from L1/L2, so the kernel
is bound by load latency rather than bandwidth; the TPU's 64 pre-rolled
copies are not needed.

`thinthres` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build, thin

launches = 0


def thin_plain(em: torch.Tensor, vec: torch.Tensor, mode: str = "thres",
               slack: float = 0.99):
    if mode == "thres":
        return thin.thinthres(em, vec)
    if mode == "cubic":
        return thin.thincubic(em, vec, slack)
    raise ValueError(f"unknown thinning mode {mode!r}")


def thinthres(em: torch.Tensor, vec: torch.Tensor, mode: str = "thres",
              slack: float = 0.99):
    """em (H,W) f32, vec (H,W,2) f32 -> thinned magnitude (H,W) f32."""
    global launches
    if not _build.on_cuda(em, vec):
        return thin_plain(em, vec, mode, slack)
    if mode not in ("thres", "cubic"):
        raise ValueError(f"unknown thinning mode {mode!r}")
    h, w = em.shape
    _build.check(em, "em", torch.float32, (h, w))
    _build.check(vec, "vec", torch.float32, (h, w, 2))
    if h < 5 or w < 5:
        raise ValueError(f"thinning needs a frame of at least 5x5, got {h}x{w}")
    out = torch.empty_like(em)
    _build.launch("rd_thin", em.device, em.data_ptr(), vec.data_ptr(),
                  out.data_ptr(), h, w, int(mode == "cubic"), float(slack))
    launches += 1
    return out

"""Oriented edge gradient and edge magnitude, plain PyTorch (port of
rectdetect_tpu/ops/gradient.py).

edgevec: 5x5 oriented-gradient filter bank giving per-pixel unit edge
direction vectors (edgevec_f, oclimgutil.cl:395-420; bank :346-352).
edge_lab: 3x3 cross-difference edge magnitude, clamped per channel,
summed and square-rooted (edge_plab, oclimgutil.cl:422-437).

Both are shifted multiply-adds in the JAX order with XLA's multiply-add
contraction (ops/fp.py).  The one deliberate difference is
the reciprocal square root of edgevec: XLA:CPU evaluates `lax.rsqrt` with a
hardware estimate plus a Newton step, which is faithful (within one ulp)
but not correctly rounded and cannot be reproduced on the GPU.  The port
rounds 1/sqrt once from float64 (`_rsqrt`), on the CPU, in the plain
version on the GPU and in the CUDA kernel alike, so the port agrees with
itself bit for bit and with JAX within one ulp of the unit vector.
"""

from __future__ import annotations

import torch

from portbench.reference.ops import fp
from portbench.reference.ops.fp import dot_chain, fma
from portbench.reference.ops.shifts import pad2d, shifted

# 5x5 oriented-gradient coefficients (v5c, oclimgutil.cl:346-352).
V5C = (
    (-4.667, -4.083, 0.000, 4.083, 4.667),
    (-10.024, -0.963, 0.000, 0.963, 10.024),
    (-14.120, 3.622, 0.000, -3.622, 14.120),
    (-10.024, -0.963, 0.000, 0.963, 10.024),
    (-4.667, -4.083, 0.000, 4.083, 4.667),
)

SQRT_HALF = 0.70710678118


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 1/sqrt(max(x, 1e-30))."""
    x = torch.clamp(x, min=1e-30)
    return (1.0 / torch.sqrt(x.double())).float()


def _grad5(img: torch.Tensor):
    """Raw (vx, vy) responses of the 5x5 bank: yy outer, xx inner, zero
    coefficients skipped (the accumulation order of gradient._grad5)."""
    h, w = img.shape[-2], img.shape[-1]
    p = pad2d(img, 2, "mirror")
    tx, ty = [], []
    for yy in range(-2, 3):
        for xx in range(-2, 3):
            cx = V5C[yy + 2][xx + 2]
            cy = V5C[xx + 2][yy + 2]
            s = shifted(p, 2, yy, xx, h, w)
            if cx != 0.0:
                tx.append((cx, s))
            if cy != 0.0:
                ty.append((cy, s))
    return dot_chain(tx), dot_chain(ty)


def edgevec(img: torch.Tensor) -> torch.Tensor:
    """(H,W) float32 -> (H,W,2) unit direction vectors; |v|^2 <= 1e-10
    falls back to (sqrt(1/2), sqrt(1/2)) (edgevec_f, oclimgutil.cl:395-420)."""
    vx, vy = _grad5(img)
    ivlen = fma(vx, vx, vy * vy)
    rs = _rsqrt(ivlen)
    big = ivlen > 1e-10
    half = torch.full_like(vx, SQRT_HALF)
    return torch.stack([torch.where(big, vx * rs, half),
                        torch.where(big, vy * rs, half)], dim=-1)


def _edge_single(img: torch.Tensor):
    """Per-channel sum of the cross-difference products s0 + s1 (before
    clamping)."""
    h, w = img.shape[-2], img.shape[-1]
    p = pad2d(img, 1, "mirror")

    def n(dy, dx):
        return shifted(p, 1, dy, dx, h, w)

    t0 = n(-1, 0) + n(0, -1) - n(1, 0) - n(0, 1)
    t1 = n(-1, 0) - n(0, -1) + n(0, 1) - n(1, 0)
    s1 = (n(-1, 1) - n(1, -1)) * t1
    return fma(n(-1, -1) - n(1, 1), t0, s1)        # s0 + s1, contracted


def edge_lab(labf: torch.Tensor) -> torch.Tensor:
    """(H,W,3) Lab planes -> (H,W) edge magnitude; each channel's s0+s1
    is clamped to >= 0 before the sum (edge_plab, oclimgutil.cl:422-437)."""
    total = None
    for c in range(3):
        v = torch.clamp(_edge_single(labf[..., c]), min=0.0)
        total = v if total is None else total + v
    return torch.where(total > 0, fp.sqrt(total), torch.zeros_like(total))

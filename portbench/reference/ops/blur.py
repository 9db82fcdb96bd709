"""Gaussian blur of the edge front-end (port of rectdetect_tpu/ops/blur.py).

The reference runs a recursive (IIR) Gaussian, iirblur (oclimgutil.cl:
542-637), with r=2 in the pipeline (oclrect.c:248-250).  The JAX package
replaces it by a separable FIR whose taps are the recurrence's exact
impulse response, derived from the reference's coefficient row; this
module keeps all 32 rows (iircoef, oclimgutil.cl:900-1125, ops/_iircoef.py)
and derives the same taps the same way, truncated where the JAX package
truncates them.  Beyond the table (r > 31) the taps are a sampled Gaussian
with sigma = r/3 out to 4 sigma.

The blur is written as shifted multiply-adds in the JAX order, with XLA's
multiply-add contraction (ops/fp.py), not as conv2d: on CUDA a float32
convolution goes through cuDNN in TF32 by default, and a convolution sums
in another order either way.

`gaussian_blur_iir` is the JAX package's true recursive Gaussian (the
third-order Young-van Vliet recursion, forward and backward along each
axis), which the JAX package evaluates by associative scans; here the
recursion runs in order along the axis, which sums in another order (see
its docstring).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from portbench.reference.ops._iircoef import IIRCOEF
from portbench.reference.ops.fp import dot_chain
from portbench.reference.ops.shifts import pad2d, shifted


@functools.lru_cache(maxsize=None)
def _ref_iir_taps(r: int) -> tuple[float, ...]:
    """Symmetric FIR taps: the exact impulse response of the reference's
    iirblur axis pass (fwd scan + bwd scan - c0*in, oclimgutil.cl:542-589)
    for iircoef row r, truncated at radius 6 for r <= 2 and at
    ~2.5 (r + 1) beyond (the row's effective sigma is (r + 1) / 3)."""
    coef = np.asarray(IIRCOEF[r], np.float32)
    c = max(64, 4 * r + 48)
    n = 2 * c + 1
    row = np.zeros(n, np.float32)
    row[c] = 1.0

    def scan(xs):
        iv = np.zeros(8, np.float32)
        tv = np.zeros(7, np.float32)
        out = np.zeros(n, np.float32)
        for x in xs:
            iv[1:] = iv[:-1]
            iv[0] = row[min(max(x, -x), 2 * n - 2 - x)]
            d = np.float32(coef[0] * iv[0])
            d += np.float32((coef[1:8] * iv[1:]).sum())
            d += np.float32((coef[8:] * tv).sum())
            out[x % n] = d
            tv[1:] = tv[:-1]
            tv[0] = d
        return out

    t0 = scan(range(-(r + 9), n))
    t1 = scan(range(n + r + 9, -1, -1))
    h = (t0 + t1 - row * coef[0]).astype(np.float64)
    rad = 6 if r <= 2 else min(c - 1, max(6, int(math.ceil(2.5 * (r + 1)))))
    return tuple(float(v) for v in h[c - rad:c + rad + 1])


@functools.lru_cache(maxsize=None)
def gaussian_taps(r: int = 2) -> tuple[float, ...]:
    """Symmetric FIR taps for blur radius r: the reference recurrence's
    exact impulse response for r in [0, 31] (the iircoef rows), a sampled
    Gaussian with sigma = r/3 out to 4 sigma beyond."""
    if 0 <= r < len(IIRCOEF):
        return _ref_iir_taps(r)
    sigma = r / 3.0
    rad = max(2, int(math.ceil(4.0 * sigma)))
    k = np.arange(-rad, rad + 1, dtype=np.float64)
    t = np.exp(-0.5 * (k / sigma) ** 2)
    t /= t.sum()
    return tuple(float(v) for v in t)


def gaussian_blur(img: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Separable blur with reflect-101 borders at radius r.
    img: (..., H, W) float32."""
    taps = gaussian_taps(r)
    rad = len(taps) // 2
    h, w = img.shape[-2], img.shape[-1]
    p = pad2d(img, rad, "mirror")
    out = dot_chain((t, shifted(p, rad, 0, i - rad, h, w))    # horizontal
                    for i, t in enumerate(taps))
    p = pad2d(out, rad, "mirror")
    return dot_chain((t, shifted(p, rad, i - rad, 0, h, w))   # vertical
                     for i, t in enumerate(taps))


@functools.lru_cache(maxsize=None)
def _yvv_coeffs(sigma: float):
    """Young-van Vliet third-order recursive Gaussian (Young & van Vliet
    1995): q from sigma, then the normalised feedback coefficients
    (a1, a2, a3) and the input gain b of y[n] = b x[n] + a1 y[n-1] +
    a2 y[n-2] + a3 y[n-3]."""
    if sigma >= 2.5:
        q = 0.98711 * sigma - 0.96330
    else:
        q = 3.97156 - 4.14554 * math.sqrt(1.0 - 0.26891 * sigma)
    b0 = 1.57825 + 2.44413 * q + 1.4281 * q * q + 0.422205 * q ** 3
    b1 = 2.44413 * q + 2.85619 * q * q + 1.26661 * q ** 3
    b2 = -(1.4281 * q * q + 1.26661 * q ** 3)
    b3 = 0.422205 * q ** 3
    bb = 1.0 - (b1 + b2 + b3) / b0
    return (b1 / b0, b2 / b0, b3 / b0, bb)


def _iir_pass(x: torch.Tensor, a1: float, a2: float, a3: float, b: float,
              reverse: bool) -> torch.Tensor:
    """y[n] = b x[n] + a1 y[n-1] + a2 y[n-2] + a3 y[n-3] along the last
    axis, zero state before the first sample (from the end if reverse)."""
    n = x.shape[-1]
    zero = torch.zeros_like(x[..., 0])
    y1 = y2 = y3 = zero
    out = torch.empty_like(x)
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        y = b * x[..., i] + a1 * y1 + a2 * y2 + a3 * y3
        out[..., i] = y
        y1, y2, y3 = y, y1, y2
    return out


def gaussian_blur_iir(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """True recursive Gaussian (Young-van Vliet) along both axes, forward
    then backward, for large sigma where the FIR gets long.  img: (..., H,
    W) float32.  The JAX package evaluates the same recursion by
    associative scans over 3x3 companion matrices; this runs it in order,
    so the two round differently (float32 sums in another order): they
    agree to ~1e-6 of the image's range, not bit for bit."""
    a1, a2, a3, b = _yvv_coeffs(float(sigma))

    def axis_pass(z):
        fwd = _iir_pass(z, a1, a2, a3, b, reverse=False)
        return _iir_pass(fwd, a1, a2, a3, b, reverse=True)

    out = axis_pass(img)
    return axis_pass(out.transpose(-1, -2)).transpose(-1, -2)

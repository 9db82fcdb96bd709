"""Gaussian blur of the edge front-end (port of rectdetect_tpu/ops/blur.py,
r=2 path).

The reference runs a recursive (IIR) Gaussian, iirblur with r=2
(oclimgutil.cl:542-637, oclrect.c:248-250).  The JAX package replaces it by
a separable FIR whose taps are the recurrence's exact impulse response,
derived from the reference's coefficient row.  This module keeps that row
(iircoef[2], oclimgutil.cl:900-1125, as the JAX package's
ops/_iircoef.py holds it) and derives the same taps the same way.

The blur is written as shifted multiply-adds in the JAX order, with XLA's
multiply-add contraction (ops/fp.py), not as conv2d: on CUDA a float32
convolution goes through cuDNN in TF32 by default, and a convolution sums
in another order either way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rectdetect_tpu_torch.ops.fp import dot_chain
from rectdetect_tpu_torch.ops.shifts import pad2d, shifted

# iircoef row r=2: 8 feed-forward + 7 feedback float32 taps.
IIRCOEF_R2 = (0.3989422804, 0.14145424, -0.0030406818, -0.0041116157,
              0.0006696623, 4.98707e-05, -4.49761e-05, -5.1528e-06,
              0.2519574622, -0.0098627835, -0.0067013653, 0.0012572396,
              4.81394e-05, -9.7781e-06, 6.462e-07)


@functools.lru_cache(maxsize=None)
def gaussian_taps(r: int = 2) -> tuple[float, ...]:
    """Symmetric FIR taps: the exact impulse response of the reference's
    iirblur axis pass (fwd scan + bwd scan - c0*in, oclimgutil.cl:542-589)
    for r=2, truncated at radius 6."""
    if r != 2:
        raise NotImplementedError("the port carries the r=2 blur only")
    coef = np.asarray(IIRCOEF_R2, np.float32)
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
    rad = 6
    return tuple(float(v) for v in h[c - rad:c + rad + 1])


def gaussian_blur(img: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Separable blur with reflect-101 borders. img: (..., H, W) float32."""
    taps = gaussian_taps(r)
    rad = len(taps) // 2
    h, w = img.shape[-2], img.shape[-1]
    p = pad2d(img, rad, "mirror")
    out = dot_chain((t, shifted(p, rad, 0, i - rad, h, w))    # horizontal
                    for i, t in enumerate(taps))
    p = pad2d(out, rad, "mirror")
    return dot_chain((t, shifted(p, rad, i - rad, 0, h, w))   # vertical
                     for i, t in enumerate(taps))

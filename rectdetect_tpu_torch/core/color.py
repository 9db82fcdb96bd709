"""sRGB -> CIELAB and the packed-Lab format (port of
rectdetect_tpu/core/color.py, closed-form path).

Packed Lab is one int32 per pixel, b<<22 | a<<12 | L, with the normalized
values Lf = L*/256, af = (a*+128)/256, bf = (b*+128)/256 on a 12/10/10-bit
lattice (packlab/unpacklab, oclimgutil.cl:28-39).

The arithmetic is the jitted JAX function's, multiply-add contraction
included (ops/fp.py), so that the CPU and the GPU give the same bits as
each other and, nearly everywhere, as the JAX reference on the CPU.  Two
transcendental steps need care:
  * the sRGB decode has only 256 inputs, so it is a 256-entry float32
    table: `((s + 0.055) / 1.055) ** 2.4` evaluated in float64 with the
    float32-rounded exponent and rounded once, and the linear branch with
    its two constant factors folded as XLA folds them (the table equals
    the jitted JAX function on all 256 inputs);
  * `cbrt` is pow(x, float32(1/3)) evaluated in float64 and rounded once,
    which is the closest float64-reproducible form of XLA:CPU's `cbrt`
    (it agrees on all but a few float32 inputs; see tests).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rectdetect_tpu_torch.ops.fp import dot_chain, f32, fma

# D65 sRGB -> XYZ matrix, same literals as oclimgutil.cl:113-115.
_M_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XN = 0.950456
_ZN = 1.088754
_LAB_EPS = 0.008856      # (6/29)^3
_LAB_KAPPA = 903.3
_THIRD = float(np.float32(1.0 / 3.0))


@functools.lru_cache(maxsize=None)
def _srgb_table_np() -> np.ndarray:
    u = np.arange(256, dtype=np.float32)
    c255 = np.float32(1.0 / 255.0)
    s = u * c255
    # (s + 0.055) contracts to fma(u, 1/255, 0.055)
    base = ((u.astype(np.float64) * np.float64(c255) + np.float64(np.float32(0.055)))
            .astype(np.float32) * np.float32(1.0 / 1.055))
    hi = np.power(base.astype(np.float64),
                  float(np.float32(2.4))).astype(np.float32)
    # the linear branch's two constant factors fold into one constant
    lo = u * (c255 * np.float32(1.0 / 12.92))
    return np.where(s <= np.float32(0.04045), lo, hi).astype(np.float32)


def srgb_to_linear(u8: torch.Tensor) -> torch.Tensor:
    """sRGB byte -> linear light in [0,1] (matches the s2l LUT generator)."""
    tbl = torch.from_numpy(_srgb_table_np()).to(u8.device)
    return tbl[u8.long()]


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.pow(t.double(), _THIRD).float()


def _lab_f(t):
    return torch.where(t > _LAB_EPS, _cbrt(t), fma(7.787, t, 16.0 / 116.0))


def bgr_to_labf(bgr_u8: torch.Tensor) -> torch.Tensor:
    """(H,W,3) uint8 BGR -> (H,W,3) float32 normalized Lab (Lf, af, bf)."""
    b = srgb_to_linear(bgr_u8[..., 0])
    g = srgb_to_linear(bgr_u8[..., 1])
    r = srgb_to_linear(bgr_u8[..., 2])
    m = _M_RGB2XYZ
    x = dot_chain([(m[0][0], r), (m[0][1], g), (m[0][2], b)]) * f32(1.0 / _XN)
    y = dot_chain([(m[1][0], r), (m[1][1], g), (m[1][2], b)])
    z = dot_chain([(m[2][0], r), (m[2][1], g), (m[2][2], b)]) * f32(1.0 / _ZN)
    fx, fy, fz = _lab_f(x), _lab_f(y), _lab_f(z)
    lstar = torch.where(y > _LAB_EPS, fma(116.0, fy, -16.0), _LAB_KAPPA * y)
    lf = lstar * (1.0 / 256.0)
    af = fma(500.0, fx - fy, 128.0) * (1.0 / 256.0)
    bf = fma(200.0, fy - fz, 128.0) * (1.0 / 256.0)
    return torch.stack([lf, af, bf], dim=-1)


_SCALE = (4096.0, 1024.0, 1024.0)
_HI = (4095.0, 1023.0, 1023.0)


def quantize_labf(labf: torch.Tensor) -> torch.Tensor:
    """Snap normalized Lab onto the packed lattice: unpacklab(packlab(x)),
    floor to the grid plus half a quantum (oclimgutil.cl:36-39)."""
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=labf.device)
    hi = torch.tensor(_HI, dtype=torch.float32, device=labf.device)
    q = torch.minimum(torch.clamp(torch.floor(labf * scale), min=0.0), hi)
    return (q + 0.5) / scale


def pack_lab(labf: torch.Tensor) -> torch.Tensor:
    """(...,3) normalized Lab floats -> packed int32 (b<<22 | a<<12 | L)."""
    cl = torch.clamp(torch.floor(labf[..., 0] * 4096.0), 0, 4095).to(torch.int32)
    ca = torch.clamp(torch.floor(labf[..., 1] * 1024.0), 0, 1023).to(torch.int32)
    cb = torch.clamp(torch.floor(labf[..., 2] * 1024.0), 0, 1023).to(torch.int32)
    return (cb << 22) | (ca << 12) | cl


def pack_lab_int(cl, ca, cb):
    """Raw integer lattice coordinates (clamped) -> packed int32
    (packlabbl, oclrect.cl:38-44)."""
    cl = torch.clamp(cl, 0, 4095).to(torch.int32)
    ca = torch.clamp(ca, 0, 1023).to(torch.int32)
    cb = torch.clamp(cb, 0, 1023).to(torch.int32)
    return (cb << 22) | (ca << 12) | cl


def unpack_lab_int(packed):
    """packed int32 -> (cl, ca, cb) raw int32 lattice coordinates
    (unpacklabbl, oclrect.cl:46-48)."""
    return packed & 4095, (packed >> 12) & 1023, (packed >> 22) & 1023


def unpack_labf(packed):
    """packed int32 -> (...,3) normalized Lab floats at lattice centers."""
    cl, ca, cb = unpack_lab_int(packed)
    lf = (cl.to(torch.float32) + 0.5) * (1.0 / 4096.0)
    af = (ca.to(torch.float32) + 0.5) * (1.0 / 1024.0)
    bf = (cb.to(torch.float32) + 0.5) * (1.0 / 1024.0)
    return torch.stack([lf, af, bf], dim=-1)

"""Fixed-point LUT generators for the exact packed-Lab path (the port's
own copy of rectdetect_tpu/core/luts.py, numpy only).

The reference embeds three tables used by srgb2plab (oclimgutil.cl:106-134):
`s2l` (sRGB byte -> linear light, oclimgutil.cl:661-695), `cfunc` (the
CIELAB f-function, :764-898) and `cfunc2` (the L* transfer, :764-898).
They are pure samplings of the public sRGB / CIELAB(D65) standards on
fixed-point grids; regenerating them from the formulas below reproduces
every entry bit-identically (verified against the reference during
development), so the integer conversion path can match the reference
exactly without shipping copied data:

    s2l[i]    = floor(srgb_to_linear(i / 255) * 32768),   i in [0, 260]
    cfunc[i]  = round(f(i / 1024) * 65536) - 9039,        i in [0, 1030]
    cfunc2[i] = round((116 f(i / 1024) - 16) * 2*65536/255)
    with f(t) = t^(1/3) if t > (6/29)^3 else 7.787 t + 16/116
    and round(x) = floor(x + 0.5)

(9039 = round(f(0) * 65536) = round(16/116 * 65536): lab2srgb adds it
back at oclimgutil.cl:159, which pins the offset.)  The inverse table
`l2s` (oclimgutil.cl:697-762, consumed at :173-175 as
l2s[clamp(floor(lin*1024), 0, 1023)]) is the sampling

    l2s[i] = clamp(round(linear_to_srgb(i / 1023) * 256), 0, 255)

— note the off-by-the-usual conventions: the 1024-entry grid is
normalized by 1023 and the byte scale is 256, both verified entry-exact
against the reference during development.
"""

from __future__ import annotations

import functools

import numpy as np


def _round_half_up(x):
    return np.floor(x + 0.5)


@functools.lru_cache(maxsize=None)
def s2l_table() -> np.ndarray:
    """(261,) int32: floor(srgb_to_linear(i/255) * 32768); entries past
    255 extrapolate the power branch (interpolation headroom)."""
    i = np.arange(261, dtype=np.float64)
    s = i / 255.0
    lin = np.where(s <= 0.04045, s / 12.92,
                   ((s + 0.055) / 1.055) ** 2.4)
    return np.floor(lin * 32768.0).astype(np.int32)


def _lab_f(t):
    th = (6.0 / 29.0) ** 3
    return np.where(t > th, np.cbrt(t), 7.787 * t + 16.0 / 116.0)


@functools.lru_cache(maxsize=None)
def l2s_table() -> np.ndarray:
    """(1024,) int32: clamp(round(linear_to_srgb(i/1023) * 256), 0, 255).

    The inverse of s2l (oclimgutil.cl:697-762).  Grid normalization is
    /1023 (not /1024) and the output scale 256 (not 255) with
    round-half-up — the combination that reproduces every reference
    entry exactly."""
    lin = np.arange(1024, dtype=np.float64) / 1023.0
    s = np.where(lin <= 0.0031308, lin * 12.92,
                 1.055 * np.power(lin, 1.0 / 2.4) - 0.055)
    return np.clip(_round_half_up(s * 256.0), 0, 255).astype(np.int32)


@functools.lru_cache(maxsize=None)
def cfunc_table() -> np.ndarray:
    """(1031,) int32: round(f(i/1024) * 65536) - 9039."""
    t = np.arange(1031, dtype=np.float64) / 1024.0
    return (_round_half_up(_lab_f(t) * 65536.0) - 9039).astype(np.int32)


@functools.lru_cache(maxsize=None)
def cfunc2_table() -> np.ndarray:
    """(1031,) int32: round((116 f(i/1024) - 16) * 2*65536/255)."""
    t = np.arange(1031, dtype=np.float64) / 1024.0
    l = 116.0 * _lab_f(t) - 16.0
    return _round_half_up(l * (2.0 * 65536.0 / 255.0)).astype(np.int32)

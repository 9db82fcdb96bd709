"""Non-max-suppression edge thinning with bicubic resampling, plain
PyTorch (port of rectdetect_tpu/ops/thin.py).

The reference samples the edge magnitude at +-1 and +-2 steps along the
unit gradient with Catmull-Rom bicubic interpolation and keeps a pixel
only if it is a local maximum along that direction (thinthres_f_f_f2,
oclimgutil.cl:456-471; bicubic, :65-94).

This is the gather-free XLA formulation, op for op: all 16 taps of a
sample lie in a static 8x8 neighbourhood (offsets -3..+4), each tap is
selected per pixel from statically shifted copies, then combined with the
reference's exact Horner sequence (bicubicSub, oclimgutil.cl:65-74).  The
sample position is pos = x + k*vx in float32, truncated toward zero, with
the fraction pos - trunc(pos) (negative near the top/left borders).
"""

from __future__ import annotations

import torch

from portbench.reference.ops.fp import fma
from portbench.reference.ops.shifts import pad2d, shifted

_R = 4  # padded radius: tap offsets span [-3, +4]


def _bicubic_sub(p0, p1, p2, p3, x):
    """bicubicSub (oclimgutil.cl:65-74), exact op order, with XLA's
    multiply-add contraction (the last step's u*x*0.5 + p1 rounds the
    same either way: the 0.5 scaling is exact)."""
    v = p1 - p2
    w = p3 - p0
    u = fma(v, 3.0, w)
    u = fma(u, x, fma(-4.0, v, p0 - p1 - w))
    u = fma(u, x, p2 - p0)
    u = u * x * 0.5 + p1
    return u


def _int_frac(delta, coord, icoord):
    """pos = coord + delta in f32, ix = trunc(pos): returns (ix - coord as
    int32, pos - ix)."""
    pos = coord + delta
    ip = torch.trunc(pos)
    return ip.to(torch.int32) - icoord, pos - ip


def bicubic_sample_along(img, vx, vy, k: float, x0: int = 0):
    """Bicubic sample of img at (x + k*vx, y + k*vy) for every pixel; x is
    the frame column, local column + x0 (a width tile of the width-tiled
    path, dist/tile.py): the float position, so its rounding, is the
    frame's."""
    h, w = img.shape[-2], img.shape[-1]
    kr = max(1, min(2, int(abs(k))))
    p = pad2d(img, _R, "mirror")
    dev = img.device
    xs = torch.arange(x0, x0 + w, dtype=img.dtype, device=dev)[None, :]
    ys = torch.arange(h, dtype=img.dtype, device=dev)[:, None]
    ixs = torch.arange(x0, x0 + w, dtype=torch.int32, device=dev)[None, :]
    iys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    fdx, fx = _int_frac(k * vx, xs, ixs)
    fdy, fy = _int_frac(k * vy, ys, iys)

    # x stage: Horner over the 4 selected taps, for every candidate row
    offs = list(range(-kr - 1, kr + 3))
    rows = []
    for b in offs:
        taps = [shifted(p, _R, b, o, h, w) for o in offs]
        t = []
        for i in range(4):
            acc = taps[i]                      # fd = -kr
            for fd in range(-kr + 1, kr + 1):
                acc = torch.where(fdx == fd, taps[fd + i + kr], acc)
            t.append(acc)
        rows.append(_bicubic_sub(t[0], t[1], t[2], t[3], fx))
    # y stage: select the 4 rows at fdy + j - 1, Horner in y
    R = []
    for j in range(4):
        acc = rows[j]                          # fd = -kr
        for fd in range(-kr + 1, kr + 1):
            acc = torch.where(fdy == fd, rows[fd + j + kr], acc)
        R.append(acc)
    return _bicubic_sub(R[0], R[1], R[2], R[3], fy)


def _samples(edge_img, vec, x0: int = 0):
    vx = vec[..., 0]
    vy = vec[..., 1]
    am2 = bicubic_sample_along(edge_img, vx, vy, -2.0, x0)
    am1 = bicubic_sample_along(edge_img, vx, vy, -1.0, x0)
    ap1 = bicubic_sample_along(edge_img, vx, vy, 1.0, x0)
    ap2 = bicubic_sample_along(edge_img, vx, vy, 2.0, x0)
    return am2, am1, edge_img, ap1, ap2


def thinthres(edge_img, vec, x0: int = 0):
    """NMS thinning (thinthres_f_f_f2, oclimgutil.cl:456-471): keep a pixel
    if am1 <= a0 >= ap1; the output is the 5-sample sum, else 0.  x0: the
    frame column of local column 0."""
    am2, am1, a0, ap1, ap2 = _samples(edge_img, vec, x0)
    keep = (am1 <= a0) & (a0 >= ap1)
    return torch.where(keep, am2 + am1 + a0 + ap1 + ap2,
                       torch.zeros_like(a0))


def thincubic(edge_img, vec, slack: float = 0.99, x0: int = 0):
    """Slack variant (thincubic_float_float, oclimgutil.cl:473-491)."""
    am2, am1, a0, ap1, ap2 = _samples(edge_img, vec, x0)
    keep = ((am2 * slack <= a0) & (am1 * slack <= a0) &
            (a0 >= ap1 * slack) & (a0 >= ap2 * slack))
    return torch.where(keep, am2 + am1 + a0 + ap1 + ap2,
                       torch.zeros_like(a0))

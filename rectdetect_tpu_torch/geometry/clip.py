"""Branchless batched Cohen-Sutherland line clipping (port of
rectdetect_tpu/geometry/clip.py).

clipLineWithRect (oclrect.c:758-802) loops until accept or reject; each
endpoint is clipped against at most all 4 box sides, so 4 fixed
iterations of the update step reach the fixpoint.  NaN = rejected, like
the reference's NAN sentinel return.  The intersection x0 + dx*(y-y0)/dy
adds a quotient, so no multiply-add contracts: plain float32 operations
in the JAX order give the same bits.
"""

from __future__ import annotations

import torch

_LEFT, _RIGHT, _BOTTOM, _TOP = 1, 2, 4, 8


def _outcode(x, y, box):
    return ((x < box[..., 0]).to(torch.int32) * _LEFT
            | (x > box[..., 2]).to(torch.int32) * _RIGHT
            | (y < box[..., 1]).to(torch.int32) * _BOTTOM
            | (y > box[..., 3]).to(torch.int32) * _TOP)


def clip_segments(segs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """segs (..., 4) [x0, y0, x1, y1]; boxes (..., 4) [xmin, ymin, xmax,
    ymax], float32.  Returns (..., 4) clipped coordinates, NaN where the
    segment is rejected."""
    x0, y0, x1, y1 = segs.unbind(-1)
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    c0 = _outcode(x0, y0, boxes)
    c1 = _outcode(x1, y1, boxes)
    accept = (c0 | c1) == 0
    reject = (c0 & c1) != 0
    one = torch.ones_like(x0)
    for _ in range(4):
        active = ~accept & ~reject
        out = torch.where(c0 != 0, c0, c1)
        dx = x1 - x0
        dy = y1 - y0
        dy_safe = torch.where(dy == 0, one, dy)
        dx_safe = torch.where(dx == 0, one, dx)
        # priority: TOP, BOTTOM, RIGHT, LEFT (oclrect.c:773-785)
        is_top = (out & _TOP) != 0
        is_bot = ~is_top & ((out & _BOTTOM) != 0)
        is_right = ~is_top & ~is_bot & ((out & _RIGHT) != 0)
        nx = torch.where(is_top, x0 + dx * (ymax - y0) / dy_safe,
                         torch.where(is_bot, x0 + dx * (ymin - y0) / dy_safe,
                                     torch.where(is_right, xmax, xmin)))
        ny = torch.where(is_top, ymax,
                         torch.where(is_bot, ymin,
                                     torch.where(
                                         is_right,
                                         y0 + dy * (xmax - x0) / dx_safe,
                                         y0 + dy * (xmin - x0) / dx_safe)))
        upd0 = active & (out == c0)
        upd1 = active & (out != c0)
        x0 = torch.where(upd0, nx, x0)
        y0 = torch.where(upd0, ny, y0)
        x1 = torch.where(upd1, nx, x1)
        y1 = torch.where(upd1, ny, y1)
        c0 = _outcode(x0, y0, boxes)
        c1 = _outcode(x1, y1, boxes)
        accept = accept | ((c0 | c1) == 0)
        reject = reject | (~accept & ((c0 & c1) != 0))
    res = torch.stack([x0, y0, x1, y1], dim=-1)
    return torch.where((accept & ~reject)[..., None], res,
                       torch.full_like(res, float("nan")))

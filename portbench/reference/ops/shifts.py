"""Static-shift stencil helpers (port of rectdetect_tpu/ops/shifts.py).

Every 2D stencil of the plain path is a sum/select of statically shifted
views of a padded image, exactly as in the JAX package, so the plain
versions evaluate the same float operations in the same order.

Boundary conventions of the reference:
  * mirror(): reflect-101 (clamp(x, -x, 2w-2-x), oclimgutil.cl:41-45)
  * zero padding with an optional constant
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# 8-neighbourhood order used throughout the reference (oclpolyline.cl:63-64).
NEIGH8 = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1))
# getnp's first/second-neighbour semantics depend on exactly this scan
# order (oclpolyline.cl:169-191).
NEIGH8_REF = NEIGH8


def reflect_index(n: int, r: int, device=None) -> torch.Tensor:
    """Source index of each padded position -r..n+r-1 under reflect-101,
    reflected again where r >= n (numpy's and jnp.pad's "reflect": a
    triangle wave of period 2n - 2; a size of 1 repeats its one value)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * n - 2)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def pad2d(img: torch.Tensor, r: int, mode: str = "mirror", constant=0):
    """Pad the last two dims by r: "mirror" (reflect-101), "edge" (the
    border pixel repeated) or "zero" (filled with `constant`)."""
    if mode in ("mirror", "edge"):
        h, w = img.shape[-2], img.shape[-1]
        if mode == "mirror":
            iy = reflect_index(h, r, img.device)
            ix = reflect_index(w, r, img.device)
        else:
            iy = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
            ix = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
        return img.index_select(-2, iy).index_select(-1, ix)
    if mode == "zero":
        return F.pad(img, (r, r, r, r), value=constant)
    raise ValueError(f"unknown pad mode {mode!r}")


def shifted(padded: torch.Tensor, r: int, dy: int, dx: int, h: int, w: int):
    """View of pad2d(img, r) with out[y, x] = img_padded[y+dy, x+dx]."""
    return padded[..., r + dy:r + dy + h, r + dx:r + dx + w]


def interior_mask(h: int, w: int, margin: int, device=None, x0: int = 0,
                  w_total: int | None = None) -> torch.Tensor:
    """True for pixels at least `margin` away from every image border.

    x0/w_total: the global x of local column 0 and the true frame width,
    for a width slice of a (h, w_total) frame (the width-tiled path,
    dist/tile.py, runs ops on halo-widened tiles): "border" then means the
    true frame border.  w_total=None is the slice's own width."""
    wt = w if w_total is None else w_total
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    lo = min(max(margin - x0, 0), w)
    hi = min(max(wt - margin - x0, 0), w)
    if lo < hi:
        m[margin:h - margin, lo:hi] = True
    return m


def per_frame(fn):
    """A plain single-frame function of (H,W) maps, taking a leading frame
    axis too: with a (B,H,W) first argument, every tensor argument is cut
    frame by frame and the B results are stacked (element-wise over the
    frames, as the JAX package's vmap; a loop, since the plain versions
    are references)."""
    @functools.wraps(fn)
    def over_frames(first, *args, **kwargs):
        if first.dim() != 3:
            return fn(first, *args, **kwargs)
        return torch.stack([
            fn(first[i], *(a[i] if isinstance(a, torch.Tensor) else a
                           for a in args), **kwargs)
            for i in range(first.shape[0])])
    return over_frames

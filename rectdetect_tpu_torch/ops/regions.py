"""Region smoothing of the rect pipeline, plain PyTorch (port of the
blblur / quantize / despeckle part of rectdetect_tpu/ops/regions.py).

Everything works on the packed-Lab int32 plane (core/color.py), as the
reference does, so the integer results (blblur's truncated averages, the
quantize lattice) are exact.  These are the plain versions of kernels
#12 blblur (ops/hopper_blblur.py) and #5 quant_despeckle
(ops/hopper_quant.py).

Floats in quantize + despeckle, as jitted XLA:CPU evaluates them (found
by comparing with the jitted JAX functions):
  * the lattice snap floor(v*n + 0.5) is never within an ulp of an
    integer for lattice-centre inputs, so its contraction cannot change
    the result; the port fuses it (fp.fma) and divides by n, as the JAX
    composition does;
  * the despeckle distance is sqrt((dL^2 + da^2) + db^2) in float32 with
    no fused multiply-add, and a correctly rounded sqrt (fp.sqrt).
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.ops import fp
from rectdetect_tpu_torch.ops.shifts import pad2d, shifted

BLBLURSIZE = 4  # oclrect.cl:72


def _coord_maps(h: int, w: int, device=None):
    yy = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def _blblur_axis(packed: torch.Tensor, edge: torch.Tensor,
                 horizontal: bool) -> torch.Tensor:
    """One blblur0 (horizontal) or blblur1 (vertical) pass
    (oclrect.cl:155-205).  packed: (H,W) int32 packed Lab; edge: (H,W)
    int32 0/1 (the weak-edge map, oclrect.c:284)."""
    h, w = packed.shape
    yy, xx = _coord_maps(h, w, packed.device)
    chans = color.unpack_lab_int(packed)
    r = BLBLURSIZE + 1
    ep = pad2d(edge, r, "zero")
    cps = [pad2d(c, r, "zero") for c in chans]

    def ed(dy, dx):
        return shifted(ep, r, dy, dx, h, w) != 0

    def off(k):  # offset along the scan axis
        return (0, k) if horizontal else (k, 0)

    # cross-axis +1 offset of the diagonal-corner break test
    cross = (1, 0) if horizontal else (0, 1)
    coord = xx if horizontal else yy
    limit = w if horizontal else h
    cross_coord = yy if horizontal else xx
    cross_limit = h if horizontal else w

    oe = ed(0, 0)
    wsum = torch.zeros((h, w), dtype=torch.int32, device=packed.device)
    csum = [torch.zeros_like(wsum) for _ in range(3)]

    def accumulate(alive, k):
        nonlocal wsum
        wsum = wsum + alive.to(torch.int32)
        for i in range(3):
            csum[i] = csum[i] + torch.where(
                alive, shifted(cps[i], r, *off(k), h, w), 0)

    # negative arm: k = 0, -1, ..., -BLBLURSIZE (oclrect.cl:162-169)
    alive = torch.ones((h, w), dtype=torch.bool, device=packed.device)
    for k in range(0, -BLBLURSIZE - 1, -1):
        q = coord + k
        brk = q < 0
        brk |= (q > 0) & ed(*off(k)) & ~ed(*off(k - 1))
        brk |= ((q > 0) & (cross_coord < cross_limit - 1) & ~ed(*off(k)) &
                ed(*off(k - 1)) &
                ed(off(k)[0] + cross[0], off(k)[1] + cross[1]))
        alive = alive & ~brk
        accumulate(alive, k)

    # positive arm: k = 0..BLBLURSIZE (oclrect.cl:171-178)
    alive = torch.ones((h, w), dtype=torch.bool, device=packed.device)
    for k in range(0, BLBLURSIZE + 1):
        q = coord + k
        brk = q > limit - 1
        brk |= (q < limit - 1) & ~ed(*off(k)) & ed(*off(k + 1))
        brk |= oe & ~ed(*off(k))
        alive = alive & ~brk
        accumulate(alive, k)

    ws = torch.clamp(wsum, min=1)
    avg = [torch.div(c, ws, rounding_mode="trunc") for c in csum]
    blurred = color.pack_lab_int(*avg)
    return torch.where(wsum == 0, packed, blurred)


def blblur(packed: torch.Tensor, edge: torch.Tensor,
           iters: int = 10) -> torch.Tensor:
    """Edge-limited blur: `iters` rounds of a horizontal then a vertical
    pass (oclrect.c:286-296)."""
    p = packed
    for _ in range(iters):
        p = _blblur_axis(p, edge, True)
        p = _blblur_axis(p, edge, False)
    return p


def quantize_packed(packed: torch.Tensor, n0: int = 24, n1: int = 24,
                    n2: int = 24) -> torch.Tensor:
    """Quantize the unpacked Lab floats to n levels and repack (quantize,
    oclrect.cl:207-216).  OpenCL round() is half away from zero; the
    values are non-negative, so floor(x + 0.5) matches."""
    v = color.unpack_labf(packed)
    n = torch.tensor([n0, n1, n2], dtype=torch.float32, device=packed.device)
    q = torch.floor(fp.fma(v, n, 0.5)) / n
    return color.pack_lab(q)


def _lab_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    s = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return fp.sqrt(s + d[..., 2] * d[..., 2])


def despeckle(packed: torch.Tensor, edge_mag: torch.Tensor) -> torch.Tensor:
    """On-edge pixels take the nearest-colour off-edge 3x3 neighbour
    (despeckle, oclrect.cl:218-244); ties keep the first in (dy, dx) scan
    order.  edge_mag: the thinned edge magnitude; 'edge' is >= 1e-6."""
    h, w = packed.shape
    on_edge = edge_mag >= 1e-6
    lab = color.unpack_labf(packed)
    pp = pad2d(packed, 1, "zero")
    lp = pad2d(lab.permute(2, 0, 1), 1, "zero")
    # out-of-frame neighbours count as edge pixels: never taken
    egp = pad2d(on_edge.to(torch.int32), 1, "zero", constant=1)
    best_d = torch.full((h, w), 1e10, dtype=torch.float32,
                        device=packed.device)
    best = packed
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok = shifted(egp, 1, dy, dx, h, w) == 0
            labn = shifted(lp, 1, dy, dx, h, w).permute(1, 2, 0)
            d = _lab_dist(labn, lab)
            take = ok & (d < best_d)
            best_d = torch.where(take, d, best_d)
            best = torch.where(take, shifted(pp, 1, dy, dx, h, w), best)
    return torch.where(on_edge, best, packed)


def quantize_despeckle(packed: torch.Tensor, edge_mag: torch.Tensor,
                       n0: int = 24, n1: int = 24,
                       n2: int = 24) -> torch.Tensor:
    """quantize_packed + despeckle (oclrect.c:300-303)."""
    return despeckle(quantize_packed(packed, n0, n1, n2), edge_mag)

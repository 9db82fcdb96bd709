"""Region smoothing and region merge of the rect pipeline, plain PyTorch
(port of rectdetect_tpu/ops/regions.py).

Everything works on the packed-Lab int32 plane (core/color.py), as the
reference does, so the integer results (blblur's truncated averages, the
quantize lattice) are exact.  These are the plain versions of kernels
#12 blblur (ops/hopper_blblur.py), #5 quant_despeckle
(ops/hopper_quant.py), #6 merge mask (ops/hopper_merge_mask.py), #9 links
CCL (ops/hopper_links.py) and #8 despeckle2 (ops/hopper_despeckle2.py).
The region merge's labels are the minimum flat index of each region, so
every output here is an exact integer map.  The five plain versions take
a leading frame axis ([B,]H,W), element-wise over it (shifts.per_frame),
as the batch forms of their kernels do.  `color_reassign`, which the
reference leaves out of its pipeline, has no kernel in either package.

The border-sensitive functions take x0/w_total, the global x of local
column 0 and the true frame width, for a halo-widened width tile of the
width-tiled path (dist/tile.py): blblur's border breaks and cross-axis
test, the merge mask's junction and the merge links' interior test then
mean the true frame border.

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
import torch.nn.functional as F

from portbench.reference.core import color
from portbench.reference.ops import fp
from portbench.reference.ops.morphology import simple_junction
from portbench.reference.ops.shifts import (interior_mask, pad2d, per_frame,
                                             shifted)

BLBLURSIZE = 4  # oclrect.cl:72


def _coord_maps(h: int, w: int, device=None):
    yy = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def _blblur_axis(packed: torch.Tensor, edge: torch.Tensor,
                 horizontal: bool, x0: int = 0,
                 w_total: int | None = None) -> torch.Tensor:
    """One blblur0 (horizontal) or blblur1 (vertical) pass
    (oclrect.cl:155-205).  packed: (H,W) int32 packed Lab; edge: (H,W)
    int32 0/1 (the weak-edge map, oclrect.c:284).  The q < 0 and
    q > limit - 1 breaks and the vertical pass's cross-axis test run in
    frame columns (x + x0, against w_total): beyond-frame columns never
    contribute, so any fill is safe; at the array's own edges the taps read
    zero padding, as at the frame border."""
    h, w = packed.shape
    yy, xx = _coord_maps(h, w, packed.device)
    xx = xx + x0
    wt = w if w_total is None else w_total
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
    limit = wt if horizontal else h
    cross_coord = yy if horizontal else xx
    cross_limit = h if horizontal else wt

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


@per_frame
def blblur(packed: torch.Tensor, edge: torch.Tensor, iters: int = 10,
           x0: int = 0, w_total: int | None = None) -> torch.Tensor:
    """Edge-limited blur: `iters` rounds of a horizontal then a vertical
    pass (oclrect.c:286-296)."""
    p = packed
    for _ in range(iters):
        p = _blblur_axis(p, edge, True, x0, w_total)
        p = _blblur_axis(p, edge, False, x0, w_total)
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


@per_frame
def quantize_despeckle(packed: torch.Tensor, edge_mag: torch.Tensor,
                       n0: int = 24, n1: int = 24,
                       n2: int = 24) -> torch.Tensor:
    """quantize_packed + despeckle (oclrect.c:300-303)."""
    return despeckle(quantize_packed(packed, n0, n1, n2), edge_mag)


def _disk_offsets(rmax: int, lo_sq: int, hi_sq: int) -> list[tuple[int, int]]:
    """The (dy, dx) offsets with lo_sq <= dy^2 + dx^2 < hi_sq."""
    return [(dy, dx) for dy in range(-rmax, rmax + 1)
            for dx in range(-rmax, rmax + 1)
            if lo_sq <= dy * dy + dx * dx < hi_sq]


RING_16_36 = _disk_offsets(6, 16, 36)   # mkMergeMask0, oclrect.cl:252-258
DISK_64 = _disk_offsets(8, 0, 64)       # mkMergeMask1 ends, oclrect.cl:268
DISK_16 = _disk_offsets(4, 0, 16)       # mkMergeMask1 junctions, :278


def _dilate(mask: torch.Tensor, offsets) -> torch.Tensor:
    """Binary dilation by a symmetric structuring element, pixels outside
    the frame reading 0: a float convolution of 0/1 values, whose integer
    sums are exact in any order."""
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    ker = torch.zeros((2 * r + 1, 2 * r + 1), dtype=torch.float32)
    for dy, dx in offsets:
        ker[dy + r, dx + r] = 1.0
    x = mask.to(torch.float32)[None, None]
    return F.conv2d(x, ker.to(mask.device)[None, None], padding=r)[0, 0] > 0.5


def merge_mask(junction: torch.Tensor) -> torch.Tensor:
    """mkMergeMask0 + mkMergeMask1 (oclrect.cl:246-287): the force-merge
    ring 16 <= d^2 < 36 around junctions, cleared inside the d^2 < 64 disk
    around line ends (junction == 2) and the d^2 < 16 disk around junction
    cores (junction > 2).  Returns (H,W) int32 0/1."""
    any_jn = junction != 0
    ends = junction == 2
    m = _dilate(any_jn, RING_16_36)
    clear = _dilate(ends, DISK_64) | _dilate(any_jn & ~ends, DISK_16)
    return (m & ~clear).to(torch.int32)


@per_frame
def junction_merge_mask(strong_lbl: torch.Tensor, x0: int = 0,
                        w_total: int | None = None) -> torch.Tensor:
    """simple_junction(positive_only) + merge_mask: the plain version of
    kernel #6 (ops/hopper_merge_mask.py).  Only the junction's interior
    test sees x0/w_total: the dilations read 0 beyond the map either
    way."""
    return merge_mask(simple_junction(strong_lbl, True, x0, w_total))


def merge_pairs(packed: torch.Tensor, mask: torch.Tensor,
                edge_label: torch.Tensor, x0: int = 0,
                w_total: int | None = None):
    """Mergeability of horizontally / vertically adjacent pixels under
    labelMergeMain's rules (oclrect.cl:300-334) plus the labelxPreprocess
    seed links (oclrect.cl:289-298), as regions._merge_pairs of the JAX
    package: for a pair (a, b), b right of or below a,
        edge_label[b] <= 0 and (colours equal or mask[a] or mask[b]),
    the merging pixel interior; preprocess adds colour-equal links
    regardless (up always, left only where the up pixel differs); the
    interior in frame columns (x0/w_total).  Returns (mh (H, W-1),
    mv (H-1, W)) bool."""
    h, w = packed.shape
    eq_h = packed[:, 1:] == packed[:, :-1]
    eq_v = packed[1:, :] == packed[:-1, :]
    m = mask != 0
    blocked_h = edge_label[:, 1:] > 0
    blocked_v = edge_label[1:, :] > 0
    inter = interior_mask(h, w, 1, packed.device, x0, w_total)
    mh = ~blocked_h & ((inter[:, :-1] & (eq_h | m[:, :-1])) |
                       (inter[:, 1:] & (eq_h | m[:, 1:])))
    mv = ~blocked_v & ((inter[:-1, :] & (eq_v | m[:-1, :])) |
                       (inter[1:, :] & (eq_v | m[1:, :])))
    up_eq = torch.zeros((h, w), dtype=torch.bool, device=packed.device)
    up_eq[1:, :] = eq_v
    return mh | (eq_h & ~up_eq[:, 1:]), mv | eq_v


def label_links(mh: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """Exact 4-connected labels over the links (mh (H, W-1), mv (H-1, W)),
    every pixel foreground: the minimum flat index of each component.
    Min-label propagation along the links, hooking onto the old roots by
    scatter-min and pointer jumping, to the fixpoint."""
    h, w = mh.shape[0], mv.shape[1]
    n = h * w
    label = torch.arange(n, dtype=torch.int32, device=mh.device).reshape(h, w)
    while True:
        g = label.clone()
        g[:, 1:] = torch.minimum(g[:, 1:], torch.where(mh, label[:, :-1], n))
        g[:, :-1] = torch.minimum(g[:, :-1], torch.where(mh, label[:, 1:], n))
        g[1:, :] = torch.minimum(g[1:, :], torch.where(mv, label[:-1, :], n))
        g[:-1, :] = torch.minimum(g[:-1, :], torch.where(mv, label[1:, :], n))
        flat, gf = label.reshape(-1), g.reshape(-1)
        new = flat.scatter_reduce(0, flat.long(), gf, reduce="amin",
                                  include_self=True)
        new = torch.minimum(new, gf)
        for _ in range(4):
            new = new[new.long()]
        new = new.reshape(h, w)
        if torch.equal(new, label):
            return label
        label = new


@per_frame
def label_merge(packed: torch.Tensor, mask: torch.Tensor,
                edge_label: torch.Tensor, x0: int = 0,
                w_total: int | None = None) -> torch.Tensor:
    """Region-merge CCL (labelxPreprocess + labelMergeMain,
    oclrect.cl:289-334) at its exact fixpoint, min-flat-index labels (of
    the local array): the plain version of kernel #9
    (ops/hopper_links.py)."""
    return label_links(*merge_pairs(packed, mask, edge_label, x0, w_total))


def label_sizes(label: torch.Tensor) -> torch.Tensor:
    """calcSize (oclrect.cl:336-348): pixel count per label, (H*W,) int32;
    every pixel is labelled, with a value in [0, H*W)."""
    n = label.numel()
    tgt = torch.clamp(label.reshape(-1), 0, n - 1).long()
    sizes = torch.zeros((n,), dtype=torch.int32, device=label.device)
    return sizes.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))


def despeckle2(label: torch.Tensor, sizes: torch.Tensor,
               thre: int = 16) -> torch.Tensor:
    """Regions of <= thre px take the label of the largest in-frame 3x3
    neighbour (despeckle2, oclrect.cl:350-371), the first maximum in
    (dy, dx) scan order."""
    h, w = label.shape
    n = h * w
    sz_at = sizes[torch.clamp(label, 0, n - 1).long()]
    lp = pad2d(label, 1, "zero")
    # out-of-frame neighbours have size 0: never larger than the best
    sp = pad2d(sz_at, 1, "zero")
    best_sz = torch.zeros_like(label)
    best_lb = label
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = shifted(sp, 1, dy, dx, h, w)
            take = s > best_sz
            best_sz = torch.where(take, s, best_sz)
            best_lb = torch.where(take, shifted(lp, 1, dy, dx, h, w), best_lb)
    return torch.where(sz_at <= thre, best_lb, label).to(torch.int32)


@per_frame
def sizes_despeckle2(label: torch.Tensor, thre: int = 16) -> torch.Tensor:
    """calcSize + despeckle2 (oclrect.cl:336-371): the plain version of
    kernel #8 (ops/hopper_despeckle2.py).  The JAX package's run-length
    form (region_run_factor) gives the same output; the port runs the
    dense form only."""
    return despeckle2(label, label_sizes(label), thre)


def color_reassign(packed: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Every labelled pixel (label >= 0) takes its region's mean colour
    (colorReassign_pass0/1, oclrect.cl:392-424: present but disabled in
    the reference's pipeline, oclrect.c:346-359; for debug rendering),
    with the reference's x128 fixed-point sums: trunc(Lab * 128) summed in
    int32 per region, divided in float32 by 128 * count, and packed.
    Pixels with label < 0 keep their colour.  (H,W) int32 packed Lab."""
    h, w = packed.shape
    n = h * w
    lab = color.unpack_labf(packed).reshape(-1, 3)
    lbl = label.reshape(-1)
    ok = lbl >= 0
    tgt = torch.where(ok, torch.clamp(lbl, 0, n - 1), n).long()
    fx = torch.trunc(lab * 128.0).to(torch.int32)
    acc = torch.zeros((n + 1, 3), dtype=torch.int32, device=packed.device)
    acc.index_add_(0, tgt, torch.where(ok[:, None], fx, 0))
    cnt = torch.zeros((n + 1,), dtype=torch.int32, device=packed.device)
    cnt.index_add_(0, tgt, ok.to(torch.int32))
    mean = acc[tgt].to(torch.float32) / torch.clamp(
        cnt[tgt, None].to(torch.float32) * 128.0, min=1.0)
    out = torch.where(ok[:, None], mean, lab)
    return color.pack_lab(out.reshape(h, w, 3))

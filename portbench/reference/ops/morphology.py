"""Binary edge-map morphology, plain PyTorch (port of
rectdetect_tpu/ops/morphology.py, single-frame form).

Junction counting, 1-px gap bridging (and the 2-px bridging of the
`bridge_gap2` accuracy extension), checkerboard thinning to strings and
branch removal, each an interior-masked stencil of statically shifted
views with zero padding.  These are the plain versions of kernel K3
(ops/hopper_morph.py).

x0/w_total: the global x of local column 0 and the true frame width, for a
halo-widened width tile (dist/tile.py): the border guards then mean the
true frame border and stringify's checkerboard is frame-global.
"""

from __future__ import annotations

import torch

from portbench.reference.ops.shifts import (NEIGH8, interior_mask, pad2d,
                                             per_frame, shifted)


def _neighbor_count(nz: torch.Tensor) -> torch.Tensor:
    """#nonzero 8-neighbours (zero padding)."""
    h, w = nz.shape
    p = pad2d(nz.to(torch.int32), 1, "zero")
    cnt = torch.zeros(nz.shape, dtype=torch.int32, device=nz.device)
    for dy, dx in NEIGH8:
        cnt = cnt + shifted(p, 1, dy, dx, h, w)
    return cnt


def _masked(out: torch.Tensor, margin: int, x0: int = 0,
            w_total: int | None = None) -> torch.Tensor:
    h, w = out.shape
    m = interior_mask(h, w, margin, out.device, x0, w_total)
    return torch.where(m, out, torch.zeros_like(out)).to(torch.int32)


def simple_junction(img, positive_only: bool = False, x0: int = 0,
                    w_total: int | None = None):
    """Neighbour-degree map (simpleJunction, oclpolyline.cl:66-87): 0 for
    background/isolated pixels, else 1 + #nonzero 8-neighbours;
    positive_only is the oclrect.cl:74-95 variant (only values > 0 set)."""
    nz = (img > 0) if positive_only else (img != 0)
    cnt = 1 + _neighbor_count(nz)
    return _masked(torch.where(nz & (cnt > 1), cnt, torch.zeros_like(cnt)), 1,
                   x0, w_total)


def simple_connect_poly(jn, x0: int = 0, w_total: int | None = None):
    """1-px gap bridging on a junction-degree map (oclpolyline.cl:89-110);
    binary output, the 2-px border is zero."""
    h, w = jn.shape
    p = pad2d(jn, 2, "zero")

    def n(dy, dx):
        return shifted(p, 2, dy, dx, h, w)

    bridge = ((n(0, -2) != 0) & (n(0, -1) == 2) & (n(0, 1) == 2) & (n(0, 2) != 0))
    bridge |= ((n(-2, 0) != 0) & (n(-1, 0) == 2) & (n(1, 0) == 2) & (n(2, 0) != 0))
    bridge |= ((n(-2, -2) != 0) & (n(-1, -1) == 2) & (n(1, 1) == 2) & (n(2, 2) != 0))
    bridge |= ((n(-2, 2) != 0) & (n(-1, 1) == 2) & (n(1, -1) == 2) & (n(2, -2) != 0))
    bridge |= ((n(0, 2) != 0) & (n(0, 1) == 2) & (n(1, -1) == 2) & (n(1, -2) != 0))
    bridge |= ((n(0, -2) != 0) & (n(0, -1) == 2) & (n(1, 1) == 2) & (n(1, 2) != 0))
    bridge |= ((n(-2, 1) != 0) & (n(-1, 1) == 2) & (n(1, 0) == 2) & (n(2, 0) != 0))
    bridge |= ((n(-2, -1) != 0) & (n(-1, -1) == 2) & (n(1, 0) == 2) & (n(2, 0) != 0))
    return _masked(((jn != 0) | bridge).to(torch.int32), 2, x0, w_total)


def simple_connect_rect(jn, x0: int = 0, w_total: int | None = None):
    """The oclrect.cl:97-121 bridging variant."""
    h, w = jn.shape
    p = pad2d(jn, 1, "zero")

    def n(dy, dx):
        return shifted(p, 1, dy, dx, h, w)

    bridge = ((n(0, -1) == 2) & (n(0, 1) != 0))
    bridge |= ((n(0, -1) != 0) & (n(0, 1) == 2))
    bridge |= ((n(-1, 0) == 2) & (n(1, 0) != 0))
    bridge |= ((n(-1, 0) != 0) & (n(1, 0) == 2))
    bridge |= ((n(-1, -1) == 2) & (n(1, 1) == 2))
    bridge |= ((n(-1, 1) == 2) & (n(1, -1) == 2))
    bridge |= ((n(0, 1) == 2) & (n(1, -1) == 2))
    bridge |= ((n(0, -1) == 2) & (n(1, 1) == 2))
    bridge |= ((n(-1, 1) == 2) & (n(1, 0) == 2))
    bridge |= ((n(-1, -1) == 2) & (n(1, 0) == 2))
    return _masked(((jn != 0) | bridge).to(torch.int32), 2, x0, w_total)


def simple_connect2(conn, x0: int = 0, w_total: int | None = None):
    """2-px gap bridging, an accuracy extension over the reference
    (ops/morphology.py:simple_connect2 of the JAX package): the thinning
    drops two pixels at every staircase step of a shallow edge, and the
    reference's bridging closes 1-px gaps only.  Sets a background pixel
    of a straight 2-px gap whose two flanks are chain ends (degree 2: set,
    with exactly one set 8-neighbour), along the 4 axis and diagonal
    directions; binary output, the 2-px border is zero."""
    h, w = conn.shape
    nz = conn != 0
    deg = torch.where(nz, 1 + _neighbor_count(nz), torch.zeros_like(conn))
    p = pad2d(deg, 3, "zero")

    def end(dy, dx):
        return shifted(p, 3, dy, dx, h, w) == 2

    fill = torch.zeros((h, w), dtype=torch.bool, device=conn.device)
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        # ends at p - d and p + 2d set p; the mirrored pattern sets the
        # other pixel of the gap
        fill |= end(-dy, -dx) & end(2 * dy, 2 * dx)
        fill |= end(-2 * dy, -2 * dx) & end(dy, dx)
    return _masked((nz | fill).to(torch.int32), 2, x0, w_total)


def stringify(img, parity: int, x0: int = 0, w_total: int | None = None):
    """Checkerboard corner thinning (stringify, oclpolyline.cl:112-124): on
    pixels of the given frame-global parity, clear a pixel that has both a
    vertical and a horizontal nonzero neighbour."""
    h, w = img.shape
    p = pad2d(img, 1, "zero")

    def n(dy, dx):
        return shifted(p, 1, dy, dx, h, w) != 0

    corner = ((n(-1, 0) & n(0, -1)) | (n(-1, 0) & n(0, 1)) |
              (n(1, 0) & n(0, -1)) | (n(1, 0) & n(0, 1)))
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :] + x0
    on_parity = ((yy + xx) & 1) == parity
    clear = on_parity & corner & interior_mask(h, w, 1, img.device, x0,
                                               w_total)
    return torch.where(clear, torch.zeros_like(img), img).to(torch.int32)


def remove_branch(img, x0: int = 0, w_total: int | None = None):
    """Keep only pixels with <= 2 nonzero neighbours (oclpolyline.cl:126-147)."""
    nz = img != 0
    cnt = _neighbor_count(nz)
    return _masked((nz & (cnt <= 2)).to(torch.int32), 1, x0, w_total)


@per_frame
def strings_chain(edge_bin, variant: str, bridge2: bool = False,
                  x0: int = 0, w_total: int | None = None):
    """The edge -> strings morphology prefix: "rect" = junction(positive)
    -> connect_rect -> stringify x2 (oclrect.c:265-272); "poly_branch" =
    junction -> connect_poly -> stringify x2 -> removeBranch
    (oclpolyline.c stages 1-4).  bridge2 inserts simple_connect2 after the
    connect stage.  x0/w_total pass to every stage.  ([B,]H,W): element-
    wise over a leading frame axis."""
    o = (x0, w_total)
    if variant == "rect":
        c = simple_connect_rect(
            simple_junction(edge_bin, True, *o), *o)
    elif variant == "poly_branch":
        c = simple_connect_poly(simple_junction(edge_bin, False, *o), *o)
    else:
        raise ValueError(f"unknown strings variant {variant!r}")
    if bridge2:
        c = simple_connect2(c, *o)
    s = stringify(stringify(c, 0, *o), 1, *o)
    return s if variant == "rect" else remove_branch(s, *o)

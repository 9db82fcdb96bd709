"""Width-tile spatial parallelism: halo exchange and cross-tile labeling
(port of rectdetect_tpu/dist/tile.py).

A frame's width is cut into n tiles of Wl columns (dist/mesh.py:
`TileGroup`, one device per tile).  The JAX package runs every function
here inside shard_map, one program per tile; the port runs each stage as
a loop over the tiles, with the collectives between the loops, on lists
holding one tensor per tile:

  * stencil stages exchange `halo` columns with the neighbouring tiles,
    compute on the widened tile and crop; the border-guarded operations
    take the tile's frame column x0 and the frame's width, so "border"
    means the true frame border.  On a CUDA tile each stage launches the
    single-frame path's kernels: K1 and K2 on the widened tile, K3, the
    merge mask (#6), the links CCL (#9) and blblur (#12) in their
    x0/w_total offset forms, quant_despeckle (#5) on the widened tile and
    K4 for each tile's local labels;
  * connected components: each tile labels locally, keeps one frame-flat
    label per local root in a value table, and one seam-graph resolve
    over the tiles' two boundary columns (`_seam_resolve`, a fixed number
    of hook-and-compress rounds, so nothing waits on the device) lowers
    each root to its component's frame minimum;
  * per-component tables (strength sums, sizes) are scatter-adds over
    frame labels, summed over the tiles (integer adds: exact);
  * the geometry tail takes the gathered strong-edge and boundary maps
    (pipeline/rect.py:rect_geometry_tail) on the first tile's device.
    Over n > 1 tiles two parts of its polyline stage run by slot range
    over the tiles, as the JAX package runs them under shard_map: the arc
    walk's doubling rounds (ops/chain.py: each tile merges its range of
    the state table, an all_gather rebuilds it) and the subdivision
    (ops/mkpl.py and, on CUDA tiles, the slot-range form of kernel #14 in
    ops/hopper_mkpl.py: each tile reduces the chord distances of its
    range into per-segment keys, group.pmax/pmin combine them, the split
    pass runs on every tile's copy of the arena, and the tiles' labels
    are gathered).  The rest stays on the first tile's device: K3's
    poly_branch strings, the cycle re-walk, the arc grouping, mkpl_init,
    refine, the hypotheses with distinct_bids and hyp (#15), the quad
    reduction and the pose.  The JAX package runs that rest replicated on
    every tile, with the same result.  A one-tile group runs the
    unsharded tail.

`despeckle2_tiled`, `mark_boundary_tiled` and the summed tables are plain
PyTorch on either device, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.dist.mesh import TileGroup
from rectdetect_tpu_torch.ops import blur, regions
from rectdetect_tpu_torch.ops.hopper_blblur import blblur
from rectdetect_tpu_torch.ops.hopper_ccl import label_components
from rectdetect_tpu_torch.ops.hopper_grad import edge_front
from rectdetect_tpu_torch.ops.hopper_links import label_merge
from rectdetect_tpu_torch.ops.hopper_merge_mask import junction_merge_mask
from rectdetect_tpu_torch.ops.hopper_morph import strings_chain
from rectdetect_tpu_torch.ops.hopper_quant import quantize_despeckle
from rectdetect_tpu_torch.ops.hopper_thin import thinthres
from rectdetect_tpu_torch.ops.shifts import interior_mask, pad2d, shifted

_I32 = torch.int32


def _crop(x: torch.Tensor, halo: int) -> torch.Tensor:
    return x[..., halo:x.shape[-1] - halo].contiguous()


def halo_exchange_w(group: TileGroup, xs: list, halo: int,
                    fill: str = "reflect", fill_value=0) -> list:
    """Widen every width tile (..., H, Wl) by `halo` columns from its
    neighbours.  Interior seams get the true neighbour columns (several
    hops when halo > Wl); at the true frame borders the pad is reflect-101
    (`fill="reflect"`, the mirrored front-end stencils) or a constant
    (`fill="const"`: pick fill_value so that beyond-frame data is inert
    for the operation)."""
    n = group.n_tiles
    wl = xs[0].shape[-1]
    if fill == "reflect":
        if halo >= wl:
            raise NotImplementedError("reflect fill needs halo < tile w")
        from_left = group.fetch_from([x[..., -halo:] for x in xs], 1)
        from_right = group.fetch_from([x[..., :halo] for x in xs], -1)
        out = []
        for i, x in enumerate(xs):
            left = x[..., 1:halo + 1].flip(-1) if i == 0 else from_left[i]
            right = (x[..., -halo - 1:-1].flip(-1) if i == n - 1
                     else from_right[i])
            out.append(torch.cat([left, x, right], dim=-1))
        return out

    # hop d brings c_d columns; hops past the last tile are pure fill
    hops = []                         # (d, c_d), nearest first
    rem, d = halo, 1
    while rem > 0:
        hops.append((d, min(wl, rem)))
        rem -= min(wl, rem)
        d += 1
    lblk = {d: group.fetch_from([x[..., -c:] for x in xs], d)
            for d, c in hops if d <= n - 1}
    rblk = {d: group.fetch_from([x[..., :c] for x in xs], -d)
            for d, c in hops if d <= n - 1}
    out = []
    for i, x in enumerate(xs):
        def fill_of(c):
            return torch.full(x.shape[:-1] + (c,), fill_value,
                              dtype=x.dtype, device=x.device)
        lparts = [lblk[d][i] if d in lblk and lblk[d][i] is not None
                  else fill_of(c) for d, c in reversed(hops)]
        rparts = [rblk[d][i] if d in rblk and rblk[d][i] is not None
                  else fill_of(c) for d, c in hops]
        out.append(torch.cat([*lparts, x, *rparts], dim=-1))
    return out


def _seam_resolve(group: TileGroup, values: list, lcol_roots: list,
                  rcol_roots: list, key_cols: list, right_links: list,
                  dys, n_frame: int, extra_rounds: int = 6) -> list:
    """Exact cross-tile component resolution on the seam-node graph
    (tile.py:_seam_resolve).

    Nodes are the two boundary columns of every tile (M = n*2*H); nodes
    with one key (one local component) join star-wise through a
    representative table, and `right_links` adds the cross-seam edges.
    The graph is gathered once and resolved once, on the first tile's
    device, by hook-and-compress min-union for a fixed number of rounds,
    O(log M) (the JAX package's count, so that nothing waits on the
    device); each tile then scatter-mins its columns' component minima
    into its root table.

    values: per tile, the local root table; lcol_roots / rcol_roots: the
    local roots of the left / right column, (H,) each; key_cols: (2, H)
    frame key of the left / right column (n_frame for background nodes);
    right_links: (len(dys), H), [j, y] links the right column's row y to
    the right neighbour's left column row y + dys[j]; ignored on the last
    tile.  Returns the updated value tables."""
    dev = group.devices[0]
    n_t = group.n_tiles
    h = key_cols[0].shape[1]
    m = n_t * 2 * h
    sent_key = n_frame
    sent = m

    keys = torch.stack([k.to(dev) for k in key_cols]).reshape(m)
    node_valid = keys < sent_key
    ids = torch.arange(m, dtype=_I32, device=dev)

    # star edges within each key group
    kc = torch.clamp(keys, 0, n_frame).long()
    rep_t = torch.full((n_frame + 1,), sent, dtype=_I32, device=dev)
    rep_t = rep_t.scatter_reduce(0, kc, torch.where(node_valid, ids, sent),
                                 reduce="amin")
    rep = rep_t[kc]
    eu = [ids]
    ev = [torch.where(node_valid & (rep < sent), rep, ids)]

    if n_t > 1:
        l_all = torch.stack([lk.to(dev) for lk in right_links[:-1]])
        t_ = torch.arange(n_t - 1, dtype=_I32, device=dev)[:, None]
        y_ = torch.arange(h, dtype=_I32, device=dev)[None, :]
        for j, dy in enumerate(dys):
            yv = y_ + dy
            ok = (yv >= 0) & (yv < h) & l_all[:, j, :]
            u = (t_ * 2 + 1) * h + y_
            v = ((t_ + 1) * 2 + 0) * h + torch.clamp(yv, 0, h - 1)
            eu.append(torch.where(ok, u, 0).reshape(-1))
            ev.append(torch.where(ok, v, 0).reshape(-1))
    eu = torch.cat(eu).long()
    ev = torch.cat(ev).long()

    parent = ids
    rounds = max(8, int(math.ceil(math.log2(max(m, 2)))) + extra_rounds)
    for _ in range(rounds):
        pu = parent[eu]
        pv = parent[ev]
        parent = parent.scatter_reduce(0, eu, pv, reduce="amin")
        parent = parent.scatter_reduce(0, ev, pu, reduce="amin")
        parent = parent[parent.long()]
        parent = parent[parent.long()]
    for _ in range(4):
        parent = parent[parent.long()]

    minkey = torch.full((m,), sent_key, dtype=_I32, device=dev)
    minkey = minkey.scatter_reduce(
        0, parent.long(), torch.where(node_valid, keys, sent_key),
        reduce="amin")
    final = minkey[parent.long()]

    out = []
    for idx, value in enumerate(values):
        vdev = value.device
        my_l = final[(idx * 2 + 0) * h:(idx * 2 + 1) * h].to(vdev)
        my_r = final[(idx * 2 + 1) * h:(idx * 2 + 2) * h].to(vdev)
        kl, kr = key_cols[idx][0], key_cols[idx][1]
        lv = torch.where(kl < sent_key, my_l, sent_key)
        rv = torch.where(kr < sent_key, my_r, sent_key)
        value = value.scatter_reduce(0, lcol_roots[idx].long(), lv,
                                     reduce="amin")
        value = value.scatter_reduce(0, rcol_roots[idx].long(), rv,
                                     reduce="amin")
        out.append(value)
    return out


def _frame_index(h: int, wl: int, w: int, x0: int, device) -> torch.Tensor:
    """The frame-flat index y * w + x0 + x of every pixel of a tile,
    (H*Wl,) int32."""
    yy = torch.arange(h, dtype=_I32, device=device)[:, None]
    xg = torch.arange(wl, dtype=_I32, device=device)[None, :] + x0
    return (yy * w + xg).reshape(-1)


def ccl_tiled(group: TileGroup, pix_tiles: list, bgc: int) -> list:
    """8-connected equal-value CCL across width tiles.  pix_tiles: (H, Wl)
    int32 each.  Returns frame-flat labels (y * W + x, the component's
    minimum), -1 background: the single-frame labels of the stitched
    frame, tile by tile."""
    n, w = group.geom(pix_tiles[0].shape[1])
    h, wl = pix_tiles[0].shape
    gsent = h * w

    # 1. local labels (K4), 2. a frame label per local root
    lflats, values, fgs = [], [], []
    for i, pix in enumerate(pix_tiles):
        local = label_components(pix, bgc)
        lflat = torch.where(local >= 0, local, h * wl).reshape(-1)
        gidx = _frame_index(h, wl, w, group.x0(i, wl), pix.device)
        value = torch.full((h * wl + 1,), gsent, dtype=_I32,
                           device=pix.device)
        value = value.scatter_reduce(
            0, lflat.long(), torch.where(lflat < h * wl, gidx, gsent),
            reduce="amin")
        lflats.append(lflat)
        values.append(value)
        fgs.append(pix != bgc)

    # 3. the seam graph: 8-connected equal-value adjacency between each
    # tile's right column and its right neighbour's left column
    nbs = group.fetch_from(
        [torch.stack([pix[:, 0], fg[:, 0].to(_I32)])
         for pix, fg in zip(pix_tiles, fgs)], -1)
    dys = (-1, 0, 1)
    right_links, key_cols = [], []
    for i, (pix, fg, lflat, value) in enumerate(
            zip(pix_tiles, fgs, lflats, values)):
        if i < n - 1:
            nb = nbs[i]
            links = []
            for dy in dys:
                nb_pix = torch.roll(nb[0], -dy)
                nb_fg = torch.roll(nb[1], -dy) != 0
                links.append((nb_pix == pix[:, -1]) & nb_fg & fg[:, -1])
            right_links.append(torch.stack(links))
        else:
            right_links.append(torch.zeros((len(dys), h), dtype=torch.bool,
                                           device=pix.device))
        g0 = value[lflat.long()].reshape(h, wl)
        key_cols.append(torch.stack([torch.where(fg[:, 0], g0[:, 0], gsent),
                                     torch.where(fg[:, -1], g0[:, -1],
                                                 gsent)]))
    values = _seam_resolve(
        group, values, [lf.reshape(h, wl)[:, 0] for lf in lflats],
        [lf.reshape(h, wl)[:, -1] for lf in lflats], key_cols, right_links,
        dys, h * w)
    return [torch.where(fg, value[lflat.long()].reshape(h, wl), -1).to(_I32)
            for fg, lflat, value in zip(fgs, lflats, values)]


def _reflect_border(x: torch.Tensor, halo: int, left: bool, right: bool,
                    dim: int) -> torch.Tensor:
    """x, a tile widened by `halo` columns along `dim`, with the columns
    beyond the frame's left / right border set to the reflect-101 of the
    columns inside it, as the single frame's mirror padding reads them."""
    if left:
        x.narrow(dim, 0, halo).copy_(x.narrow(dim, halo + 1, halo).flip(dim))
    if right:
        n = x.shape[dim]
        x.narrow(dim, n - halo, halo).copy_(
            x.narrow(dim, n - 2 * halo - 1, halo).flip(dim))
    return x


def edge_frontend_tiled(group: TileGroup, bgr_tiles: list, halo: int = 16,
                        cfg: PipelineConfig = DEFAULT_CONFIG):
    """The edge front-end on width tiles: returns (edge_thin, edge_bin),
    one (H, Wl) tensor per tile, bit-equal to the single-frame front-end's
    tile.  The colour conversion runs on the tile, the blur and K1 and K2
    on the reflect-widened tile.  Two steps go beyond the JAX package's
    edge_frontend_tiled, whose tiles differ from its whole frame in float
    ulps: at the true frame border the blurred planes and the edge
    magnitude are reflected again before the next stencil reads them (the
    single frame mirrors each stage's input; a blur of the reflected
    input sums its taps in the other order), and K2 samples at frame
    columns (x0), since the rounding of a sample's float position depends
    on its column."""
    n = group.n_tiles
    wl = bgr_tiles[0].shape[1]
    labqs = []
    for bgr in bgr_tiles:
        if cfg.color_exact:
            labq = color.unpack_labf(color.bgr_to_packed_exact(bgr))
        else:
            labq = color.quantize_labf(color.bgr_to_labf(bgr))
        labqs.append(labq.permute(2, 0, 1))
    et_tiles, eb_tiles = [], []
    for i, wide in enumerate(halo_exchange_w(group, labqs, halo)):
        ends = (i == 0, i == n - 1)
        labb = _reflect_border(
            torch.stack([blur.gaussian_blur(wide[c], cfg.blur_radius)
                         for c in range(3)], dim=-1), halo, *ends, dim=1)
        em, vec = edge_front(labb)
        em = _reflect_border(em, halo, *ends, dim=1)
        et = _crop(thinthres(em, vec, x0=group.x0(i, wl) - halo), halo)
        et_tiles.append(et)
        eb_tiles.append((et > 0).to(_I32))
    return et_tiles, eb_tiles


def packed_tiled(bgr_tiles: list, cfg: PipelineConfig = DEFAULT_CONFIG):
    """The packed-Lab plane of every tile (a per-pixel conversion)."""
    if cfg.color_exact:
        return [color.bgr_to_packed_exact(b) for b in bgr_tiles]
    return [color.pack_lab(color.bgr_to_labf(b)) for b in bgr_tiles]


# ---------------------------------------------------------------------------
# the rect tail's stages on width tiles (each equals its single-frame stage's
# tile)
# ---------------------------------------------------------------------------

def strings_chain_tiled(group: TileGroup, edge_bin_tiles: list, variant: str,
                        halo: int = 12, bridge2: bool = False) -> list:
    """strings_chain (K3) on width tiles: the halo covers the stencil
    chain; x0 keeps the checkerboard parity and the border guards
    frame-global."""
    wl = edge_bin_tiles[0].shape[1]
    _, w = group.geom(wl)
    wides = halo_exchange_w(group, edge_bin_tiles, halo, fill="const")
    return [_crop(strings_chain(wide, variant, bridge2,
                                x0=group.x0(i, wl) - halo, w_total=w), halo)
            for i, wide in enumerate(wides)]


def calc_strength_tiled(group: TileGroup, edge_thin_tiles: list,
                        glabel_tiles: list, scale: float) -> list:
    """The frame's per-component strength table (n+1,), n = H*W, on every
    tile: each tile scatter-adds trunc(edge^2 * scale) of its interior
    labelled pixels by frame label, and the tables are summed
    (calcStrength, oclimgutil.cl:641-649)."""
    h, wl = glabel_tiles[0].shape
    _, w = group.geom(wl)
    n = h * w
    partials = []
    for i, (et, gl) in enumerate(zip(edge_thin_tiles, glabel_tiles)):
        inter = interior_mask(h, wl, 1, gl.device, group.x0(i, wl), w)
        lbl = gl.reshape(-1)
        e = et.reshape(-1)
        val = torch.trunc(e * e * scale).to(_I32)
        ok = inter.reshape(-1) & (lbl > 0)
        tgt = torch.where(ok, lbl, n).long()
        partial = torch.zeros((n + 1,), dtype=_I32, device=gl.device)
        partials.append(partial.index_add_(0, tgt, torch.where(ok, val, 0)))
    return group.psum(partials)


def filter_strength_tiled(group: TileGroup, glabel_tiles: list,
                          strength: list, thre: int) -> list:
    """filterStrength (oclimgutil.cl:651-657) with frame labels and the
    summed table: interior pixels (of the true frame) of components below
    `thre` become -1.  No rescue pass: the tiled labels are exact
    components, under which it changes nothing."""
    h, wl = glabel_tiles[0].shape
    _, w = group.geom(wl)
    out = []
    for i, (gl, st) in enumerate(zip(glabel_tiles, strength)):
        inter = interior_mask(h, wl, 1, gl.device, group.x0(i, wl), w)
        s = st[torch.clamp(gl, 0, st.shape[0] - 1).long()]
        kill = (gl <= 0) | (s < thre)
        out.append(torch.where(inter & kill, -1, gl).to(_I32))
    return out


def blblur_tiled(group: TileGroup, packed_tiles: list, edge_tiles: list,
                 iters: int = 10, halo: int | None = None) -> list:
    """The edge-limited blur (#12) on width tiles, one exchange up front:
    the horizontal pass reaches 5 columns a round (window 4, break tests
    5) and the vertical pass reads the edge map one column across, so a
    halo of 5 * iters + 5 makes the crop exact (56 at 10 rounds, as the
    JAX package).  The border breaks run in frame columns
    (x0/w_total)."""
    if halo is None:
        halo = 5 * iters + 6
    wl = packed_tiles[0].shape[1]
    _, w = group.geom(wl)
    wps = halo_exchange_w(group, packed_tiles, halo, fill="const")
    wes = halo_exchange_w(group, edge_tiles, halo, fill="const")
    return [_crop(blblur(wp, we, iters, x0=group.x0(i, wl) - halo,
                         w_total=w), halo)
            for i, (wp, we) in enumerate(zip(wps, wes))]


def quantize_despeckle_tiled(group: TileGroup, blurred_tiles: list,
                             edge_thin_tiles: list,
                             cfg: PipelineConfig = DEFAULT_CONFIG) -> list:
    """quantize + despeckle (#5, oclrect.c:300-303) on the widened tiles;
    the beyond-frame halo is "on edge" (edge magnitude 1e9), so the
    candidate scan skips it as the single frame's bounds test does."""
    halo = 2
    wps = halo_exchange_w(group, blurred_tiles, halo, fill="const")
    wes = halo_exchange_w(group, edge_thin_tiles, halo, fill="const",
                          fill_value=1e9)
    n = cfg.quantize_levels
    return [_crop(quantize_despeckle(wp, we, n, n, n), halo)
            for wp, we in zip(wps, wes)]


def junction_merge_mask_tiled(group: TileGroup, strong_tiles: list) -> list:
    """simple_junction + the merge mask (#6, oclrect.cl:246-287) on width
    tiles: the dilations reach 8 columns, the junction one more."""
    halo = 12
    wl = strong_tiles[0].shape[1]
    _, w = group.geom(wl)
    wides = halo_exchange_w(group, strong_tiles, halo, fill="const",
                            fill_value=-1)
    return [_crop(junction_merge_mask(wide, x0=group.x0(i, wl) - halo,
                                      w_total=w), halo)
            for i, wide in enumerate(wides)]


def label_merge_tiled(group: TileGroup, despeck_tiles: list,
                      mask_tiles: list, strong_tiles: list) -> list:
    """The region-merge CCL across width tiles (labelMergeMain,
    oclrect.cl:300-334): each tile's local labels (the links CCL, #9,
    with the tile's frame column), then the seam-graph resolve over the
    4-connected link across each seam, which regions.merge_pairs computes
    on the two-column strip [my last column | the neighbour's first] at
    the strip's frame column: the in-tile links' predicate, by
    construction.  Returns frame-flat labels, the component minima."""
    n, w = group.geom(despeck_tiles[0].shape[1])
    h, wl = despeck_tiles[0].shape
    gsent = h * w

    lflats, values = [], []
    for i, (p, mk, e) in enumerate(zip(despeck_tiles, mask_tiles,
                                       strong_tiles)):
        x0 = group.x0(i, wl)
        local = label_merge(p, mk, e, x0=x0, w_total=w)
        lflat = local.reshape(-1)
        value = torch.full((h * wl,), gsent, dtype=_I32, device=p.device)
        value = value.scatter_reduce(
            0, lflat.long(), _frame_index(h, wl, w, x0, p.device),
            reduce="amin")
        lflats.append(lflat)
        values.append(value)

    # the right neighbour's first column, received once; the up-equality
    # the preprocess seed needs is a property of that column alone, so the
    # strip's own up-shift of it is right
    from_right = group.fetch_from(
        [torch.stack([p[:, 0], mk[:, 0], e[:, 0]])
         for p, mk, e in zip(despeck_tiles, mask_tiles, strong_tiles)], -1)
    links, key_cols = [], []
    for i, (p, mk, e, lflat, value) in enumerate(
            zip(despeck_tiles, mask_tiles, strong_tiles, lflats, values)):
        if i < n - 1:
            fr = from_right[i]
            mh, _ = regions.merge_pairs(
                torch.stack([p[:, -1], fr[0]], dim=1),
                torch.stack([mk[:, -1], fr[1]], dim=1),
                torch.stack([e[:, -1], fr[2]], dim=1),
                x0=(i + 1) * wl - 1, w_total=w)
            links.append(mh[:, 0][None, :])
        else:
            links.append(torch.zeros((1, h), dtype=torch.bool,
                                     device=p.device))
        g = value[lflat.long()].reshape(h, wl)
        key_cols.append(torch.stack([g[:, 0], g[:, -1]]))
    values = _seam_resolve(
        group, values, [lf.reshape(h, wl)[:, 0] for lf in lflats],
        [lf.reshape(h, wl)[:, -1] for lf in lflats], key_cols, links, (0,),
        h * w)
    return [value[lflat.long()].reshape(h, wl)
            for lflat, value in zip(lflats, values)]


def label_sizes_tiled(group: TileGroup, glabel_tiles: list) -> list:
    """The frame's size table (calcSize, oclrect.cl:336-348), (n+1,) with
    the last slot 0 (the inert beyond-frame fill of despeckle2_tiled),
    summed over the tiles."""
    h, wl = glabel_tiles[0].shape
    _, w = group.geom(wl)
    n = h * w
    partials = []
    for gl in glabel_tiles:
        tgt = torch.clamp(gl.reshape(-1), 0, n - 1).long()
        partial = torch.zeros((n + 1,), dtype=_I32, device=gl.device)
        partials.append(partial.index_add_(
            0, tgt, torch.ones_like(tgt, dtype=_I32)))
    return group.psum(partials)


def despeckle2_tiled(group: TileGroup, glabel_tiles: list, sizes_ext: list,
                     thre: int) -> list:
    """despeckle2 (oclrect.cl:350-371) on width tiles: the 3x3 first-max
    absorb over the summed size table.  Beyond-frame candidates carry
    label n (size 0), so the strict s > best test drops them as the single
    frame's bounds check does."""
    h, wl = glabel_tiles[0].shape
    _, w = group.geom(wl)
    n = h * w
    wides = halo_exchange_w(group, glabel_tiles, 1, fill="const",
                            fill_value=n)
    out = []
    for gl, wide, sz in zip(glabel_tiles, wides, sizes_ext):
        wp = pad2d(wide, 1, "zero", constant=n)
        szp = sz[torch.clamp(wp, 0, n).long()]
        ww = wide.shape[-1]
        small = sz[torch.clamp(gl, 0, n).long()] <= thre
        best_sz = torch.zeros((h, ww), dtype=_I32, device=gl.device)
        best_lb = wide
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                s = shifted(szp, 1, dy, dx, h, ww)
                take = s > best_sz
                best_sz = torch.where(take, s, best_sz)
                best_lb = torch.where(take, shifted(wp, 1, dy, dx, h, ww),
                                      best_lb)
        out.append(torch.where(small, best_lb[:, 1:-1], gl).to(_I32))
    return out


def mark_boundary_tiled(group: TileGroup, glabel_tiles: list) -> list:
    """markBoundary (oclrect.cl:373-390) on width tiles: the 5x5
    different-label test; the 2-px true frame border is -1."""
    h, wl = glabel_tiles[0].shape
    _, w = group.geom(wl)
    wides = halo_exchange_w(group, glabel_tiles, 2, fill="const",
                            fill_value=-1)
    out = []
    for i, (gl, wide) in enumerate(zip(glabel_tiles, wides)):
        inter = interior_mask(h, wl, 2, gl.device, group.x0(i, wl), w)
        wp = pad2d(wide, 2, "edge")
        ww = wide.shape[-1]
        diff = torch.zeros((h, ww), dtype=torch.bool, device=gl.device)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                diff |= shifted(wp, 2, dy, dx, h, ww) != wide
        out.append(torch.where(inter & diff[:, 2:-2], gl, -1).to(_I32))
    return out


def _shards(group: TileGroup):
    """The group the polyline stage shards over: None for one tile."""
    return group if group.n_tiles > 1 else None


def rect_tail_maps_tiled(group: TileGroup, packed_tiles: list,
                         edge_thin_tiles: list, edge_bin_tiles: list,
                         cfg: PipelineConfig = DEFAULT_CONFIG) -> dict:
    """Every stage of the rect tail before the geometry on width tiles
    (rect_tail_tiled up to the gathers): a dict of per-tile lists,
    strings, weak, blurred, despeck, strong, mask, seg, bmark, boundary."""
    s = strings_chain_tiled(group, edge_bin_tiles, "rect",
                            bridge2=cfg.bridge_gap2)
    glabel = ccl_tiled(group, s, 0)
    st = calc_strength_tiled(group, edge_thin_tiles, glabel,
                             cfg.strength_scale)
    weak = filter_strength_tiled(group, glabel, st, cfg.strength_weak)
    weak_bin = [(x > 0).to(_I32) for x in weak]
    blurred = blblur_tiled(group, packed_tiles, weak_bin, cfg.blblur_iters)
    despeck = quantize_despeckle_tiled(group, blurred, edge_thin_tiles, cfg)
    strong = filter_strength_tiled(group, weak, st, cfg.strength_strong)
    mask = junction_merge_mask_tiled(group, strong)
    seg = label_merge_tiled(group, despeck, mask, strong)
    sizes = label_sizes_tiled(group, seg)
    seg = despeckle2_tiled(group, seg, sizes, cfg.despeckle2_thre)
    bmark = mark_boundary_tiled(group, seg)
    boundary = ccl_tiled(group, bmark, -1)
    return dict(strings=s, weak=weak, blurred=blurred, despeck=despeck,
                strong=strong, mask=mask, seg=seg, bmark=bmark,
                boundary=boundary)


def rect_tail_tiled(group: TileGroup, packed_tiles: list,
                    edge_thin_tiles: list, edge_bin_tiles: list,
                    tan_aov: float, cfg: PipelineConfig = DEFAULT_CONFIG):
    """The rect tail with every stage before the geometry on width tiles
    (pipeline/rect.py's dense, exact-label tail); the polyline, hypothesis
    and pose tail runs on the gathered strong-edge and boundary maps, on
    the first tile's device, its arc walk and subdivision by slot range
    over the tiles.  Returns a RectResult."""
    from rectdetect_tpu_torch.pipeline.rect import rect_geometry_tail

    maps = rect_tail_maps_tiled(group, packed_tiles, edge_thin_tiles,
                                edge_bin_tiles, cfg)
    sb = group.all_gather([(x > 0).to(_I32) for x in maps["strong"]], 1)
    bd = group.all_gather(maps["boundary"], 1)
    return rect_geometry_tail(sb[0], bd[0], tan_aov, cfg, _shards(group))


def rect_step_tiled(group: TileGroup, frame_tiles: list, tan_aov: float,
                    halo: int = 16, cfg: PipelineConfig = DEFAULT_CONFIG):
    """Rect detection of one frame whose width is cut into
    `group.n_tiles` tiles, frame_tiles[i] (H, Wl, 3) uint8 on
    group.devices[i] (`group.split(frame)`).  Every stage up to the
    boundary labels runs on the tiles (halo-exchanged stencils, the
    cross-tile CCLs, summed component tables); the geometry tail runs on
    the gathered maps, its arc walk and subdivision by slot range over the
    tiles.  Returns the frame's RectResult on the first tile's
    device."""
    et, eb = edge_frontend_tiled(group, frame_tiles, halo, cfg)
    return rect_tail_tiled(group, packed_tiled(frame_tiles, cfg), et, eb,
                           tan_aov, cfg)


def poly_step_tiled(group: TileGroup, frame_tiles: list,
                    cfg: PipelineConfig = DEFAULT_CONFIG,
                    minerror: float = 1.0, size_thre: int = 20,
                    strength: int = 2000, halo: int = 16):
    """The poly pipeline with the front-end and the edge labeling on width
    tiles; the polyline stage runs on the gathered filtered edge map, on
    the first tile's device, its arc walk and subdivision by slot range
    over the tiles.  Returns (SegmentArena, lsid)."""
    from rectdetect_tpu_torch.ops.polyline import polyline_execute

    et, eb = edge_frontend_tiled(group, frame_tiles, halo, cfg)
    glabel = ccl_tiled(group, eb, 0)
    st = calc_strength_tiled(group, et, glabel, cfg.strength_scale)
    filtered = filter_strength_tiled(group, glabel, st, strength)
    ef = group.all_gather([(x > 0).to(_I32) for x in filtered], 1)[0]
    ih, iw = ef.shape
    return polyline_execute(ef, minerror, size_thre, cfg.ls_cap_for(iw, ih),
                            cfg, group=_shards(group))


def rect_step_tiled_gather(group: TileGroup, frame_tiles: list,
                           tan_aov: float, halo: int = 16,
                           cfg: PipelineConfig = DEFAULT_CONFIG):
    """The oracle: only the front-end on width tiles, its products
    gathered and the whole single-frame tail run once on them
    (pipeline/rect.py:rect_tail)."""
    from rectdetect_tpu_torch.pipeline.rect import rect_tail

    et, eb = edge_frontend_tiled(group, frame_tiles, halo, cfg)
    packed = group.all_gather(packed_tiled(frame_tiles, cfg), 1)[0]
    etf = group.all_gather(et, 1)[0]
    ebf = group.all_gather(eb, 1)[0]
    return rect_tail(packed, etf, ebf, tan_aov, cfg)

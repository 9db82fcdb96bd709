"""Segment <-> region-boundary association and hypothesis grouping (port of
the boundary_comp=1 path of rectdetect_tpu/ops/reduce_ls.py).

Covers the reference's reduceLS kernel (oclrect.cl:427-464) and the
group-building half of executeCPUTask (oclrect.c:1064-1114, 1175-1188):

  * reduceLS hashes (lsid * bid) into an open table of clip boxes; the
    slot owner is the smallest (lsid, bid) claimant, which makes the
    reference's first-claimant race deterministic (colliding pairs still
    drop);
  * the 7x7 window keeps up to 4 distinct boundary ids per pixel (kernel
    #7, ops/hopper_bids.py);
  * the CPU's segid -> {lsid} sets become the k longest distinct members
    per group, from the 3x5 probe pattern (source A) or the polyline chain
    (source B).

Integer arithmetic follows the JAX package's uint32 forms in int64: the
slot hash keeps the low 31 bits of the product, and the member sort packs
(group, inverted weight, lsid) into one int64 key.  Floats follow the
jitted XLA:CPU evaluation (ops/fp.py): probe points x0 + dx*f as a fused
multiply-add, squared lengths as fma(a, a, b*b), the square root
correctly rounded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rectdetect_tpu_torch.ops import fp
from rectdetect_tpu_torch.ops.compact import Compaction
from rectdetect_tpu_torch.ops.hopper_bids import distinct_bids
from rectdetect_tpu_torch.ops.mkpl import SegmentArena
from rectdetect_tpu_torch.ops.shifts import interior_mask

_I32 = torch.int32


class PairTable(NamedTuple):
    """Deterministic stand-in for the reduceLS hash table."""
    owner_lsid: torch.Tensor   # (nentry,) int32, 0 = empty
    owner_bid: torch.Tensor    # (nentry,) int32
    bb: torch.Tensor           # (nentry, 4) int32: max(iw-x), max(x), max(ih-y), max(y)


def hash_slot(lsid: torch.Tensor, bid: torch.Tensor, nentry: int):
    """The reference's slot ((uint)lsid * (uint)bid & 0x7fffffff) % nentry
    (oclrect.cl:448): the low 31 bits of the product are those of the
    product of the low 31 bits, which fits int64."""
    m = 0x7FFFFFFF
    prod = ((lsid.long() & m) * (bid.long() & m)) & m
    return (prod % nentry).to(_I32)


def _gather(comp: Compaction, img_flat: torch.Tensor):
    """Per-slot values of a flat image, 0 in empty slots."""
    n = img_flat.shape[0]
    p = torch.clamp(comp.idx, 0, n - 1).long()
    return torch.where(comp.valid(), img_flat[p], 0)


def pair_bbox_table(boundary: torch.Tensor, lsid_img: torch.Tensor,
                    nentry: int, comp: Compaction) -> PairTable:
    """The (segment, boundary) -> clip-box table (reduceLS,
    oclrect.cl:427-464) over the interior pixels with lsid > 0, gathered
    through `comp`, a compaction covering them (the polyline's arc
    compaction), with the 4 distinct boundary ids of each pixel's 7x7
    window (kernel #7)."""
    h, w = boundary.shape
    n = h * w
    dev = boundary.device
    inter = interior_mask(h, w, 1, dev)
    lsid = torch.where(inter & (lsid_img > 0), lsid_img, 0).to(_I32)
    ls_s = _gather(comp, lsid.reshape(-1))
    live = comp.valid()
    p = torch.clamp(comp.idx, 0, n - 1)
    x_s = torch.where(live, p % w, 0).to(_I32)
    y_s = torch.where(live, p // w, 0).to(_I32)
    big = 2 ** 30

    owner_lsid = torch.full((nentry + 1,), big, dtype=_I32, device=dev)
    pairs = []
    for s in distinct_bids(boundary):
        bid = _gather(comp, s.reshape(-1))
        v = (ls_s > 0) & (bid > 0)
        hsh = torch.where(v, hash_slot(ls_s, bid, nentry), nentry).long()
        pairs.append((bid, v, hsh))
        owner_lsid = owner_lsid.scatter_reduce(
            0, hsh, torch.where(v, ls_s, big), reduce="amin")

    owner_bid = torch.full((nentry + 1,), big, dtype=_I32, device=dev)
    for bid, v, hsh in pairs:
        mine = v & (owner_lsid[hsh] == ls_s)
        owner_bid = owner_bid.scatter_reduce(
            0, hsh, torch.where(mine, bid, big), reduce="amin")

    bb = torch.zeros((nentry + 1, 4), dtype=_I32, device=dev)
    vals = torch.stack([w - x_s, x_s, h - y_s, y_s], dim=1)
    for bid, v, hsh in pairs:
        mine = v & (owner_lsid[hsh] == ls_s) & (owner_bid[hsh] == bid)
        tgt = torch.where(mine, hsh, nentry)[:, None].expand(-1, 4)
        bb = bb.scatter_reduce(0, tgt, torch.where(mine[:, None], vals, 0),
                               reduce="amax")

    owner_lsid = torch.where(owner_lsid == big, 0, owner_lsid)
    owner_bid = torch.where(owner_bid == big, 0, owner_bid)
    return PairTable(owner_lsid[:nentry], owner_bid[:nentry], bb[:nentry])


def densify_labels_sparse(label: torch.Tensor, comp: Compaction, k: int,
                          bg: int = -1):
    """Dense ids 1..count for a min-flat-index label image, in slot space:
    `comp` must cover every non-bg pixel of `label` (the boundary
    compaction).  Slot order is flat order, so the g-th root in flat order
    gets dense id g.  Returns (table (H*W+1,) flat -> dense id, 0 for
    non-roots; count; roots (k+1,) flat root index per dense id, H*W for
    id 0 and beyond count)."""
    h, w = label.shape
    n = h * w
    live = comp.valid()
    p = torch.clamp(comp.idx, 0, n - 1)
    l_s = torch.where(live, label.reshape(-1)[p.long()], bg)
    is_root = (l_s == p) & (l_s != bg) & live
    rank = torch.cumsum(is_root.to(_I32), 0, dtype=_I32)
    table = torch.zeros((n + 1,), dtype=_I32, device=label.device)
    table.scatter_(0, torch.where(is_root, p, n).long(), rank)
    table[n] = 0
    roots = torch.full((k + 2,), n, dtype=_I32, device=label.device)
    roots.scatter_(0, torch.where(is_root & (rank <= k), rank, k + 1).long(),
                   p.to(_I32))
    roots = roots[:k + 1].clone()
    roots[0] = n
    return table, rank[-1], roots


def first_k_members(g: torch.Tensor, lsid: torch.Tensor, n_groups: int,
                    k: int, cap: int, weight: torch.Tensor | None = None):
    """The k smallest distinct member lsids per group (the k largest by
    weight when given: quantized to 20 bits, ties by smallest lsid) from
    the candidate pairs (g, lsid), (M,) int32 each; pairs with g outside
    [1, n_groups] or lsid outside [1, cap) are ignored.  weight, (M,)
    float32, must be a function of lsid alone.  Returns (ids (n_groups, k)
    int32, 0-filled beyond the member count; valid (n_groups, k) bool;
    counts (n_groups+1,) int32 distinct members per group, counts[0] = 0)."""
    ok = (g > 0) & (g <= n_groups) & (lsid > 0) & (lsid < cap)
    gl = g.long()
    if weight is not None:
        # g << 20 | inverted weight must stay below the all-ones sentinel
        # of 32 bits.  The JAX package asserts n_groups < 2**11
        # (reduce_ls.py:286), which refuses the 2048 groups its own
        # calibrate may choose (calibrate.py:173-174); the key holds them
        if n_groups >= (1 << 12) - 1:
            raise ValueError(f"n_groups {n_groups} does not fit 12 bits")
        # the float's bits are monotone in its value for non-negative
        # floats; the top 20 of them, inverted, order by weight descending
        wq = torch.clamp(weight.float(), min=0.0).view(_I32).long() >> 12
        gk = torch.where(ok, (gl << 20) | ((1 << 20) - 1 - wq), 0xFFFFFFFF)
        key = (gk << 31) | torch.where(ok, lsid.long(), 0)
        skey = torch.sort(key).values
        live = (skey >> 31) < 0xFFFFFFFF
        sg = torch.where(live, skey >> 51, n_groups + 1)
        sl = torch.where(live, skey & 0x7FFFFFFF, 0)
    else:
        big = (n_groups + 2) * cap
        skey = torch.sort(torch.where(ok, gl * cap + lsid.long(), big)).values
        live = skey < big
        sg = torch.where(live, skey // cap, n_groups + 1)
        sl = torch.where(live, skey % cap, 0)
    m = skey.shape[0]
    change = torch.ones((m,), dtype=torch.bool, device=g.device)
    change[1:] = (sg[1:] != sg[:-1]) | (sl[1:] != sl[:-1])
    first = change & live
    dr = torch.cumsum(first.long(), 0) - 1          # distinct rank
    newg = first.clone()
    newg[1:] &= sg[1:] != sg[:-1]
    # dr never decreases, so a running max of dr frozen at each group's
    # first member forward-fills the group's base rank
    base = torch.cummax(torch.where(newg, dr, 0), 0).values
    rig = dr - base                                 # rank in the group
    take = first & (rig < k)
    tgt = torch.where(take, (sg - 1) * k + rig, n_groups * k)
    ids = torch.zeros((n_groups * k + 1,), dtype=_I32, device=g.device)
    ids.scatter_(0, tgt, torch.where(take, sl, 0).to(_I32))
    valid = torch.zeros((n_groups * k + 1,), dtype=torch.bool, device=g.device)
    valid.scatter_(0, tgt, take)
    counts = torch.zeros((n_groups + 2,), dtype=_I32, device=g.device)
    counts.index_add_(0, torch.where(first, sg, n_groups + 1),
                      first.to(_I32))
    return (ids[:-1].reshape(n_groups, k), valid[:-1].reshape(n_groups, k),
            counts[:n_groups + 1])


def probe_members(boundary: torch.Tensor, arena: SegmentArena, n_groups: int,
                  table: torch.Tensor, k: int, probe_n: int = 3,
                  probe_dist: int = 2, by_length: bool = False):
    """Source A's members: the boundary groups that the 3x5 probe pattern
    around each live segment hits (oclrect.c:1070-1096), the k smallest
    (by_length: the k longest) distinct member lsids per group.
    table: flat -> dense group id (densify_labels_sparse).  Returns (ids,
    valid, counts) as first_k_members."""
    h, w = boundary.shape
    n = h * w
    cap = arena.cap
    live = arena.polyid != 0
    x0, y0 = torch.round(arena.sx), torch.round(arena.sy)
    x1, y1 = torch.round(arena.ex), torch.round(arena.ey)
    dx = x1 - x0
    dy = y1 - y0
    sq = fp.fma(dx, dx, dy * dy)
    ln = torch.clamp(fp.sqrt(sq), min=1e-20)
    vdx = -dy / ln
    vdy = dx / ln
    bflat = boundary.reshape(-1)
    dense_all = []
    for j in range(probe_n):
        fj = (j + 0.5) / probe_n
        px = fp.fma(dx, fj, x0)
        py = fp.fma(dy, fj, y0)
        for dist in range(-probe_dist, probe_dist + 1):
            # vdx * dist is exact for these small integers: fused or not,
            # the sum rounds once
            cx = torch.floor(px + vdx * dist + 0.5).to(_I32)
            cy = torch.floor(py + vdy * dist + 0.5).to(_I32)
            inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & live
            flat = torch.clamp(cy, 0, h - 1) * w + torch.clamp(cx, 0, w - 1)
            segid = bflat[flat.long()]
            ok = inb & (segid > 0)
            dense = torch.where(
                ok, table[torch.clamp(segid, 0, n - 1).long()], 0)
            dense_all.append(torch.where(dense <= n_groups, dense, 0))
    reps = len(dense_all)
    g = torch.cat(dense_all)
    ls = torch.arange(cap, dtype=_I32, device=boundary.device).repeat(reps)
    wt = sq.repeat(reps) if by_length else None
    return first_k_members(g, ls, n_groups, k, cap, weight=wt)


def chain_heads(arena: SegmentArena) -> torch.Tensor:
    """Chain head of every segment (source B walks rightPtr from the heads,
    oclrect.c:1175-1188).  Every chain is one polyline (splits inherit the
    polyid), so each polyid's unique left_ptr <= 0 segment is published by
    one scatter-min; segments without a head map to themselves."""
    cap = arena.cap
    ids = torch.arange(cap, dtype=_I32, device=arena.polyid.device)
    is_head = (arena.polyid != 0) & (arena.left_ptr <= 0)
    htab = torch.full((cap + 1,), cap, dtype=_I32, device=ids.device)
    htab = htab.scatter_reduce(
        0, torch.where(is_head, torch.clamp(arena.polyid, 0, cap), cap).long(),
        torch.where(is_head, ids, cap), reduce="amin")
    ph = htab[torch.clamp(arena.polyid, 0, cap - 1).long()]
    return torch.where((arena.polyid != 0) & (ph < cap), ph, ids)


def chain_members(arena: SegmentArena, n_groups: int, k: int,
                  ls_thre: float = 32.0, by_length: bool = False):
    """Source B's members: each polyline chain (by head rank) is a group of
    its segments longer than ls_thre, the k smallest (by_length: the k
    longest) member lsids.  Returns (ids, valid)."""
    cap = arena.cap
    ids = torch.arange(cap, dtype=_I32, device=arena.polyid.device)
    heads = chain_heads(arena)
    is_head = (arena.polyid != 0) & (arena.left_ptr <= 0) & (ids > 0)
    rank = torch.cumsum(is_head.to(_I32), 0, dtype=_I32)
    head_dense = torch.where(is_head, rank, 0)
    a = arena.ex - arena.sx
    b = arena.ey - arena.sy
    sq = fp.fma(a, a, b * b)
    member = (arena.polyid != 0) & (sq > ls_thre * ls_thre)
    g = head_dense[heads.long()]
    g = torch.where(member & (g > 0) & (g <= n_groups), g, 0)
    mids, mvalid, _ = first_k_members(g, ids, n_groups, k, cap,
                                      weight=sq if by_length else None)
    return mids, mvalid

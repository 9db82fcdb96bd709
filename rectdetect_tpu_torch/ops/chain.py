"""Arc-length numbering of pixel strings with built-in loop breaking (port
of rectdetect_tpu/ops/chain.py: chain_neighbors, arc_chain_sparse).

Every string pixel p (degree <= 2 after removeBranch) has up to two
neighbours n0(p), n1(p) in the reference's scan order (oclpolyline.cl:
63-64, getnp :169-191).  The 2S walker states (k, p) = "at p, about to
step to nk(p)" are advanced by pointer doubling over the compacted slot
list, accumulating the distance, the end reached, and the smallest and
second-smallest pixel visited.  Chains get their number from the head
(the end with the smaller flat index); cycles never absorb, and each is
cut at its minimum pixel and re-numbered by a second doubling over the
cycle slots only (the walk form of breakLoops, oclpolyline.cl:157-167).

Port choices (equal output, see config.py): every doubling round runs over
the full state table (no tail sub-lists), and the cycle re-walk always
runs (the `cyc_pin=2` semantics), so no round waits on a device-to-host
branch decision.

With a TileGroup (the width-tiled path, dist/tile.py), pass A's doubling
rounds run by state range over the tiles, as the JAX package's
`_doubling_rows` runs them under shard_map: each tile gathers the rows of
its range from its copy of the packed (2S, 6) state table and merges them,
and an all_gather rebuilds the table on every tile.  Integer work on
identical tables: the result equals the unsharded walk bit for bit.  The
cycle re-walk stays whole, on the first tile's device.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops.shifts import NEIGH8_REF, interior_mask, pad2d, shifted


def chain_neighbors(label: torch.Tensor):
    """First/second same-label neighbour of every pixel as flat indices.
    label: (H,W) int32, -1 background.  Border pixels and background get
    n0 = n1 = self.  Returns (n0, n1): (H*W,) int32 each."""
    h, w = label.shape
    dev = label.device
    idx2d = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
    lblp = pad2d(label, 1, "zero", constant=-2)
    active = (label >= 0) & interior_mask(h, w, 1, dev)
    n0 = idx2d
    n1 = idx2d
    found0 = torch.zeros((h, w), dtype=torch.bool, device=dev)
    found1 = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for dy, dx in NEIGH8_REF:
        same = shifted(lblp, 1, dy, dx, h, w) == label
        nbidx = idx2d + (dy * w + dx)
        take0 = same & ~found0
        take1 = same & found0 & ~found1
        n0 = torch.where(take0, nbidx, n0)
        n1 = torch.where(take1, nbidx, n1)
        found1 = found1 | take1
        found0 = found0 | same
    n0 = torch.where(active, n0, idx2d)
    n1 = torch.where(active, n1, idx2d)
    return n0.reshape(-1), n1.reshape(-1)


def _merge2(m1, m2, b1, b2, n: int):
    """(min, 2nd-min) of the union of two visited-pixel windows; a
    duplicate minimum is not counted twice (chain._merge2)."""
    dup = m1 == b1
    cand = torch.where(dup, n, torch.maximum(m1, b1))
    return (torch.minimum(m1, b1),
            torch.minimum(torch.minimum(m2, b2), cand))


def set_drop(dst: torch.Tensor, tgt: torch.Tensor, val: torch.Tensor):
    """dst.at[tgt].set(val, mode="drop") for tgt in [0, len(dst)]; the
    targets below len(dst) are unique."""
    ext = torch.cat([dst, dst.new_zeros(1)])
    ext.scatter_(0, tgt.long(), val.to(dst.dtype))
    return ext[:-1]


def _doublings_by_range(group, state, rounds: int, n: int):
    """`rounds` doubling rounds of the pass-A state (dist, ptr, minv, term,
    end, minv2) by state range over `group`'s tiles.  The tables each tile
    receives are shared with the tiles on its device and only read; every
    round's rows are new tensors.  Returns the state on the first tile's
    device."""
    m = state[0].shape[0]
    tabs = group.broadcast(torch.stack(state, dim=1))
    for _ in range(rounds):
        pieces = []
        for i, tab in enumerate(tabs):
            lo, hi = group.slot_range(i, m)
            own = tab[lo:hi]
            rows = tab[own[:, 1].long()]
            minv, minv2 = _merge2(own[:, 2], own[:, 5], rows[:, 2],
                                  rows[:, 5], n)
            pieces.append(torch.stack([own[:, 0] + rows[:, 0], rows[:, 1],
                                       minv, rows[:, 3], rows[:, 4], minv2],
                                      dim=1))
        tabs = group.all_gather(pieces, 0)
    return tabs[0].unbind(1)


def arc_chain_sparse(strings: torch.Tensor, comp, n_doublings: int,
                     cyc_cap: int, group=None):
    """Arc numbering over the slots of `comp` (a Compaction of the strings
    foreground); with `group` (a dist.mesh.TileGroup whose first tile holds
    the inputs) pass A's doublings run by state range over its tiles.
    Returns (number_s, head_s, live, cyc, chainlen_s,
    arcmin_s), each (S,):
      number_s   arc index from the head (0 at heads, cycle roots, bg)
      head_s     flat index of the chain head
      live       slot validity
      cyc        slot lies on a cycle
      chainlen_s chain pixel count excluding the head
      arcmin_s   labelpl arc id: min flat index over the arc (head excluded)
    """
    h, w = strings.shape
    n = h * w
    dev = strings.device
    i32 = torch.int32
    lbl01 = torch.where(strings != 0, 0, -1).to(i32)
    n0, n1 = chain_neighbors(lbl01)

    S = comp.cap
    live = comp.valid()
    p_s = torch.clamp(comp.idx, 0, n - 1)
    pl = p_s.long()
    n0_s = n0[pl]
    n1_s = n1[pl]

    # ---- pass A: full walk with min-visited accumulation ----------------
    nk = torch.cat([n0_s, n1_s])
    p_rep = torch.cat([p_s, p_s])
    live2 = torch.cat([live, live])
    absorbing = (nk == p_rep) | ~live2
    nkc = torch.clamp(nk, 0, n).long()
    q_slot_raw = comp.slot_of[nkc]
    n0_ext = torch.cat([n0, n0.new_full((1,), n)])
    q_ok = q_slot_raw < S
    q_slot = torch.clamp(q_slot_raw, 0, S - 1)
    absorbing = absorbing | ~q_ok
    kprime = (n0_ext[nkc] == p_rep).to(i32)
    self_state = torch.arange(2 * S, dtype=i32, device=dev)
    ptr = torch.where(absorbing, self_state, kprime * S + q_slot).to(i32)
    dist = (~absorbing).to(i32)
    minv = p_rep.clone()
    minv2 = torch.full_like(minv, n)
    absorb0 = absorbing
    term = absorb0.to(i32)[ptr.long()]
    end = p_rep[ptr.long()]

    if group is not None:
        dist, ptr, minv, term, end, minv2 = _doublings_by_range(
            group, (dist, ptr, minv, term, end, minv2), n_doublings, n)
    else:
        for _ in range(n_doublings):
            pt = ptr.long()
            r_dist, r_ptr, r_minv = dist[pt], ptr[pt], minv[pt]
            r_term, r_end, r_minv2 = term[pt], end[pt], minv2[pt]
            dist = dist + r_dist
            minv, minv2 = _merge2(minv, minv2, r_minv, r_minv2, n)
            term, end, ptr = r_term, r_end, r_ptr

    absorbed = term != 0
    e0, d0, a0 = end[:S], dist[:S], absorbed[:S]
    e1, d1, a1 = end[S:], dist[S:], absorbed[S:]
    pick0 = e0 <= e1
    num_path = torch.where(pick0, d0, d1)
    okdir = torch.where(pick0, a0, a1)
    head_path = torch.minimum(e0, e1)

    # ---- cycle detection + root kill -------------------------------------
    cyc = live & ~a0 & ~a1
    root = torch.minimum(minv[:S], minv[S:])
    is_root = cyc & (p_s == root)
    sub = cyc & ~is_root

    number_s = torch.where(live & okdir & ~cyc, num_path, 0).to(i32)
    head_s = head_path
    chainlen_s = torch.where(live & a0 & a1, d0 + d1, 0).to(i32)
    arcmin_s = torch.minimum(minv[:S], minv[S:])

    # ---- pass B: re-number the cut cycles over a cycle sub-list ----------
    C = cyc_cap
    slot_ids = torch.arange(S, dtype=i32, device=dev)
    ranks = torch.cumsum(sub.to(i32), 0, dtype=i32) - 1
    take = sub & (ranks < C)                  # overflow -> number 0
    sub_idx = torch.full((C + 1,), S, dtype=i32, device=dev).scatter_reduce(
        0, torch.where(take, ranks, C).long(), slot_ids, reduce="amin",
        include_self=True)[:C]
    sub_of = torch.full((S + 1,), C, dtype=i32, device=dev).scatter_reduce(
        0, torch.where(take, slot_ids, S).long(), torch.where(take, ranks, C),
        reduce="amin", include_self=True)
    sub_of[S] = C

    ssafe = torch.clamp(sub_idx, 0, S - 1).long()
    sub_live = sub_idx < S
    p2 = p_s[ssafe]
    r2 = root[ssafe]
    n0_2 = n0_s[ssafe]
    n1_2 = n1_s[ssafe]

    nk2 = torch.cat([n0_2, n1_2])
    p2_rep = torch.cat([p2, p2])
    r2_rep = torch.cat([r2, r2])
    live2b = torch.cat([sub_live, sub_live])
    absorbing2 = (nk2 == p2_rep) | (nk2 == r2_rep) | ~live2b
    qs2 = comp.slot_of[torch.clamp(nk2, 0, n).long()]
    q2 = sub_of[torch.clamp(qs2, 0, S).long()]
    q2ok = q2 < C
    q2 = torch.clamp(q2, 0, C - 1)
    absorbing2 = absorbing2 | ~q2ok
    kp2 = (n0_2[q2.long()] == p2_rep).to(i32)
    self2 = torch.arange(2 * C, dtype=i32, device=dev)
    ptr2 = torch.where(absorbing2, self2, kp2 * C + q2).to(i32)
    dist2 = (~absorbing2).to(i32)
    ab02 = absorbing2

    k_c = min(n_doublings, max(1, (C - 1).bit_length()))
    for _ in range(k_c):
        pt = ptr2.long()
        dist2 = dist2 + dist2[pt]
        ptr2 = ptr2[pt]

    absorbed2 = ab02[ptr2.long()]
    end2 = p2_rep[ptr2.long()]
    e0b, d0b, a0b = end2[:C], dist2[:C], absorbed2[:C]
    e1b, d1b, a1b = end2[C:], dist2[C:], absorbed2[C:]
    pick0b = e0b <= e1b
    numb = torch.where(pick0b, d0b, d1b)
    okb = torch.where(pick0b, a0b, a1b)
    headb = torch.minimum(e0b, e1b)
    numb = torch.where(sub_live & okb, numb, 0).to(i32)
    hb_slot = comp.slot_of[torch.clamp(headb, 0, n).long()]
    hb_sub = sub_of[torch.clamp(hb_slot, 0, S).long()]
    grp_ok = sub_live & (numb > 0) & (hb_sub < C)
    grp = torch.where(grp_ok, hb_sub, C).long()
    sizes_c = torch.zeros((C + 1,), dtype=i32, device=dev)
    sizes_c.index_add_(0, grp, grp_ok.to(i32))
    amin_c = torch.full((C + 1,), n, dtype=i32, device=dev).scatter_reduce(
        0, grp, p2, reduce="amin", include_self=True)
    gsafe = torch.clamp(hb_sub, 0, C - 1).long()
    lenb = torch.where(grp_ok, sizes_c[gsafe], 0).to(i32)
    minb = torch.where(grp_ok, amin_c[gsafe], n).to(i32)

    tgt = torch.where(sub_live, sub_idx, S)
    number_s = set_drop(number_s, tgt, numb)
    head_s = set_drop(head_s, tgt, headb)
    chainlen_s = set_drop(chainlen_s, tgt, lenb)
    arcmin_s = set_drop(arcmin_s, tgt, minb)

    # non-cycle slots: exclude the head pixel from the arc id (labelpl
    # drops number == 0)
    mh1 = torch.where(pick0, minv[:S], minv[S:])
    mh2 = torch.where(pick0, minv2[:S], minv2[S:])
    mt1 = torch.where(pick0, minv[S:], minv[:S])
    arc_nohead = torch.minimum(torch.where(mh1 == head_path, mh2, mh1), mt1)
    arcmin_s = torch.where(cyc, arcmin_s, arc_nohead)
    return number_s, head_s, live, cyc, chainlen_s, arcmin_s

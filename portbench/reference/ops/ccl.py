"""Connected-component labeling and per-component strength, plain PyTorch
(port of the subset of rectdetect_tpu/ops/ccl.py that the port runs).

Labels are the minimum flat index of each 8-connected equal-value
component, background -1 (the reference's converged fixpoint of
labelxPreprocess / label8xMain, oclimgutil.cl:495-538).  The plain version
runs min-label propagation with pointer jumping and scatter-min to its
fixpoint, like ccl.label_components_converged; it is the plain version of
kernel K4 (ops/hopper_ccl.py).

The strength filters (calcStrength / filterStrength, dense or over a slot
list) and `rescue_filtered` are XLA in the JAX package, with no Pallas
kernel, and are plain PyTorch here on either device: the per-component
sums are int32 `index_add_`, exact in any order.
"""

from __future__ import annotations

import torch

from portbench.reference.ops.compact import Compaction
from portbench.reference.ops.scan import seg_total_sorted
from portbench.reference.ops.shifts import NEIGH8, interior_mask, pad2d, shifted


def _ccl_pass(label2d: torch.Tensor, pix: torch.Tensor, bgc: int):
    """One propagation pass over a sentinel-coded (background = N) label
    image: 8-neighbour equal-value min, 6 pointer jumps, scatter-min to the
    old roots (ccl._ccl_pass_free)."""
    h, w = pix.shape
    n = h * w
    sent = n
    label = label2d.reshape(-1)
    lblp = pad2d(label2d, 1, "zero", constant=sent)
    pixq = pad2d(pix, 1, "zero", constant=bgc ^ 0x55555555)
    g = label2d
    for dy, dx in NEIGH8:
        cand = shifted(lblp, 1, dy, dx, h, w)
        same = shifted(pixq, 1, dy, dx, h, w) == pix
        g = torch.minimum(g, torch.where(same, cand, sent))
    g = g.reshape(-1)
    ext = torch.cat([label, label.new_full((1,), sent)])
    for _ in range(6):
        g = ext[g.long()]
    fg = pix.reshape(-1) != bgc
    og = torch.where(fg, label, sent)
    g = torch.where(fg, g, sent)
    new = ext.scatter_reduce(0, og.long(), g, reduce="amin",
                             include_self=True)[:n]
    return torch.minimum(new, g).reshape(h, w)


def label_components_plain(pix: torch.Tensor, bgc: int) -> torch.Tensor:
    """Exact labels by propagation to the fixpoint. pix (H,W) int32."""
    h, w = pix.shape
    sent = h * w
    fg = pix.reshape(-1) != bgc
    idx = torch.arange(sent, dtype=torch.int32, device=pix.device)
    cur = torch.where(fg, idx, sent).reshape(h, w).to(torch.int32)
    prev = None
    while prev is None or not torch.equal(prev, cur):
        prev, cur = cur, _ccl_pass(cur, pix, bgc)
    ext = torch.cat([cur.reshape(-1), cur.new_full((1,), sent)])
    for _ in range(6):
        ext = ext[ext.long()]
    return torch.where(fg, ext[:-1], -1).reshape(h, w).to(torch.int32)


def calc_strength(edge_img: torch.Tensor, label: torch.Tensor,
                  scale: float = 10000.0,
                  comp: Compaction | None = None) -> torch.Tensor:
    """Per-component sum of (int)(edge^2 * scale) over interior pixels with
    label > 0 (calcStrength, oclimgutil.cl:641-649). Returns (H*W,) int32
    indexed by label.

    comp: a slot list of the labelled pixels (compact_mask); the sums then
    run over its live slots only, so a pixel beyond its capacity adds
    nothing, as in the JAX package."""
    h, w = edge_img.shape
    n = h * w
    dev = edge_img.device
    if comp is not None:
        p = torch.clamp(comp.idx, 0, n - 1).long()
        yy, xx = p // w, p % w
        inter = (yy >= 1) & (yy < h - 1) & (xx >= 1) & (xx < w - 1)
        lbl = label.reshape(-1)[p]
        e = edge_img.reshape(-1)[p]
        ok = comp.valid() & inter & (lbl > 0)
    else:
        inter = interior_mask(h, w, 1, dev).reshape(-1)
        lbl = label.reshape(-1)
        e = edge_img.reshape(-1)
        ok = inter & (lbl > 0)
    val = torch.trunc(e * e * scale).to(torch.int32)
    tgt = torch.where(ok, lbl, n).long()
    acc = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    acc.index_add_(0, tgt, torch.where(ok, val, 0))
    return acc[:n]


def filter_strength(label: torch.Tensor, strength: torch.Tensor,
                    thre: int, comp: Compaction | None = None
                    ) -> torch.Tensor:
    """Interior pixels whose component strength < thre (or label <= 0)
    become -1; border pixels keep their label (filterStrength,
    oclimgutil.cl:651-657).

    comp: a slot list covering the label > 0 pixels; only its live slots
    can survive, so an interior pixel beyond its capacity becomes -1, as
    in the JAX package."""
    h, w = label.shape
    n = h * w
    inter = interior_mask(h, w, 1, label.device).reshape(-1)
    lbl = label.reshape(-1)
    if comp is not None:
        live = comp.valid()
        p = torch.clamp(comp.idx, 0, n - 1).long()
        lbl_s = torch.where(live, lbl[p], 0)
        st_s = strength[torch.clamp(lbl_s, 0, strength.shape[0] - 1).long()]
        keep = live & (lbl_s > 0) & (st_s >= thre)
        base = torch.cat([torch.where(inter, -1, lbl).to(torch.int32),
                          lbl.new_zeros((1,))])
        out = base.scatter(0, torch.where(keep, p, n), lbl_s)[:n]
        return out.reshape(h, w)
    st = strength[torch.clamp(lbl, 0, strength.shape[0] - 1).long()]
    kill = (lbl <= 0) | (st < thre)
    return torch.where(inter & kill, -1, lbl).reshape(h, w).to(torch.int32)


def rescue_filtered(pre_label: torch.Tensor, filtered: torch.Tensor,
                    rounds: int = 3) -> torch.Tensor:
    """Fail-open repair of strength filtering (the `strength_rescue_rounds`
    accuracy extension, ccl.rescue_filtered of the JAX package): a killed
    foreground pixel (pre_label > 0) that is 8-adjacent to a surviving
    pixel (> 0) takes its pre-filter label back, `rounds` times.  Such a
    pixel is in the surviving pixel's component, so exact filtering keeps
    it; it repairs piece labels, pixels dropped past a slot list, and the
    border pixels that filterStrength leaves labelled.  Returns the
    repaired image, (H,W) int32."""
    h, w = pre_label.shape
    fg = pre_label > 0
    out = filtered
    for _ in range(rounds):
        surv = out > 0
        sp = pad2d(surv.to(torch.uint8), 1, "zero")
        near = torch.zeros((h, w), dtype=torch.uint8, device=surv.device)
        for dy, dx in NEIGH8:
            near = near | shifted(sp, 1, dy, dx, h, w)
        out = torch.where(fg & ~surv & (near != 0), pre_label, out)
    return out.to(torch.int32)


def strength_filter_pair_dense(edge_img: torch.Tensor, label: torch.Tensor,
                               cap: int, thre_weak: int, thre_strong: int,
                               scale: float = 10000.0):
    """calcStrength plus filterStrength at both thresholds
    (oclimgutil.cl:641-657; thresholds oclrect.c:277/307), in the
    label-sorted form of ccl.strength_filter_pair_dense: one stable sort
    by label of the interior labelled pixels, per-component totals from
    the segmented scan (kernel #10, ops/hopper_scan.py) saturating at
    max(thresholds), which keeps every threshold compare exact, and one
    scatter over the first `cap` sorted rows.

    The stable sort orders equal labels by flat index, so beyond `cap` the
    pixels of the largest labels drop first, and within the last run the
    highest flat indices; dropped interior pixels read as filtered (-1),
    as in the JAX package.  Returns (weak_img, strong_img) (H,W) int32."""
    h, w = edge_img.shape
    n = h * w
    if n >= 1 << 29:
        raise ValueError("the strength pair tags labels with bit 29")
    thre_max = int(max(thre_weak, thre_strong))
    skey, s_cl, order = strength_table(edge_img, label, cap, thre_max, scale)
    tot = seg_total_sorted(skey, s_cl, thre_max)

    flag = 1 << 29
    keep_w = (skey < n) & (tot >= thre_weak)
    tagged = torch.where(tot >= thre_strong, skey + flag, skey)
    inter = interior_mask(h, w, 1, edge_img.device).reshape(-1)
    lbl = label.reshape(-1)
    base = torch.cat([torch.where(inter, -1, lbl).to(torch.int32),
                      lbl.new_zeros((1,))])
    out = base.scatter(0, torch.where(keep_w, order, n), tagged)[:n]
    weak = torch.where(out >= flag, out - flag, out).reshape(h, w)
    strong = torch.where(out >= flag, out - flag, base[:n]).reshape(h, w)
    return weak, strong


def strength_table(edge_img: torch.Tensor, label: torch.Tensor, cap: int,
                   thre_max: int, scale: float = 10000.0):
    """The strength pair's sorted table: the interior labelled pixels'
    labels (n for every other pixel) sorted stably, with each pixel's
    strength trunc(edge^2 * scale) clamped at thre_max, cut to the first
    `cap` rows.  Returns (key, value, flat index), (cap,) each."""
    h, w = edge_img.shape
    n = h * w
    inter = interior_mask(h, w, 1, edge_img.device).reshape(-1)
    lbl = label.reshape(-1)
    live = inter & (lbl > 0)
    key = torch.where(live, lbl, n).to(torch.int32)
    e = edge_img.reshape(-1)
    val = torch.trunc(e * e * scale).to(torch.int32)
    cl = torch.where(live, torch.clamp(val, max=thre_max), 0).to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    order = order[:cap]
    return skey[:cap].contiguous(), cl[order].contiguous(), order

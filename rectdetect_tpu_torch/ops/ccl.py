"""Connected-component labeling and per-component strength, plain PyTorch
(port of the poly-path subset of rectdetect_tpu/ops/ccl.py).

Labels are the minimum flat index of each 8-connected equal-value
component, background -1 (the reference's converged fixpoint of
labelxPreprocess / label8xMain, oclimgutil.cl:495-538).  The plain version
runs min-label propagation with pointer jumping and scatter-min to its
fixpoint, like ccl.label_components_converged; it is the plain version of
kernel K4 (ops/hopper_ccl.py).
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops.shifts import NEIGH8, interior_mask, pad2d, shifted


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
                  scale: float = 10000.0) -> torch.Tensor:
    """Per-component sum of (int)(edge^2 * scale) over interior pixels with
    label > 0 (calcStrength, oclimgutil.cl:641-649). Returns (H*W,) int32
    indexed by label."""
    h, w = edge_img.shape
    n = h * w
    inter = interior_mask(h, w, 1, edge_img.device).reshape(-1)
    lbl = label.reshape(-1)
    e = edge_img.reshape(-1)
    val = torch.trunc(e * e * scale).to(torch.int32)
    ok = inter & (lbl > 0)
    tgt = torch.where(ok, lbl, n).long()
    acc = torch.zeros((n + 1,), dtype=torch.int32, device=edge_img.device)
    acc.index_add_(0, tgt, torch.where(ok, val, 0))
    return acc[:n]


def filter_strength(label: torch.Tensor, strength: torch.Tensor,
                    thre: int) -> torch.Tensor:
    """Interior pixels whose component strength < thre (or label <= 0)
    become -1; border pixels keep their label (filterStrength,
    oclimgutil.cl:651-657)."""
    h, w = label.shape
    inter = interior_mask(h, w, 1, label.device).reshape(-1)
    lbl = label.reshape(-1)
    st = strength[torch.clamp(lbl, 0, strength.shape[0] - 1).long()]
    kill = (lbl <= 0) | (st < thre)
    return torch.where(inter & kill, -1, lbl).reshape(h, w).to(torch.int32)

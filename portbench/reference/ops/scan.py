"""The segmented scans of kernel #10 in plain PyTorch (the port's plain
forms, frozen)."""

from __future__ import annotations

import torch


def _starts(key: torch.Tensor) -> torch.Tensor:
    st = torch.ones_like(key, dtype=torch.bool)
    st[1:] = key[1:] != key[:-1]
    return st


def seg_scan_sorted(key: torch.Tensor, val: torch.Tensor, op: str = "satsum",
                    cap: int = 2 ** 30) -> torch.Tensor:
    """#10: inclusive segmented scan of val (S,) int32 over the equal-key
    runs of key (S,) int32, saturating at cap (satsum) or the running
    maximum."""
    if op not in ("satsum", "max"):
        raise ValueError(f"unknown scan op {op!r}")
    s = key.shape[0]
    if s == 0:
        return val.clone()
    st = _starts(key)
    v = val.long()
    idx = torch.arange(s, device=key.device)
    if op == "max":
        seg = torch.cumsum(st.long(), 0) - 1
        enc = torch.cummax((seg << 32) | v, 0).values
        return (enc - (seg << 32)).to(torch.int32)
    first = torch.cummax(torch.where(st, idx, 0), 0).values
    cs = torch.cumsum(v, 0)
    run = cs - (cs[first] - v[first])
    return torch.where(st, v, torch.clamp(run, max=cap)).to(torch.int32)


def seg_total_sorted(key: torch.Tensor, val: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """#10's total form: every element of an equal-key run gets the run's
    saturating sum."""
    fwd = seg_scan_sorted(key, val, "satsum", cap)
    return torch.flip(seg_scan_sorted(torch.flip(key, (0,)),
                                      torch.flip(fwd, (0,)), "max", cap),
                      (0,))

"""Kernel #10 seg_scan: segmented scans over sorted 1-D tables.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_scan.py:_seg_scan_kernel
(seg_scan_sorted, seg_total_sorted).  CUDA source: csrc/scan.cu, a
three-phase scan (tile scans, one block for the tile carries, a fix-up of
each tile's leading run) in three launches per scan; a scan is bound by
device memory, 12 B per element, and `seg_total_sorted`, two scans, needs
those 12 B once but moves them twice.  The TPU kernel carried (last key,
running value) from one sequential grid step to the next; Hopper's blocks
run in parallel, hence the carry pass.

Segments are maximal runs of equal keys (the keys need not be sorted).
Values must be non-negative.  'satsum' sums saturating at `cap` (each
segment's first element keeps its own value), 'max' takes the running
maximum.  The 64-bit sum inside the kernel never wraps, so the results
equal the JAX kernel's wherever its int32 sums do not overflow.

`seg_scan_sorted` and `seg_total_sorted` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import torch

from rectdetect_tpu_torch.ops import _build

_OPS = {"satsum": 0, "max": 1}
_TILE = 1024          # csrc/scan.cu kTile

launches = 0


def _starts(key: torch.Tensor) -> torch.Tensor:
    st = torch.ones_like(key, dtype=torch.bool)
    st[1:] = key[1:] != key[:-1]
    return st


def seg_scan_plain(key: torch.Tensor, val: torch.Tensor, op: str = "satsum",
                   cap: int = 2 ** 30) -> torch.Tensor:
    """Inclusive segmented scan of val (S,) int32 over the equal-key runs
    of key (S,) int32, in index order; vectorised over 64-bit prefix
    sums / maxima."""
    if op not in _OPS:
        raise ValueError(f"unknown scan op {op!r}")
    s = key.shape[0]
    if s == 0:
        return val.clone()
    st = _starts(key)
    v = val.long()
    idx = torch.arange(s, device=key.device)
    if op == "max":
        # segment number in the high word: the running maximum restarts at
        # every segment because later segments encode larger numbers
        seg = torch.cumsum(st.long(), 0) - 1
        enc = torch.cummax((seg << 32) | v, 0).values
        return (enc - (seg << 32)).to(torch.int32)
    first = torch.cummax(torch.where(st, idx, 0), 0).values
    cs = torch.cumsum(v, 0)
    run = cs - (cs[first] - v[first])
    return torch.where(st, v, torch.clamp(run, max=cap)).to(torch.int32)


def seg_total_plain(key: torch.Tensor, val: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """Every element of an equal-key run gets the run's saturating sum."""
    fwd = seg_scan_plain(key, val, "satsum", cap)
    return torch.flip(seg_scan_plain(torch.flip(key, (0,)),
                                     torch.flip(fwd, (0,)), "max", cap), (0,))


def _launch(key, val, op: str, cap: int, rev: bool) -> torch.Tensor:
    global launches
    s = key.shape[0]
    _build.check(key, "key", torch.int32, (s,))
    _build.check(val, "val", torch.int32, (s,))
    if not 0 <= cap < 2 ** 31:
        raise ValueError(f"cap must fit int32, got {cap}")
    out = torch.empty_like(val)
    scratch = torch.empty((4 * max(1, -(-s // _TILE)),), dtype=torch.int32,
                          device=key.device)
    _build.launch("rd_seg_scan", key.device, key.data_ptr(), val.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), s, _OPS[op], cap,
                  int(rev))
    launches += 1
    return out


def seg_scan_sorted(key: torch.Tensor, val: torch.Tensor, op: str = "satsum",
                    cap: int = 2 ** 30) -> torch.Tensor:
    """key, val (S,) int32 -> (S,) int32 segmented inclusive scan."""
    if op not in _OPS:
        raise ValueError(f"unknown scan op {op!r}")
    if not _build.on_cuda(key, val):
        return seg_scan_plain(key, val, op, cap)
    return _launch(key, val, op, cap, False)


def seg_total_sorted(key: torch.Tensor, val: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Per-element segment total saturating at cap: a forward satsum scan
    (totals land at run ends), then a reverse max scan spreads each run's
    end value over the run (ops/pallas_scan.py:169-179)."""
    if not _build.on_cuda(key, val):
        return seg_total_plain(key, val, cap)
    fwd = _launch(key, val, "satsum", cap, False)
    return _launch(key, fwd, "max", cap, True)

"""Kernel #10 seg_scan: segmented scans over sorted 1-D tables.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_scan.py:_seg_scan_kernel
(seg_scan_sorted, seg_total_sorted).  CUDA source: csrc/scan.cu.
`seg_total_sorted` (the strength pair's per-element run totals, on the
main path) is one cooperative launch: tile scans in registers publish
tile descriptors, and after one grid barrier each tile looks back and
forward over them for the carries of the runs that cross its edges; it
reads key and val once and writes the totals once, 12 B per element, the
bound.  `seg_scan_sorted` (off the main path) keeps the three-phase form
(tile scans, one block for the tile carries, a fix-up of each tile's
leading run) in three launches.  The TPU kernel carried (last key,
running value) from one sequential grid step to the next; Hopper's blocks
run in parallel, hence the carries.

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
# kernels launched per seg_total_sorted call (of a non-empty table)
TOTAL_KERNELS = 1

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


def _check(key, val, cap: int) -> int:
    """Raise unless key and val are (S,) int32 CUDA tensors and cap fits
    int32; returns S."""
    s = key.shape[0]
    _build.check(key, "key", torch.int32, (s,))
    _build.check(val, "val", torch.int32, (s,))
    if not 0 <= cap < 2 ** 31:
        raise ValueError(f"cap must fit int32, got {cap}")
    return s


def seg_scan_sorted(key: torch.Tensor, val: torch.Tensor, op: str = "satsum",
                    cap: int = 2 ** 30) -> torch.Tensor:
    """key, val (S,) int32 -> (S,) int32 segmented inclusive scan."""
    if op not in _OPS:
        raise ValueError(f"unknown scan op {op!r}")
    if not _build.on_cuda(key, val):
        return seg_scan_plain(key, val, op, cap)
    s = _check(key, val, cap)
    out = torch.empty_like(val)
    # tile aggregates and carries, written before they are read
    scratch = torch.empty((_build.lib().rd_seg_scan_scratch_words(s),),
                          dtype=torch.int32, device=key.device)
    _build.launch("rd_seg_scan", key.device, key.data_ptr(), val.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), s, _OPS[op], cap,
                  kernels=3 if s else 0)
    _build.count(globals(), "launches")
    return out


def seg_total_sorted(key: torch.Tensor, val: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Per-element segment total saturating at cap: what a forward satsum
    scan (totals land at run ends) followed by a reverse max scan (each
    run's end value spread over the run) gives (ops/pallas_scan.py:169-179):
    min(cap, the run's sum), and at a run's first element the larger of
    that and its own value; in one launch."""
    if not _build.on_cuda(key, val):
        return seg_total_plain(key, val, cap)
    s = _check(key, val, cap)
    out = torch.empty_like(val)
    # tile descriptors, written before they are read
    scratch = torch.empty((_build.lib().rd_seg_total_scratch_words(s),),
                          dtype=torch.int32, device=key.device)
    _build.launch("rd_seg_total", key.device, key.data_ptr(), val.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), s, cap,
                  kernels=TOTAL_KERNELS if s else 0)
    _build.count(globals(), "launches")
    return out

"""Kernel #14 mkpl: the max-deviation subdivision of the polyline stage.

Replaces the TPU kernel rectdetect_tpu/ops/pallas_mkpl.py:_mkpl_kernel
(mkpl_subdivide_pallas).  CUDA source: csrc/mkpl.cu, one launch of one
thread-block cluster for all rounds.  As on the TPU, the live slots are put
in (arc, number) order once, so every segment is a contiguous run and
pass3 is implicit; each round is a segmented max of the chord distance
over the runs' parts in each warp's 32 positions by shuffles, one atomic
max a part into its segment's key, then the split tests and an id-order
scan of the split flags across the blocks (decoupled look-back), with two
cluster barriers.  It is bound by latency (the barriers and chains of
dependent loads), not by bytes.

The Pallas kernel renamed provisional slot-order ids afterwards, which is
exact only when the arena cannot overflow (arena cap >= slot count); the
port's arc slot list is larger than the arena, so the kernel allocates as
the plain version does (ops/mkpl.py:mkpl_subdivide): split segments
ranked by id, dropped once count + rank >= cap.  Its arena and lsid are
bit-equal to the plain version's for an arena as
ops/polyline.py:mkpl_init builds it (every live slot's label at most
count, its number at most its segment's end index).

`mkpl_subdivide` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import functools

import torch

from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.ops.compact import Compaction
from rectdetect_tpu_torch.ops.mkpl import (FIX, SegmentArena,
                                           mkpl_subdivide as
                                           mkpl_subdivide_plain)

# SegmentArena fields in the kernel's row order (csrc/mkpl.cu rd_mkpl)
_FLOATS = ("sx", "sy", "ex", "ey")
_INTS = ("start_index", "end_index", "left_ptr", "right_ptr", "start_count",
         "end_count", "polyid", "npix", "level")

launches = 0


@functools.lru_cache(maxsize=None)
def _scratch_words(slots: int, cap: int) -> int:
    return _build.lib().rd_mkpl_scratch_words(slots, cap)


def mkpl_subdivide(arena: SegmentArena, label: torch.Tensor,
                   number: torch.Tensor, minerror: float, n_iters: int,
                   comp: Compaction):
    """(arena, dense label image, number image, ...) -> (arena, lsid
    (H,W) int32), as mkpl.mkpl_subdivide.  The input arena is not
    modified."""
    if not _build.on_cuda(label, number, comp.idx, arena.sx):
        return mkpl_subdivide_plain(arena, label, number, minerror, n_iters,
                                    comp)
    h, w = label.shape
    n = h * w
    cap = arena.cap
    slots = comp.cap
    _build.check(label, "label", torch.int32, (h, w))
    _build.check(number, "number", torch.int32, (h, w))
    _build.check(comp.idx, "comp.idx", torch.int32, (slots,))
    if comp.slot_of.shape[0] != n + 1:
        raise ValueError("the compaction does not belong to this frame")
    for f in _FLOATS:
        _build.check(getattr(arena, f), f, torch.float32, (cap,))
    for f in _INTS:
        _build.check(getattr(arena, f), f, torch.int32, (cap,))
    fields = torch.stack([getattr(arena, f).view(torch.int32)
                          for f in _FLOATS] +
                         [getattr(arena, f) for f in _INTS])
    count = arena.count.to(torch.int32).reshape(1).clone()
    scratch = torch.empty((_scratch_words(slots, cap),), dtype=torch.int32,
                          device=label.device)
    lsid = torch.zeros((n,), dtype=torch.int32, device=label.device)
    _build.launch("rd_mkpl", label.device, comp.idx.data_ptr(),
                  label.data_ptr(), number.data_ptr(), fields.data_ptr(),
                  count.data_ptr(), scratch.data_ptr(), lsid.data_ptr(),
                  slots, cap, n, w, max(0, n_iters - 1),
                  int(minerror * FIX))
    _build.count(globals(), "launches")
    out = {f: fields[i].view(torch.float32) for i, f in enumerate(_FLOATS)}
    out.update({f: fields[len(_FLOATS) + i] for i, f in enumerate(_INTS)})
    return arena._replace(count=count.reshape(()), **out), lsid.reshape(h, w)

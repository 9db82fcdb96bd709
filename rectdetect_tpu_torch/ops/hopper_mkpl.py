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

The width-tiled path's slot-range form (`group`, dist/mesh.py: a
TileGroup) runs the same device functions from three entry points,
launched on each tile's device, every tile with its own arena, key table
and scratch: `rd_mkpl_setup` (one cluster, as rd_mkpl's set-up: the
same inputs give every tile the same run layout), per round
`rd_mkpl_keys` over the tile's share of the live positions (the previous
round's pass3, the distances and one 64-bit atomic max of
(distance, -slot) a run part into the tile's (cap,) key table) and, after
`group.pmax` of the key tables, `rd_mkpl_splits` (one block: the split
tests, an id-order scan of the flags in chunks, the record writes and the
run cuts); a last `rd_mkpl_keys` writes the last round's labels of the
tile's positions into its own lsid image, and the images, disjoint, are
summed on the first tile's device.  Launches per call: `kernels(n, n_iters)`.

`mkpl_subdivide` takes the plain version for CPU tensors and launches the
kernels for CUDA tensors; there is no other path.
"""

from __future__ import annotations

import functools

import torch

from rectdetect_tpu_torch.ops import _build, mkpl
from rectdetect_tpu_torch.ops.compact import Compaction
from rectdetect_tpu_torch.ops.mkpl import FIX, SegmentArena

# SegmentArena fields in the kernel's row order (csrc/mkpl.cu rd_mkpl)
_FLOATS = ("sx", "sy", "ex", "ey")
_INTS = ("start_index", "end_index", "left_ptr", "right_ptr", "start_count",
         "end_count", "polyid", "npix", "level")

launches = 0


def kernels(tiles: int | None, n_iters: int) -> int:
    """Kernels one call launches: 1 unsharded (tiles None); over `tiles`
    slot ranges a set-up, a key and a split launch a round and a last key
    launch, on each tile."""
    if tiles is None:
        return 1
    return tiles * (2 + 2 * max(0, n_iters - 1))


@functools.lru_cache(maxsize=None)
def _scratch_words(slots: int, cap: int) -> int:
    return _build.lib().rd_mkpl_scratch_words(slots, cap)


def _checked(arena: SegmentArena, label, number, comp: Compaction):
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
    return torch.stack([getattr(arena, f).view(torch.int32)
                        for f in _FLOATS] +
                       [getattr(arena, f) for f in _INTS])


def _arena(arena: SegmentArena, fields, count) -> SegmentArena:
    out = {f: fields[i].view(torch.float32) for i, f in enumerate(_FLOATS)}
    out.update({f: fields[len(_FLOATS) + i] for i, f in enumerate(_INTS)})
    return arena._replace(count=count.reshape(()), **out)


def mkpl_subdivide(arena: SegmentArena, label: torch.Tensor,
                   number: torch.Tensor, minerror: float, n_iters: int,
                   comp: Compaction, group=None):
    """(arena, dense label image, number image, ...) -> (arena, lsid
    (H,W) int32), as mkpl.mkpl_subdivide, by slot range over `group`'s
    tiles if given (the inputs on its first tile's device, the result
    there too).  The input arena is not modified."""
    on_cuda = _build.on_cuda(label, number, comp.idx, arena.sx)
    if group is not None and (label.device != group.devices[0] or any(
            d.type != label.device.type for d in group.devices)):
        raise ValueError(f"the inputs are on {label.device}; the group's "
                         f"tiles on {[str(d) for d in group.devices]} must "
                         "be of that kind, the first tile on that device")
    if not on_cuda:
        return mkpl.mkpl_subdivide(arena, label, number, minerror, n_iters,
                                   comp, group)
    fields = _checked(arena, label, number, comp)
    if group is not None:
        return _subdivide_by_range(group, arena, fields, label, number,
                                   minerror, n_iters, comp)
    h, w = label.shape
    n = h * w
    cap = arena.cap
    slots = comp.cap
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
    return _arena(arena, fields, count), lsid.reshape(h, w)


def _subdivide_by_range(group, arena: SegmentArena, fields, label, number,
                        minerror: float, n_iters: int, comp: Compaction):
    """The slot-range form over the tiles of `group` (see the module
    docstring)."""
    h, w = label.shape
    n = h * w
    cap = arena.cap
    slots = comp.cap
    rounds = max(0, n_iters - 1)
    parts = group.n_tiles
    idx, lbl, num = (group.broadcast(t) for t in (comp.idx, label, number))
    count0 = arena.count.to(torch.int32).reshape(1)
    # each tile's own arena, count, scratch and lsid image: the kernels
    # write them in place
    own = [(fields.to(d, copy=True), count0.to(d, copy=True),
            torch.empty((_scratch_words(slots, cap),), dtype=torch.int32,
                        device=d),
            torch.zeros((n,), dtype=torch.int32, device=d))
           for d in group.devices]
    minerr_fix = int(minerror * FIX)

    def launch(name, i, r, red=None):
        f, c, scratch, lsid = own[i]
        _build.launch(name, group.devices[i], idx[i].data_ptr(),
                      lbl[i].data_ptr(), num[i].data_ptr(), f.data_ptr(),
                      c.data_ptr(), scratch.data_ptr(), lsid.data_ptr(),
                      0 if red is None else red.data_ptr(), slots, cap, n, w,
                      rounds, minerr_fix, r, i, parts)
        _build.count(globals(), "launches")

    for i in range(parts):
        launch("rd_mkpl_setup", i, 0)
    for r in range(rounds):
        for i in range(parts):
            launch("rd_mkpl_keys", i, r)
        # the first cap 8-byte words of a scratch are its key table
        red = group.pmax([o[2][:2 * cap].view(torch.int64) for o in own])
        for i in range(parts):
            launch("rd_mkpl_splits", i, r, red[i])
    for i in range(parts):
        launch("rd_mkpl_keys", i, rounds)
    lsid = own[0][3]
    for o in own[1:]:
        lsid = lsid + o[3].to(lsid.device)
    return _arena(arena, own[0][0], own[0][1]), lsid.reshape(h, w)

"""Fixed-capacity stream compaction (port of rectdetect_tpu/ops/compact.py).

`compact_mask` turns a boolean image into a slot list by prefix sum: slot i
holds the i-th set pixel in flat order; beyond `cap` the highest flat
indices drop, deterministically.  Every write goes through an extra dump
slot instead of a host-side filter, so nothing waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Compaction(NamedTuple):
    idx: torch.Tensor      # (cap,) flat pixel index per slot; N = empty
    slot_of: torch.Tensor  # (N+1,) slot per flat pixel; cap = not included
    n: torch.Tensor        # scalar: number of live slots (<= cap)

    @property
    def cap(self) -> int:
        return self.idx.shape[0]

    def valid(self) -> torch.Tensor:
        return self.idx < self.slot_of.shape[0] - 1


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def compact_mask(mask_flat: torch.Tensor, cap: int) -> Compaction:
    """mask_flat: (N,) bool -> slots for the first `cap` set positions."""
    n = mask_flat.shape[0]
    dev = mask_flat.device
    ranks = torch.cumsum(mask_flat.to(torch.int32), 0, dtype=torch.int32) - 1
    take = mask_flat & (ranks < cap)
    pos = torch.where(take, ranks, cap).long()
    idx = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    idx.scatter_(0, pos, torch.arange(n, dtype=torch.int32, device=dev))
    slot_of = torch.full((n + 1,), cap, dtype=torch.int32, device=dev)
    slot_of[:n] = _i32(pos)
    count = torch.clamp(ranks[-1] + 1, max=cap)
    return Compaction(idx=idx[:cap], slot_of=slot_of, n=_i32(count))

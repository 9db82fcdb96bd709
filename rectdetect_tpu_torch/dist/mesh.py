"""The tile axis of the width-tiled detection path (port of the tile part
of rectdetect_tpu/dist/mesh.py).

The JAX package shards a frame's width over the "tile" axis of a device
mesh and runs dist/tile.py inside shard_map, one program per chip, with
lax collectives between them.  The port runs the same program in one
process: a `TileGroup` holds one torch.device per tile (a device may
repeat: all the tiles of a one-card host run on that card), every stage
is a loop over the tiles with one tensor per tile on its tile's device,
and the collectives are the explicit functions below on those lists.  A
copy between tiles goes to the receiving tile's device.  The stream axis
(`make_mesh`'s "stream") is not ported.
"""

from __future__ import annotations

import torch


class TileGroup:
    """The tile axis: tile i of n runs on devices[i]."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a TileGroup needs at least one device")

    @property
    def n_tiles(self) -> int:
        return len(self.devices)

    def geom(self, wl: int) -> tuple[int, int]:
        """(n_tiles, frame width) for tiles `wl` columns wide
        (_tile_geom, tile.py:110-114)."""
        return self.n_tiles, wl * self.n_tiles

    @staticmethod
    def x0(i: int, wl: int) -> int:
        """The frame column of tile i's local column 0."""
        return i * wl

    def split(self, frame: torch.Tensor, axis: int = 1) -> list:
        """A frame's `axis` cut into n equal contiguous tiles, tile i on
        devices[i] (tile_sharding)."""
        n = self.n_tiles
        if frame.shape[axis] % n:
            raise ValueError(f"width {frame.shape[axis]} not divisible by "
                             f"{n} tiles")
        return [t.to(d).contiguous()
                for t, d in zip(frame.chunk(n, dim=axis), self.devices)]

    def fetch_from(self, xs: list, d: int) -> list:
        """lax.ppermute by d hops (tile.py:44-48): entry i is xs[i - d] on
        tile i's device, None where tile i - d does not exist (the JAX
        package's ring wraps there, and every user masks it out)."""
        n = self.n_tiles
        return [xs[i - d].to(dev) if 0 <= i - d < n else None
                for i, dev in enumerate(self.devices)]

    def psum(self, xs: list) -> list:
        """lax.psum: the sum of all tiles' tensors, on every tile's device
        (integer tables: exact in any order)."""
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return self._broadcast(total)

    def all_gather(self, xs: list, axis: int) -> list:
        """lax.all_gather(..., tiled=True): the tiles concatenated along
        `axis`, on every tile's device."""
        dev = self.devices[0]
        return self._broadcast(torch.cat([x.to(dev) for x in xs], dim=axis))

    def _broadcast(self, t: torch.Tensor) -> list:
        copies = {}
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = t.to(dev)
            out.append(copies[dev])
        return out

"""The stream and tile axes of the multi-device paths (port of
rectdetect_tpu/dist/mesh.py).

The JAX package shards a frame's width over the "tile" axis of a device
mesh and runs dist/tile.py inside shard_map, one program per chip, with
lax collectives between them.  The port runs the same program in one
process: a `TileGroup` holds one torch.device per tile (a device may
repeat: all the tiles of a one-card host run on that card), every stage
is a loop over the tiles with one tensor per tile on its tile's device,
and the collectives are the explicit functions below on those lists.  A
copy between tiles goes to the receiving tile's device.

The stream axis is frame data parallelism: `make_mesh(n_stream, n_tile)`
is an n_stream x n_tile grid of devices whose row i is the TileGroup of
stream i, and `stream_split` cuts a stack of frames into one contiguous
block per row (the JAX package's stream_sharding).  dist/stream.py runs
each row's block on its own device.
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
        return self._reduce(xs, torch.add)

    def pmax(self, xs: list) -> list:
        """lax.pmax: the elementwise maximum of all tiles' tensors, on every
        tile's device."""
        return self._reduce(xs, torch.maximum)

    def pmin(self, xs: list) -> list:
        """lax.pmin: the elementwise minimum of all tiles' tensors, on every
        tile's device."""
        return self._reduce(xs, torch.minimum)

    def all_gather(self, xs: list, axis: int) -> list:
        """lax.all_gather(..., tiled=True): the tiles concatenated along
        `axis`, on every tile's device."""
        dev = self.devices[0]
        return self.broadcast(torch.cat([x.to(dev) for x in xs], dim=axis))

    def slot_range(self, i: int, m: int) -> tuple[int, int]:
        """Tile i's contiguous share [lo, hi) of m slots: chunks of
        ceil(m / n), the last one short or empty (the JAX package pads it
        and trims the gathered result, rectdetect_tpu/ops/chain.py:53-63;
        a slice needs no pad)."""
        chunk = -(-m // self.n_tiles)
        lo = min(i * chunk, m)
        return lo, min(lo + chunk, m)

    def _reduce(self, xs: list, op) -> list:
        total = xs[0]
        for x in xs[1:]:
            total = op(total, x.to(total.device))
        return self.broadcast(total)

    def broadcast(self, t: torch.Tensor) -> list:
        """t on every tile's device.  Tiles on one device get one and the
        same tensor, so whoever receives it must treat it as read-only."""
        copies = {}
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = t.to(dev)
            out.append(copies[dev])
        return out


def visible_devices() -> list:
    """Every visible CUDA device, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class StreamMesh:
    """The (stream, tile) mesh: rows[i] is the TileGroup of stream i."""

    def __init__(self, rows):
        self.rows = [TileGroup(r) for r in rows]
        if not self.rows or len({r.n_tiles for r in self.rows}) != 1:
            raise ValueError("a StreamMesh needs rows of one length")

    @property
    def n_stream(self) -> int:
        return len(self.rows)

    @property
    def n_tile(self) -> int:
        return self.rows[0].n_tiles

    @property
    def devices(self) -> list:
        """The entries, row by row."""
        return [d for r in self.rows for d in r.devices]

    @property
    def first(self) -> torch.device:
        return self.rows[0].devices[0]

    def stream_split(self, frames) -> list:
        """frames (B,H,W,3) cut into n_stream contiguous blocks of
        B / n_stream frames, block i on row i's first device; B must divide
        evenly, as under shard_map."""
        frames = torch.as_tensor(frames)
        b = frames.shape[0]
        if b % self.n_stream:
            raise ValueError(f"{b} frames not divisible by {self.n_stream} "
                             f"streams")
        return [blk.to(r.devices[0]).contiguous()
                for blk, r in zip(frames.chunk(self.n_stream), self.rows)]

    def gather(self, blocks: list) -> torch.Tensor:
        """The rows' blocks concatenated on the leading axis, on the first
        device (the out_specs=P("stream") result)."""
        return torch.cat([x.to(self.first) for x in blocks])


def make_mesh(n_stream: int, n_tile: int = 1, devices=None) -> StreamMesh:
    """An n_stream x n_tile mesh over the first n_stream * n_tile of
    `devices` (default: every visible CUDA device); a device may repeat."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    need = n_stream * n_tile
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return StreamMesh([devices[i * n_tile:(i + 1) * n_tile]
                       for i in range(n_stream)])

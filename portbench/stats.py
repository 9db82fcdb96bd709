"""The arithmetic that turns the benchmark's records into numbers: a
percentile over every sample, and busy time and idle gaps from device
intervals that may overlap."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0 < q <= 100) of all values by nearest rank:
    the smallest value with at least q% of the values at or below it.
    None for no values."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def union(intervals, lo: float | None = None, hi: float | None = None):
    """The union of (start, end) intervals, clipped to [lo, hi] where given,
    as sorted disjoint (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Time within [lo, hi] covered by at least one interval."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out

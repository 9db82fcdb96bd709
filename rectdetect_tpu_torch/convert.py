"""Carry state between the JAX package and the port.

The pipeline has no weights: what carries over is the configuration (a
field-for-field copy, config.py) and segment arenas, which tests compare
field by field.  Nothing here imports JAX: a JAX PipelineConfig is read
through its dataclass fields and a JAX arena through numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.ops.polyline import SegmentArena


def config_from_jax(obj) -> PipelineConfig:
    """A JAX `PipelineConfig` (or its dataclasses.asdict) -> the port's."""
    fields = obj if isinstance(obj, dict) else dataclasses.asdict(obj)
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise ValueError(f"fields the port's PipelineConfig lacks: {unknown}")
    return PipelineConfig(**fields)


def arena_to_numpy(arena) -> dict:
    """A SegmentArena of either package -> {field: numpy array}."""
    out = {}
    for name, v in arena._asdict().items():
        out[name] = v.cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    return out


def arena_from_numpy(fields: dict, device="cpu") -> SegmentArena:
    """{field: array} (e.g. arena_to_numpy of a JAX arena) -> the port's
    SegmentArena on `device`, with the port's dtypes."""
    vals = {}
    for name in SegmentArena._fields:
        a = np.asarray(fields[name])
        dt = torch.float32 if a.dtype.kind == "f" else torch.int32
        vals[name] = torch.as_tensor(a.copy(), dtype=dt, device=device)
    return SegmentArena(**vals)

"""Fused multiply-add as the JAX reference evaluates it.

XLA:CPU compiles jitted float code with multiply-add contraction: inside a
fusion, `a * b + c` becomes one fused multiply-add, rounded once.  The port
evaluates the same expressions with the same contraction, so that its
float stencils agree with the jitted JAX functions bit for bit instead of
drifting by an ulp at every multiply-add.  The rules XLA:CPU follows,
found by comparing jitted JAX functions with emulations:

  * `a*b + c` and `c + a*b`        -> fma(a, b, c)
  * `a*b - c`                      -> fma(a, b, -c)
  * `c - a*b`                      -> fma(-a, b, c)
  * `-(a*b) + c*d`                 -> fma(c, d, -(a*b))
  * a chain `a0*b0 + a1*b1 + a2*b2 + ...` of products, left to right:
    acc = a1*b1 rounded, acc = fma(a0, b0, acc), then acc = fma(ai, bi,
    acc) for i >= 2 (so `a*b + c*d` alone is fma(a, b, c*d))

The CUDA kernels call fmaf (built with --fmad=false so nvcc adds no
contraction of its own).  The plain PyTorch code has no fused multiply-add
operator, so `fma` below evaluates the product and the sum in float64 and
rounds once to float32: the product of two float32 values is exact in
float64, and the sum rounds twice only when it lands within 2^-53 of a
float32 rounding midpoint.

Square roots go through `sqrt` below, for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(v: float) -> float:
    """A Python float constant rounded to float32, as XLA rounds it."""
    return float(np.float32(v))


def _wide(v):
    return v.double() if isinstance(v, torch.Tensor) else f32(v)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt.  torch.sqrt on the CPU is a
    vectorized approximation that misses by an ulp on ~0.7% of inputs;
    the float64 square root rounded to float32 is exact."""
    return x.double().sqrt().float()


def fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once (a, b, c tensors or Python floats)."""
    return (_wide(a) * _wide(b) + _wide(c)).float()


def dot_chain(terms) -> torch.Tensor:
    """Left-to-right sum of products [(a0, b0), (a1, b1), ...] in XLA's
    contraction: a1*b1 rounded, fma with a0*b0, then fma with the rest."""
    terms = list(terms)
    if len(terms) == 1:
        (a0, b0), = terms
        return (_wide(a0) * _wide(b0)).float()
    (a0, b0), (a1, b1), *rest = terms
    acc = fma(a0, b0, (_wide(a1) * _wide(b1)).float())
    for a, b in rest:
        acc = fma(a, b, acc)
    return acc


def hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formulation: x1 * sqrt(1 + (x2/x1)^2) with x1 = max(|a|,
    |b|), x2 = min(|a|, |b|), the 1 + r*r contracted."""
    a, b = torch.abs(a), torch.abs(b)
    x1, x2 = torch.maximum(a, b), torch.minimum(a, b)
    zero = x1 == 0
    r = x2 / torch.where(zero, torch.ones_like(x1), x1)
    x = torch.where(zero, x1, x1 * sqrt(fma(r, r, 1.0)))
    inf = torch.isposinf(a) | torch.isposinf(b)
    return torch.where(inf, torch.full_like(x, float("inf")), x)

"""The reference's counter-based PRNG (xrandom, oclpolyline.cl:870-888),
port of rectdetect_tpu/ops/rand.py.

A stateless 64-bit rotate-xor mixing ladder seeded per element.  In the
reference its only pipeline use perturbs mkpl's max-distance tie-break
(oclpolyline.cl:536), which the JAX package and the port replace by the
deterministic min-flat-index winner; this module is there for capability
parity (the `rand` kernel, oclpolyline.cl:883-889) and tests.

The JAX package carries each uint64 as a (hi, lo) pair of uint32 halves.
PyTorch has no unsigned 32- or 64-bit arithmetic on every device, so here
each half is an int64 tensor holding a value in [0, 2^32), masked after
every operation that can leave that range: bit-exact against the
reference's uint64 arithmetic, with no float anywhere.
"""

from __future__ import annotations

import torch

_XOR = (0xf3dd0fb7820fde37, 0xe6c6ac2c59e52811, 0x2fc7871fff7c5b45,
        0x47c7e1f70aa4f7c5, 0x094f02b7fb9ba895, 0x89afda817e744570,
        0xc7277d052c7bf14b)
_SHIFTS = (24, 6, 18, 48, 0, 12, 36)
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _rotl64(hi, lo, n):
    """Rotate the (hi, lo) pair left by n (a tensor of values in [0, 64))."""
    big = n >= 32
    hi1 = torch.where(big, lo, hi)
    lo1 = torch.where(big, hi, lo)
    m = torch.where(big, n - 32, n)
    inv = (32 - m) & 31
    zero = torch.zeros_like(hi)
    carry_hi = torch.where(m == 0, zero, lo1 >> inv)
    carry_lo = torch.where(m == 0, zero, hi1 >> inv)
    return (((hi1 << m) & _M32) | carry_hi, ((lo1 << m) & _M32) | carry_lo)


def _mul64(ahi, alo, b: int):
    """(ahi, alo) * b (a Python int) mod 2^64, by 16-bit limbs."""
    a_limbs = [alo & _M16, alo >> 16, ahi & _M16, ahi >> 16]
    b_limbs = [(b >> (16 * i)) & _M16 for i in range(4)]
    acc = [torch.zeros_like(alo) for _ in range(4)]
    for i in range(4):
        for j in range(4 - i):
            acc[i + j] = (acc[i + j] + a_limbs[i] * b_limbs[j]) & _M32
    limbs = []
    carry = torch.zeros_like(alo)
    for k in range(4):
        v = (acc[k] + carry) & _M32
        limbs.append(v & _M16)
        carry = v >> 16
    return limbs[2] | (limbs[3] << 16), limbs[0] | (limbs[1] << 16)


def _add64(ahi, alo, bhi, blo):
    lo = alo + blo
    return (ahi + bhi + (lo >> 32)) & _M32, lo & _M32


def xrandom_pair(shi: torch.Tensor, slo: torch.Tensor):
    """uint64 (hi, lo), each an int64 tensor in [0, 2^32) -> the mixed
    uint64 (hi, lo), bit-exact xrandom."""
    thi, tlo = shi, slo
    for sh, x in zip(_SHIFTS, _XOR):
        if sh < 32:
            n = (slo >> sh) & 63
        else:
            n = (shi >> (sh - 32)) & 63
        thi, tlo = _rotl64(thi, tlo, n)
        thi = thi ^ (x >> 32)
        tlo = tlo ^ (x & _M32)
    return thi, tlo


def rand_field(size: int, seed: int = 0, device=None) -> torch.Tensor:
    """The `rand` kernel (oclpolyline.cl:883-889): int32 noise per index,
    out[x] = (int)xrandom((x ^ C1) * C2 + (seed ^ C3) * C4)."""
    x_lo = torch.arange(size, dtype=torch.int64, device=device)
    x_hi = torch.zeros_like(x_lo)
    c1, c2 = 0xb21c2cb635b48285, 0x9b923b9cec745401
    c3, c4 = 0x7bb93d75a79d2f15, 0x22cab58ada573a29
    ahi, alo = _mul64(x_hi ^ (c1 >> 32), x_lo ^ (c1 & _M32), c2)
    t = (((seed & 0xFFFFFFFFFFFFFFFF) ^ c3) * c4) & 0xFFFFFFFFFFFFFFFF
    ahi, alo = _add64(ahi, alo, torch.full_like(ahi, t >> 32),
                      torch.full_like(alo, t & _M32))
    _, lo = xrandom_pair(ahi, alo)
    # the low half as a two's-complement int32
    return torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)

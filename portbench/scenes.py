"""Camera scenes made from a seed: flat-shaded quadrilaterals seen in
perspective (screens, sheets, boards) over a flat background, with thin
clutter bars and +-4 of noise a channel.

A copy of the JAX package's `bench.synth_frame` idea (two perspective quads
and noise) rewritten in PyTorch on the device, with the shapes drawn from
the seed so that the frames of a stream differ.  Every scene of every seed
has the same amount of structure: QUADS quadrilaterals, one in each cell of
a 3x2 grid with its corners jittered inside the cell, and BARS bars, so a
seed changes where the edges lie and not how much work they make.
"""

from __future__ import annotations

import numpy as np
import torch

QUADS = 6
BARS = 12
BACKGROUND = 80
NOISE = 4
# the quadrilateral's margin inside its cell, and how far each corner
# moves from it, as shares of the cell
MARGIN = 0.14
JITTER = 0.1
GRID = (2, 3)   # rows, columns


def seed_words(seed: int) -> list[int]:
    """Any whole number as two 32-bit words, for numpy's seed sequences."""
    s = seed % 2 ** 64
    return [s & 0xFFFFFFFF, s >> 32]


def _shapes(seed: int, index: int, h: int, w: int):
    """(quads (QUADS,4,2) float64 x,y corners, clockwise on screen; their
    colours (QUADS,3); bars (BARS,4,2); their colours (BARS,3))."""
    rng = np.random.default_rng([*seed_words(seed), index])
    rows, cols = GRID
    ch, cw = h / rows, w / cols
    quads = []
    for r in range(rows):
        for c in range(cols):
            x0, y0 = c * cw + MARGIN * cw, r * ch + MARGIN * ch
            x1, y1 = (c + 1) * cw - MARGIN * cw, (r + 1) * ch - MARGIN * ch
            box = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            quads.append(box + rng.uniform(-JITTER, JITTER, (4, 2))
                         * np.array([cw, ch]))
    qcol = rng.integers(20, 236, (QUADS, 3))
    bars = []
    for _ in range(BARS):
        p = rng.uniform([0, 0], [w, h])
        ang = rng.uniform(0, np.pi)
        d = np.array([np.cos(ang), np.sin(ang)])
        n = np.array([-d[1], d[0]])
        half = rng.uniform(0.03, 0.12) * min(h, w)
        thick = rng.uniform(1.5, 4.0) * max(1.0, min(h, w) / 720)
        bars.append(np.stack([p - d * half - n * thick, p + d * half - n * thick,
                              p + d * half + n * thick, p - d * half + n * thick]))
    bcol = rng.integers(20, 236, (BARS, 3))
    return np.stack(quads), qcol, np.stack(bars), bcol


def _fill(img: torch.Tensor, poly: np.ndarray, colour, yy, xx) -> None:
    """Paint the convex polygon (4,2) into img (H,W,3) uint8."""
    inside = torch.ones(img.shape[:2], dtype=torch.bool, device=img.device)
    area = 0.0
    for i in range(4):
        a, b = poly[i], poly[(i + 1) % 4]
        area += a[0] * b[1] - b[0] * a[1]
    sign = 1.0 if area > 0 else -1.0
    for i in range(4):
        a, b = poly[i], poly[(i + 1) % 4]
        inside &= sign * ((b[0] - a[0]) * (yy - a[1])
                          - (b[1] - a[1]) * (xx - a[0])) > 0
    img[inside] = torch.tensor([int(v) for v in colour], dtype=torch.uint8,
                               device=img.device)


def scene(seed: int, index: int, h: int, w: int,
          device="cpu") -> torch.Tensor:
    """Scene `index` of `seed`: (h,w,3) uint8 BGR on `device`."""
    dev = torch.device(device)
    quads, qcol, bars, bcol = _shapes(seed, index, h, w)
    img = torch.full((h, w, 3), BACKGROUND, dtype=torch.uint8, device=dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    for q, c in zip(quads, qcol):
        _fill(img, q, c, yy, xx)
    for b, c in zip(bars, bcol):
        _fill(img, b, c, yy, xx)
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed * 1000003 + index) % (2 ** 63))
    noise = torch.randint(-NOISE, NOISE + 1, (h, w, 3), generator=gen,
                          device=dev, dtype=torch.int16)
    return (img.to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)


def ring(seed: int, n: int, h: int, w: int, device="cpu",
         first: int = 0) -> list[np.ndarray]:
    """Scenes first..first+n-1 of `seed`, made on `device` and copied to the
    host as contiguous (h,w,3) uint8 arrays, as a camera hands them over."""
    return [np.ascontiguousarray(scene(seed, first + i, h, w, device)
                                 .cpu().numpy()) for i in range(n)]

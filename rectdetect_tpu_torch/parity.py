"""Inputs and scoring for holding the port's geometry against its references:
a randomized corpus of segment groups for the quad reduction, projected
rectangles for the pose, and the accepted-corner-set matching of
tools/ab_parity.py (the port's own copy, so that chip_smoke.py and the
card tests need nothing of the JAX package)."""

from __future__ import annotations

import math

import numpy as np


def segment_groups(seed: int, g: int = 32, k: int = 48, scale: float = 1.0):
    """(segs (g,k,2,2) float32, valid (g,k) bool): random segments, a
    random number valid per group; every third group holds the 4 sides of
    a quad (every sixth one axis-aligned, which reaches atan2's signed-zero
    boundary in the angle sort); group 1 holds 8 copies of one segment and
    group 2 only zero-length segments.  The corpus of
    tests/test_pallas_hyp.py."""
    rng = np.random.default_rng(seed)
    segs = rng.uniform(0, 640, (g, k, 2, 2)).astype(np.float32)
    nv = rng.integers(0, k + 1, g)
    valid = np.arange(k)[None, :] < nv[:, None]
    for i in range(0, g, 3):
        c = rng.uniform(200, 400, 2)
        wh = rng.uniform(60, 150, 2)
        th = rng.uniform(0, np.pi / 2) if i % 6 else 0.0
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        corners = np.array([[-wh[0], -wh[1]], [wh[0], -wh[1]],
                            [wh[0], wh[1]], [-wh[0], wh[1]]]) @ rot.T + c
        for j in range(4):
            a, b = corners[j], corners[(j + 1) % 4]
            segs[i, j, 0] = a + (b - a) * 0.03
            segs[i, j, 1] = a + (b - a) * 0.97
        valid[i, :4] = True
    segs[1, :8] = segs[1, 0:1]
    valid[1, :8] = True
    segs[2] = 0
    valid[2] = True
    return (segs * scale).astype(np.float32), valid


def project_rect(center, yaw, pitch, w3, h3, iw, ih, tan_aov):
    """The image corners (4,2) and 3D corners (4,3) of a w3 x h3 rectangle
    at `center`, its normal turned by yaw and pitch, through the pinhole
    model the pose inverts (x right, y up, z forward, focal =
    (iw/2)/tan_aov; tests/test_pose.py)."""
    f = (iw / 2) / tan_aov
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    u = np.array([cy, 0.0, -sy])
    v = np.array([sy * sp, cp, cy * sp])
    c = np.asarray(center, np.float64)
    c3 = np.stack([c - u * w3 / 2 - v * h3 / 2, c + u * w3 / 2 - v * h3 / 2,
                   c + u * w3 / 2 + v * h3 / 2, c - u * w3 / 2 + v * h3 / 2])
    c2 = np.stack([c3[:, 0] / c3[:, 2] * f + iw / 2,
                   -(c3[:, 1] / c3[:, 2]) * f + ih / 2], axis=1)
    return c2, c3


def pose_quads(seed: int, n_rect: int, n_bad: int, iw: int, ih: int,
               tan_aov: float):
    """(n_rect + n_bad, 4, 2) float32 quads for the pose: n_rect projected
    rectangles at random positions, sizes, yaws and pitches (aspect up to
    20:1), their corner order rotated at random; then n_bad degenerate ones
    in turn: all zero, three corners on a line, two corners equal, and a
    bow tie."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_rect):
        c2, _ = project_rect(
            [rng.uniform(-0.6, 0.6), rng.uniform(-0.4, 0.4),
             rng.uniform(2.0, 5.0)], rng.uniform(-0.9, 0.9),
            rng.uniform(-0.7, 0.7), rng.uniform(0.3, 2.0),
            rng.uniform(0.1, 1.5), iw, ih, tan_aov)
        out.append(np.roll(c2, int(rng.integers(0, 4)), axis=0))
    for i in range(n_bad):
        q = rng.uniform(0, min(iw, ih), (4, 2))
        kind = i % 4
        if kind == 0:
            q[:] = 0
        elif kind == 1:
            q[2] = (q[1] + q[3]) / 2
        elif kind == 2:
            q[1] = q[0]
        else:
            q[[1, 2]] = q[[2, 1]]
        out.append(q)
    return np.stack(out).astype(np.float32)


def corner_err(a, b) -> float:
    """Best mean corner distance over the cyclic shifts and the reflection
    (tools/ab_parity.py)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    best = np.inf
    for s in range(4):
        for f in (1, -1):
            idx = [(s + f * j) % 4 for j in range(4)]
            best = min(best, float(np.linalg.norm(a - b[idx], axis=1).mean()))
    return best


def dedupe(quads, tol: float = 3.0):
    """One quad of each set of hypotheses within `tol` of each other."""
    out = []
    for q in quads:
        if all(corner_err(q, o) > tol for o in out):
            out.append(np.asarray(q, np.float64))
    return out


def match_sets(a_set, b_set, tol: float = 2.0):
    """Greedy one-to-one matching within `tol` px; returns (n_matched,
    a_only, b_only)."""
    used = [False] * len(b_set)
    matched = 0
    for qa in a_set:
        errs = [corner_err(qa, qb) if not used[j] else np.inf
                for j, qb in enumerate(b_set)]
        if errs and min(errs) <= tol:
            used[int(np.argmin(errs))] = True
            matched += 1
    return matched, len(a_set) - matched, used.count(False)


def accepted_corner_sets(c2, valid):
    """The deduplicated corner sets of the valid hypotheses; c2 (G,4,2),
    valid (G,), numpy."""
    return dedupe([c2[i] for i in np.nonzero(valid)[0]])

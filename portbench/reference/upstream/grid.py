"""Pixel-grid helpers: neighbours by shifting, and connected components
labelled by their least flat index (the converged labels of upstream's
label8x, oclimgutil.cl:495-538)."""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

# getnp's neighbour order (oclpolyline.cl:169-191)
RX = (1, 1, 0, -1, -1, -1, 0, 1)
RY = (0, -1, -1, -1, 0, 1, 1, 1)
# the forward half of the 8-neighbourhood, (dy, dx)
FORWARD = ((0, 1), (1, -1), (1, 0), (1, 1))


def shifted(img: np.ndarray, dy: int, dx: int, fill=0) -> np.ndarray:
    """out[y, x] = img[y + dy, x + dx], `fill` outside the image."""
    h, w = img.shape
    out = np.full_like(img, fill)
    ys, yd = max(0, dy), max(0, -dy)
    xs, xd = max(0, dx), max(0, -dx)
    out[yd:h - ys, xd:w - xs] = img[ys:h - yd, xs:w - xd]
    return out


def interior(h: int, w: int, m: int) -> np.ndarray:
    """True on pixels at least `m` from every edge of the image."""
    out = np.zeros((h, w), bool)
    out[m:h - m, m:w - m] = True
    return out


def components(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Component index of each of n nodes joined by the edges (a, b)."""
    g = coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(n, n))
    return connected_components(g, directed=False)[1]


def least_index_labels(mask: np.ndarray, joined) -> np.ndarray:
    """(H,W) int64: each pixel of `mask` labelled by the least flat index of
    its component, -1 elsewhere.  joined(dy, dx) -> (H,W) bool: whether a
    pixel joins its (dy, dx) neighbour, for the forward offsets."""
    h, w = mask.shape
    flat = np.flatnonzero(mask)
    node = np.full(h * w, -1, np.int64)
    node[flat] = np.arange(len(flat))
    a, b = [], []
    for dy, dx in FORWARD:
        j = joined(dy, dx) & mask & shifted(mask, dy, dx, False)
        p = np.flatnonzero(j)
        a.append(node[p])
        b.append(node[p + dy * w + dx])
    comp = components(len(flat), np.concatenate(a), np.concatenate(b))
    # flat is ascending, so a component's first node is its least index
    _, first = np.unique(comp, return_index=True)
    out = np.full(h * w, -1, np.int64)
    out[flat] = flat[first][comp]
    return out.reshape(h, w)


def label_components(pix: np.ndarray, bgc: int) -> np.ndarray:
    """8-connected components of equal value, pixels of value `bgc`
    excluded (golden labeling.label_components)."""
    return least_index_labels(
        pix != bgc, lambda dy, dx: shifted(pix, dy, dx, bgc) == pix)

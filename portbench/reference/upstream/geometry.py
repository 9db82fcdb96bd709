"""Upstream's CPU geometry stage (oclrect.c:385-1226) in float64: the
hypothesis reduction chain (removeShortLS -> pickExternalLS ->
pickLongestLS -> sortByAngle -> findCorners -> checks) with quickHull and
Cohen-Sutherland clipping, the screen test, and the conjugate-gradient
pose with central-difference derivatives.

The reduction and the screen test are golden/geometry.py's loop code,
frozen; the pose is its pose_estimation batched over quads with numpy, the
same steps on every quad, each branch taken per quad."""

from __future__ import annotations

import math

import numpy as np

EPS = 1e-6
INIT_SCALE = 1.0


# ---------------------------------------------------------------- pose ----

def _dot(a, b):
    return (a * b).sum(-1)


def value(v, p, mode):
    """Objective (oclrect.c:441-477), v (N,4), p (N,4,3) -> (N,)."""
    q = p * v[..., None]
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]

    def dsq(a, b):
        return _dot(a - b, a - b)

    l01, l12, l23, l03 = dsq(q0, q1), dsq(q1, q2), dsq(q2, q3), dsq(q0, q3)
    l02, l13 = dsq(q0, q2), dsq(q1, q3)
    score = ((l23 if mode else l03) - 1.0) ** 2
    score = score + ((l01 if mode else l12) - 1.0) ** 2
    comp = 1.0 / (l12 if mode else l01)
    a = (q0 if mode else q2) - q1
    b = (q2 if mode else q0) - q3
    score = score + _dot(a + b, a + b)
    c = q1 - (q2 if mode else q0)
    d = q3 - (q0 if mode else q2)
    score = score + comp * _dot(c + d, c + d)
    score = score + (l01 + l12 - l02) ** 2
    score = score + (l03 + l23 - l02) ** 2
    score = score + (l01 + l03 - l13) ** 2
    score = score + (l12 + l23 - l13) ** 2
    n013 = np.cross(q1 - q0, q3 - q0)
    score = score + comp * (_dot(n013, q2) - _dot(n013, q0)) ** 2 / \
        _dot(n013, n013)
    n102 = np.cross(q0 - q1, q2 - q1)
    score = score + comp * (_dot(n102, q3) - _dot(n102, q1)) ** 2 / \
        _dot(n102, n102)
    return score


def gradient_dir(v, direction, p, mode):
    """(f, f', f'') along direction (gradient, oclrect.c:479-490)."""
    h = EPS
    f0 = value(v, p, mode)
    fp = value(v + direction * h, p, mode)
    fm = value(v - direction * h, p, mode)
    return f0, (fp - fm) / (2 * h), (fp + fm - 2 * f0) / (h * h)


def gradient2(v, p, mode):
    """(grad, diag hess) by central differences (oclrect.c:492-512)."""
    fx = value(v, p, mode)
    a = np.zeros_like(v)
    a2 = np.zeros_like(v)
    for i in range(4):
        d = np.zeros(4)
        d[i] = EPS
        fm = value(v - d, p, mode)
        fp = value(v + d, p, mode)
        a[:, i] = (fp - fm) / (2 * EPS)
        a2[:, i] = (fm - 2 * fx + fp) / (EPS * EPS)
    return a, a2


def line_search(iv, direction, n_iter, p, mode):
    d = direction / np.linalg.norm(direction, axis=-1, keepdims=True)
    scale = np.full(len(iv), INIT_SCALE)
    live = np.ones(len(iv), bool)
    for _ in range(n_iter):
        f0, g1, g2 = gradient_dir(iv, d, p, mode)
        g2 = np.where(g2 * g2 < 1e-10, 1.0, g2)
        delta = np.abs(g1 / g2)
        live &= ~(delta < 1e-10)
        v = iv + d * (delta * scale)[:, None]
        worse = value(v, p, mode) > f0
        scale = np.where(live & worse, scale * 0.5, scale)
        iv = np.where((live & ~worse)[:, None], v, iv)
    return iv


def inversedot(m, r):
    return np.where(np.all(m > 0, axis=-1, keepdims=True), r / m, r)


def cgexecute(iv, loop_cnt, n_iter2, p, mode):
    x = iv.copy()
    g, m = gradient2(x, p, mode)
    r = -g
    s = inversedot(m, r)
    d = s
    deltanew = _dot(r, d)
    k = np.zeros(len(x), np.int64)
    for _ in range(loop_cnt):
        x = line_search(x, d, n_iter2, p, mode)
        g, m = gradient2(x, p, mode)
        r = -g
        deltaold = deltanew
        deltamid = _dot(r, s)
        s = inversedot(m, r)
        deltanew = _dot(r, s)
        beta = np.where(deltaold != 0,
                        (deltanew - deltamid)
                        / np.where(deltaold != 0, deltaold, 1.0), 0.0)
        restart = (k == 10) | (beta <= 0) | (deltaold == 0)
        d = np.where(restart[:, None], s, s + d * beta[:, None])
        k = np.where(restart, 0, k) + 1
    return x


def pose_estimation(corners, iw, ih, tan_aov, loop_cnt=12, n_iter2=10):
    """poseEstimation (oclrect.c:590-634) of N quads: corners (N,4,2),
    edge i from corner i to corner i+1 -> (c2 (N,4,2), c3 (N,4,3),
    value (N,))."""
    corners = np.asarray(corners, np.float64)
    n = len(corners)
    e0 = corners
    e1 = np.roll(corners, -1, axis=1)
    gv = corners.mean(axis=1)
    best = np.full(n, 1e100)
    tl = np.zeros(n, np.int64)
    for i in range(4):
        v = e1[:, i] - e0[:, i]
        v = v / np.linalg.norm(v, axis=-1, keepdims=True)
        v = np.stack([-v[:, 1], v[:, 0]], axis=-1)
        v = np.where((_dot(e0[:, i] - gv, v) < 0)[:, None], -v, v)
        lower = v[:, 1] < best
        best = np.where(lower, v[:, 1], best)
        tl = np.where(lower, i, tl)
    idx = (np.arange(4)[None] + tl[:, None]) & 3
    c2 = np.take_along_axis(e0, idx[..., None], axis=1)
    q = np.stack([c2[..., 0] - iw / 2, -(c2[..., 1] - ih / 2),
                  np.full((n, 4), (iw / 2) / tan_aov)], axis=-1)
    p = q / np.linalg.norm(q, axis=-1, keepdims=True)

    def inv(a, b):
        return 1.0 / np.linalg.norm(p[:, a] - p[:, b], axis=-1)
    d01, d23 = inv(0, 1), inv(2, 3)
    x0 = cgexecute(np.stack([d01, d01, d23, d23], -1), loop_cnt, n_iter2,
                   p, 1)
    v0 = value(x0, p, 1)
    d12, d03 = inv(1, 2), inv(0, 3)
    x1 = cgexecute(np.stack([d03, d12, d12, d03], -1), loop_cnt, n_iter2,
                   p, 0)
    v1 = value(x1, p, 0)
    val = np.where(v1 < v0, v1, v0)
    x = np.where((v0 < v1)[:, None], x0, x1)
    x = np.where((x[:, :1] < 0), -x, x)
    return c2, p * x[..., None], val


def closest_point_ls(v, w, p):
    d = w - v
    l2 = float(np.dot(d, d))
    if l2 == 0:
        return v
    t = float(np.dot(p - v, d)) / l2
    t = min(max(t, 0.0), 1.0)
    return v + t * d


def looks_like_a_screen(c2, c3, val):
    if val > 0.05:
        return False
    if np.any(c3[:, 2] < 0):
        return False
    asp = np.linalg.norm(c3[0] - c3[1]) / np.linalg.norm(c3[1] - c3[2])
    if asp < 1 / 12 or asp > 12:
        return False
    maxs, mins = 0.0, 1e100
    for i in range(4):
        s0 = np.sum((c2[(i + 2) % 4] - closest_point_ls(
            c2[i], c2[(i + 1) % 4], c2[(i + 2) % 4])) ** 2)
        s1 = np.sum((c2[(i + 3) % 4] - closest_point_ls(
            c2[i], c2[(i + 1) % 4], c2[(i + 3) % 4])) ** 2)
        maxs = max(maxs, max(s0, s1))
        mins = min(mins, max(s0, s1))
    return maxs / mins <= 100


# --------------------------------------------------------------- quads ----

def closest_point(v, w, p):
    d = w - v
    l2 = float(np.dot(d, d))
    if l2 == 0:
        return v.copy()
    t = float(np.dot(p - v, d)) / l2
    return v + t * d


def quick_hull(points):
    """quickHull2 (oclrect.c:697-734); returns hull vertices in order."""
    pts = [np.asarray(p, np.float64) for p in points]
    if not pts:
        return []
    v_right = max(pts, key=lambda p: p[0])
    v_left = min(pts, key=lambda p: p[0])
    v_top = np.array([v_left[1] - v_right[1], v_right[0] - v_left[0]])

    s_top, s_bot = [], []
    for p in pts:
        if (p == v_left).all() or (p == v_right).all():
            continue
        if np.dot(p - v_left, v_top) > 0:
            s_top.append(p)
        else:
            s_bot.append(p)

    hull = []

    def find_hull(s, vl, vr):
        if not s:
            return
        far, d = None, 0.0
        for p in s:
            e = float(np.sum((closest_point(vl, vr, p) - p) ** 2))
            if far is None or e > d:
                far, d = p, e
        if d < 0.01 or far is None:
            return
        v_tr = np.array([far[1] - vr[1], vr[0] - far[0]])
        v_tl = np.array([vl[1] - far[1], far[0] - vl[0]])
        s_tr = [p for p in s if p is not far and np.dot(p - far, v_tr) > 0]
        s_tl = [p for p in s if p is not far and np.dot(p - far, v_tl) > 0]
        find_hull(s_tr, far, vr)
        hull.append(far)
        find_hull(s_tl, vl, far)

    hull.append(v_right)
    find_hull(s_top, v_left, v_right)
    hull.append(v_left)
    find_hull(s_bot, v_right, v_left)
    return hull


def clip_line(x0, y0, x1, y1, xmin, ymin, xmax, ymax):
    """Cohen-Sutherland (clipLineWithRect, oclrect.c:758-802)."""
    def code(x, y):
        c = 0
        if x < xmin:
            c |= 1
        if x > xmax:
            c |= 2
        if y < ymin:
            c |= 4
        if y > ymax:
            c |= 8
        return c

    c0, c1 = code(x0, y0), code(x1, y1)
    while True:
        if (c0 | c1) == 0:
            return (x0, y0, x1, y1)
        if (c0 & c1) != 0:
            return None
        out = c0 if c0 else c1
        if out & 8:
            x = x0 + (x1 - x0) * (ymax - y0) / (y1 - y0)
            y = ymax
        elif out & 4:
            x = x0 + (x1 - x0) * (ymin - y0) / (y1 - y0)
            y = ymin
        elif out & 2:
            y = y0 + (y1 - y0) * (xmax - x0) / (x1 - x0)
            x = xmax
        else:
            y = y0 + (y1 - y0) * (xmin - x0) / (x1 - x0)
            x = xmin
        if out == c0:
            x0, y0, c0 = x, y, code(x, y)
        else:
            x1, y1, c1 = x, y, code(x, y)


def _sq_len(ls):
    return float(np.sum((ls[0] - ls[1]) ** 2))


def remove_short_ls(als, ratio=0.05):
    """removeShortLS (oclrect.c:926-943)."""
    if len(als) <= 4:
        return als
    als = sorted(als, key=_sq_len)
    longest = _sq_len(als[-1])
    while len(als) > 4 and _sq_len(als[0]) / longest <= ratio * ratio:
        als.pop(0)
    return als


def pick_external_ls(als):
    """pickExternalLS (oclrect.c:945-992)."""
    plist = []
    for e0, e1 in als:
        plist.append(e0)
        plist.append(e1)
    q = quick_hull(plist)
    als = list(als)
    als2 = []
    DTHRE0, ATHRE1, DTHRE1 = 1.0, 0.95, 0.01
    for i in range(len(q)):
        q0, q1 = q[i], q[(i + 1) % len(q)]
        m = (q0 + q1) * 0.5
        nq01 = (q0 - q1) / np.linalg.norm(q0 - q1)
        als.sort(key=_sq_len)
        last = -1
        for j in range(len(als) - 1, -1, -1):
            e0, e1 = als[j]
            cp = closest_point_ls(e0, e1, m)
            if float(np.sum((m - cp) ** 2)) < DTHRE0:
                als2.append(als[j])
                last = j
                break
            de = (e0 - e1) / np.linalg.norm(e0 - e1)
            if abs(float(np.dot(nq01, de))) > ATHRE1 and \
                    float(np.sum((m - cp) ** 2)) / \
                    float(np.sum((q0 - q1) ** 2)) < DTHRE1:
                als2.append(als[j])
                last = j
                break
        if last != -1:
            als.pop(last)
    return als2


def sum_length(als):
    return sum(math.sqrt(_sq_len(ls)) for ls in als)


def pick_longest_ls(als, n=4):
    if len(als) <= n:
        return als
    als = sorted(als, key=_sq_len)
    return als[::-1][:n]


def gv_of(als):
    g = np.zeros(2)
    lensum = 0.0
    for e0, e1 in als:
        ln = math.sqrt(_sq_len((e0, e1)))
        g += (e0 + e1) * ln
        lensum += ln
    return g * (0.5 / lensum)


def sort_by_angle(als, gv):
    def angle(ls):
        e0, e1 = ls
        v = e0 - e1
        v = np.array([v[1], -v[0]])
        if np.dot(v, e0 - gv) < 0:
            v = -v
        return math.atan2(v[0], v[1])
    return sorted(als, key=angle)


def intersection(u, v):
    """intersection2 (oclrect.c:418-425); u, v: (e0, e1) pairs."""
    d = (v[1][0] - v[0][0]) * (u[1][1] - u[0][1]) - \
        (v[1][1] - v[0][1]) * (u[1][0] - u[0][0])
    if abs(d) < 1e-4:
        return None
    n = (v[0][1] - u[0][1]) * (u[1][0] - u[0][0]) - \
        (v[0][0] - u[0][0]) * (u[1][1] - u[0][1])
    q = n / d
    return np.array([v[0][0] + q * (v[1][0] - v[0][0]),
                     v[0][1] + q * (v[1][1] - v[0][1])])


def find_corners(als):
    c = []
    for i in range(len(als)):
        w = intersection(als[i], als[(i + 1) % len(als)])
        if w is None:
            return None
        c.append(w)
    return [(c[i], c[(i + 1) % len(c)]) for i in range(len(c))]


def close_to_triangle(als, ratio=0.001):
    for i in range(len(als)):
        ls0 = als[i]
        ls1 = als[(i + 1) % len(als)]
        d0 = float(np.sum((ls0[1] - closest_point(ls0[0], ls1[1],
                                                  ls0[1])) ** 2))
        d1 = float(np.sum((ls0[0] - ls1[1]) ** 2))
        if d0 / d1 < ratio:
            return True
    return False


def is_convex(als):
    def c(i):
        return als[i][1] - als[i][0]
    sign = (c(0)[0] * c(1)[1] - c(0)[1] * c(1)[0]) > 0
    for i in range(1, len(als)):
        d0 = c(i)
        d1 = als[(i + 1) % len(als)][1] - als[(i + 1) % len(als)][0]
        if sign != ((d0[0] * d1[1] - d0[1] * d1[0]) > 0):
            return False
    return True


def reduce_group(als):
    """The shared reduction chain (oclrect.c:1134-1151).  als: list of
    (e0, e1).  Returns (corner segments, gv) or None on rejection."""
    als = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
           for a, b in als]
    als = remove_short_ls(als, 0.05)
    als = pick_external_ls(als)
    len0 = sum_length(als)
    als = pick_longest_ls(als, 4)
    if len(als) < 4 or len0 == 0:
        return None
    als = sort_by_angle(als, gv_of(als))
    als = find_corners(als)
    if als is None:
        return None
    len1 = sum_length(als)
    if close_to_triangle(als, 0.001) or len(als) < 4 or len1 / len0 > 2 \
            or not is_convex(als):
        return None
    return als

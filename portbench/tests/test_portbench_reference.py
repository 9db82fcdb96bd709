"""The plain reference against the port's CPU path on small frames: the
per-pixel stages are the port's plain forms frozen, the rest follows
upstream's semantics on its own (reference/upstream/), so the two agree
within the cells' limits and not bit for bit."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import compare, harness, scenes
from portbench.reference import frame
from portbench.reference.config import DEFAULT_CONFIG as REF_CONFIG
from portbench.reference.upstream import geometry, polyline
from rectdetect_tpu_torch.config import DEFAULT_CONFIG
from rectdetect_tpu_torch.pipeline.poly import poly_frame, live_segments
from rectdetect_tpu_torch.pipeline.rect import live_rects, rect_frame

TAN = math.tan(math.radians(36))
H, W = 112, 192


def _frames(n, seed=2 ** 31 + 1):
    return [torch.from_numpy(f) for f in scenes.ring(seed, n, H, W)]


def _config(name):
    return harness.resolve(harness.load_benchmark(), name).config


def test_config_field_for_field():
    assert REF_CONFIG.__dict__ == DEFAULT_CONFIG.__dict__


def test_rect_agrees_with_the_port_on_the_cpu():
    c = _config("vidrect.uhd1")
    pairs = []
    for f in _frames(2):
        port = rect_frame(f, TAN, harness.pipeline_config(DEFAULT_CONFIG, c,
                                                          H, W))
        ref = frame.rect_frame(f, TAN, harness.pipeline_config(REF_CONFIG, c,
                                                               H, W))
        assert ref
        pairs.append((live_rects(port), ref))
    ok, table = compare.judge(compare.compare_rect(pairs), c["limits"])
    assert ok, table


def test_poly_agrees_with_the_port_on_the_cpu():
    c = _config("vidpoly.uhd1")
    f = _frames(1)[0]
    arena, _ = poly_frame(f, DEFAULT_CONFIG, c["minerror"], c["size_thre"],
                          c["strength"])
    ref = frame.poly_frame(f, REF_CONFIG, c["minerror"], c["size_thre"],
                           c["strength"])
    assert len(ref) > 1
    ok, table = compare.judge(
        compare.compare_poly([(live_segments(arena), ref)]), c["limits"])
    assert ok, table


@pytest.mark.parametrize("kind", ["rect", "poly"])
def test_lowp_differs(kind):
    f = _frames(1)[0]
    if kind == "rect":
        a = frame.rect_frame(f, TAN, REF_CONFIG)
        b = frame.rect_frame(f, TAN, REF_CONFIG, lowp=True)
        assert compare.compare_rect([(b, a)])["rect_px"] > 0
    else:
        a = frame.poly_frame(f, REF_CONFIG, 1.0, 10, 2000)
        b = frame.poly_frame(f, REF_CONFIG, 1.0, 10, 2000, lowp=True)
        assert compare.compare_poly([(b, a)])["seg_px"] > 0


def test_upstream_polyline_of_a_line_and_an_outline():
    img = np.zeros((40, 64), np.int64)
    img[10, 4:60] = 1
    segs, _ = polyline.polyline_execute(img, 1.0, 5)
    live = polyline.live_segments(segs)
    assert len(live) == 1
    assert abs(live[0]["y0"] - 10) < 0.5 and abs(live[0]["y1"] - 10) < 0.5
    box = np.zeros((48, 64), np.int64)
    box[8, 8:56] = box[40, 8:56] = 1
    box[8:41, 8] = box[8:41, 55] = 1
    segs, _ = polyline.polyline_execute(box, 1.0, 5)
    assert 3 <= len(polyline.live_segments(segs)) <= 6


def test_upstream_pose_of_a_centred_square():
    """A square facing the camera at the image's centre has a residual of
    about 0 and a square of 3D corners."""
    iw, ih = 640, 480
    c = np.array([[[270.0, 190.0], [370.0, 190.0], [370.0, 290.0],
                   [270.0, 290.0]]])
    c2, c3, val = geometry.pose_estimation(c, iw, ih, TAN)
    assert val[0] < 1e-6
    sides = np.linalg.norm(c3[0] - np.roll(c3[0], -1, axis=0), axis=1)
    np.testing.assert_allclose(sides, sides.mean(), rtol=1e-3)

"""PyTorch port, the end of the rect path against the JAX package on the
CPU: the plain quad reduction (kernel #15's plain version) against the
jitted quad.reduce_groups and the interpreted Pallas kernel, the plain
pose against the jitted pose.pose_estimate, looks_like_a_screen, the
hypotheses -> RectResult tail against the 720p JAX fixture, and rect_frame
as a whole against the small JAX fixture.

Tolerances:
  * reduction: `ok` equal, corners within 1e-3 where ok (the contract
    between the Pallas kernel and XLA, tests/test_pallas_hyp.py); the jitted
    JAX function fuses multiply-adds, so corners differ by ulps;
  * pose: c2 equal (a rotation of the input corners); NaN in the same
    places; the screen bit equal wherever the JAX value is more than 1e-3
    from accept_value.  The CG stops after 12 iterations, short of
    convergence on many quads, and the rounding of JAX's reverse-mode
    gradient and of the port's forward-mode jets takes the iterations
    apart: on 420 projected rectangles (3 seeds) the value differed by at
    most 0.0096 and the 3D corners, each quad scaled to unit norm, by at
    most 0.036 (0.00024 where both values are below 1e-5); so the
    rectangles' values are held to 0.02 and their scaled corners to 0.05,
    and 1e-3 where both values are below 1e-5.  The two normalization
    modes fix different sides to unit length, and the better mode flips on
    ulps once both have converged, which is why c3 is compared scaled;
  * rect_frame: valid and status equal, and the accepted corner sets
    matched one to one within 2 px, none on one side only (the scoring of
    tools/ab_parity.py).

The JAX references are the jitted functions; no test compiles the JAX
rect_frame: the two rect_frame fixtures (tools/make_torch_fixture.py
frame) carry its results.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectdetect_tpu.geometry import pose as jpose
from rectdetect_tpu.geometry import quad as jquad
from rectdetect_tpu.ops.pallas_hyp import reduce_groups_pallas

from rectdetect_tpu_torch import parity
from rectdetect_tpu_torch.apps import common
from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.geometry import pose, quad
from rectdetect_tpu_torch.ops import hopper_hyp, hopper_pose
from rectdetect_tpu_torch.pipeline import rect

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
TAN_AOV = math.tan(math.radians(72.0) / 2)
CORNER_ATOL = 1e-3
VALUE_ATOL = 0.02
C3_SCALED_ATOL = 0.05
C3_SCALED_ATOL_CONVERGED = 1e-3
IW, IH = 640, 480

_jax_reduce = jax.jit(lambda s, v: jquad.reduce_groups(s, v, 24))


def _t(a):
    return torch.from_numpy(np.array(a))


def _scaled(c3):
    n = np.linalg.norm(c3.reshape(len(c3), -1), axis=1)
    return c3 / n[:, None, None]


def _check_reduce(got, want_c, want_ok):
    corners, ok = (x.numpy() for x in got)
    want_c, want_ok = np.asarray(want_c), np.asarray(want_ok)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_allclose(corners[ok], want_c[ok], rtol=0,
                               atol=CORNER_ATOL)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1.0), (2, 0.03),
                                        (3, 1.0)])
def test_reduce_groups_matches_jax(seed, scale):
    """The plain reduction against the jitted quad.reduce_groups on the
    port's copy of the randomized corpus (tests/test_pallas_hyp.py)."""
    segs, valid = parity.segment_groups(seed, 32, 48, scale)
    if seed == 0:
        from test_pallas_hyp import _corpus
        for a, b in zip((segs, valid), _corpus(seed, scale=scale)):
            np.testing.assert_array_equal(a, b)
    _check_reduce(quad.reduce_groups(_t(segs), _t(valid)),
                  *_jax_reduce(segs, valid))


def test_reduce_groups_matches_pallas_interpret():
    """The plain reduction against the interpreted Pallas kernel on 16
    groups of the 384-group corpus at scale 0.03: the duplicate-heavy and
    the zero-length group, 12 that pass and 2 that do not (interpret mode
    compiles for ~20 s whatever the group count)."""
    segs, valid = parity.segment_groups(2, 384, 48, 0.03)
    sel = [1, 2, 6, 10, 12, 15, 24, 25, 29, 30, 36, 53, 57, 58, 3, 4]
    segs, valid = segs[sel], valid[sel]
    want_c, want_ok = reduce_groups_pallas(jnp.asarray(segs),
                                           jnp.asarray(valid), 24, gb=16,
                                           interpret=True)
    got = quad.reduce_groups(_t(segs), _t(valid))
    _check_reduce(got, want_c, want_ok)
    assert int(np.asarray(want_ok).sum()) == 12


def test_reduce_groups_empty_and_padding():
    """Groups without valid segments reduce to nothing; a group count that
    is no multiple of the Pallas block (8) needs no padding here."""
    segs = torch.zeros((5, 48, 2, 2))
    valid = torch.zeros((5, 48), dtype=torch.bool)
    for fn in (quad.reduce_groups, hopper_hyp.reduce_groups):
        corners, ok = fn(segs, valid, 24)
        assert corners.shape == (5, 4, 2) and ok.shape == (5,)
        assert not ok.any()


def test_pose_matches_jax():
    """The plain pose on 16 projected rectangles and 4 degenerate quads
    against the jitted pose_estimate and looks_like_a_screen (tan_aov a
    float32 argument, as in the jitted pipeline)."""
    q = parity.pose_quads(0, 16, 4, IW, IH, TAN_AOV)
    c2, c3, val = hopper_pose.pose_estimate(_t(q), IW, IH, TAN_AOV)
    screen = pose.looks_like_a_screen(c2, c3, val).numpy()
    c2, c3, val = c2.numpy(), c3.numpy(), val.numpy()

    @jax.jit
    def ref(c, tan_aov):
        r = jpose.pose_estimate(c, IW, IH, tan_aov)
        return (*r, jpose.looks_like_a_screen(*r))

    jc2, jc3, jval, jscreen = map(np.asarray, ref(q, TAN_AOV))
    np.testing.assert_array_equal(c2, jc2)
    np.testing.assert_array_equal(np.isnan(val), np.isnan(jval))
    rects = slice(0, 16)
    np.testing.assert_allclose(val[rects], jval[rects], rtol=0,
                               atol=VALUE_ATOL)
    d = np.abs(_scaled(c3[rects]) - _scaled(jc3[rects])).max(axis=(1, 2))
    assert d.max() <= C3_SCALED_ATOL, d
    conv = (val[rects] < 1e-5) & (jval[rects] < 1e-5)
    assert conv.sum() >= 4
    assert d[conv].max() <= C3_SCALED_ATOL_CONVERGED, d[conv]
    away = ~(np.abs(jval - 0.05) <= 1e-3)
    np.testing.assert_array_equal(screen[away], jscreen[away])
    assert 12 <= screen.sum() <= 18


def test_looks_like_a_screen_matches_jax():
    """The screen test on projected rectangles with their true 3D corners
    and values spread around accept_value, plus cases each check rejects:
    a corner behind the camera, a 20:1 aspect, and an image quad 50:1
    thin (its offset ratio 2500)."""
    r = np.random.default_rng(4)
    c2s, c3s = [], []
    for _ in range(24):
        c2, c3 = parity.project_rect(
            [r.uniform(-0.5, 0.5), r.uniform(-0.3, 0.3), r.uniform(2, 4)],
            r.uniform(-0.8, 0.8), r.uniform(-0.6, 0.6), r.uniform(0.5, 2),
            r.uniform(0.2, 1.5), IW, IH, TAN_AOV)
        c2s.append(c2)
        c3s.append(c3)
    c2, c3 = np.stack(c2s), np.stack(c3s)
    c3[0, 2, 2] = -0.1
    c3[1, 1] = c3[1, 0] + (c3[1, 1] - c3[1, 0]) * 40.0
    c2[2] = [[300, 200], [400, 200], [400, 202], [300, 202]]
    val = r.uniform(0, 0.1, len(c2))
    val[:3] = 0.01
    val[3] = 0.05
    c2, c3, val = (a.astype(np.float32) for a in (c2, c3, val))
    got = pose.looks_like_a_screen(_t(c2), _t(c3), _t(val)).numpy()
    want = np.asarray(jax.jit(jpose.looks_like_a_screen)(c2, c3, val))
    np.testing.assert_array_equal(got, want)
    assert not got[:3].any() and got[3]
    assert 0 < got[4:].sum() < len(got) - 4


def _fixture(name):
    return np.load(os.path.join(DATA, name))


def test_rect_geometry_720p_matches_fixture():
    """The 720p hypotheses (rect_hyp_720p_synth.npz) through the plain
    reduction, pose, screen test and sanitising against the JAX tail
    (rect_frame_720p_synth.npz), with no JAX involved."""
    hx, fx = _fixture("rect_hyp_720p_synth.npz"), \
        _fixture("rect_frame_720p_synth.npz")
    corners, ok = quad.reduce_groups(_t(hx["segs"]), _t(hx["valid"]))
    _check_reduce((corners, ok), fx["corners"], fx["ok"])
    res = rect.rect_geometry(_t(hx["segs"]), _t(hx["valid"]),
                             _t(hx["status"]), 1280, 720, TAN_AOV)
    np.testing.assert_array_equal(res.valid.numpy(), fx["valid"])
    np.testing.assert_array_equal(res.status.numpy(), fx["status"])
    v = fx["valid"]
    np.testing.assert_allclose(res.c2.numpy()[v], fx["c2"][v], rtol=0,
                               atol=CORNER_ATOL)
    np.testing.assert_allclose(res.value.numpy()[v], fx["value"][v],
                               rtol=0, atol=VALUE_ATOL)
    assert np.isinf(res.value.numpy()[~v]).all()
    assert not res.c2.numpy()[~v].any() and not res.c3.numpy()[~v].any()
    _check_corner_sets(res, fx)


def _check_corner_sets(res, fx):
    mine = parity.accepted_corner_sets(res.c2.numpy(), res.valid.numpy())
    ref = parity.accepted_corner_sets(fx["c2"], fx["valid"])
    assert len(ref) >= 2
    assert parity.match_sets(mine, ref) == (len(ref), 0, 0)


def test_rect_frame_small_matches_fixture():
    """rect_frame on tests/test_rect_pipeline.py's two-quad scene against
    the JAX chain's result (rect_frame_small.npz): the hypotheses, valid
    and status equal, the accepted corner sets matched; both quads found
    as screens within 4 px, as test_rect_frame_detects_quads asks of the
    JAX package."""
    fx = _fixture("rect_frame_small.npz")
    bgr = _t(fx["bgr"])
    hyp = rect.rect_hypotheses(bgr)
    np.testing.assert_array_equal(hyp.valid.numpy(), fx["hyp_valid"])
    np.testing.assert_allclose(hyp.segs.numpy(), fx["hyp_segs"], rtol=0,
                               atol=1e-4)
    res = rect.rect_frame(bgr, TAN_AOV)
    np.testing.assert_array_equal(res.valid.numpy(), fx["valid"])
    np.testing.assert_array_equal(res.status.numpy(), fx["status"])
    _check_corner_sets(res, fx)
    screens = [r["c2"] for r in rect.live_rects(res) if r["status"] & 1]
    for q in json.loads(str(fx["meta"]))["quads"]:
        assert min(parity.corner_err(q, s) for s in screens) < 4.0


def test_rect_frame_fixtures_are_the_jax_reference():
    fx = _fixture("rect_frame_720p_synth.npz")
    meta = json.loads(str(fx["meta"]))
    assert "quad.reduce_groups -> pose.pose_estimate" in meta["reference"]
    pal = meta["pallas_interpret"]
    assert pal["ok_equal"] and pal["corners_within_1e-3"]
    assert tuple(fx["shape"]) == (720, 1280)
    for k, shape in (("c2", (384, 4, 2)), ("c3", (384, 4, 3)),
                     ("value", (384,)), ("status", (384,)),
                     ("valid", (384,)), ("corners", (384, 4, 2))):
        assert fx[k].shape == shape, k
    assert fx["valid"].sum() >= 2 and (fx["status"] & 1).sum() >= 1
    hx = _fixture("rect_hyp_720p_synth.npz")
    np.testing.assert_array_equal(fx["status"] & 2, hx["status"])
    sx = _fixture("rect_frame_small.npz")
    smeta = json.loads(str(sx["meta"]))
    assert "label_components_converged" in smeta["reference"]
    assert tuple(sx["shape"]) == (144, 192) and sx["bgr"].shape == (144, 192,
                                                                     3)
    assert (sx["status"] & 1).sum() >= 2
    for name in ("rect_frame_720p_synth.npz", "rect_frame_small.npz"):
        assert os.path.getsize(os.path.join(DATA, name)) < 100_000


def test_rect_frame_raises_on_unported_branches():
    """The batched form and the configs the port leaves out (ROADMAP "Do
    not port": the dense oracle path, the two-flood boundary labels)
    raise; bridge_gap2, ported since, is in tests/test_torch_extended.py."""
    bgr = torch.zeros((2, 24, 32, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError):
        rect.rect_frame(bgr, TAN_AOV)
    for cfg in (PipelineConfig(sparse_factor=0),
                PipelineConfig(boundary_comp=0)):
        with pytest.raises(NotImplementedError):
            rect.rect_frame(bgr[0], TAN_AOV, cfg)


def test_cli_rect_on_png(tmp_path):
    fx = _fixture("rect_frame_small.npz")
    common.save_image_bgr(str(tmp_path / "scene.png"), fx["bgr"])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m",
                          "rectdetect_tpu_torch.apps.rect", "scene.png",
                          "cpu", "out.png"], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(fx["valid"].sum())
    assert f"{n} rectangles -> out.png" in res.stdout
    out = common.load_image_bgr(str(tmp_path / "out.png"))
    # the screens' sides are drawn in orange (status 1) or red (3)
    drawn = (out != fx["bgr"]).any(-1)
    assert drawn.sum() > 100
    assert ((out == (0, 200, 255)).all(-1) | (out == (0, 0, 255)).all(-1)
            ).sum() > 100

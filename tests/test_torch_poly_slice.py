"""PyTorch port, the poly slice end to end: poly_frame against the JAX
package on the CPU, the configuration and constant tables carried across,
the package's independence from JAX, and the CLI.

poly_frame: lsid, `count` and every SegmentArena integer field equal; the
float fields within atol 1e-4 (bit-equal in practice, see
test_torch_polyline.py).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_scene
from rectdetect_tpu.config import PipelineConfig as JaxConfig
from rectdetect_tpu.ops import blur as jblur
from rectdetect_tpu.ops import gradient as jgrad
from rectdetect_tpu.ops import shifts as jshifts
from rectdetect_tpu.ops.polyline import SegmentArena as JaxArena
from rectdetect_tpu.pipeline.poly import poly_frame as jax_poly_frame

from rectdetect_tpu_torch import convert
from rectdetect_tpu_torch.apps import common
from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.ops import blur, gradient, shifts
from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame

# The suite runs several test workers on shared cores: a torch thread pool
# per worker would oversubscribe them, and these tensors are small.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_ATOL = 1e-4


def _arena_equal(got, want):
    for f in want._fields:
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("shape,seed", [((32, 44), 0), ((96, 128), 2)])
def test_poly_frame_matches_jax(shape, seed):
    bgr = synth_scene(*shape, seed)
    ja, jl = jax_poly_frame(jnp.asarray(bgr), JaxConfig(mkpl_pallas=0))
    ta, tl = poly_frame(torch.from_numpy(bgr), PipelineConfig(mkpl_pallas=0))
    _arena_equal(ta, ja)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32 and tuple(tl.shape) == shape
    assert len(live_segments(ta)) == int(np.count_nonzero(
        np.asarray(ja.polyid)[1:int(ja.count) + 1]))


def test_config_copy_equals_jax_dataclass():
    jf = dataclasses.fields(JaxConfig)
    tf = dataclasses.fields(PipelineConfig)
    assert [(f.name, f.type, f.default) for f in tf] == \
        [(f.name, f.type, f.default) for f in jf]
    jcfg = JaxConfig(mkpl_pallas=0, strength_poly=700, ls_capacity=1024)
    for src in (jcfg, dataclasses.asdict(jcfg)):
        cfg = convert.config_from_jax(src)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.ls_cap_for(1280, 720) == jcfg.ls_cap_for(1280, 720)
    with pytest.raises(ValueError):
        convert.config_from_jax({"no_such_field": 1})


def test_constant_tables_match_jax():
    assert gradient.V5C == jgrad.V5C
    assert gradient.SQRT_HALF == jgrad._SQRT_HALF
    assert shifts.NEIGH8 == jshifts.NEIGH8
    assert shifts.NEIGH8_REF == jshifts.NEIGH8_REF
    assert blur.gaussian_taps(2) == jblur.gaussian_taps(2)


def test_arena_numpy_round_trip():
    r = np.random.default_rng(4)
    fields = {f: (jnp.asarray(r.random(64, np.float32) * 100)
                  if f in ("sx", "sy", "ex", "ey")
                  else jnp.asarray(r.integers(0, 64, 64, dtype=np.int32)))
              for f in JaxArena._fields if f != "count"}
    ja = JaxArena(count=jnp.int32(17), **fields)
    arena = convert.arena_from_numpy(convert.arena_to_numpy(ja))
    _arena_equal(arena, ja)
    back = convert.arena_to_numpy(arena)
    assert back["sx"].dtype == np.float32 and back["polyid"].dtype == np.int32


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from rectdetect_tpu_torch.pipeline.poly import poly_frame\n"
        "from rectdetect_tpu_torch import convert, parity\n"
        "from rectdetect_tpu_torch.apps import (common, poly, profile_poly,"
        " rect, videotest, vidpoly, vidrect)\n"
        "from rectdetect_tpu_torch.runtime import calibrate, native\n"
        "from rectdetect_tpu_torch.utils import debug\n"
        "from rectdetect_tpu_torch.pipeline.video import ("
        "FpsMeter, VideoPolyDetector, VideoRectDetector)\n"
        "from rectdetect_tpu_torch.ops import (hopper_bids, hopper_blblur,"
        " hopper_despeckle2, hopper_hyp, hopper_links, hopper_merge_mask,"
        " hopper_mkpl, hopper_pose, hopper_quant, hopper_scan, mkpl,"
        " reduce_ls, regions, rand, blur, _iircoef)\n"
        "from rectdetect_tpu_torch.core import luts\n"
        "from rectdetect_tpu_torch.config import EXTENDED_CONFIG\n"
        "from rectdetect_tpu_torch.geometry import clip, pose, quad\n"
        "from rectdetect_tpu_torch.pipeline.frontend import edge_frontend\n"
        "from rectdetect_tpu_torch.pipeline.rect import ("
        "rect_frame, region_smoothing, weak_strong_labels)\n"
        "import chip_smoke\n"
        "img = torch.from_numpy(np.random.default_rng(0).integers("
        "0, 256, (24, 32, 3), dtype=np.uint8))\n"
        "poly_frame(img)\n"
        "fe = edge_frontend(img)\n"
        "weak, _ = weak_strong_labels(fe.edge_bin, fe.edge_thin)\n"
        "region_smoothing(fe.packed0, weak, fe.edge_thin)\n"
        "rect_frame(img, 0.7)\n"
        "calibrate._densities([img])\n"
        "rect_frame(img, 0.7, EXTENDED_CONFIG)\n"
        "poly_frame(img, EXTENDED_CONFIG)\n"
        "calibrate._densities([img], EXTENDED_CONFIG)\n"
        "import dataclasses\n"
        "edge_frontend(img, dataclasses.replace(EXTENDED_CONFIG, "
        "color_exact=True, blur_radius=5))\n"
        "regions.color_reassign(fe.packed0, fe.edge_bin - 1)\n"
        "rand.rand_field(16, 3)\n"
        "blur.gaussian_blur_iir(fe.edge_thin, 3.0)\n"
        "calibrate.plan_fits(calibrate.DEFAULT_CONFIG, img)\n"
        "from rectdetect_tpu_torch.pipeline.rect import rect_stage_images\n"
        "debug.render_packed_lab(rect_stage_images(img)['blblur'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'rectdetect_tpu' or "
        "m.startswith('rectdetect_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def test_png_codec_round_trip_and_pillow(tmp_path):
    from PIL import Image
    bgr = np.random.default_rng(1).integers(0, 256, (13, 17, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "a.png")
    common.save_image_bgr(path, bgr)
    np.testing.assert_array_equal(common.load_image_bgr(path), bgr)
    # the file holds RGB, as any other PNG reader expects
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  bgr[..., ::-1])
    # grey and RGBA inputs come back as three BGR channels
    grey = bgr[..., 0]
    Image.fromarray(grey).save(str(tmp_path / "g.png"))
    np.testing.assert_array_equal(
        common.load_image_bgr(str(tmp_path / "g.png")),
        np.repeat(grey[..., None], 3, axis=2))
    rgba = np.concatenate([bgr[..., ::-1], bgr[..., :1]], axis=2)
    Image.fromarray(rgba).save(str(tmp_path / "c.png"))
    np.testing.assert_array_equal(
        common.load_image_bgr(str(tmp_path / "c.png")), bgr)


def test_cli_poly_on_png(tmp_path):
    common.save_image_bgr(str(tmp_path / "scene.png"), synth_scene(48, 64, 4))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m",
                          "rectdetect_tpu_torch.apps.poly", "scene.png",
                          "cpu"], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "segments -> output.png" in res.stdout
    out = common.load_image_bgr(str(tmp_path / "output.png"))
    assert out.shape == (48, 64, 3) and out.any()


def test_cli_refuses_missing_cuda_device(tmp_path):
    common.save_image_bgr(str(tmp_path / "s.png"), synth_scene(24, 32, 0))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m",
                          "rectdetect_tpu_torch.apps.poly", "s.png", "0"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert not (tmp_path / "output.png").exists()


def test_fixture_is_the_jax_720p_reference():
    fx = np.load(os.path.join(ROOT, "tests", "data", "poly_720p_synth.npz"))
    assert os.path.getsize(os.path.join(ROOT, "tests", "data",
                                        "poly_720p_synth.npz")) < 200_000
    assert tuple(fx["shape"]) == (720, 1280)
    n = len(fx["seg_id"])
    assert n > 100 and int(fx["count"]) >= n
    for f in ("sx", "sy", "ex", "ey", "polyid", "left_ptr", "right_ptr"):
        assert fx[f].shape == (n,)
    assert (fx["polyid"] != 0).all() and (fx["seg_id"] >= 1).all()
    assert np.unpackbits(fx["edge_bin_bits"]).size >= 720 * 1280


def test_rect_fixture_is_the_jax_720p_reference():
    path = os.path.join(ROOT, "tests", "data", "rect_regions_720p_synth.npz")
    assert os.path.getsize(path) < 200_000
    fx = np.load(path)
    assert tuple(fx["shape"]) == (720, 1280)
    for k in ("packed0", "weak_lbl", "strong_lbl", "blurred", "despeck"):
        assert len(str(fx[f"{k}_sha256"])) == 64
    for k in ("weak", "strong"):
        bits = np.unpackbits(fx[f"{k}_bits"])
        assert bits.size >= 720 * 1280
        assert int(bits.sum()) == int(fx[f"{k}_count"]) > 1000
    assert int(fx["strong_count"]) < int(fx["weak_count"])
    poly = np.load(os.path.join(ROOT, "tests", "data", "poly_720p_synth.npz"))
    assert str(fx["packed0_sha256"]) == str(poly["packed0_sha256"])

"""PyTorch port, the runtime against the JAX package on the CPU: the
capacity calibration (runtime/calibrate.py), the plan file
(runtime/native.py), the stage images (pipeline/rect.py
rect_stage_images) and their dumps (utils/debug.py), the still-image CLI
with its plan, and the cv2 frame pump.

The JAX references come from the `calib` fixture
(tests/data/calib_small.npz, tools/make_torch_fixture.py calib): on the
192x144 scene of rect_frame_small.npz, the JAX calibrate's densities and
capacities, plan_fits for DEFAULT_CONFIG and the calibrated config, and
the SHA-256 of rect_stage_images' nine maps.  Nothing here imports JAX.

Tolerances: densities, capacities, plan_fits answers and the integer
stage maps equal.  edge_thin, the one float map, differs in its low bits
where XLA:CPU's rsqrt of the edge vector does (ROADMAP Queue 3, "rsqrt";
tests/test_torch_frontend.py): it is held within atol 5e-3, the front
end's tolerance there, with edge_thin > 0 equal.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.config import DEFAULT_CONFIG
from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.pipeline.rect import STAGE_KINDS, rect_stage_images
from rectdetect_tpu_torch.runtime import calibrate as cal
from rectdetect_tpu_torch.runtime import native
from rectdetect_tpu_torch.utils.debug import StageDumper

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
THIN_ATOL = 5e-3


def _digest(a: np.ndarray) -> str:
    if a.dtype == np.float32:
        a = a.view(np.int32)
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype="<i4").tobytes()).hexdigest()


@pytest.fixture(scope="module")
def calib():
    return np.load(os.path.join(DATA, "calib_small.npz"))


@pytest.fixture(scope="module")
def scene():
    return torch.from_numpy(
        np.load(os.path.join(DATA, "rect_frame_small.npz"))["bgr"])


@pytest.fixture(scope="module")
def stages(scene):
    return {k: v.numpy() for k, v in rect_stage_images(scene).items()}


def one_quad_scene() -> np.ndarray:
    """192x144 BGR: one clean quad on a flat background, a scene whose
    calibrated plan passes plan_fits."""
    from PIL import Image, ImageDraw
    im = Image.new("RGB", (192, 144), (90, 110, 130))
    ImageDraw.Draw(im).polygon([(38, 29), (144, 36), (134, 115), (48, 101)],
                               fill=(230, 200, 60))
    return np.ascontiguousarray(np.asarray(im)[..., ::-1])


def test_calibration_matches_jax(calib, scene, tmp_path):
    """The densities and the kept capacities equal the JAX calibrate's, and
    the plan section holds exactly the kept capacities."""
    got = cal._densities([scene])
    names = [str(k) for k in calib["density_names"]]
    assert [got[k] for k in names] == calib["densities"].tolist()
    plan = str(tmp_path / "plan_torch.txt")
    new = cal.calibrate([scene], plan_path=plan)
    kept = [str(k) for k in calib["kept"]]
    assert kept == list(cal.KEPT)
    assert [getattr(new, k) for k in kept] == calib["capacities"].tolist()
    entries = native.plan_load(plan, "cpu|144x192")
    assert entries == {k: str(getattr(new, k)) for k in kept}
    assert open(plan).read().startswith("[cpu|144x192]\n")


@pytest.mark.parametrize("which", [0, 1], ids=["default", "calibrated"])
def test_plan_fits_matches_jax(calib, scene, which):
    cfg = DEFAULT_CONFIG
    if which:
        cfg = dataclasses.replace(cfg, **dict(zip(
            (str(k) for k in calib["kept"]),
            (int(v) for v in calib["capacities"]))))
    assert cal.plan_fits(cfg, scene) == bool(calib["plan_fits"][which])


@pytest.mark.parametrize("name", list(STAGE_KINDS))
def test_stage_images_match_jax(calib, stages, name):
    names = [str(k) for k in calib["stage_names"]]
    assert sorted(names) == sorted(STAGE_KINDS)
    want = str(calib["stage_sha256"][names.index(name)])
    got = stages[name]
    if name == "edge_thin":
        ref = calib["edge_thin"]
        np.testing.assert_array_equal(got > 0, ref > 0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=THIN_ATOL)
    else:
        assert got.dtype == np.int32 and _digest(got) == want


def test_stage_dumper_writes_nine_pngs(stages, tmp_path, monkeypatch):
    from PIL import Image
    monkeypatch.delenv("RECTDETECT_DUMP", raising=False)
    off = StageDumper()
    off.add("edge_thin", "gray", stages["edge_thin"])
    assert not off.enabled and off.flush() == []
    dumper = StageDumper(str(tmp_path / "dump"))
    for name, arr in stages.items():
        dumper.add(name, STAGE_KINDS[name], arr)
    paths = dumper.flush()
    assert [os.path.basename(p) for p in paths] == [
        f"{i:02d}_{k}.png" for i, k in enumerate(STAGE_KINDS)]
    for p in paths:
        img = np.asarray(Image.open(p))
        assert img.shape == (144, 192, 3) and img.any()


def test_labf_to_bgr_inverts_the_conversion():
    """Every 4th level of each channel: back to within 1 of itself."""
    v = np.arange(0, 256, 4, dtype=np.uint8)
    bgr = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(64, -1, 3)
    back = color.labf_to_bgr(color.bgr_to_labf(torch.from_numpy(bgr)))
    assert back.dtype == torch.uint8
    assert np.abs(back.numpy().astype(int) - bgr).max() <= 1


def test_plan_file_round_trips_a_jax_section(tmp_path):
    """The repo's plan.txt, written by the JAX package, read only: each
    section reads as its `name value` lines, and rewriting every section
    through plan_save in turn gives the same bytes back."""
    src = os.path.join(ROOT, "plan.txt")
    text = open(src).read()
    sections, cur = {}, None
    for line in text.splitlines():
        if line.startswith("["):
            cur = line[1:-1]
            sections[cur] = {}
        elif line:
            k, _, v = line.partition(" ")
            sections[cur][k] = v
    assert len(sections) >= 2
    out = str(tmp_path / "plan.txt")
    for name, entries in sections.items():
        assert native.plan_load(src, name) == entries
        native.plan_save(out, name, entries)
    assert open(out).read() == text
    # a section written over keeps the others and its place
    first = next(iter(sections))
    native.plan_save(out, first, {"max_groups": "256"})
    assert native.plan_load(out, first) == {"max_groups": "256"}
    for name in list(sections)[1:]:
        assert native.plan_load(out, name) == sections[name]
    assert native.plan_load(str(tmp_path / "none.txt"), first) == {}


def test_load_calibrated_config_applies_a_section(tmp_path):
    plan = str(tmp_path / "plan_torch.txt")
    assert cal.load_calibrated_config(144, 192, "cpu",
                                      plan_path=plan) == DEFAULT_CONFIG
    native.plan_save(plan, "cpu|144x192", {
        "sparse_factor": "7", "max_groups": "320", "ls_capacity": "9000",
        "walk_prefilter_factor": "64", "pin_region_runs": "1"})
    native.plan_save(plan, "cpu|72x96", {"sparse_factor": "2"})
    cfg = cal.load_calibrated_config(144, 192, torch.device("cpu"),
                                     plan_path=plan)
    assert (cfg.sparse_factor, cfg.max_groups, cfg.ls_capacity,
            cfg.walk_prefilter_factor) == (7, 320, 9000, 64)
    assert cfg.strings_sparse_factor == DEFAULT_CONFIG.strings_sparse_factor
    assert cfg.pin_region_runs == 0
    assert cal._key("NVIDIA H100 80GB HBM3", 720, 1280) == \
        "NVIDIA_H100_80GB_HBM3|720x1280"


def test_calibrate_cli_shows_and_clears(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    native.plan_save(cal.PLAN_PATH, "cpu|144x192", {"sparse_factor": "7"})
    cal.main(["calibrate", "--kernels"])
    out = capsys.readouterr().out
    assert "nothing to tune, plan unchanged" in out and "cpu|144x192" in out
    assert native.plan_load(cal.PLAN_PATH, "cpu|144x192") == \
        {"sparse_factor": "7"}
    cal.main(["calibrate", "--clear"])
    assert not os.path.exists(cal.PLAN_PATH)


def test_rect_cli_calibrates_then_applies_the_plan(tmp_path, monkeypatch,
                                                  capsys):
    """In a fresh directory the first run has no plan, calibrates and
    writes ./plan_torch.txt; the second applies that section, which this
    scene fits, and writes nothing new."""
    from rectdetect_tpu_torch.apps import common, rect
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RECTDETECT_DUMP", raising=False)
    common.save_image_bgr("quad.png", one_quad_scene())
    outs = []
    for _ in range(2):
        assert rect.main(["rect", "quad.png", "cpu", "out.png"]) == 0
        outs.append(capsys.readouterr())
    plan = tmp_path / "plan_torch.txt"
    assert "No plan" in outs[0].out
    text = plan.read_text()
    assert text.startswith("[cpu|144x192]\n") and text.count("[") == 1
    assert "No plan" not in outs[1].out
    assert "recalibrating" not in outs[1].out
    assert "applying plan [cpu|144x192]" in outs[1].err
    last = [o.out.splitlines()[-1] for o in outs]
    assert last[0] == last[1] and last[0].endswith(" rectangles -> out.png")
    assert int(last[0].split()[0]) >= 1
    assert plan.read_text() == text


def test_rect_cli_extended_is_not_ported(tmp_path, monkeypatch, capsys):
    """--extended runs EXTENDED_CONFIG: in a fresh directory it calibrates
    from EXTENDED_CONFIG on the image, writes the plan and draws the
    detections, as the JAX CLI does (rectdetect_tpu/apps/rect.py:36-48)."""
    from rectdetect_tpu_torch.apps import common, rect
    from rectdetect_tpu_torch.config import EXTENDED_CONFIG
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RECTDETECT_DUMP", raising=False)
    common.save_image_bgr("quad.png", one_quad_scene())
    seen = []
    real = cal.calibrate
    monkeypatch.setattr(cal, "calibrate", lambda frames, cfg, *a: (
        seen.append(cfg), real(frames, cfg, *a))[1])
    assert rect.main(["rect", "quad.png", "cpu", "out.png",
                      "--extended"]) == 0
    out = capsys.readouterr().out
    assert "No plan" in out and "not ported" not in out
    assert [(c.bridge_gap2, c.strength_rescue_rounds) for c in seen] == \
        [(EXTENDED_CONFIG.bridge_gap2, EXTENDED_CONFIG.strength_rescue_rounds)]
    last = out.splitlines()[-1]
    assert last.endswith(" rectangles -> out.png") and int(last.split()[0]) >= 1
    assert (tmp_path / "plan_torch.txt").read_text().startswith(
        "[cpu|144x192]\n")


def test_frame_pump_reads_a_file_in_order(tmp_path):
    import cv2
    path = str(tmp_path / "v.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        (32, 24), True)
    for i in range(5):
        w.write(np.full((24, 32, 3), 40 * i, np.uint8))
    w.release()
    pump = native.FramePump(path)
    assert (pump.width, pump.height) == (32, 24)
    got = []
    while (f := pump.next(timeout_ms=2000)) is not None:
        got.append(int(f.mean().round()))
    pump.close()
    assert len(got) == 5
    assert all(abs(g - 40 * i) <= 3 for i, g in enumerate(got))


@pytest.mark.parametrize("n_groups", [2047, 2048])
def test_first_k_members_takes_the_groups_calibrate_may_choose(n_groups):
    """calibrate caps max_groups at 2048; the weighted member selection
    packs group ids above 20 weight bits in 32 and takes them (the JAX
    package's own assert stops at 2047, reduce_ls.py:286).  Against a
    loop: per group, distinct lsids by quantized weight descending, ties
    by smallest lsid, the first k."""
    from rectdetect_tpu_torch.ops.reduce_ls import first_k_members
    r = np.random.default_rng(n_groups)
    m, k, cap = 6000, 4, 900
    g = r.integers(0, n_groups + 2, m).astype(np.int32)
    g[:50] = n_groups
    lsid = r.integers(0, cap + 1, m).astype(np.int32)
    wt_of = r.random(cap + 1).astype(np.float32) * 1000
    ids, valid, counts = first_k_members(
        torch.from_numpy(g), torch.from_numpy(lsid), n_groups, k, cap,
        weight=torch.from_numpy(wt_of[lsid]))
    wq = wt_of.view(np.int32) >> 12
    for grp in (1, 2, n_groups // 2, n_groups - 1, n_groups):
        mem = sorted({int(x) for x, gg in zip(lsid, g)
                      if gg == grp and 0 < x < cap},
                     key=lambda x: (-wq[x], x))
        assert counts[grp] == len(mem)
        got = ids[grp - 1][valid[grp - 1]].tolist()
        assert got == mem[:k]


def _gap_pixels():
    path = os.path.join(DATA, "photo_gaps.npz")
    gx = np.load(path)
    return sorted({k.rsplit("/", 1)[0] for k in gx.files if k != "meta"})


def _front(labq: torch.Tensor):
    """The front end from the quantized Lab planes on: blur, K1, K2."""
    from rectdetect_tpu_torch.ops import blur
    from rectdetect_tpu_torch.ops.hopper_grad import edge_front
    from rectdetect_tpu_torch.ops.hopper_thin import thinthres
    labb = torch.stack([blur.gaussian_blur(labq[..., c], 2)
                        for c in range(3)], dim=-1)
    return labb, thinthres(*edge_front(labb))


@pytest.mark.parametrize("pixel", _gap_pixels())
def test_photo_edge_bin_gap_is_a_known_ulp_gap(pixel):
    """Where the port's edge_bin differs from the JAX package's on a
    photograph (tests/data/photo_gaps.npz, windows of 33x33 around each
    pixel), the difference comes from one of the XLA:CPU ulp gaps that
    ROADMAP Queue 3 lists: either the colour conversion's cbrt/pow (the
    port's packed Lab differs in the window, and with the JAX package's
    packed Lab the port's blur, K1 and K2 give its edge pixel), or K1/K2's
    rsqrt (the port's blur of the JAX colours equals the JAX blurred Lab
    in the window, and K1/K2 on that equal input still flip the pixel)."""
    gx = np.load(os.path.join(DATA, "photo_gaps.npz"))
    y, x = (int(v) for v in pixel.split("/")[1].split("_"))
    y0, x0, h, w = gx[pixel + "/corner"]
    cy, cx = y - y0, x - x0
    jax_on = bool(gx[pixel + "/edge_thin"][cy, cx] > 0)
    packed0 = gx[pixel + "/packed0"]
    own = gx[pixel + "/port_packed0"]
    _, et_own = _front(color.unpack_labf(torch.from_numpy(own)))
    assert bool(et_own[cy, cx] > 0) != jax_on      # the gap, in the window
    labb, et = _front(color.unpack_labf(torch.from_numpy(packed0)))
    if (own != packed0).any():
        assert bool(et[cy, cx] > 0) == jax_on      # the colour gap
    else:
        # rows and columns more than 6 from a cut side blur as in the frame
        ys = slice(0 if y0 == 0 else 6, None if y0 + labb.shape[0] == h
                   else -6)
        xs = slice(0 if x0 == 0 else 6, None if x0 + labb.shape[1] == w
                   else -6)
        np.testing.assert_array_equal(labb.numpy()[ys, xs],
                                      gx[pixel + "/labb"][ys, xs])
        assert bool(et[cy, cx] > 0) != jax_on      # K1/K2 on equal input

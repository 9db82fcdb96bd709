"""PyTorch port, the off-default capabilities against the JAX package on the
CPU: EXTENDED_CONFIG (K3's bridge2 variant in its plain version,
simple_connect2, the staged strength filters over the strings' slot list
with rescue_filtered), end to end on the seed-66 shallow-slope scene, with
its calibration; the exact LUT colour path; the blur at every radius;
color_reassign; and the xrandom ladder (rand_field).

The JAX references come from the `extended` fixture
(tests/data/extended.npz, tools/make_torch_fixture.py extended).  Nothing
here imports JAX.  The 720p EXTENDED_CONFIG frame and the photographs run
on the card (chip_smoke.py phase 7).

Tolerances: every integer map, label, arena field, slot list, table and
digest equal; the FIR blur and its taps bit for bit; the recursive blur
(gaussian_blur_iir) within 1e-4 of a unit-range image, because the JAX
package runs the recursion as an associative scan and the port in order
(float32 sums in another order; the JAX form drifts up to 4.2e-5 from the
float64 recursion at sigma 5, the port's 3.5e-6); rect_frame's accepted
corner sets within 2 px of the JAX package's, none one-sided
(parity.match_sets), with valid and status equal.
"""

import hashlib
import math
import os

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch import parity
from rectdetect_tpu_torch.config import (DEFAULT_CONFIG, EXTENDED_CONFIG,
                                         PipelineConfig)
from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.ops import blur, ccl, hopper_morph, morphology
from rectdetect_tpu_torch.ops import rand, regions
from rectdetect_tpu_torch.ops.compact import compact_mask
from rectdetect_tpu_torch.ops.hopper_ccl import label_components
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.poly import poly_frame
from rectdetect_tpu_torch.pipeline.rect import (rect_frame,
                                                weak_strong_labels)
from rectdetect_tpu_torch.runtime import calibrate as cal

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
# the rect tools' horizontal angle of view, 72 degrees (rect.cpp:84)
TAN_AOV = math.tan(math.radians(72.0) / 2)
IIR_ATOL = 1e-4
CORNER_TOL = 2.0
# the quad's corners against the ground truth
# (tests/test_accuracy_fixes.py::test_shallow_slope_quad_detected_end_to_end)
GT_TOL = 3.0
FIX = np.load(os.path.join(DATA, "extended.npz"))
META = __import__("json").loads(str(FIX["meta"]))
INT_FIELDS = ("start_index", "end_index", "left_ptr", "right_ptr",
              "start_count", "end_count", "polyid", "npix", "level")
FLOAT_FIELDS = ("sx", "sy", "ex", "ey")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _digest(t) -> str:
    a = t.numpy() if isinstance(t, torch.Tensor) else t
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype="<i4").tobytes()).hexdigest()


@pytest.fixture(scope="module")
def s66():
    """The seed-66 scene and the port's EXTENDED_CONFIG rect_frame of it."""
    bgr = _t(FIX["s66/bgr"])
    return bgr, rect_frame(bgr, TAN_AOV, EXTENDED_CONFIG)


# ---- K3 with bridge2, plain version ----------------------------------------

@pytest.mark.parametrize("name", [str(k) for k in FIX["k3_names"]])
def test_k3_bridge2_plain_matches_jax(name):
    """simple_connect2 and strings_chain in both variants, bridge2 off and
    on, equal the JAX package's; the wrapper takes the plain version for
    a CPU tensor."""
    m = _t(FIX[f"k3/{name}/in"])
    np.testing.assert_array_equal(morphology.simple_connect2(m).numpy(),
                                  FIX[f"k3/{name}/connect2"])
    for v in ("rect", "poly_branch"):
        for b2 in (0, 1):
            want = FIX[f"k3/{name}/{v}/{b2}"]
            np.testing.assert_array_equal(
                morphology.strings_chain(m, v, bool(b2)).numpy(), want,
                err_msg=f"{v} bridge2={b2}")
            np.testing.assert_array_equal(
                hopper_morph.strings_chain(m, v, bool(b2)).numpy(), want)


def test_connect2_closes_the_staircase_and_nothing_else():
    """The staircase's 2-px holes close into one chain; the 3-px hole and
    the hole beside a junction stay open; bridging only adds pixels."""
    stair = _t(FIX["k3/staircase/in"])
    before = label_components(stair, 0)
    bridged = morphology.simple_connect2(stair)
    after = label_components(bridged, 0)
    assert len(torch.unique(before[before >= 0])) > 5
    assert len(torch.unique(after[after >= 0])) == 1
    assert bool((bridged >= stair).all())
    assert int(morphology.simple_connect2(_t(FIX["k3/wide/in"]))[
        8, 10:13].sum()) == 0
    assert int(morphology.simple_connect2(_t(FIX["k3/junction/in"]))[
        8, 10:12].sum()) == 0


# ---- the staged strength filters and the rescue ---------------------------

@pytest.mark.parametrize("case", ["sliver", "random"])
def test_rescue_filtered_matches_jax(case):
    got = ccl.rescue_filtered(_t(FIX[f"rescue/{case}/pre"]),
                              _t(FIX[f"rescue/{case}/filtered"]), 3)
    np.testing.assert_array_equal(got.numpy(), FIX[f"rescue/{case}/out"])
    if case == "sliver":
        assert bool((got[6, 10:12] > 0).all())      # the sliver restored
        assert bool((got[2, 5:8] == -1).all())      # the isolated one not


def test_compacted_strength_pair_past_capacity_matches_jax():
    """calc_strength and filter_strength over a slot list that holds 60% of
    the labelled pixels drop the rest as the JAX package does, and the
    rescue of the weak map equals its own."""
    lbl, edge = _t(FIX["strength/label"]), _t(FIX["strength/edge"])
    cap = int(FIX["strength/cap"])
    weak_t, strong_t = (int(v) for v in FIX["strength/thresholds"])
    comp = compact_mask((lbl > 0).reshape(-1), cap)
    assert int(comp.n) == cap < int((lbl > 0).sum())
    st = ccl.calc_strength(edge, lbl, 10000.0, comp)
    weak = ccl.filter_strength(lbl, st, weak_t, comp)
    strong = ccl.filter_strength(weak, st, strong_t, comp)
    for got, key in ((st, "st"), (weak, "weak"), (strong, "strong"),
                     (ccl.rescue_filtered(lbl, weak, 3), "weak_rescued")):
        np.testing.assert_array_equal(got.numpy(), FIX[f"strength/{key}"],
                                      err_msg=key)
    # the dense forms differ from the compacted ones: pixels did drop
    assert not torch.equal(ccl.filter_strength(
        lbl, ccl.calc_strength(edge, lbl), weak_t), weak)


# ---- the seed-66 scene end to end ------------------------------------------

def test_seed66_extended_rect_frame_matches_jax(s66):
    """EXTENDED_CONFIG rect_frame: the weak/strong maps, valid and status
    equal to the JAX fixture's, the accepted corner sets within 2 px, none
    one-sided, and every ground-truth quad found within 3 px."""
    bgr, res = s66
    fe = edge_frontend(bgr, EXTENDED_CONFIG)
    weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin,
                                      EXTENDED_CONFIG)
    assert _digest(weak) == str(FIX["s66/weak_sha256"])
    assert _digest(strong) == str(FIX["s66/strong_sha256"])
    n = int(FIX["s66/n_slots"])
    rows = FIX["s66/rows"]
    valid_ref = np.zeros(n, bool)
    valid_ref[rows] = True
    c2_ref = np.zeros((n, 4, 2), np.float32)
    c2_ref[rows] = FIX["s66/c2"]
    valid = res.valid.numpy()
    np.testing.assert_array_equal(valid, valid_ref)
    np.testing.assert_array_equal(res.status.numpy()[rows],
                                  FIX["s66/status"])
    mine = parity.accepted_corner_sets(res.c2.numpy(), valid)
    ref = parity.accepted_corner_sets(c2_ref, valid_ref)
    assert parity.match_sets(mine, ref, CORNER_TOL) == (len(ref), 0, 0)
    c2 = res.c2.numpy()[valid]
    for g in FIX["s66/quads"]:
        assert min(parity.corner_err(c, g) for c in c2) <= GT_TOL


def test_seed66_default_config_does_not_miss_it():
    """On this scene the extension changes nothing on the CPU: its edge
    map has no straight 2-px gap between chain ends, and exact labels
    leave the rescue nothing to restore, so the strings of both K3
    variants and the weak/strong maps are the same under either config.
    The JAX package's own rect_frame (the fixture's meta) finds both
    quads under either config too, at the errors the port finds under
    EXTENDED_CONFIG (test above): DEFAULT_CONFIG does not miss them."""
    fe = edge_frontend(_t(FIX["s66/bgr"]), DEFAULT_CONFIG)
    for v in ("rect", "poly_branch"):
        assert torch.equal(hopper_morph.strings_chain(fe.edge_bin, v, True),
                           hopper_morph.strings_chain(fe.edge_bin, v))
    ext, dflt = (weak_strong_labels(fe.edge_bin, fe.edge_thin, c)
                 for c in (EXTENDED_CONFIG, DEFAULT_CONFIG))
    assert all(torch.equal(a, b) for a, b in zip(ext, dflt))
    strong = (ext[1] > 0).to(torch.int32)
    assert torch.equal(hopper_morph.strings_chain(strong, "poly_branch",
                                                  True),
                       hopper_morph.strings_chain(strong, "poly_branch"))
    rf = META["s66"]["rect_frame"]
    assert rf["DEFAULT_CONFIG"]["best_err_per_quad"] == \
        rf["EXTENDED_CONFIG"]["best_err_per_quad"]
    assert max(rf["DEFAULT_CONFIG"]["best_err_per_quad"]) <= GT_TOL


def test_extension_changes_the_720p_maps_as_in_jax():
    """On bench.synth_frame's 720p frame the extension is live: K3's
    bridge2 adds string pixels, and the weak/strong maps under
    EXTENDED_CONFIG equal the JAX package's extended maps
    (tests/data/extended.npz) while those under DEFAULT_CONFIG equal its
    default maps (tests/data/rect_regions_720p_synth.npz), which differ
    from them."""
    from bench import synth_frame
    fe = edge_frontend(torch.from_numpy(synth_frame(720, 1280, seed=0)))
    assert int(hopper_morph.strings_chain(fe.edge_bin, "rect", True).sum()) \
        > int(hopper_morph.strings_chain(fe.edge_bin, "rect").sum())
    dflt = np.load(os.path.join(DATA, "rect_regions_720p_synth.npz"))
    for cfg, fx, pre in ((EXTENDED_CONFIG, FIX, "s720/"),
                         (DEFAULT_CONFIG, dflt, "")):
        maps = weak_strong_labels(fe.edge_bin, fe.edge_thin, cfg)
        for k, m in zip(("weak", "strong"), maps):
            np.testing.assert_array_equal(
                np.packbits((m > 0).numpy().reshape(-1)),
                fx[f"{pre}{k}_bits"], err_msg=f"{k} {pre}")
    for k in ("weak", "strong"):
        assert not np.array_equal(FIX[f"s720/{k}_bits"], dflt[f"{k}_bits"])


def test_seed66_extended_poly_frame_arena_matches_jax():
    """EXTENDED_CONFIG poly_frame (rescue after the filter, K3 bridge2 in
    the polyline): lsid and every live segment equal the JAX fixture's."""
    arena, lsid = poly_frame(_t(FIX["s66/bgr"]), EXTENDED_CONFIG)
    assert _digest(lsid) == str(FIX["s66/poly/lsid_sha256"])
    a = {k: v.numpy() for k, v in arena._asdict().items()}
    assert int(a["count"]) == int(FIX["s66/poly/count"])
    live = np.nonzero(a["polyid"][:int(a["count"]) + 1])[0]
    np.testing.assert_array_equal(live, FIX["s66/poly/seg_id"])
    for f in INT_FIELDS + FLOAT_FIELDS:
        np.testing.assert_array_equal(a[f][live], FIX[f"s66/poly/{f}"],
                                      err_msg=f)


def test_calibration_extended_matches_jax(tmp_path):
    """calibrate from EXTENDED_CONFIG on the 192x144 scene of
    rect_frame_small.npz: the densities, the kept capacities and both
    plan_fits answers equal the JAX package's."""
    scene = _t(np.load(os.path.join(DATA, "rect_frame_small.npz"))["bgr"])
    got = cal._densities([scene], EXTENDED_CONFIG)
    names = ("rect_d", "strings_d", "boundary_d", "arcs_d", "n_arcs",
             "cyc_d", "groups")
    assert [got[k] for k in names] == FIX["calib/densities"].tolist()
    new = cal.calibrate([scene], EXTENDED_CONFIG,
                        str(tmp_path / "plan_torch.txt"))
    assert [getattr(new, k) for k in cal.KEPT] == \
        FIX["calib/capacities"].tolist()
    assert (new.bridge_gap2, new.strength_rescue_rounds) == (True, 3)
    assert [cal.plan_fits(c, scene) for c in (EXTENDED_CONFIG, new)] == \
        FIX["calib/plan_fits"].tolist()


# ---- the exact colour path, the blur, color_reassign, rand ----------------

def test_exact_colour_path_over_all_colours():
    """bgr_to_packed_exact of all 2^24 colours hashes to the JAX package's
    digest; labf_to_bgr(exact=True) equals it on a sample; the front end's
    color_exact branch starts from it."""
    h = hashlib.sha256()
    for part in range(16):
        i = torch.arange(part << 20, (part + 1) << 20, dtype=torch.int64)
        bgr = torch.stack([i & 255, (i >> 8) & 255, i >> 16], -1).to(
            torch.uint8).reshape(1024, 1024, 3)
        h.update(np.ascontiguousarray(color.bgr_to_packed_exact(bgr).numpy(),
                                      dtype="<i4").tobytes())
    assert h.hexdigest() == str(FIX["packed_exact_sha256"])
    packed = color.bgr_to_packed_exact(_t(FIX["color/bgr"]))
    np.testing.assert_array_equal(packed.numpy(), FIX["color/packed"])
    np.testing.assert_array_equal(
        color.labf_to_bgr(color.unpack_labf(packed), exact=True).numpy(),
        FIX["color/labf_to_bgr_exact"])
    fe = edge_frontend(_t(FIX["color/bgr"]), PipelineConfig(color_exact=True))
    assert torch.equal(fe.packed0, packed)


@pytest.mark.parametrize("r", range(41))
def test_gaussian_taps_every_radius(r):
    """The taps at r: the reference recurrence's exact impulse response
    for r <= 31, the sampled Gaussian beyond; equal to the JAX package's."""
    n = FIX["taps_len"]
    start = int(n[:r].sum())
    want = FIX["taps"][start:start + int(n[r])]
    assert blur.gaussian_taps(r) == tuple(want.tolist())


@pytest.mark.parametrize("r", [1, 3, 7, 31, 40])
def test_gaussian_blur_at_radius_matches_jax(r):
    """The 37x53 blur at r, bit for bit (its radius 80 at r = 31 reflects
    the image more than once, as jnp.pad's "reflect" does)."""
    got = blur.gaussian_blur(_t(FIX["blur/in"]), r)
    np.testing.assert_array_equal(got.numpy(), FIX[f"blur/{r}"])


@pytest.mark.parametrize("sigma", [2.0, 5.0])
def test_gaussian_blur_iir_matches_jax(sigma):
    got = blur.gaussian_blur_iir(_t(FIX["blur/in"]), sigma)
    np.testing.assert_allclose(got.numpy(), FIX[f"blur_iir/{sigma}"],
                               rtol=0, atol=IIR_ATOL)


def test_color_reassign_matches_jax():
    got = regions.color_reassign(_t(FIX["reassign/packed"]),
                                 _t(FIX["reassign/label"]))
    np.testing.assert_array_equal(got.numpy(), FIX["reassign/out"])


@pytest.mark.parametrize("seed", [str(k) for k in FIX["rand/seeds"]])
def test_rand_field_matches_jax(seed):
    """4096 values of rand_field bit for bit (the fixture keeps their
    SHA-256 and the first 16)."""
    got = rand.rand_field(4096, int(seed))
    np.testing.assert_array_equal(got[:16].numpy(), FIX[f"rand/{seed}/head"])
    assert _digest(got) == str(FIX[f"rand/{seed}/sha256"])

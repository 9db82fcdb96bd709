"""PyTorch port, the width-tiled path (dist/tile.py, dist/mesh.py) on the
CPU: the x0/w_total offset forms of K3, the merge mask, blblur and the
links CCL; every tiled stage, ccl_tiled, rect_tail_tiled, rect_step_tiled,
poly_step_tiled and rect_step_tiled_gather; the TileGroup collectives; the
tiled video detector and `vidrect --tiles`.

The JAX references come from the `tiles` fixture (tests/data/tiles.npz,
tools/make_torch_fixture.py tiles: the JAX package under shard_map on 4
host devices).  Nothing here imports JAX.  The kernels run on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8).

Tolerances: every integer map, label and table equal, element for
element, against the JAX tiled fixture and against the port's own
single-frame stage, sliced to the tile.  Labels from a CCL are compared
with the JAX package's only where its fixed-pass CPU CCL has converged
(the fixture's meta says where; the port's labels are exact).  The tiled
front end equals the port's single-frame front end bit for bit; against
the JAX package's single-chip front end (the fixture) packed0 and
edge_bin are equal and edge_thin within 5e-3 (tests/test_torch_frontend.py:
the port rounds 1/sqrt once, XLA:CPU does not).  The JAX package's own
tiled front end differs from its single chip in float ulps of edge_thin
(it samples K2 in tile columns and blurs the reflected border in another
order), which the fixture's meta counts and the port does not inherit.
RectResults: the port's tiled result equals its single-frame one bit for
bit; against the JAX package, test_torch_rect.py's tolerances for
rect_geometry: valid and status equal, c2 within 1e-3 (the jitted quad
reduction fuses multiply-adds, so its corners differ by ulps), value
within 0.02 and the 3D corners within 0.05.  Arenas: integer fields and
lsid equal, endpoints within 1e-4.
"""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.dist import tile as dtile
from rectdetect_tpu_torch.dist.mesh import TileGroup
from rectdetect_tpu_torch.ops import (ccl, hopper_blblur, hopper_ccl,
                                      hopper_links, hopper_merge_mask,
                                      hopper_morph, morphology, regions)
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.poly import poly_frame
from rectdetect_tpu_torch.pipeline.rect import (live_rects, rect_frame,
                                                rect_tail)

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = np.load(os.path.join(ROOT, "tests", "data", "tiles.npz"))
META = json.loads(str(FIX["meta"]))
CFG = PipelineConfig(max_groups=16)
TAN_AOV = math.tan(math.radians(72.0) / 2)
EDGE_THIN_ATOL = 5e-3
CORNER_ATOL = 1e-3
VALUE_ATOL = 0.02
C3_ATOL = 0.05
ARENA_ATOL = 1e-4
CASES = tuple(META["cases"])
TAIL_KEYS = ("strings", "glabel", "weak", "blurred", "despeck", "strong",
             "mask", "seg", "bmark", "boundary")
CCL_KEYS = ("glabel", "boundary")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cpu(n):
    return TileGroup(["cpu"] * n)


def _cat(tiles):
    return torch.cat(tiles, dim=1)


_SINGLE = {}


def _single(case, part):
    """One part of the port's single-frame results for a case's frame,
    computed once per process: "fe" the front end; "maps" the dense tail
    stages of tests/test_tile_tail.py from the fixture's front-end
    products; "rect_frame"; "rect_tail" from those products."""
    key = (case, part)
    if key in _SINGLE:
        return _SINGLE[key]
    bgr = _t(FIX[f"{case}/bgr"])
    pk, et, eb = (_t(FIX[f"{case}/{k}"])
                  for k in ("packed0", "edge_thin", "edge_bin"))
    if part == "fe":
        out = edge_frontend(bgr, CFG)
    elif part == "rect_frame":
        out = rect_frame(bgr, TAN_AOV, CFG)
    elif part == "rect_tail":
        out = rect_tail(pk, et, eb, TAN_AOV, CFG)
    else:
        s = hopper_morph.strings_chain(eb, "rect")
        lbl = hopper_ccl.label_components(s, 0)
        st = ccl.calc_strength(et, lbl, CFG.strength_scale)
        weak = ccl.filter_strength(lbl, st, CFG.strength_weak)
        blurred = hopper_blblur.blblur(pk, (weak > 0).to(torch.int32),
                                       CFG.blblur_iters)
        despeck = regions.quantize_despeckle(blurred, et, 24, 24, 24)
        strong = ccl.filter_strength(weak, st, CFG.strength_strong)
        mask = hopper_merge_mask.junction_merge_mask(strong)
        seg = regions.sizes_despeckle2(
            hopper_links.label_merge(despeck, mask, strong),
            CFG.despeckle2_thre)
        bmark = regions.mark_boundary(seg)
        out = dict(strings=s, glabel=lbl, weak=weak, blurred=blurred,
                   despeck=despeck, strong=strong, mask=mask, seg=seg,
                   bmark=bmark,
                   boundary=hopper_ccl.label_components(bmark, -1))
    _SINGLE[key] = out
    return out


def _frame_tiles(case):
    """The case's TileGroup and its frame cut into the tiles."""
    g = _cpu(META["cases"][case]["tiles"])
    return g, g.split(_t(FIX[f"{case}/bgr"]))


def _same(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _close_to_jax(res, prefix):
    valid = FIX[f"{prefix}/valid"]
    np.testing.assert_array_equal(res.valid.numpy(), valid)
    np.testing.assert_array_equal(res.status.numpy(), FIX[f"{prefix}/status"])
    np.testing.assert_allclose(res.c2.numpy()[valid],
                               FIX[f"{prefix}/c2"][valid], rtol=0,
                               atol=CORNER_ATOL)
    np.testing.assert_allclose(res.value.numpy()[valid],
                               FIX[f"{prefix}/value"][valid], rtol=0,
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(res.c3.numpy()[valid],
                               FIX[f"{prefix}/c3"][valid], rtol=0,
                               atol=C3_ATOL)
    assert valid.sum() > 0


# ---- the offset forms ---------------------------------------------------

@pytest.mark.parametrize("j", range(len(META["offsets"])))
def test_offset_forms_match_jax(j):
    """K3 (both variants, bridge2 off and on), blblur, the merge mask and
    the links CCL at (x0, w_total) against the JAX offset forms; the
    wrappers take the plain versions on CPU tensors."""
    x0, wt = META["offsets"][j]
    inp = {k[len("offset/in/"):]: _t(FIX[k]) for k in FIX.files
           if k.startswith("offset/in/")}
    o = dict(x0=x0, w_total=wt)
    for v in ("rect", "poly_branch"):
        for b2 in (0, 1):
            want = FIX[f"offset/{j}/strings/{v}/{b2}"]
            np.testing.assert_array_equal(
                hopper_morph.strings_chain(inp["edge"], v, bool(b2),
                                           **o).numpy(), want)
            np.testing.assert_array_equal(
                morphology.strings_chain(inp["edge"], v, bool(b2),
                                         **o).numpy(), want)
    for iters in (3, 10):
        np.testing.assert_array_equal(
            hopper_blblur.blblur(inp["packed"], inp["blur_edge"], iters,
                                 **o).numpy(),
            FIX[f"offset/{j}/blblur/{iters}"])
    np.testing.assert_array_equal(
        hopper_merge_mask.junction_merge_mask(inp["lbl"], **o).numpy(),
        FIX[f"offset/{j}/merge_mask"])
    np.testing.assert_array_equal(
        hopper_links.label_merge(inp["colours"], inp["mask"], inp["lbl"],
                                 **o).numpy(),
        FIX[f"offset/{j}/label_merge"])


def test_odd_x0_strings_equal_the_frame():
    """A tile whose widened x0 is odd gives the frame's strings: the
    checkerboard parity of stringify is the frame's."""
    edge = _t(FIX["offset/in/edge"])
    h, w = edge.shape
    for v in ("rect", "poly_branch"):
        whole = hopper_morph.strings_chain(edge, v)
        for a in (1, 13, 27):
            got = hopper_morph.strings_chain(edge[:, a:a + 31].contiguous(), v,
                                             x0=a, w_total=w)
            np.testing.assert_array_equal(got[:, 6:-6].numpy(),
                                          whole[:, a + 6:a + 25].numpy())


# ---- the TileGroup and the halo exchange --------------------------------

def test_tile_group_collectives():
    g = TileGroup(["cpu"] * 3)
    assert g.n_tiles == 3 and g.geom(5) == (3, 15) and g.x0(2, 5) == 10
    xs = g.split(torch.arange(30).reshape(2, 15))
    assert [x.shape for x in xs] == [(2, 5)] * 3 and xs[1].is_contiguous()
    got = g.fetch_from(xs, 1)
    assert got[0] is None and torch.equal(got[2], xs[1])
    got = g.fetch_from(xs, -2)
    assert torch.equal(got[0], xs[2]) and got[1] is None and got[2] is None
    assert all(torch.equal(s, xs[0] + xs[1] + xs[2]) for s in g.psum(xs))
    top = torch.maximum(torch.maximum(xs[0], xs[1]), xs[2])
    low = torch.minimum(torch.minimum(xs[0], xs[1]), xs[2])
    assert all(torch.equal(s, top) for s in g.pmax(xs))
    assert all(torch.equal(s, low) for s in g.pmin(xs))
    assert all(torch.equal(a, torch.arange(30).reshape(2, 15))
               for a in g.all_gather(xs, 1))
    with pytest.raises(ValueError, match="not divisible"):
        g.split(torch.zeros(2, 16))


@pytest.mark.parametrize("op", ["pmax", "pmin", "slot_range"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_tile_group_collectives_by_tile_count(n, op):
    """pmax/pmin of int64 keys on every tile, and the slot ranges: chunks
    of ceil(m / n) covering [0, m) in tile order, the last ones short or
    empty, as the JAX package's padded slices trimmed of the pad."""
    g = _cpu(n)
    if op == "slot_range":
        for m in (0, 1, 5, 7, 12, 4097):
            chunk = -(-m // n)
            got = [g.slot_range(i, m) for i in range(n)]
            assert [lo for lo, _ in got] == [min(i * chunk, m)
                                             for i in range(n)]
            assert got[0][0] == 0 and got[-1][1] == m
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
            padded = np.arange(n * chunk).reshape(n, chunk)
            for (lo, hi), row in zip(got, padded):
                assert list(range(lo, hi)) == [v for v in row if v < m]
        return
    r = np.random.default_rng(n)
    xs = [torch.from_numpy(r.integers(-2**40, 2**40, 9)) for _ in range(n)]
    want = functools.reduce(torch.maximum if op == "pmax" else torch.minimum,
                            xs)
    got = getattr(g, op)(xs)
    assert len(got) == n and all(torch.equal(t, want) for t in got)


@pytest.mark.parametrize("halo", [1, 4, 7, 12])
def test_halo_exchange_w_matches_the_padded_frame(halo):
    """Each widened tile is the frame padded with reflect-101 (or a
    constant) and cut at the tile's columns; const halos wider than a tile
    take several hops."""
    frame = torch.arange(3 * 40, dtype=torch.int32).reshape(3, 40)
    g = _cpu(5)
    tiles = g.split(frame)
    for fill, pad in (("reflect", torch.nn.functional.pad(
            frame[None].float(), (halo, halo), mode="reflect")[0].int()),
            ("const", torch.nn.functional.pad(frame, (halo, halo),
                                              value=-3))):
        if fill == "reflect" and halo >= 8:
            with pytest.raises(NotImplementedError):
                dtile.halo_exchange_w(g, tiles, halo, fill)
            continue
        got = dtile.halo_exchange_w(g, tiles, halo, fill, fill_value=-3)
        for i, t in enumerate(got):
            assert torch.equal(t, pad[:, 8 * i:8 * i + 8 + 2 * halo]), \
                (fill, i)


# ---- the tiled stages ---------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_tiled_front_end_equals_the_single_frame(case):
    """edge_frontend_tiled equals the port's single-frame front end bit for
    bit, and the JAX package's single chip within the front end's
    tolerance; the JAX package's tiled front end differs from its single
    chip in float ulps (counted in meta)."""
    g, tiles = _frame_tiles(case)
    halo = META["cases"][case]["front_halo"]
    et, eb = dtile.edge_frontend_tiled(g, tiles, halo, CFG)
    fe = _single(case, "fe")
    assert torch.equal(_cat(et), fe.edge_thin)
    assert torch.equal(_cat(eb), fe.edge_bin)
    np.testing.assert_allclose(_cat(et).numpy(), FIX[f"{case}/edge_thin"],
                               rtol=0, atol=EDGE_THIN_ATOL)
    np.testing.assert_array_equal(_cat(eb).numpy(), FIX[f"{case}/edge_bin"])
    np.testing.assert_array_equal(fe.packed0.numpy(), FIX[f"{case}/packed0"])
    jax_tiled = FIX[f"{case}/tiled_edge_thin"]
    assert int((jax_tiled != FIX[f"{case}/edge_thin"]).sum()) == \
        META["cases"][case]["tiled_front_end_differs_from_single_chip"][
            "edge_thin"]
    assert int(fe.edge_bin.sum()) > 100


@pytest.mark.parametrize("case", CASES)
def test_tiled_tail_stages_match_jax_and_the_single_frame(case):
    """Every tiled tail stage, from the single-chip front-end products:
    equal to the JAX tiled fixture (its CCL labels where converged) and to
    the port's single-frame stage."""
    n = META["cases"][case]["tiles"]
    g = _cpu(n)
    pk, et, eb = (g.split(_t(FIX[f"{case}/{k}"]))
                  for k in ("packed0", "edge_thin", "edge_bin"))
    maps = dtile.rect_tail_maps_tiled(g, pk, et, eb, CFG)
    maps["glabel"] = dtile.ccl_tiled(g, maps["strings"], 0)
    single = _single(case, "maps")
    for k in TAIL_KEYS:
        got = _cat(maps[k])
        assert torch.equal(got, single[k]), k
        if k in CCL_KEYS and not META["converged"][f"{case}/{k}"]:
            continue
        np.testing.assert_array_equal(got.numpy(), FIX[f"{case}/tail/{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_rect_tail_tiled_matches_jax_and_rect_tail(case):
    n = META["cases"][case]["tiles"]
    g = _cpu(n)
    pk, et, eb = (g.split(_t(FIX[f"{case}/{k}"]))
                  for k in ("packed0", "edge_thin", "edge_bin"))
    res = dtile.rect_tail_tiled(g, pk, et, eb, TAN_AOV, CFG)
    _same(res, _single(case, "rect_tail"))
    _close_to_jax(res, f"{case}/rect_tail")


@pytest.mark.parametrize("case", CASES)
def test_rect_step_tiled_matches_jax_and_rect_frame(case):
    g, tiles = _frame_tiles(case)
    res = dtile.rect_step_tiled(g, tiles, TAN_AOV,
                                META["cases"][case]["front_halo"], CFG)
    _same(res, _single(case, "rect_frame"))
    _close_to_jax(res, f"{case}/rect_step")


def test_rect_step_tiled_gather_matches_jax_and_rect_frame():
    """The oracle: the front end on the tiles, the whole tail once."""
    g, tiles = _frame_tiles("t4")
    res = dtile.rect_step_tiled_gather(g, tiles, TAN_AOV, cfg=CFG)
    _same(res, _single("t4", "rect_frame"))
    _close_to_jax(res, "t4/rect_gather")


def test_poly_step_tiled_matches_jax_and_poly_frame():
    g, tiles = _frame_tiles("t4")
    arena, lsid = dtile.poly_step_tiled(g, tiles, CFG)
    want_a, want_l = poly_frame(_t(FIX["t4/bgr"]), CFG, 1.0, 20, 2000)
    assert torch.equal(lsid, want_l)
    for f in arena._fields:
        assert torch.equal(getattr(arena, f), getattr(want_a, f)), f
    np.testing.assert_array_equal(lsid.numpy(), FIX["t4/poly/lsid"])
    live = FIX["t4/poly/polyid"] != 0
    assert live.sum() > 5
    for f in arena._fields:
        a = getattr(arena, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a[live], FIX[f"t4/poly/{f}"][live],
                                       rtol=0, atol=ARENA_ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(a, FIX[f"t4/poly/{f}"], err_msg=f)


@pytest.mark.parametrize("n", [2, 4])
def test_snake_crossing_every_seam(n):
    """One boustrophedon component crossing every seam about H/2 times,
    through ccl_tiled (8-connected) and label_merge_tiled (one colour on
    the snake): exact, equal to the single-frame labels and (4 tiles) to
    the JAX package's."""
    pix = _t(FIX["snake/pix"])
    g = _cpu(n)
    lbl = _cat(dtile.ccl_tiled(g, g.split(pix), 0))
    assert torch.equal(lbl, hopper_ccl.label_components(pix, 0))
    assert len(torch.unique(lbl[lbl >= 0])) == 1
    packed = torch.where(pix > 0, 9, 7).to(torch.int32)
    z = torch.zeros_like(pix)
    seg = _cat(dtile.label_merge_tiled(g, g.split(packed), g.split(z),
                                       g.split(z)))
    assert torch.equal(seg, hopper_links.label_merge(packed, z, z))
    if n == META["snake"]["tiles"]:
        if META["converged"]["snake/ccl"]:
            np.testing.assert_array_equal(lbl.numpy(), FIX["snake/ccl"])
        np.testing.assert_array_equal(seg.numpy(), FIX["snake/label_merge"])


# ---- the video detector and the CLI -------------------------------------

def test_tiled_video_detector_polls_equal_direct_calls():
    from bench import synth_frame
    from rectdetect_tpu_torch.pipeline.video import TiledVideoRectDetector
    frames = [synth_frame(48, 128, seed=s) for s in (7, 8)]
    g = _cpu(2)
    det = TiledVideoRectDetector(TAN_AOV, g, CFG)
    assert det.poll() is None
    for f in frames:
        det.enqueue(f)
    for f in frames:
        rects = det.poll()
        direct = live_rects(dtile.rect_step_tiled(
            g, g.split(torch.from_numpy(f)), TAN_AOV, cfg=CFG))
        assert len(rects) == len(direct) > 0
        for a, b in zip(rects, direct):
            np.testing.assert_array_equal(a["c2"], b["c2"])
            assert a["value"] == b["value"] and a["status"] == b["status"]
    assert det.poll() is None
    with pytest.raises(ValueError, match="not divisible"):
        det.enqueue(np.zeros((48, 129, 3), np.uint8))


def test_vidrect_tiles_devices_and_refusals(monkeypatch):
    """--tiles=N takes CUDA devices d..d+N-1 and exits with the JAX CLI's
    message when there are fewer; on the host, N tiles of `cpu`; it is
    refused beside --streams or --batch."""
    from rectdetect_tpu_torch.apps import vidrect
    g = vidrect.tile_group(torch.device("cpu"), 4)
    assert [str(d) for d in g.devices] == ["cpu"] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    g = vidrect.tile_group(torch.device("cuda", 0), 2)
    assert [str(d) for d in g.devices] == ["cuda:0", "cuda:1"]
    with pytest.raises(SystemExit,
                       match=r"--tiles=2 from device 1 needs 3 devices, "
                             r"have 2"):
        vidrect.tile_group(torch.device("cuda", 1), 2)
    for other in ("--streams=2", "--batch=4"):
        with pytest.raises(SystemExit, match="cannot be combined"):
            vidrect.main(["vidrect", "cpu", "in.avi", "out.avi", "--tiles=2",
                          other])

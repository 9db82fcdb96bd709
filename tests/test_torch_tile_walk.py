"""PyTorch port, the width-tiled path's polyline stage by slot range on the
CPU: the arc walk's doubling rounds (ops/chain.py:arc_chain_sparse with a
TileGroup) and the plain subdivision (ops/mkpl.py:mkpl_subdivide with a
TileGroup, also through ops/hopper_mkpl.py, which takes it for CPU
tensors) over TileGroup(["cpu"] * n), n = 2, 3, 4.

The JAX references come from the `tile_walk` fixture
(tests/data/tile_walk.npz, tools/make_torch_fixture.py tile_walk: the JAX
package's arc_chain_sparse and XLA mkpl_subdivide with axis_name="tile"
under shard_map on 2, 3 and 4 host devices), on three strings maps: the
tiled fixture's t4 frame, a boustrophedon whose one chain is longer than
any tile's range of walk states, and closed rings with open strokes; the
subdivision also on an arena that overflows.  Nothing here imports JAX.
The slot-range form of kernel #14 runs on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8).

Tolerances: the walk's six outputs equal, element for element, to the
fixture and to the unsharded walk.  Subdivision: integer fields, count and
lsid equal to the fixture, endpoints within ARENA_ATOL (the jitted XLA
hypot and its contractions differ from the port's by ulps in a chord
distance's float, never in its fixed-point integer here); against the
unsharded plain form everything is bit-equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.dist.mesh import TileGroup
from rectdetect_tpu_torch.ops import hopper_mkpl, mkpl
from rectdetect_tpu_torch.ops.chain import arc_chain_sparse
from rectdetect_tpu_torch.ops.compact import compact_mask
from rectdetect_tpu_torch.ops.mkpl import SegmentArena

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = np.load(os.path.join(ROOT, "tests", "data", "tile_walk.npz"))
META = json.loads(str(FIX["meta"]))
CFG = PipelineConfig()
ARENA_ATOL = 1e-4
TILES = tuple(META["tiles"])
CASES = tuple(META["cases"])
WALK_FIELDS = ("number_s", "head_s", "live", "cyc", "chainlen_s",
               "arcmin_s")
SUBDIVISIONS = tuple((c, k) for c in CASES for k in META["cases"][c]["caps"])
FLOATS = ("sx", "sy", "ex", "ey")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _walk_inputs(case):
    strings = _t(FIX[f"{case}/strings"])
    comp = compact_mask((strings != 0).reshape(-1),
                        META["cases"][case]["strings_cap"])
    return strings, comp


def _walk(case, group=None):
    strings, comp = _walk_inputs(case)
    return arc_chain_sparse(strings, comp, CFG.number_doublings,
                            META["cases"][case]["cyc_cap"], group)


def _mkpl_inputs(case, key):
    """(arena, dense, number, comp) of a fixture subdivision; the arena cut
    to the key's capacity."""
    pre = f"{case}/mkpl_in"
    dense = _t(FIX[f"{pre}/dense"])
    number = _t(FIX[f"{pre}/number"])
    idx = FIX[f"{pre}/idx"]
    n = dense.numel()
    mask = np.zeros(n, bool)
    mask[idx[idx < n]] = True
    comp = compact_mask(torch.from_numpy(mask), idx.shape[0])
    np.testing.assert_array_equal(comp.idx.numpy(), idx)
    cap = META["cases"][case]["caps"][key]
    arena = SegmentArena(**{
        f: (_t(FIX[f"{pre}/{f}"]) if f == "count"
            else _t(FIX[f"{pre}/{f}"][:cap]))
        for f in SegmentArena._fields})
    return arena, dense, number, comp


def _subdivide(case, key, group=None, fn=mkpl.mkpl_subdivide):
    arena, dense, number, comp = _mkpl_inputs(case, key)
    return fn(arena, dense, number, META["minerror"], CFG.mkpl_iters, comp,
              group)


def test_fixture_cases_exercise_the_ranges():
    """The snake's one chain is longer than every tile's range of walk
    states, the rings and t4 hold cycles, t4's small arena overflows."""
    snake = META["cases"]["snake"]
    assert 2 * snake["longest_chain"] > max(
        snake["walk_states_per_tile"].values())
    assert META["cases"]["rings"]["cycle_slots"] > 0
    assert META["cases"]["t4"]["cycle_slots"] > 0
    assert META["cases"]["t4"]["mkpl_ovf_overflows"]


@pytest.mark.parametrize("nt", TILES)
@pytest.mark.parametrize("case", CASES)
def test_sharded_walk_equals_the_fixture_and_the_whole_walk(case, nt):
    got = _walk(case, TileGroup(["cpu"] * nt))
    whole = _walk(case)
    for f, g, w in zip(WALK_FIELDS, got, whole):
        np.testing.assert_array_equal(
            g.numpy(), FIX[f"{case}/walk/{nt}/{f}"], err_msg=f)
        assert torch.equal(g, w), f


@pytest.mark.parametrize("nt", TILES)
@pytest.mark.parametrize("case,key", SUBDIVISIONS)
def test_sharded_subdivision_equals_the_fixture_and_the_whole_form(
        case, key, nt):
    g = TileGroup(["cpu"] * nt)
    arena, lsid = _subdivide(case, key, g)
    pre = f"{case}/{key}/{nt}"
    for f in SegmentArena._fields:
        if f in FLOATS:
            np.testing.assert_allclose(getattr(arena, f).numpy(),
                                       FIX[f"{pre}/{f}"], rtol=0,
                                       atol=ARENA_ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(getattr(arena, f).numpy(),
                                          FIX[f"{pre}/{f}"], err_msg=f)
    np.testing.assert_array_equal(lsid.numpy(), FIX[f"{pre}/lsid"])
    whole = _subdivide(case, key)
    # the kernel's wrapper takes the plain form for CPU tensors
    wrapped = _subdivide(case, key, g, hopper_mkpl.mkpl_subdivide)
    for other in (whole, wrapped):
        assert torch.equal(other[1], lsid)
        for f in SegmentArena._fields:
            assert torch.equal(getattr(other[0], f), getattr(arena, f)), f


def test_sharded_stages_leave_their_inputs_unchanged():
    """Tiles on one device share what a broadcast or a collective hands
    them; nothing may write into it."""
    g = TileGroup(["cpu"] * 3)
    strings, comp = _walk_inputs("rings")
    before = [t.clone() for t in (strings, *comp)]
    arc_chain_sparse(strings, comp, CFG.number_doublings,
                     META["cases"]["rings"]["cyc_cap"], g)
    for a, b in zip(before, (strings, *comp)):
        assert torch.equal(a, b)
    ins = _mkpl_inputs("t4", "mkpl_ovf")
    arena, dense, number, comp = ins
    before = [t.clone() for t in (*arena, dense, number, *comp)]
    mkpl.mkpl_subdivide(arena, dense, number, META["minerror"],
                        CFG.mkpl_iters, comp, g)
    for a, b in zip(before, (*arena, dense, number, *comp)):
        assert torch.equal(a, b)

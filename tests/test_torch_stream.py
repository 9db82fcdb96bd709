"""PyTorch port, the stream axis on the CPU: the batched front end,
rect_frames and poly_frames (pipeline/), the StreamMesh (dist/mesh.py),
rect_frames_sharded, poly_frames_sharded and the StreamSupervisor
(dist/stream.py), the multi-process slots and the two-rank gloo
simulation (dist/multihost.py, dist/multihost_sim.py), the dry run
(dist/dryrun.py) and the kernel library's counters under threads.

The JAX references come from the `streams` fixture
(tests/data/streams.npz, tools/make_torch_fixture.py streams: the JAX
package's rect_frames, rect_frames_sharded and poly_frames_sharded on 8
forced host devices).  Nothing here imports JAX.  The batch forms of K1
and K2 run on the card (tests/test_torch_cuda.py, chip_smoke.py phase 9).

Tolerances: every batched or sharded result equals the port's per-frame
call on the same frame bit for bit.  Against the JAX fixture:
  * front end: packed0 and edge_bin equal; edge_thin within 5e-3
    (tests/test_torch_frontend.py) on every pixel but those where a
    component of the JAX package's unit vector exceeds 1 (the fixture's
    meta lists them): XLA:CPU's rsqrt is not correctly rounded, and a
    sample offset of exactly -2 becomes -2.0000002, which K2's select
    chain clamps to another tap (ops/thin.py); the port rounds 1/sqrt
    once;
  * RectResults: test_torch_tile.py's criteria: valid and status equal,
    c2 within 1e-3, value within 0.02, the 3D corners within 0.05;
  * arenas: integer fields and lsid equal, endpoints within 1e-4.
The fixture's meta records that the JAX package's batched and sharded
results equal its own per-frame ones on every frame.
"""

import json
import math
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.dist import multihost
from rectdetect_tpu_torch.dist.dryrun import dryrun_multichip
from rectdetect_tpu_torch.dist.mesh import make_mesh
from rectdetect_tpu_torch.dist.stream import (StreamSupervisor,
                                              poly_frames_sharded,
                                              rect_frames_sharded, run_on)
from rectdetect_tpu_torch.ops import _build
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.poly import poly_frame, poly_frames
from rectdetect_tpu_torch.pipeline.rect import (live_rects, rect_frame,
                                                rect_frames)

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = np.load(os.path.join(ROOT, "tests", "data", "streams.npz"))
META = json.loads(str(FIX["meta"]))
CFG = PipelineConfig(max_groups=16)
TAN_AOV = math.tan(math.radians(72.0) / 2)
EDGE_THIN_ATOL = 5e-3
CORNER_ATOL = 1e-3
VALUE_ATOL = 0.02
C3_ATOL = 0.05
ARENA_ATOL = 1e-4
FRAMES = torch.from_numpy(FIX["frames"])
B = META["batch"]

_SINGLE = {}


def _single(kind, i):
    """The port's per-frame rect_frame ("rect") or poly_frame ("poly") of
    frame i, computed once per process."""
    if (kind, i) not in _SINGLE:
        _SINGLE[kind, i] = (rect_frame(FRAMES[i], TAN_AOV, CFG)
                            if kind == "rect" else poly_frame(FRAMES[i], CFG))
    return _SINGLE[kind, i]


def _same(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _rect_slice_equal(res, i, want):
    for f in want._fields:
        assert torch.equal(getattr(res, f)[i], getattr(want, f)), f


def _rect_close_to_jax(res, prefix):
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
    assert valid.any(axis=1).all()


def _poly_close_to_jax(arena, lsid, frames):
    np.testing.assert_array_equal(lsid.numpy(), FIX["poly/lsid"][frames])
    for f in arena._fields:
        got, want = getattr(arena, f).numpy(), FIX[f"poly/{f}"][frames]
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=ARENA_ATOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert (arena.count > 0).all()


def test_fixture_batched_equals_per_frame_in_jax():
    rows = META["per_frame"]
    assert len(rows) == FRAMES.shape[0] == 8
    assert all(r["sharded_equals_single"] and r["poly_sharded_equals_single"]
               for r in rows)
    assert all(r["batch_equals_single"] for r in rows[:B])


def test_batched_frontend_matches_frames_and_jax():
    fe = edge_frontend(FRAMES[:B], CFG)
    assert fe.edge_thin.shape == (B, 48, 64) and fe.labb.shape == (B, 48, 64, 3)
    for i in range(B):
        _same(type(fe)(*(f[i] for f in fe)), edge_frontend(FRAMES[i], CFG))
    np.testing.assert_array_equal(fe.packed0.numpy(), FIX["fe/packed0"])
    np.testing.assert_array_equal(fe.edge_bin.numpy(), FIX["fe/edge_bin"])
    keep = np.ones(fe.edge_thin.shape, bool)
    for f, y, x in META["jax_vec_above_one"]:
        keep[f, y, x] = False
    assert (~keep).sum() <= keep.size // 100
    np.testing.assert_allclose(fe.edge_thin.numpy()[keep],
                               FIX["fe/edge_thin"][keep], rtol=0,
                               atol=EDGE_THIN_ATOL)


def test_rect_frames_matches_rect_frame_and_jax():
    res = rect_frames(FRAMES[:B], TAN_AOV, CFG)
    assert res.c2.shape == (B, 2 * CFG.max_groups, 4, 2)
    for i in range(B):
        _rect_slice_equal(res, i, _single("rect", i))
    _rect_close_to_jax(res, "batch")


def test_poly_frames_matches_poly_frame_and_jax():
    arena, lsid = poly_frames(FRAMES[:B], CFG)
    for i in range(B):
        a1, l1 = _single("poly", i)
        assert torch.equal(lsid[i], l1)
        for f in a1._fields:
            assert torch.equal(getattr(arena, f)[i], getattr(a1, f)), f
    _poly_close_to_jax(arena, lsid, slice(0, B))


def test_rect_frames_sharded_matches_rect_frame_and_jax():
    mesh = make_mesh(*META["mesh"], devices=["cpu"] * 4)
    res = rect_frames_sharded(FRAMES, TAN_AOV, mesh, CFG)
    for i in range(FRAMES.shape[0]):
        _rect_slice_equal(res, i, _single("rect", i))
    _rect_close_to_jax(res, "sharded")


def test_poly_frames_sharded_matches_poly_frame_and_jax():
    mesh = make_mesh(*META["mesh"], devices=["cpu"] * 4)
    arena, lsid = poly_frames_sharded(FRAMES, mesh, CFG)
    for i in range(FRAMES.shape[0]):
        a1, l1 = _single("poly", i)
        assert torch.equal(lsid[i], l1)
        for f in a1._fields:
            assert torch.equal(getattr(arena, f)[i], getattr(a1, f)), f
    _poly_close_to_jax(arena, lsid, slice(None))


def test_batched_entry_points_check_their_input():
    with pytest.raises(NotImplementedError, match="rect_frames"):
        rect_frame(FRAMES[:2], TAN_AOV, CFG)
    with pytest.raises(ValueError, match="poly_frames"):
        poly_frame(FRAMES[:2], CFG)
    for fn in (lambda f: rect_frames(f, TAN_AOV, CFG),
               lambda f: poly_frames(f, CFG)):
        with pytest.raises(ValueError, match="stack"):
            fn(FRAMES[0])
    with pytest.raises(ValueError):
        edge_frontend(FRAMES[0, :, :, :2], CFG)


def test_make_mesh_and_stream_split():
    with pytest.raises(ValueError, match="need 6 devices, have 4"):
        make_mesh(3, 2, ["cpu"] * 4)
    m = make_mesh(2, 2, ["cpu:0", "cpu:1", "cpu:2", "cpu:3", "cpu:4"])
    assert (m.n_stream, m.n_tile) == (2, 2)
    assert [[str(d) for d in r.devices] for r in m.rows] == \
        [["cpu:0", "cpu:1"], ["cpu:2", "cpu:3"]]
    assert str(m.first) == "cpu:0"
    blocks = m.stream_split(FRAMES[:6])
    assert [tuple(b.shape) for b in blocks] == [(3, 48, 64, 3)] * 2
    assert torch.equal(torch.cat(blocks), FRAMES[:6])
    assert torch.equal(m.gather(blocks), FRAMES[:6])
    with pytest.raises(ValueError, match="5 frames not divisible by 2"):
        m.stream_split(FRAMES[:5])
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        make_mesh(1, 1, [])


# the supervisor on stand-in "devices" (tests/test_dist.py:115-210)

def _devices(n):
    return [torch.device("cpu", i) for i in range(n)]


def test_stream_supervisor_failover():
    """A dying device is quarantined, its in-flight frames dropped and its
    streams re-placed on the survivors."""
    devices = _devices(4)
    dead = set()

    def run_fn(bgr, device):
        if device in (devices[i] for i in dead):
            raise RuntimeError("injected device loss")
        return int(np.asarray(bgr).sum())

    sup = StreamSupervisor(devices=devices, run_fn=run_fn,
                           read_fn=lambda r: float(r))
    frames = [np.full((4, 4), i, np.uint8) for i in range(8)]
    for sid in range(8):
        assert sup.submit(sid, frames[sid])
    loads = {}
    for di in sup._assign.values():
        loads[di] = loads.get(di, 0) + 1
    assert loads == {0: 2, 1: 2, 2: 2, 3: 2}
    victims = [sid for sid, di in sup._assign.items() if di == 2]
    dead.add(2)
    sup.collect(victims[0])                          # drain frame slot
    assert sup.submit(victims[0], frames[0])         # retried elsewhere
    assert sup.failures and sup.failures[0][0] == 2
    assert devices[2] not in sup.healthy_devices
    assert sup.collect(victims[1]) is None           # in flight: dropped
    assert sup.submit(victims[1], frames[1])
    assert sup.collect(victims[1]) == float(frames[1].sum())
    for sid in range(8):
        if sid not in victims:
            assert sup.collect(sid) == float(frames[sid].sum())
    assert all(di != 2 for di in sup._assign.values())


def test_stream_supervisor_backpressure_and_exhaustion():
    def run_fn(bgr, device):
        raise RuntimeError("all devices broken")

    sup = StreamSupervisor(devices=_devices(2), run_fn=run_fn,
                           read_fn=lambda r: r)
    assert not sup.submit("s", np.zeros((2, 2), np.uint8))
    with pytest.raises(RuntimeError, match="no healthy devices"):
        sup.submit("s", np.zeros((2, 2), np.uint8))
    ok = StreamSupervisor(devices=_devices(1), run_fn=lambda b, d: b,
                          read_fn=lambda r: r, max_in_flight=1)
    assert ok.submit("s", 1)
    assert not ok.submit("s", 2)      # back-pressure: queue full
    assert ok.collect("s") == 1
    assert ok.collect("s") is None


def test_stream_supervisor_readback_failure():
    """A device lost between dispatch and readback (here: the job on its
    worker raises, as a CUDA error would) is quarantined at collect();
    the stream is served elsewhere."""
    devices = _devices(2)
    dead = set()
    lost = threading.Event()          # the device is lost while in flight

    def job(bgr, device):
        assert lost.wait(60)
        if device in (devices[i] for i in dead):
            raise RuntimeError("dead at readback")
        return bgr

    def run_fn(bgr, device):
        return run_on("cpu", job, bgr, device)

    sup = StreamSupervisor(devices=devices, run_fn=run_fn,
                           read_fn=lambda fut: fut.result())
    assert sup.submit("a", 11)
    di = sup._assign["a"]
    dead.add(di)
    lost.set()
    assert sup.collect("a") is None           # quarantined at readback
    assert sup.failures and sup.failures[0][0] == di
    assert "dead at readback" in sup.failures[0][1]
    assert sup.submit("a", 12)                # re-placed on the survivor
    assert sup._assign["a"] != di
    assert sup.collect("a") == 12


def test_stream_supervisor_default_loop_on_cpu():
    """The default run_fn and read_fn (the device's worker, rect_frame,
    live_rects) on [cpu]: every collected frame equals rect_frame's."""
    sup = StreamSupervisor(TAN_AOV, CFG, devices=["cpu"])
    assert [str(d) for d in sup.healthy_devices] == ["cpu"]
    for sid in range(2):
        assert sup.submit(sid, FIX["frames"][sid])
    for sid in range(2):
        got = sup.collect(sid)
        want = live_rects(_single("rect", sid))
        assert len(got) == len(want) > 0
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x["c2"], y["c2"])
            assert x["status"] == y["status"] and x["value"] == y["value"]
    assert not sup.failures
    if not torch.cuda.device_count():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamSupervisor(TAN_AOV, CFG)


@pytest.mark.parametrize("lists,rank,slots", [
    ([["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
      ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]], 1, (4, 8)),
    ([[f"cuda:{i}" for i in range(8)]], 0, (0, 8)),
    ([["cuda:3", "cuda:1"], ["cuda:0", "cuda:7"]], 1, (2, 4))])
def test_local_stream_slots_mapping(monkeypatch, lists, rank, slots):
    """A rank's slots are its devices' places in the ranks' device lists,
    rank by rank (tests/test_multihost.py:11-33: a host of the second
    half, a single host, device ids out of order)."""
    monkeypatch.setattr(multihost, "device_map", lambda: (lists, rank))
    assert multihost.local_stream_slots() == slots
    mesh = multihost.global_stream_mesh()
    assert mesh.n_stream == sum(len(x) for x in lists)
    with pytest.raises(ValueError, match="host owns"):
        next(multihost.run_streams([lambda: None], TAN_AOV))


def test_run_streams_outside_a_process_group(monkeypatch):
    """One rank: its devices are every slot, and run_streams yields one
    sharded batch a round until a source runs dry."""
    monkeypatch.setattr(multihost, "_local", None)
    multihost.init(devices=["cpu", "cpu"])
    assert multihost.device_map() == ([["cpu", "cpu"]], 0)
    assert multihost.local_stream_slots() == (0, 2)
    frames = iter([FIX["frames"][0], None])
    out = list(multihost.run_streams(
        [lambda: next(frames), lambda: FIX["frames"][2]], TAN_AOV, 1, CFG))
    assert len(out) == 1
    _rect_slice_equal(out[0], 0, _single("rect", 0))
    _rect_slice_equal(out[0], 1, _single("rect", 2))


def test_multihost_sim_two_ranks_over_gloo():
    """python -m rectdetect_tpu_torch.dist.multihost_sim 2 1 48x64 cpu 1:
    two ranks over loopback, each rank's slots and its tiled step equal to
    rect_frame."""
    out = subprocess.run(
        [sys.executable, "-m", "rectdetect_tpu_torch.dist.multihost_sim",
         "2", "1", "48x64", "cpu", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    sys.stdout.write(out.stdout[-2000:])
    sys.stderr.write(out.stderr[-2000:])
    assert out.returncode == 0
    assert len(re.findall(r"parity vs rect_frame: OK; valid counts of all "
                          r"slots \[\d+, \d+\] \(own OK\)", out.stdout)) == 2
    assert len(re.findall(r"RectResult equal to rect_frame: True",
                          out.stdout)) == 2
    assert "slots [0, 1)" in out.stdout and "slots [1, 2)" in out.stdout


def test_dryrun_multichip_on_four_cpu_entries(capsys):
    got = dryrun_multichip(["cpu"] * 4, h=160, w=256)
    assert (got["n_stream"], got["n_tile"]) == (2, 2)
    assert got["valid"] > 0 and got["edge_energy"] > 0
    assert "parity vs single-device: OK" in capsys.readouterr().out


def test_kernel_counters_under_threads():
    """_build.count and the frame count of the batch forms: counters add
    up exactly from several threads."""
    ns = {"launches": 0}

    def bump():
        for _ in range(2000):
            _build.count(ns, "launches")

    threads = [threading.Thread(target=bump)
               for _ in range(2 * (os.cpu_count() or 8))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ns["launches"] == 2000 * len(threads)
    assert _build.frames((), "x") == 1 and _build.frames((7,), "x") == 7
    for lead in ((0,), (2, 3), (65536,)):
        with pytest.raises(ValueError):
            _build.frames(lead, "x")

"""PyTorch port, the native host runtime (runtime/native.py and its
sources csrc/host/rectrt_core.cpp and rectrt_video.cpp) on the CPU: the
plan file through the library against the Python forms, host packed-Lab
staging against the JAX package's library and the port's core/color.py,
the clock, the C++ frame pump and writer against cv2, and the build's
failure and probe rules.  Nothing here imports JAX or the JAX package;
the JAX package's librectrt.so is only loaded by ctypes, as the
reference of the host packing.

Tolerances: the plan forms read equal dicts; the host packing is
bit-equal to native/build/librectrt.so (the same source and flags) and
to itself at any thread count; against core/color.py's packing each
field is within 1 and at most 0.1% of colours differ (float rounding at
cell edges); pump frames of a lossless (FFV1) file equal the source;
frames resized by the pump within 1 of cv2.resize (another OpenCV build);
the native writer's MPEG-1 frames read back within 3 of their level.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.runtime import native

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(ROOT, "native", "build", "librectrt.so")
# the least share of colours host and device packing must agree on
PACK_AGREE = 0.999
# every pump call waits at most this long
TIMEOUT_MS = 2000
# a pump loop reads at most this many frames
MAX_READS = 20


@pytest.fixture(scope="module")
def rt():
    return native.load()


def _probe() -> bool:
    """`pkg-config --exists opencv4`, asked here and not through the
    module."""
    if shutil.which("pkg-config") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", "opencv4"],
                          timeout=60).returncode == 0


def _need_video(rt):
    if rt.video is None:
        pytest.skip("no OpenCV C++ package (pkg-config opencv4): the "
                    "native pump is not built here")


def _frames(n=6, h=48, w=64, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _write_ffv1(path, frames):
    import cv2
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 10.0,
                         (w, h), True)
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()


def _read_all(pump, sleep_first=0.0):
    import time
    time.sleep(sleep_first)
    got = []
    for _ in range(MAX_READS):
        f = pump.next(timeout_ms=TIMEOUT_MS)
        if f is None:
            break
        got.append(f)
    pump.close()
    return got


def _cv2_only(monkeypatch, rt):
    monkeypatch.setattr(native, "load", lambda: rt._replace(video=None))


# ---- the plan file ----------------------------------------------------

PLAN_SECTIONS = {
    "NVIDIA H100 80GB HBM3|720x1280": {"sparse_factor": "7",
                                       "max_groups": "320",
                                       "ls_capacity": "9000"},
    "cpu|144x192": {"walk_prefilter_factor": "64", "blur_block": "64"},
    "TPU v5 lite|96x128": {"zeta": "1", "alpha": "2 3", "beta": "x "},
}


@pytest.mark.parametrize("writer", ["library", "plain"])
def test_plan_forms_read_each_others_files(tmp_path, rt, writer):
    """Sections with unsorted keys and device names with spaces, written
    by one form, read to equal dicts by both; a section written over
    keeps the others; a missing section or file reads as {}."""
    save = native.plan_save if writer == "library" else \
        native.plan_save_plain
    p = str(tmp_path / "plan.txt")
    for name, entries in PLAN_SECTIONS.items():
        save(p, name, entries)
    for load in (native.plan_load, native.plan_load_plain):
        for name, entries in PLAN_SECTIONS.items():
            assert load(p, name) == entries
            assert load(p, name.replace(" ", "_")) == entries
        assert load(p, "cpu|1x1") == {}
        assert load(str(tmp_path / "none.txt"), "cpu|144x192") == {}
    save(p, "cpu|144x192", {"max_groups": "256"})
    for load in (native.plan_load, native.plan_load_plain):
        assert load(p, "cpu|144x192") == {"max_groups": "256"}
        for name in ("NVIDIA H100 80GB HBM3|720x1280", "TPU v5 lite|96x128"):
            assert load(p, name) == PLAN_SECTIONS[name]


def test_plan_library_writes_sorted_and_plain_in_order(tmp_path, rt):
    """The library writes sections and keys sorted (std::map), the plain
    form in insertion order: the JAX package's two orders."""
    lib, plain = str(tmp_path / "lib.txt"), str(tmp_path / "plain.txt")
    for name, entries in PLAN_SECTIONS.items():
        native.plan_save(lib, name, entries)
        native.plan_save_plain(plain, name, entries)

    def text(sections):
        return "".join(f"[{n.replace(' ', '_')}]\n" + "".join(
            f"{k} {v}\n" for k, v in e) for n, e in sections)

    assert open(lib).read() == text(sorted(
        (n.replace(" ", "_"), sorted(e.items()))
        for n, e in PLAN_SECTIONS.items()))
    assert open(plain).read() == text(
        (n, e.items()) for n, e in PLAN_SECTIONS.items())


def test_plan_save_to_a_missing_directory_raises(tmp_path, rt):
    with pytest.raises(OSError):
        native.plan_save(str(tmp_path / "no" / "plan.txt"), "cpu", {"a": "1"})


# ---- packed-Lab staging -------------------------------------------------

def _fields(x):
    return x & 4095, (x >> 12) & 1023, (x >> 22) & 1023


@pytest.mark.skipif(not os.path.exists(JAX_LIB),
                    reason="native/build/librectrt.so not built")
def test_packedlab_equals_the_jax_library_on_every_colour(rt):
    ref = ctypes.CDLL(JAX_LIB)
    ref.rectrt_bgr_to_packedlab.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 2
    ref.rectrt_bgr_to_packedlab.restype = None
    bgr = np.ascontiguousarray(np.arange(1 << 24, dtype="<u4").view(
        np.uint8).reshape(4096, 4096, 4)[..., :3])
    got = native.bgr_to_packedlab_host(bgr)
    want = np.empty_like(got)
    ref.rectrt_bgr_to_packedlab(bgr.ctypes.data, want.ctypes.data,
                                bgr.shape[0] * bgr.shape[1], 0)
    assert np.array_equal(got, want)


def test_packedlab_against_core_color_on_a_sample(rt):
    r = np.random.default_rng(3)
    bgr = r.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    got = native.bgr_to_packedlab_host(bgr)
    want = color.pack_lab(color.bgr_to_labf(torch.from_numpy(bgr))).numpy()
    for g, w in zip(_fields(got), _fields(want)):
        assert np.abs(g - w).max() <= 1
    assert (got == want).mean() >= PACK_AGREE


def test_packedlab_thread_count_is_bit_identical(rt):
    r = np.random.default_rng(4)
    bgr = r.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    one = native.bgr_to_packedlab_host(bgr, n_threads=1)
    assert one.shape == (720, 1280) and one.dtype == np.int32
    for n in (0, 3):
        assert np.array_equal(native.bgr_to_packedlab_host(bgr, n), one)
    # a strided view packs as its copy
    assert np.array_equal(native.bgr_to_packedlab_host(bgr[::2, ::3]),
                          one[::2, ::3])
    for bad in (bgr[..., :2], bgr.astype(np.int32), bgr[0]):
        with pytest.raises(ValueError):
            native.bgr_to_packedlab_host(bad)


def test_clock(rt):
    t0 = rt.core.rectrt_time_ms()
    rt.core.rectrt_sleep_ms(20)
    assert rt.core.rectrt_time_ms() - t0 >= 20


# ---- the frame pump and writer -------------------------------------------

def test_backend_follows_the_opencv4_probe(tmp_path, rt):
    path = str(tmp_path / "v.avi")
    _write_ffv1(path, _frames(2))
    pump = native.FramePump(path)
    assert pump.backend == ("native" if _probe() else "cv2")
    assert native.available() == _probe() == rt.opencv4
    pump.close()


def test_native_pump_returns_the_ffv1_frames_in_order(tmp_path, rt,
                                                      monkeypatch):
    """Lossless mode (a file): every source frame, in order, equal to the
    source and to the cv2 pump's."""
    _need_video(rt)
    path = str(tmp_path / "v.avi")
    src = _frames()
    _write_ffv1(path, src)
    pump = native.FramePump(path)
    assert (pump.backend, pump.width, pump.height) == ("native", 64, 48)
    got = _read_all(pump)
    assert len(got) == len(src)
    assert all(np.array_equal(g, s) for g, s in zip(got, src))
    _cv2_only(monkeypatch, rt)
    pump = native.FramePump(path)
    assert pump.backend == "cv2"
    assert all(np.array_equal(g, s) for g, s in zip(_read_all(pump), got))


@pytest.mark.parametrize("backend", ["native", "cv2"])
def test_realtime_pump_returns_an_increasing_run_ending_last(
        tmp_path, rt, monkeypatch, backend):
    if backend == "native":
        _need_video(rt)
    else:
        _cv2_only(monkeypatch, rt)
    path = str(tmp_path / "v.avi")
    src = _frames(8)
    _write_ffv1(path, src)
    pump = native.FramePump(path, ring=2, realtime=True)
    assert pump.backend == backend
    got = _read_all(pump, sleep_first=0.2)
    idx = [next(i for i, s in enumerate(src) if np.array_equal(g, s))
           for g in got]
    assert idx and idx[-1] == len(src) - 1
    assert all(a < b for a, b in zip(idx, idx[1:]))


def test_native_pump_resizes_to_cam_size(tmp_path, rt):
    import cv2
    _need_video(rt)
    path = str(tmp_path / "v.avi")
    src = _frames(3)
    _write_ffv1(path, src)
    pump = native.FramePump(path, cam_w=32, cam_h=24)
    assert (pump.width, pump.height) == (32, 24)
    got = _read_all(pump)
    assert len(got) == 3
    for g, s in zip(got, src):
        want = cv2.resize(s, (32, 24))
        assert g.shape == want.shape
        assert np.abs(g.astype(int) - want).max() <= 1


@pytest.mark.parametrize("backend", ["native", "cv2"])
def test_pump_that_cannot_open_raises(tmp_path, rt, monkeypatch, backend):
    if backend == "native":
        _need_video(rt)
    else:
        _cv2_only(monkeypatch, rt)
    with pytest.raises(RuntimeError, match="cannot open"):
        native.FramePump(str(tmp_path / "none.avi"))


def test_native_writer_frames_read_back_by_cv2(tmp_path, rt):
    import cv2
    _need_video(rt)
    lib = rt.video
    path = str(tmp_path / "w.avi")
    h = lib.rectrt_writer_open(path.encode(), 64, 48, 10.0)
    assert h
    for i in range(6):
        frame = np.full((48, 64, 3), i * 40, np.uint8)
        assert lib.rectrt_writer_write(h, frame.ctypes.data) == 0
    lib.rectrt_writer_close(h)
    cap = cv2.VideoCapture(path)
    means = []
    for _ in range(MAX_READS):
        ok, f = cap.read()
        if not ok:
            break
        means.append(float(f.mean()))
    cap.release()
    assert len(means) == 6
    assert all(abs(m - 40 * i) <= 3 for i, m in enumerate(means))


def test_library_first_then_cv2_and_no_jax(tmp_path, rt):
    """In a fresh process: the host libraries load before cv2 is
    imported, the pump and the plan file work, and neither JAX nor the
    JAX package is imported."""
    path = str(tmp_path / "v.avi")
    _write_ffv1(path, _frames(3))
    code = (
        "import sys\n"
        "from rectdetect_tpu_torch.runtime import native\n"
        "rt = native.load()\n"
        "assert 'cv2' not in sys.modules\n"
        "import cv2\n"
        f"p = native.FramePump({path!r})\n"
        "n = 0\n"
        f"while n < {MAX_READS} and p.next(timeout_ms={TIMEOUT_MS}) "
        "is not None:\n"
        "    n += 1\n"
        "p.close()\n"
        f"native.plan_save({str(tmp_path / 'p.txt')!r}, 'cpu', {{'a': '1'}})\n"
        f"assert native.plan_load({str(tmp_path / 'p.txt')!r}, 'cpu') == "
        "{'a': '1'}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'rectdetect_tpu'))\n"
        "print(n, p.backend, bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == ["3", "native" if rt.opencv4 else "cv2",
                                  "[]"]


# ---- the build -------------------------------------------------------------

def test_failed_core_build_raises_with_the_compiler_output(tmp_path, rt,
                                                           monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "rectrt_core.cpp").write_text(
        "extern \"C\" int rectrt_broken( { return 0; }\n")
    monkeypatch.setattr(native, "HOST_SRC", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "opencv4", lambda: False)
    with pytest.raises(RuntimeError, match=r"(?s)rectrt_core\.cpp.*error"):
        native.build()


def test_video_library_follows_the_probe_alone(rt, monkeypatch):
    core, video, probe, _ = native.build()
    assert core.exists() and probe == _probe()
    assert (video is not None and video.exists()) == probe
    monkeypatch.setattr(native, "opencv4", lambda: False)
    core2, video2, probe2, seconds = native.build()
    assert (core2, video2, probe2, seconds) == (core, None, False, 0.0)

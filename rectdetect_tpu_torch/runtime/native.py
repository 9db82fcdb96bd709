"""Host runtime of the port: the per-device plan file, host packed-Lab
staging, the clock and the threaded frame source (port of
rectdetect_tpu/runtime/native.py).

The native half is the port's own copy of native/rectrt.cpp, split by
what it needs (csrc/host/):

- rectrt_core.cpp: the clock, the plan file and packed-Lab staging, with
  no OpenCV.  librectrt_core.so is always built; a failed build raises
  with the compiler's output.
- rectrt_video.cpp: the C++ frame pump and video writer over OpenCV's C++
  library.  librectrt_video.so is built exactly when `pkg-config --exists
  opencv4` succeeds, with that package's flags; if the probe succeeds and
  the build fails, that raises too.  Without it FramePump runs its cv2
  thread.

Both build with g++ at first use (`load`), with native/CMakeLists.txt's
flags, into build/rectdetect_tpu_torch/host/<hash>/ at the root of the
checkout.  -march=native is what makes the host packing bit-equal to the
JAX package's library (without fused multiply-adds g++ does not contract
the XYZ dot products), and it makes the binary host-specific: the hash
covers the source, the flags, `g++ -dumpfullversion` and the CPU's
`model name` and `flags` lines, and for the video library pkg-config's
version and flags.  Each library is built under a file lock and
renamed into place, so processes that start together build it once.
`python -m rectdetect_tpu_torch.runtime.native --build` builds both and
says what it built.

The plan file is the reference's autotune cache (loadPlan/savePlan,
oclhelper.c:394-527): a `[section]` line per device and resolution, then
`name value` lines.  `plan_load` and `plan_save` go through the library,
which writes sections and keys sorted (a std::map); `plan_load_plain`
and `plan_save_plain`, the Python forms the tests hold the library
against, keep insertion order.  Both orders are the JAX package's own, and
either form reads the other's file to the same dict.

Host packing is not device packing: `bgr_to_packedlab_host` differs from
core/color.py's `pack_lab(bgr_to_labf(x))` at a small share of colours,
each field by at most 1, so no frame path feeds it to the pipeline (as in
the JAX package).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

HOST_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "rectdetect_tpu_torch" / "host")
# native/CMakeLists.txt:4-9 and its pthread link
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread")
# frames the pump reads ahead
RING = 4
# the largest plan section rectrt_plan_load copies out, in bytes
PLAN_SECTION_BYTES = 1 << 20

_C, _I, _P = ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p
# entry points: name -> (argument types, result type)
CORE_SIGNATURES = {
    "rectrt_time_ms": ((), ctypes.c_uint64),
    "rectrt_sleep_ms": ((_I,), None),
    "rectrt_plan_load": ((_C, _C, _C, _I), _I),
    "rectrt_plan_save": ((_C, _C, _C), _I),
    "rectrt_bgr_to_packedlab": ((_P, _P, _I, _I), None),
}
VIDEO_SIGNATURES = {
    "rectrt_pump_open": ((_C, _I, _I, _I, _I), _P),
    "rectrt_pump_width": ((_P,), _I),
    "rectrt_pump_height": ((_P,), _I),
    "rectrt_pump_next": ((_P, _P, _I), _I),
    "rectrt_pump_close": ((_P,), None),
    "rectrt_writer_open": ((_C, _I, _I, ctypes.c_double), _P),
    "rectrt_writer_write": ((_P, _P), _I),
    "rectrt_writer_close": ((_P,), None),
}


class HostRuntime(NamedTuple):
    core: ctypes.CDLL
    # None where the opencv4 probe finds no OpenCV C++ package
    video: ctypes.CDLL | None
    # the probe's answer
    opencv4: bool
    # seconds this process spent compiling (0.0 when both were built)
    build_seconds: float


_runtime: HostRuntime | None = None
_lock = threading.Lock()


def opencv4() -> bool:
    """The probe: does `pkg-config --exists opencv4` succeed here?"""
    try:
        return subprocess.run(["pkg-config", "--exists", "opencv4"],
                              timeout=60).returncode == 0
    except FileNotFoundError:
        return False


def _output(*cmd: str) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}): "
                           f"{res.stderr.strip()}")
    return res.stdout.strip()


def _cpu() -> str:
    """The CPU's `model name` and `flags` lines (-march=native)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return ""
    keep = {}
    for line in lines:
        key = line.split(":", 1)[0].strip()
        if key in ("model name", "flags"):
            keep.setdefault(key, line)
    return "\n".join(keep.values())


def _library(name: str, extra: tuple[str, ...], stamp: str) -> Path:
    """Where the build of csrc/host/<name>.cpp with these extra flags
    goes: a directory named by the hash of all that decides the binary."""
    src = HOST_SRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *extra)).encode())
    h.update(stamp.encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str, out: Path, extra: tuple[str, ...], libs: list[str]):
    """Take out's lock; unless out exists, start g++ on it.  Returns (lock
    file, process or None, temporary output)."""
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        lock = open(out.parent / "lock", "w")
    except OSError as e:
        raise RuntimeError(f"cannot create the host build directory "
                           f"{out.parent}: {e}") from e
    fcntl.flock(lock, fcntl.LOCK_EX)
    if out.exists():
        return lock, None, None
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(
        ["g++", *CXX_FLAGS, *extra, "-o", str(tmp),
         str(HOST_SRC / f"{name}.cpp"), *libs],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return lock, proc, tmp


def build() -> tuple[Path, Path | None, bool, float]:
    """Compile what this host needs unless that exact build exists:
    librectrt_core.so always, librectrt_video.so exactly when the opencv4
    probe succeeds, both at once.  Returns (core path, video path or None,
    the probe's answer, seconds spent compiling).  A failed build raises
    with the compiler's output."""
    stamp = "\n".join((_output("g++", "-dumpfullversion"), _cpu()))
    # (source, extra compiler flags, libraries, what else the hash covers)
    jobs = [("rectrt_core", (), [], stamp)]
    probe = opencv4()
    if probe:
        cflags = tuple(_output("pkg-config", "--cflags", "opencv4").split())
        libs = _output("pkg-config", "--libs", "opencv4").split()
        version = _output("pkg-config", "--modversion", "opencv4")
        jobs.append(("rectrt_video", cflags, libs,
                     f"{stamp}\nopencv4 {version} {' '.join(libs)}"))
    t0 = time.perf_counter()
    started, paths, errors = [], [], []
    try:
        for name, extra, libs, own in jobs:
            out = _library(name, extra, own)
            paths.append(out)
            started.append((name, out, *_start(name, out, extra, libs)))
        for name, out, _, proc, tmp in started:
            if proc is None:
                continue
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}.cpp ({proc.returncode}):\n{err}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
    finally:
        for _, _, lock, proc, _ in started:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            lock.close()
    if errors:
        raise RuntimeError("g++ failed: " + "\n".join(errors))
    compiled = any(proc is not None for _, _, _, proc, _ in started)
    return (paths[0], paths[1] if probe else None, probe,
            time.perf_counter() - t0 if compiled else 0.0)


def _bind(path: Path, signatures: dict) -> ctypes.CDLL:
    # CDLL, not PyDLL: a call releases the GIL, so rectrt_pump_next's wait
    # blocks no other thread
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = res
    return lib


def load() -> HostRuntime:
    """The host libraries, built on first use and loaded once."""
    global _runtime
    with _lock:
        if _runtime is None:
            core, video, probe, seconds = build()
            _runtime = HostRuntime(
                _bind(core, CORE_SIGNATURES),
                None if video is None else _bind(video, VIDEO_SIGNATURES),
                probe, seconds)
    return _runtime


def available() -> bool:
    """Whether the native frame pump and writer run here (the opencv4
    probe); the core library always does, or load() raises."""
    return load().video is not None


# ------------------------------------------------------------- plan file --

def plan_load(path: str, device: str) -> dict[str, str]:
    """The entries of section `device` (spaces, tabs and newlines read as
    underscores), or {} when the file or the section is missing (loadPlan,
    oclhelper.c:394-443)."""
    buf = ctypes.create_string_buffer(PLAN_SECTION_BYTES)
    n = load().core.rectrt_plan_load(os.fsencode(path), device.encode(),
                                     buf, len(buf))
    if n < 0:
        raise ValueError(f"plan section {device!r} of {path} is larger "
                         f"than {PLAN_SECTION_BYTES} bytes")
    out = {}
    for line in buf.value.decode().splitlines():
        k, _, v = line.partition(" ")
        if k:
            out[k] = v
    return out


def plan_save(path: str, device: str, entries: dict[str, str]) -> None:
    """Rewrite section `device` with `entries`, keeping every other
    section (savePlan, oclhelper.c:464-527); sections and keys sorted."""
    content = "".join(f"{k} {v}\n" for k, v in entries.items())
    if load().core.rectrt_plan_save(os.fsencode(path), device.encode(),
                                    content.encode()) != 0:
        raise OSError(f"cannot write the plan file {path}")


def plan_load_plain(path: str, device: str) -> dict[str, str]:
    """plan_load in Python (spaces read as underscores)."""
    out = {}
    cur = None
    want = device.replace(" ", "_")
    try:
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("["):
                    cur = line.strip("[]")
                elif cur == want and " " in line:
                    k, _, v = line.partition(" ")
                    out[k] = v
    except OSError:
        return {}
    return out


def plan_save_plain(path: str, device: str, entries: dict[str, str]) -> None:
    """plan_save in Python: sections and keys in insertion order."""
    content = "".join(f"{k} {v}\n" for k, v in entries.items())
    want = device.replace(" ", "_")
    sections: dict[str, list[str]] = {}
    cur = None
    try:
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("["):
                    cur = line.strip("[]")
                    sections.setdefault(cur, [])
                elif cur is not None and line:
                    sections[cur].append(line)
    except OSError:
        pass
    sections[want] = content.splitlines()
    with open(path, "w") as f:
        for name, lines in sections.items():
            f.write(f"[{name}]\n")
            for ln in lines:
                f.write(ln + "\n")


# ------------------------------------------------------ packed-Lab staging --

def bgr_to_packedlab_host(bgr, n_threads: int = 0) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H, W) int32 packed Lab (L:12b | a:10b |
    b:10b) on the host, over `n_threads` threads (0: all cores).  The
    result does not depend on the thread count."""
    bgr = np.ascontiguousarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {bgr.shape} "
                         f"{bgr.dtype}")
    h, w = bgr.shape[:2]
    if h * w >= 1 << 31:
        raise ValueError(f"{h}x{w} pixels do not fit a C int")
    out = np.empty((h, w), np.int32)
    load().core.rectrt_bgr_to_packedlab(bgr.ctypes.data_as(_P),
                                        out.ctypes.data_as(_P), h * w,
                                        n_threads)
    return out


# -------------------------------------------------------------- frame pump --

class FramePump:
    """Threaded frame source: realtime newest-frame semantics (a stale
    frame is dropped) or lossless in-order delivery (the reader waits for
    room); by default realtime for cameras, lossless for files.  A camera
    or file of another size than cam_w x cam_h (both nonzero) is resized
    to it.  `backend` is "native" (the C++ pump of librectrt_video.so,
    whose capture thread holds no GIL) where that library is built, else
    "cv2" (a Python thread).  A source that cannot be opened raises."""

    def __init__(self, spec: str | None, cam_w: int = 0, cam_h: int = 0,
                 ring: int = RING, realtime: bool | None = None):
        if realtime is None:
            realtime = spec is None or spec.startswith("cam:")
        self._realtime = realtime
        self._lib = load().video
        if self._lib is not None:
            self.backend = "native"
            self._h = self._lib.rectrt_pump_open(
                (spec or "").encode(), cam_w, cam_h, ring,
                1 if realtime else 0)
            if not self._h:
                raise RuntimeError(f"cannot open {spec!r}")
            self.width = self._lib.rectrt_pump_width(self._h)
            self.height = self._lib.rectrt_pump_height(self._h)
            return
        import cv2

        from rectdetect_tpu_torch.apps.common import video_capture
        self.backend = "cv2"
        self._cap = video_capture(spec)
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open {spec!r}")
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        if cam_w and cam_h:
            self.width, self.height = cam_w, cam_h
        self._q = queue.Queue(maxsize=ring if ring > 0 else RING)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import cv2
        while not self._stop.is_set():
            ok, frame = self._cap.read()
            if not ok:
                self._put(None)
                return
            if frame.shape[:2] != (self.height, self.width):
                frame = cv2.resize(frame, (self.width, self.height))
            if self._realtime:
                while True:              # drop the oldest when full
                    try:
                        self._q.put_nowait(frame)
                        break
                    except queue.Full:
                        try:
                            self._q.get_nowait()
                        except queue.Empty:
                            pass
            else:
                self._put(frame)

    def _put(self, item):
        """Block for room, but give up once close() was called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def next(self, timeout_ms: int = 1000):
        """The next frame, (H,W,3) uint8 BGR, or None at the end of the
        stream or after `timeout_ms` without one.  A realtime pump returns
        the newest frame and drops the older ones."""
        if self._lib is not None:
            out = np.empty((self.height, self.width, 3), np.uint8)
            # -1: timeout, -2: end of stream
            if self._lib.rectrt_pump_next(self._h, out.ctypes.data_as(_P),
                                          timeout_ms) < 0:
                return None
            return out
        try:
            frame = self._q.get(timeout=timeout_ms / 1000.0)
        except queue.Empty:
            return None
        if frame is None:
            return None
        if self._realtime:
            while True:                  # drain to the newest
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    break
                frame = nxt
        return frame

    def close(self):
        if self._lib is not None:
            if self._h:
                self._lib.rectrt_pump_close(self._h)
                self._h = None
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._cap.release()


if __name__ == "__main__":
    if sys.argv[1:] != ["--build"]:
        sys.exit("usage: python -m rectdetect_tpu_torch.runtime.native "
                 "--build")
    core, video, probe, seconds = build()
    print(f"built {core}")
    print(f"built {video}" if video else
          "librectrt_video.so not built: no OpenCV C++ package "
          "(pkg-config --exists opencv4 fails)")
    print(f"opencv4 probe: {probe}; FramePump backend "
          f"{'native' if video else 'cv2'}; compiled for {seconds:.2f} s "
          "(0 where both were built)")

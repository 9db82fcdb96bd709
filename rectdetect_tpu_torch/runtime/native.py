"""Host runtime of the port: the per-device plan file and the threaded
frame source (port of rectdetect_tpu/runtime/native.py's pure-Python
forms).

The plan file is the reference's autotune cache (loadPlan/savePlan,
oclhelper.c:394-527): a `[section]` line per device and resolution, then
`name value` lines.  `plan_load` and `plan_save` read and write the same
bytes as the JAX package's Python path, so a section either package
writes can be read by the other.  The native library's C++ frame pump
(native/rectrt.cpp) is not bound here: `FramePump` is the Python thread
over cv2.
"""

from __future__ import annotations

import queue
import threading

# frames the pump's thread reads ahead
RING = 4


def plan_load(path: str, device: str) -> dict[str, str]:
    """The entries of section `device` (spaces read as underscores), or {}
    when the file or the section is missing (loadPlan,
    oclhelper.c:394-443)."""
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


def plan_save(path: str, device: str, entries: dict[str, str]) -> None:
    """Rewrite section `device` with `entries`, keeping every other
    section (savePlan, oclhelper.c:464-527)."""
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


class FramePump:
    """Threaded frame source over cv2: realtime newest-frame semantics for
    cameras (a stale frame is dropped), lossless in-order delivery for
    files (the reader waits for room)."""

    def __init__(self, spec: str | None):
        import cv2

        from rectdetect_tpu_torch.apps.common import open_capture
        self._realtime = spec is None or spec.startswith("cam:")
        self._cap = open_capture(spec)
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._q = queue.Queue(maxsize=RING)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            ok, frame = self._cap.read()
            if not ok:
                self._put(None)
                return
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
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._cap.release()

"""Stage observability: render any intermediate map to a PNG (port of
rectdetect_tpu/utils/debug.py).

The reference's debugging story is ~10 commented-out visualization dumps
at pipeline points (oclrect.c:255-363: convert_bgr_labeli / _plab /
_lumaf).  The same three renderers, and a stage list: with a dump
directory, every stage added is written as <dir>/<NN>_<name>.png.

  * label images -> pseudocolour hash 1103515245*c+12345
    (oclimgutil.cl:306)
  * packed Lab   -> BGR through the inverse conversion (lab2srgb)
  * float maps   -> normalized grey (convert_bgr_lumaf)

Images are written through Pillow, as the port's apps write theirs.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def render_labels(label) -> np.ndarray:
    """Pseudocolour a label image (convert_bgr_labeli,
    oclimgutil.cl:298-321); labels <= 0 black."""
    lab = _host(label).astype(np.int64)
    h = (lab * 1103515245 + 12345) & 0xFFFFFF
    out = np.stack([h & 255, (h >> 8) & 255, (h >> 16) & 255],
                   axis=-1).astype(np.uint8)
    out[lab <= 0] = 0
    return out


def render_packed_lab(packed) -> np.ndarray:
    """Packed Lab -> BGR at the lattice centres."""
    from rectdetect_tpu_torch.core import color
    t = torch.as_tensor(_host(packed))
    return color.labf_to_bgr(color.unpack_labf(t)).numpy()


def render_gray(img, scale: float | None = None) -> np.ndarray:
    """A float map as grey, scaled so that its maximum is white unless
    `scale` is given."""
    x = _host(img).astype(np.float64)
    if scale is None:
        m = x.max()
        scale = 255.0 / m if m > 0 else 1.0
    g = np.clip(x * scale, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


class StageDumper:
    """Collects (name, kind, array) stage outputs and writes PNGs.

    kind in {"labels", "packed", "gray", "binary", "bgr"}.  Enabled by a
    directory, given or from the RECTDETECT_DUMP environment variable;
    without one add() does nothing, so callers can call it always."""

    def __init__(self, dump_dir: str | None = None):
        self.dir = dump_dir or os.environ.get("RECTDETECT_DUMP") or None
        self._stages: list[tuple[str, str, object]] = []

    @property
    def enabled(self) -> bool:
        return self.dir is not None

    def add(self, name: str, kind: str, array) -> None:
        if self.enabled:
            self._stages.append((name, kind, array))

    def flush(self, prefix: str = "") -> list[str]:
        """Write the stages added since the last flush; returns the paths."""
        if not self.enabled:
            return []
        from PIL import Image
        pathlib.Path(self.dir).mkdir(parents=True, exist_ok=True)
        written = []
        for i, (name, kind, arr) in enumerate(self._stages):
            if kind == "labels":
                img = render_labels(arr)
            elif kind == "packed":
                img = render_packed_lab(arr)
            elif kind == "binary":
                img = render_gray(_host(arr) != 0, 255.0)
            elif kind == "bgr":
                img = _host(arr).astype(np.uint8)
            else:
                img = render_gray(arr)
            path = os.path.join(self.dir, f"{prefix}{i:02d}_{name}.png")
            Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(path)
            written.append(path)
        self._stages.clear()
        return written

"""Shared CLI plumbing of the port's apps: device choice, image IO
(through Pillow), video IO (through cv2, imported only by the video
apps), drawing.

CLI conventions mirror the reference tools (rect.cpp:48-58,
vidrect.cpp:51-123): positional arguments, `cam:<id>,<w>,<h>` camera
inputs, `-` for window output, the device list on missing arguments."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

# tan of half the rect tools' 72-degree horizontal angle of view
# (rect.cpp:84)
TAN_AOV = math.tan(math.radians(72.0) / 2)


def pick_device(spec: str) -> torch.device:
    """`spec` is an index into the CUDA devices, or "cpu" given explicitly.
    A CUDA index without a CUDA device is an error: the apps never fall
    back to the CPU on their own."""
    if spec == "cpu":
        print("cpu")
        return torch.device("cpu")
    n = torch.cuda.device_count()
    try:
        did = int(spec)
    except ValueError:
        did = -1
    if did < 0 or did >= n:
        print_devices()
        sys.exit(f"no CUDA device {spec!r} ({n} available); pass an index "
                 "or 'cpu'")
    print(torch.cuda.get_device_name(did))
    return torch.device("cuda", did)


def print_devices() -> None:
    sys.stderr.write("\nAvailable devices :\n")
    for i in range(torch.cuda.device_count()):
        sys.stderr.write(f"  {i} : {torch.cuda.get_device_name(i)} (cuda)\n")
    sys.stderr.write("  cpu : host CPU (plain PyTorch versions)\n")


# ---- image IO ----------------------------------------------------------

def load_image_bgr(path: str) -> np.ndarray:
    """Any image Pillow reads -> (H,W,3) uint8 BGR."""
    from PIL import Image
    rgb = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return np.ascontiguousarray(rgb[..., ::-1])


def save_image_bgr(path: str, bgr: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(path)


# ---- video IO (cv2) ----------------------------------------------------

def video_capture(spec: str | None):
    """cv2.VideoCapture of a file path, of `cam:<id>,<w>,<h>`, or of camera
    0 (vidrect.cpp:64-89), opened or not."""
    import cv2
    if spec is None:
        cap = cv2.VideoCapture(0)
    elif spec.startswith("cam:"):
        parts = (spec[4:] + ",0,0").split(",")
        n, w, h = int(parts[0]), int(parts[1]), int(parts[2])
        cap = cv2.VideoCapture(n)
        if cap.isOpened() and w and h:
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, w)
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, h)
    else:
        cap = cv2.VideoCapture(spec)
    return cap


def open_capture(spec: str | None):
    """video_capture(spec), exiting with a message if it did not open."""
    cap = video_capture(spec)
    if not cap.isOpened():
        sys.exit(f"Cannot open {spec!r}")
    return cap


def open_writer(path: str, iw: int, ih: int, fps: float = 30.0):
    """cv2.VideoWriter of iw x ih BGR frames: MPEG-1 (PIM1) as the
    reference writes, else mp4v where the build lacks it."""
    import cv2
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"PIM1"), fps,
                             (iw, ih), True)
    if not writer.isOpened():
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (iw, ih), True)
    if not writer.isOpened():
        sys.exit(f"Cannot open writer {path}")
    return writer


# ---- drawing -----------------------------------------------------------

def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """1-px line from p0 to p1 (x, y), clipped to the image."""
    (x0, y0), (x1, y1) = p0, p1
    steps = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, steps)).astype(int)
    ys = np.rint(np.linspace(y0, y1, steps)).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = color


def draw_segments(img: np.ndarray, segs, alternating: bool) -> None:
    """poly.cpp:137-154: walk each polyline from its head, alternating
    segment colours (vidpoly draws plain white, vidpoly.cpp:183-189)."""
    by_id = {s["id"]: s for s in segs}
    drawn = set()
    for g in [g for g, s in by_id.items() if s["left"] <= 0]:
        cnt, j = 0, g
        while j > 0 and j not in drawn and j in by_id:
            s = by_id[j]
            drawn.add(j)
            color = ((100, 100, 255) if cnt & 1 else (255, 255, 100)) \
                if alternating else (255, 255, 255)
            draw_line(img, (s["x0"], s["y0"]), (s["x1"], s["y1"]), color)
            j = s["right"]
            cnt += 1


def draw_rect(img: np.ndarray, c2, color, thickness: int) -> None:
    """showRect (rect.cpp:33-46): the 4 sides, `thickness` px wide, and
    both diagonals, 1 px."""
    pts = [(float(x), float(y)) for x, y in c2]
    for i in range(4):
        for dy in range(thickness):
            for dx in range(thickness):
                a, b = pts[i], pts[(i + 1) % 4]
                draw_line(img, (a[0] + dx, a[1] + dy), (b[0] + dx, b[1] + dy),
                          color)
    draw_line(img, pts[0], pts[2], color)
    draw_line(img, pts[1], pts[3], color)


# status -> (BGR colour, thickness) (rect.cpp:107-121): hypotheses in
# blue, screens (status bit 0) in orange, polyline-sourced screens in red
RECT_STYLE_STILL = {0: ((255, 0, 0), 1), 2: ((255, 0, 0), 1),
                    1: ((0, 200, 255), 2), 3: ((0, 0, 255), 2)}
# the video tools draw region hypotheses in green (vidrect.cpp:174-189)
RECT_STYLE_VIDEO = {0: ((0, 255, 0), 1), 2: ((255, 0, 0), 1),
                    1: ((0, 200, 255), 2), 3: ((0, 0, 255), 2)}


def draw_rects(img: np.ndarray, rects, style) -> None:
    for r in rects:
        color, thickness = style.get(r["status"], ((255, 255, 255), 1))
        draw_rect(img, r["c2"], color, thickness)

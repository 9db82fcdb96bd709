"""Still-image edge -> polyline extraction on the port (the reference's
`poly` tool, poly.cpp:47-196); writes output.png in the working directory.

Usage: python -m rectdetect_tpu_torch.apps.poly <image> [device]

device: an index into the CUDA devices (default 0), or `cpu` for the
plain PyTorch versions on the host.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from rectdetect_tpu_torch.apps import common


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        sys.stderr.write(f"Usage : {argv[0]} <image file name> "
                         "[device number | cpu]\n")
        common.print_devices()
        return -1
    dev = common.pick_device(argv[2] if len(argv) >= 3 else "0")
    img = common.load_image_bgr(argv[1])

    from rectdetect_tpu_torch.config import DEFAULT_CONFIG
    from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame

    # poly.cpp:118-123: strength 500, minerror 1, sizeThre 20
    arena, _ = poly_frame(torch.from_numpy(img).to(dev), DEFAULT_CONFIG,
                          minerror=1.0, size_thre=20, strength=500)
    segs = live_segments(arena)

    canvas = np.zeros_like(img)                      # poly.cpp:132 memset
    common.draw_segments(canvas, segs, alternating=True)
    common.save_image_bgr("output.png", canvas)
    print(f"{len(segs)} segments -> output.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Still-image rectangle detection on the port (the reference's `rect`
tool, rect.cpp:47-138); draws the detected rectangles on the image.

Usage: python -m rectdetect_tpu_torch.apps.rect <image> [device] [output]

device: an index into the CUDA devices (default 0), or `cpu` for the
plain PyTorch versions on the host.  output: the image written (default
output.jpg in the working directory).  It runs DEFAULT_CONFIG with a
72-degree horizontal angle of view.  Not ported yet: the capacity
calibration and plan file (runtime/calibrate), the RECTDETECT_DUMP stage
images, and --extended.
"""

from __future__ import annotations

import sys

import torch

from rectdetect_tpu_torch.apps import common


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) < 2 or argv[1].startswith("--"):
        sys.stderr.write(f"Usage : {argv[0]} <image file name> "
                         "[device number | cpu] [output file name]\n"
                         "(the plan calibration, RECTDETECT_DUMP and "
                         "--extended are not ported yet)\n")
        common.print_devices()
        return -1
    dev = common.pick_device(argv[2] if len(argv) >= 3 else "0")
    img = common.load_image_bgr(argv[1])

    from rectdetect_tpu_torch.config import DEFAULT_CONFIG
    from rectdetect_tpu_torch.pipeline.rect import live_rects, rect_frame

    res = rect_frame(torch.from_numpy(img).to(dev), common.TAN_AOV,
                     DEFAULT_CONFIG)
    rects = live_rects(res)
    common.draw_rects(img, rects, common.RECT_STYLE_STILL)
    out = argv[3] if len(argv) >= 4 else "output.jpg"
    common.save_image_bgr(out, img)
    print(f"{len(rects)} rectangles -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

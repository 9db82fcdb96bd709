"""Still-image rectangle detection on the port (the reference's `rect`
tool, rect.cpp:47-138); draws the detected rectangles on the image.

Usage: python -m rectdetect_tpu_torch.apps.rect <image> [device] [output] [--extended]

device: an index into the CUDA devices (default 0), or `cpu` for the
plain PyTorch versions on the host.  output: the image written (default
output.jpg in the working directory).  It runs DEFAULT_CONFIG, or with
--extended EXTENDED_CONFIG (the accuracy extensions: 2-px staircase
bridging and strength-filter rescue rounds), with the capacities of the
plan file plan_torch.txt in the working directory: with no section for
this device and resolution it prints "No plan" and calibrates on the
image, and with one that the image does not fit, it recalibrates
(runtime/calibrate.py).  RECTDETECT_DUMP=<dir> writes the stage images
there as PNGs.
"""

from __future__ import annotations

import os
import sys

import torch

from rectdetect_tpu_torch.apps import common


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    extended = "--extended" in argv
    argv = [a for a in argv if a != "--extended"]
    if len(argv) < 2 or argv[1].startswith("--"):
        sys.stderr.write(f"Usage : {argv[0]} <image file name> "
                         "[device number | cpu] [output file name] "
                         "[--extended]\n")
        common.print_devices()
        return -1
    dev = common.pick_device(argv[2] if len(argv) >= 3 else "0")
    img = common.load_image_bgr(argv[1])

    from rectdetect_tpu_torch.config import DEFAULT_CONFIG, EXTENDED_CONFIG
    from rectdetect_tpu_torch.pipeline.rect import live_rects, rect_frame
    from rectdetect_tpu_torch.runtime import calibrate as cal

    # the reference autotunes and saves its plan when it is missing
    # (rect.cpp:86-101); here: calibrate the capacities on this image
    ih, iw = img.shape[:2]
    frame = torch.from_numpy(img).to(dev)
    base = EXTENDED_CONFIG if extended else DEFAULT_CONFIG
    if not cal.plan_section(ih, iw, dev):
        print("No plan")                              # vidrect.cpp:125
        cfg = cal.calibrate([frame], base)
    else:
        cfg = cal.load_calibrated_config(ih, iw, dev, base, verbose=True)
        if not cal.plan_fits(cfg, frame):
            # a plan calibrated on a sparser scene class would truncate
            # this image's edge map: recalibrate on it instead
            print("Plan does not fit this image; recalibrating")
            cfg = cal.calibrate([frame], base)

    res = rect_frame(frame, common.TAN_AOV, cfg)
    rects = live_rects(res)

    # RECTDETECT_DUMP=<dir>: every intermediate stage as a PNG (the
    # reference's commented-out visualization hooks, oclrect.c:255-363)
    if os.environ.get("RECTDETECT_DUMP"):
        from rectdetect_tpu_torch.pipeline.rect import (STAGE_KINDS,
                                                        rect_stage_images)
        from rectdetect_tpu_torch.utils.debug import StageDumper
        dumper = StageDumper()
        for name, arr in rect_stage_images(frame, cfg).items():
            dumper.add(name, STAGE_KINDS[name], arr)
        for path in dumper.flush():
            print(f"  dump: {path}")

    common.draw_rects(img, rects, common.RECT_STYLE_STILL)
    out = argv[3] if len(argv) >= 4 else "output.jpg"
    common.save_image_bgr(out, img)
    print(f"{len(rects)} rectangles -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

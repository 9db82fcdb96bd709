"""Realtime video polyline extraction on the port (the reference's
`vidpoly`, vidpoly.cpp:45-262).

Usage: python -m rectdetect_tpu_torch.apps.vidpoly [device] [input] [output]
  device: an index into the CUDA devices, or `cpu` given explicitly
  input:  video file, or cam:<id>,<w>,<h>, default camera 0
  output: file path, or `-` for a window
"""

from __future__ import annotations

import sys

import numpy as np

from rectdetect_tpu_torch.apps import common


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        sys.stderr.write(
            f"Usage : {argv[0]} [device number | cpu] [input video file] "
            "[output video file]\n"
            "By specifying cam:<cam id>,<width>,<height> as an input, a "
            "camera can be used.\n")
        common.print_devices()
        return -1

    import cv2

    dev = common.pick_device(argv[1])

    from rectdetect_tpu_torch.runtime.native import FramePump
    pump = FramePump(argv[2] if len(argv) >= 3 else None)
    iw, ih = pump.width, pump.height
    print(f"Resolution : {iw} x {ih} (frame pump: {pump.backend})")

    writer = None
    winname = "Polyline Demo"
    if len(argv) < 4 or argv[3] == "-":
        cv2.namedWindow(winname, cv2.WINDOW_AUTOSIZE)
    else:
        writer = common.open_writer(argv[3], iw, ih)

    from rectdetect_tpu_torch.pipeline.video import FpsMeter, VideoPolyDetector

    # vidpoly.cpp:151-166: strength 2000, minerror 1, sizeThre 10
    det = VideoPolyDetector(minerror=1.0, size_thre=10, strength=2000,
                            device=dev)
    meter = FpsMeter()

    frame = pump.next(timeout_ms=5000)
    if frame is None:
        sys.exit("no frames")
    det.enqueue(frame)
    shown = 0
    while frame is not None:
        frame = pump.next(timeout_ms=5000)
        if frame is not None:
            det.enqueue(frame)
        segs = det.poll()                  # the previous frame's segments
        canvas = np.zeros((ih, iw, 3), np.uint8)
        common.draw_segments(canvas, segs, alternating=False)
        shown += 1
        if writer is not None:
            writer.write(canvas)
            fps = meter.tick()
            if fps is not None:
                print(f"{fps:.3g} fps")
        else:
            cv2.imshow(winname, canvas)
            if (cv2.waitKey(1) & 0xFF) in (27, 13):
                break

    if writer is not None:
        writer.release()
    pump.close()
    if writer is None:
        cv2.destroyAllWindows()
    print(f"{shown} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())

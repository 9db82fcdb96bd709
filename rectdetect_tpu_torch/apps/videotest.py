"""Capture and display without any detection (the reference's
`videotest`, videotest.cpp:19-82).

Usage: python -m rectdetect_tpu_torch.apps.videotest [input] [output]
  input:  video file, or cam:<id>,<w>,<h>, default camera 0
  output: file path, or `-` (default) for a window
"""

from __future__ import annotations

import sys

from rectdetect_tpu_torch.apps import common


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    import cv2

    cap = common.open_capture(argv[1] if len(argv) >= 2 else None)
    iw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    ih = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    print(f"Resolution : {iw} x {ih}")

    writer = None
    winname = "Video Test"
    if len(argv) < 3 or argv[2] == "-":
        cv2.namedWindow(winname, cv2.WINDOW_AUTOSIZE)
    else:
        writer = common.open_writer(argv[2], iw, ih)

    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n += 1
        if writer is not None:
            writer.write(frame)
        else:
            cv2.imshow(winname, frame)
            if (cv2.waitKey(1) & 0xFF) in (27, 13):
                break

    if writer is not None:
        writer.release()
    cap.release()
    if writer is None:
        cv2.destroyAllWindows()
    print(f"{n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())

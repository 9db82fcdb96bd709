"""Realtime video rectangle detection on the port (the reference's
`vidrect`, vidrect.cpp:51-227), one stream on one device.

Usage: python -m rectdetect_tpu_torch.apps.vidrect [device] [input] [output] [AOV] [--extended]
  device: an index into the CUDA devices, or `cpu` given explicitly
  input:  video file, or cam:<id>,<w>,<h>, default camera 0
  output: file path, or `-` for a window
  AOV:    horizontal angle of view in degrees (default 90; demo uses 72)
  --trace=DIR: a torch.profiler trace of the steady loop, written to
  DIR/vidrect_trace.json (chrome trace format).
  --extended: EXTENDED_CONFIG (2-px staircase bridging and strength-filter
  rescue rounds) in place of DEFAULT_CONFIG.
  --tiles=N: width tiles: each frame's width is cut over N devices, CUDA
  devices device..device+N-1 (halo-exchanged stencils, cross-tile CCLs;
  dist/tile.py), or N tiles on the host with `cpu`; for resolutions (4K)
  where one device cannot hold the frame pipeline at rate.
  --batch=N: throughput mode: groups of N frames through rect_frames (the
  front end once per group).  The last group runs at its own size: the JAX
  CLI pads it to reuse a compiled batch shape, and the port has none.
  --streams=N: N copies of the input served as N streams by a
  StreamSupervisor (dist/stream.py) over every visible CUDA device, or on
  the host with `cpu`; prints the aggregate frames/s and writes stream 0.
It applies the plan file's capacities (plan_torch.txt in the working
directory, runtime/calibrate.py) and warns when the first frame of the
single-stream loop does not fit them.  --tiles cannot be combined with
--batch or --streams, nor --trace with either.
"""

from __future__ import annotations

import math
import os
import sys

from rectdetect_tpu_torch.apps import common

FLAGS = ("--tiles=", "--batch=", "--streams=")


def _count(argv, flag: str) -> int:
    """The value of the last `flag=N` in argv, 0 without one."""
    n = 0
    for a in argv[1:]:
        if a.startswith(flag):
            n = int(a.split("=")[1])
    return n


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    tiles = _count(argv, "--tiles=")
    streams = _count(argv, "--streams=")
    batch = _count(argv, "--batch=")
    if tiles > 1 and (streams > 1 or batch > 1):
        sys.exit("--tiles cannot be combined with --streams/--batch")
    trace_dir = None
    extended = False
    kept = []
    for a in argv:
        if a.startswith("--trace="):
            trace_dir = a.split("=", 1)[1] or None
        elif a == "--extended":
            extended = True
        elif not a.startswith(FLAGS):
            kept.append(a)
    argv = kept
    if trace_dir and (streams > 1 or batch > 1):
        sys.exit("--trace only supports the single-stream loop")
    if len(argv) < 2:
        sys.stderr.write(
            f"Usage : {argv[0]} [device number | cpu] [input video file] "
            "[output video file] [AOV]\n"
            "By specifying cam:<cam id>,<width>,<height> as an input, a "
            "camera can be used.\n"
            "Output is displayed on an window by specifying - to the "
            "output.\n"
            f"Example command line : {argv[0]} 0 cam:0,1280,720 - 72\n")
        common.print_devices()
        return -1

    import cv2

    dev = common.pick_device(argv[1])
    group = tile_group(dev, tiles) if tiles > 1 else None

    from rectdetect_tpu_torch.runtime.native import FramePump
    pump = FramePump(argv[2] if len(argv) >= 3 else None)
    iw, ih = pump.width, pump.height
    print(f"Resolution : {iw} x {ih} (frame pump: {pump.backend})")

    aov = float(argv[4]) if len(argv) >= 5 else 90.0   # vidrect.cpp:112-116
    print(f"Horizontal angle of view : {aov:g} degrees")
    tan_aov = math.tan(aov / 2 / 180.0 * math.pi)

    writer = None
    winname = "Rectangle Detection Demo"
    if len(argv) < 4 or argv[3] == "-":
        cv2.namedWindow(winname, cv2.WINDOW_AUTOSIZE)
        print("\n>>>>> Press ENTER on the window to exit <<<<<")
    else:
        writer = common.open_writer(argv[3], iw, ih)

    import torch

    from rectdetect_tpu_torch.config import DEFAULT_CONFIG, EXTENDED_CONFIG
    from rectdetect_tpu_torch.pipeline.video import FpsMeter, VideoRectDetector
    from rectdetect_tpu_torch.runtime.calibrate import (load_calibrated_config,
                                                        plan_fits)

    # loadPlan (rect.cpp:86 / vidrect.cpp:125): the plan's capacities for
    # this device and resolution, if it has them
    cfg = load_calibrated_config(
        ih, iw, dev, EXTENDED_CONFIG if extended else DEFAULT_CONFIG,
        verbose=True)
    meter = FpsMeter()
    if streams > 1:
        pump.close()
        return _run_streams(argv[2] if len(argv) >= 3 else None, writer,
                            winname, dev, tan_aov, cfg, streams, meter)
    if batch > 1:
        return _run_batched(pump, writer, winname, dev, tan_aov, cfg, batch,
                            meter)
    if group is not None:
        from rectdetect_tpu_torch.pipeline.video import TiledVideoRectDetector
        det = TiledVideoRectDetector(tan_aov, group, cfg=cfg)
        print(f"width sharded over {tiles} tiles "
              f"({', '.join(str(d) for d in group.devices)})")
    else:
        det = VideoRectDetector(tan_aov, cfg=cfg, device=dev)

    frame = pump.next(timeout_ms=5000)
    if frame is None:
        sys.exit("no frames")
    if not plan_fits(cfg, torch.from_numpy(frame).to(dev)):
        print("WARNING: the capacity plan does not fit this stream's "
              "scene density; detections may be truncated. Run "
              "rectdetect_tpu_torch.apps.rect on a sample frame to "
              "recalibrate", file=sys.stderr)
    det.enqueue(frame)

    prof = None
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        print(f"tracing to {trace_dir}")
    try:
        n = _steady_loop(pump, det, writer, winname, frame, meter)
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, "vidrect_trace.json")
            prof.export_chrome_trace(path)
            print(f"trace written to {path}")
    print(f"{n} frames")
    return 0


def tile_group(dev, tiles: int):
    """The TileGroup of `--tiles`: CUDA devices dev..dev+tiles-1, which
    must exist (the JAX CLI's check and message), or `tiles` tiles on the
    host for `cpu`."""
    import torch

    from rectdetect_tpu_torch.dist.mesh import TileGroup
    if dev.type == "cpu":
        return TileGroup([dev] * tiles)
    did, have = dev.index, torch.cuda.device_count()
    if did + tiles > have:
        sys.exit(f"--tiles={tiles} from device {did} needs "
                 f"{did + tiles} devices, have {have}")
    return TileGroup([torch.device("cuda", did + i) for i in range(tiles)])


def _show(writer, winname, frame, meter) -> bool:
    """Write or show one annotated frame; False when the window asks to
    stop."""
    import cv2
    if writer is not None:
        writer.write(frame)
        fps = meter.tick()
        if fps is not None:
            print(f"{fps:.3g} fps")
        return True
    cv2.imshow(winname, frame)
    return (cv2.waitKey(1) & 0xFF) not in (27, 13)


def _close(writer) -> None:
    import cv2
    if writer is not None:
        writer.release()
    else:
        cv2.destroyAllWindows()


def _run_batched(pump, writer, winname, dev, tan_aov, cfg, batch,
                 meter) -> int:
    """Throughput mode: `batch` frames at a time through rect_frames."""
    import numpy as np
    import torch

    from rectdetect_tpu_torch.pipeline.rect import rect_frames

    shown, going = 0, True
    while going:
        group = []
        while len(group) < batch:
            f = pump.next(timeout_ms=5000)
            if f is None:
                going = False
                break
            group.append(f)
        if not group:
            break
        res = rect_frames(torch.from_numpy(np.stack(group)).to(dev),
                          tan_aov, cfg)
        c2, stat, ok = (t.cpu().numpy() for t in (res.c2, res.status,
                                                  res.valid))
        for bi, frame in enumerate(group):
            rects = [{"c2": c2[bi, i], "status": int(stat[bi, i])}
                     for i in range(c2.shape[1]) if ok[bi, i]]
            common.draw_rects(frame, rects, common.RECT_STYLE_VIDEO)
            shown += 1
            if not _show(writer, winname, frame, meter):
                going = False
                break
    pump.close()
    _close(writer)
    print(f"{shown} frames")
    return 0


def _run_streams(path, writer, winname, dev, tan_aov, cfg, n_streams,
                 meter) -> int:
    """Multi-stream serving: N copies of the input served across the
    devices by the fault-tolerant StreamSupervisor; stream 0's frames are
    annotated and written or shown, the aggregate frames/s printed."""
    import torch

    from rectdetect_tpu_torch.dist.mesh import visible_devices
    from rectdetect_tpu_torch.dist.stream import StreamSupervisor
    from rectdetect_tpu_torch.runtime.native import FramePump

    devices = [torch.device("cpu")] if dev.type == "cpu" \
        else visible_devices()
    pumps = [FramePump(path) for _ in range(n_streams)]
    sup = StreamSupervisor(tan_aov, cfg=cfg, devices=devices)
    print(f"{n_streams} streams over {len(sup.healthy_devices)} devices "
          f"(frame pumps: {pumps[0].backend})")
    done, going = 0, True
    while going:
        frames = [p.next(timeout_ms=5000) for p in pumps]
        if any(f is None for f in frames):
            break
        for sid, f in enumerate(frames):
            sup.submit(sid, f)
        for sid in range(n_streams):
            rects = sup.collect(sid)
            done += 1
            if sid == 0 and rects is not None:
                common.draw_rects(frames[0], rects, common.RECT_STYLE_VIDEO)
                if writer is not None:
                    writer.write(frames[0])
                elif not _show(None, winname, frames[0], meter):
                    going = False
            fps = meter.tick()
            if fps is not None:
                print(f"{fps:.3g} frames/s aggregate")
    for p in pumps:
        p.close()
    _close(writer)
    print(f"{done} frames served")
    return 0


def _steady_loop(pump, det, writer, winname, first, meter) -> int:
    """Enqueue frame n, then draw and show frame n-1's rectangles; at the
    end of the stream drain the last frame.  Returns the frames shown."""
    shown, prev = 0, first
    while prev is not None:
        frame = pump.next(timeout_ms=5000)
        if frame is not None:
            det.enqueue(frame)
        rects = det.poll()                 # frame n-1's results
        common.draw_rects(prev, rects, common.RECT_STYLE_VIDEO)
        shown += 1
        if not _show(writer, winname, prev, meter):
            break
        prev = frame
    pump.close()
    _close(writer)
    return shown


if __name__ == "__main__":
    sys.exit(main())

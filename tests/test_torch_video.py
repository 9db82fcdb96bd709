"""PyTorch port, the video detectors and apps on the CPU (pipeline/video.py,
apps/vidrect.py, apps/vidpoly.py, apps/videotest.py): the detectors'
results equal direct rect_frame and poly_frame calls frame for frame, the
frame rate meter, and the apps over a short video file written with cv2.
The pipelined CUDA form runs on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 6).  Nothing here imports JAX.
"""

import os

import numpy as np
import pytest
import torch

from bench import synth_frame
from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.pipeline.poly import live_segments, poly_frame
from rectdetect_tpu_torch.pipeline.rect import live_rects, rect_frame
from rectdetect_tpu_torch.pipeline.video import (FpsMeter, VideoPolyDetector,
                                                 VideoRectDetector)

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

# a narrow config keeps the plain pose of every group cheap on the host
SMALL = PipelineConfig(max_groups=16)


def _same_rects(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["status"] == y["status"] and x["value"] == y["value"]
        np.testing.assert_array_equal(x["c2"], y["c2"])
        np.testing.assert_array_equal(x["c3"], y["c3"])


def test_video_rect_detector_on_cpu_equals_rect_frame():
    frames = [synth_frame(72, 96, seed=s) for s in range(3)]
    det = VideoRectDetector(0.7, SMALL, device="cpu")
    assert det.poll() is None
    det.enqueue(frames[0])
    got = []
    for f in frames[1:]:
        det.enqueue(f)
        got.append(det.poll())           # the oldest frame in flight
    got.append(det.poll())
    assert det.poll() is None
    for f, rects in zip(frames, got):
        _same_rects(rects, live_rects(rect_frame(torch.from_numpy(f), 0.7,
                                                 SMALL)))
    assert sum(len(r) for r in got) > 0


def test_video_poly_detector_on_cpu_equals_poly_frame():
    frames = [synth_frame(72, 96, seed=s) for s in range(3)]
    det = VideoPolyDetector(device="cpu")
    for f in frames:
        det.enqueue(f)
    for f in frames:
        want = live_segments(poly_frame(torch.from_numpy(f), PipelineConfig(),
                                        1.0, 10, 2000)[0])
        assert det.poll() == want
    assert det.poll() is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "machine: a CUDA device must not fall back to the host")
@pytest.mark.parametrize("make", [
    lambda: VideoRectDetector(0.7, device="cuda"),
    lambda: VideoPolyDetector(device=torch.device("cuda", 0))],
    ids=["rect", "poly"])
def test_detectors_raise_without_a_card(make):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_fps_meter_reports_about_once_a_second():
    t = [0.0]
    meter = FpsMeter(clock=lambda: t[0])
    got = []
    for _ in range(50):
        t[0] += 0.1
        got.append(meter.tick())
    rates = [r for r in got if r is not None]
    assert len(rates) == 4 and got[10] is not None
    assert all(abs(r - 10.0) < 1.0 for r in rates)


def _write_video(path, n, h, w):
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (w, h), True)
    for s in range(n):
        wr.write(synth_frame(h, w, seed=s))
    wr.release()


def _count_frames(path):
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_vidrect_writes_every_frame(tmp_path, monkeypatch, capsys):
    from rectdetect_tpu_torch.apps import vidrect
    monkeypatch.chdir(tmp_path)
    _write_video("in.avi", 3, 144, 192)
    assert vidrect.main(["vidrect", "cpu", "in.avi", "out.avi", "72"]) == 0
    out = capsys.readouterr().out
    assert "Resolution : 192 x 144" in out and "3 frames" in out
    assert _count_frames("out.avi") == 3


def test_vidpoly_and_videotest_write_every_frame(tmp_path, monkeypatch):
    from rectdetect_tpu_torch.apps import videotest, vidpoly
    monkeypatch.chdir(tmp_path)
    _write_video("in.avi", 3, 72, 96)
    assert vidpoly.main(["vidpoly", "cpu", "in.avi", "poly.avi"]) == 0
    assert videotest.main(["videotest", "in.avi", "copy.avi"]) == 0
    assert _count_frames("poly.avi") == 3 and _count_frames("copy.avi") == 3


@pytest.mark.parametrize("flag", ["--batch=4", "--streams=2", "--tiles=2",
                                  "--extended"])
def test_vidrect_flags_not_ported(flag, tmp_path, monkeypatch, capsys):
    """Every flag is ported and runs over every frame on the host with
    `cpu`: --batch=4 groups the frames through rect_frames (the last group
    at its own size), --streams=2 serves two copies of the video through a
    StreamSupervisor on [cpu] and writes stream 0, --tiles=2 runs the
    width-tiled detector (two tiles on the host), --extended runs
    EXTENDED_CONFIG."""
    from rectdetect_tpu_torch.apps import vidrect
    from rectdetect_tpu_torch.dist import stream
    from rectdetect_tpu_torch.pipeline import rect, video
    monkeypatch.chdir(tmp_path)
    _write_video("in.avi", 2, 72, 96)
    if flag == "--batch=4":
        sizes = []
        real_frames = rect.rect_frames

        def spy_frames(frames, tan_aov, cfg):
            sizes.append(tuple(frames.shape))
            return real_frames(frames, tan_aov, cfg)

        monkeypatch.setattr(rect, "rect_frames", spy_frames)
        assert vidrect.main(["vidrect", "cpu", "in.avi", "out.avi", "72",
                             flag]) == 0
        assert "2 frames" in capsys.readouterr().out
        assert _count_frames("out.avi") == 2
        assert sizes == [(2, 72, 96, 3)]
        return
    if flag == "--streams=2":
        sups = []
        real_sup = stream.StreamSupervisor.__init__

        def spy_sup(self, tan_aov, **kw):
            sups.append(kw["devices"])
            real_sup(self, tan_aov, **kw)

        monkeypatch.setattr(stream.StreamSupervisor, "__init__", spy_sup)
        assert vidrect.main(["vidrect", "cpu", "in.avi", "out.avi", "72",
                             flag]) == 0
        out = capsys.readouterr().out
        assert "2 streams over 1 devices" in out and \
            "4 frames served" in out
        assert _count_frames("out.avi") == 2
        assert [[str(d) for d in s] for s in sups] == [["cpu"]]
        return
    if flag == "--tiles=2":
        groups = []
        real_tiled = video.TiledVideoRectDetector.__init__

        def spy_tiled(self, tan_aov, group, **kw):
            groups.append(group)
            real_tiled(self, tan_aov, group, **kw)

        monkeypatch.setattr(video.TiledVideoRectDetector, "__init__",
                            spy_tiled)
        assert vidrect.main(["vidrect", "cpu", "in.avi", "out.avi", "72",
                             flag]) == 0
        assert "2 frames" in capsys.readouterr().out
        assert _count_frames("out.avi") == 2
        assert [[str(d) for d in g.devices] for g in groups] == \
            [["cpu", "cpu"]]
        return
    seen = []
    real = video.VideoRectDetector.__init__

    def spy(self, tan_aov, cfg=None, **kw):
        seen.append(cfg)
        real(self, tan_aov, cfg=cfg, **kw)

    monkeypatch.setattr(video.VideoRectDetector, "__init__", spy)
    assert vidrect.main(["vidrect", "cpu", "in.avi", "out.avi", "72",
                         flag]) == 0
    assert "2 frames" in capsys.readouterr().out
    assert _count_frames("out.avi") == 2
    assert [(c.bridge_gap2, c.strength_rescue_rounds) for c in seen] == \
        [(True, 3)]


def test_vidrect_needs_an_explicit_cpu(tmp_path, monkeypatch):
    from rectdetect_tpu_torch.apps import vidrect
    if torch.cuda.device_count() > 3:
        pytest.skip("a machine with 4 CUDA devices has device 3")
    monkeypatch.chdir(tmp_path)
    _write_video("in.avi", 1, 24, 32)
    with pytest.raises(SystemExit, match="no CUDA device"):
        vidrect.main(["vidrect", "3", "in.avi", "out.avi"])
    assert not os.path.exists("out.avi")

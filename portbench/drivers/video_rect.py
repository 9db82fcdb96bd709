"""One camera through VideoRectDetector (rect_frame a frame), as vidrect
runs it."""

from portbench.loops import VideoLoop


def make(s):
    from rectdetect_tpu_torch.pipeline.video import VideoRectDetector
    return VideoLoop(VideoRectDetector(s.tan_aov, s.cfg, device=s.device), s)

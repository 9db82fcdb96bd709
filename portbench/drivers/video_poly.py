"""One camera through VideoPolyDetector (poly_frame a frame), as vidpoly
runs it."""

from portbench.loops import VideoLoop


def make(s):
    from rectdetect_tpu_torch.pipeline.video import VideoPolyDetector
    c = s.config
    return VideoLoop(VideoPolyDetector(s.cfg, c["minerror"], c["size_thre"],
                                       c["strength"], device=s.device), s)

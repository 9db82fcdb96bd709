"""Host ms a frame in the rect geometry: rect_geometry (the hyp
kernel's quad reduction, the pose kernel, the screen test)."""

from portbench.metrics import span_ms_per_frame

SPAN = "geometry"
WRAPS = [("rectdetect_tpu_torch.pipeline.rect", "rect_geometry")]


def read(run):
    return span_ms_per_frame(run, SPAN)

"""Host ms a frame in the polyline stage (ops/polyline.py:
polyline_execute: K3 poly_branch, the arc walk, mkpl, refine), called
from the rect and poly pipelines."""

from portbench.metrics import span_ms_per_frame

SPAN = "polyline"
WRAPS = [("rectdetect_tpu_torch.pipeline.rect", "polyline_execute"),
         ("rectdetect_tpu_torch.ops.polyline", "polyline_execute")]


def read(run):
    return span_ms_per_frame(run, SPAN)

"""Host ms a frame in the rect path's edge labelling: K3's rect strings
(rect_strings) and the labels with the strength pair (strength_labels:
K4, the segmented scan)."""

from portbench.metrics import span_ms_per_frame

SPAN = "labels"
WRAPS = [("rectdetect_tpu_torch.pipeline.rect", "rect_strings"),
         ("rectdetect_tpu_torch.pipeline.rect", "strength_labels")]


def read(run):
    return span_ms_per_frame(run, SPAN)

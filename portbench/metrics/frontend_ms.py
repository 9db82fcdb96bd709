"""Host ms a frame in the edge front end (pipeline/frontend.py:
edge_frontend: colour, blur, K1, K2), in ranges around its calls from the
rect and poly pipelines."""

from portbench.metrics import span_ms_per_frame

SPAN = "frontend"
WRAPS = [("rectdetect_tpu_torch.pipeline.rect", "edge_frontend"),
         ("rectdetect_tpu_torch.pipeline.poly", "edge_frontend")]


def read(run):
    return span_ms_per_frame(run, SPAN)

"""Host ms a frame in the rect hypotheses: boundary_labels (K4 on the
boundary marks) and hypotheses (reduceLS table with distinct_bids,
probes, chains, clipping)."""

from portbench.metrics import span_ms_per_frame

SPAN = "hypotheses"
WRAPS = [("rectdetect_tpu_torch.pipeline.rect", "boundary_labels"),
         ("rectdetect_tpu_torch.pipeline.rect", "hypotheses")]


def read(run):
    return span_ms_per_frame(run, SPAN)

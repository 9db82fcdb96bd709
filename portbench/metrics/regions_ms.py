"""Host ms a frame in the rect path's regions: region_smoothing (blblur,
quant_despeckle) and region_merge (merge_mask, links CCL, despeckle2)."""

from portbench.metrics import span_ms_per_frame

SPAN = "regions"
WRAPS = [("rectdetect_tpu_torch.pipeline.rect", "region_smoothing"),
         ("rectdetect_tpu_torch.pipeline.rect", "region_merge")]


def read(run):
    return span_ms_per_frame(run, SPAN)

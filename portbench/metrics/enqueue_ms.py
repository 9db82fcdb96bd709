"""Host ms a frame inside the video driver's enqueue: the copy into
pinned memory, the upload and the issue of the frame's path (with what of
it the host waits for)."""

from portbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "enqueue")

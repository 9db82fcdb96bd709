"""Host ms a frame inside the video driver's poll: waiting for the
oldest frame in flight and turning its result into the host list."""

from portbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "poll")

"""Frames whose result reached the host inside the window, over all
cameras, over the window's seconds."""

from portbench.metrics import in_window


def read(run):
    return len(in_window(run)) / run.seconds

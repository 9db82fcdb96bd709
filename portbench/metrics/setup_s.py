"""Seconds from the start of the process to the start of the window:
imports, the kernel library (built on a checkout's first run), the scenes
made on the card and the warm-up of every shape the
window uses."""


def read(run):
    return run.setup_s

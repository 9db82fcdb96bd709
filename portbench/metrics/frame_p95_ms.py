"""The 95th percentile over every frame whose result reached the host
inside the window of the time from the call that handed the frame to the
program to the return of the call that gave its result."""

from portbench import stats
from portbench.metrics import in_window


def read(run):
    p = stats.percentile([f.t_done - f.t_submit for f in in_window(run)], 95)
    return None if p is None else p * 1e3

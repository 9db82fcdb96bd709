"""The share of the traced stretch in which no kernel, copy or memset
ran on the device: 1 - the union of the device's busy intervals over the
stretch."""


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]

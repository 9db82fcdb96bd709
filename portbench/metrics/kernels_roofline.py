"""The port's own kernels (csrc/*.cu) in the traced stretch: the sum of
each library call's least time (portbench/roofline.py, from the
arguments it was launched with) over the sum of the device time of their
kernels in the trace, in percent."""


def read(run):
    t = run.trace
    if not t or not t["port_kernel_s"]:
        return None
    return 100.0 * t["port_bound_s"] / t["port_kernel_s"]

"""Every kernel launched on the device in the traced stretch, ATen's and
the port's, over the frames handed to the program in it."""


def read(run):
    t = run.trace
    if not t or not t["frames"]:
        return None
    return t["kernels"] / t["frames"]

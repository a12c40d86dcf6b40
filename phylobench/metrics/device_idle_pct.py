"""The share of the traced window, in %, in which no operation ran on the
device (the union of kernels, copies and sets, from the profiler)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

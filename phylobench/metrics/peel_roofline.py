"""The peel kernel's share of its roofline, in %: the least time of the
window's launches (`counts/<kernel>.py`, a launch that keeps its partials
for a gradient counted with them) over their device time, the kernel found
by name in the profiler's trace. Nothing to read where it never ran."""

from phylobench import peaks


def read(ctx):
    n, seconds = ctx.trace.kernel_time(ctx.kernel.TRACE_NAMES)
    if n == 0 or seconds <= 0:
        return None
    post = min(ctx.gradients, n)
    peak = peaks.PEAK_FLOPS[ctx.dtype]

    def bound(partials):
        return ctx.kernel.bound_s(ctx.shape, ctx.chains, partials, peak,
                                  peaks.HBM_BYTES_PER_S, ctx.itemsize)

    return 100.0 * ((n - post) * bound(False) + post * bound(True)) / seconds

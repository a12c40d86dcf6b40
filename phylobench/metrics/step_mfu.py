"""The whole step's share of the card's float64 peak, in %: the useful
operations of the window's evaluations (`counts/step.py`: each peel launch
one evaluation of the batch, each gradient three) over the traced window's
seconds times the peak."""

from phylobench import peaks
from phylobench.counts import step


def read(ctx):
    ops = step.window_ops(ctx.shape, ctx.chains, ctx.launches,
                          ctx.gradients)
    return 100.0 * ops / (ctx.trace.window_s * peaks.PEAK_FLOPS[ctx.dtype])

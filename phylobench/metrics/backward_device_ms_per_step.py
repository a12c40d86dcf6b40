"""Device milliseconds a batch step of the operations launched while the
program took a gradient (the backward passes: the level adjoint and the
rest), from the profiler's trace and the host spans of the gradients.
Nothing to read in a window with no gradient."""


def read(ctx):
    if not ctx.gradients:
        return None
    return 1e3 * ctx.trace.launched_within(ctx.gradient_spans) / ctx.steps

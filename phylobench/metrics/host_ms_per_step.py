"""Host milliseconds a batch step: the host clock around each call of the
step in the traced window, with no synchronise (the chain loop and the
proposals' host side)."""


def read(ctx):
    return 1e3 * sum(ctx.host_s) / len(ctx.host_s)

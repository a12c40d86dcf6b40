"""Peel kernel launches a batch step, from the program's own `launches`
counters of its four kernel wrappers (`ops/cuda_peeling.py`,
`cuda_stream.py`, `cuda_stream2.py`, `cuda_mxu.py`)."""


def read(ctx):
    return ctx.launches / ctx.steps

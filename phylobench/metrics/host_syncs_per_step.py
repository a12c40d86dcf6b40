"""Runtime calls a batch step makes that make the host wait for the device
(stream, device and event synchronisations, blocking copies), counted in
the profiler's trace of the window within the steps' host spans: the reads
a step forces, and none of the harness's own."""


def read(ctx):
    return ctx.trace.syncs_within(ctx.step_spans) / ctx.steps

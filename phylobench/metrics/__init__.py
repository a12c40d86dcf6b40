"""Per-layer metric readers, one module a metric (`<metric>.py`, found by
the metric's name in BENCHMARK.json). Each has `read(ctx) -> float or
None`; None, where the run holds nothing to read, leaves the metric out of
the result line. `ctx` is the traced window (`harness.TracedWindow`)."""

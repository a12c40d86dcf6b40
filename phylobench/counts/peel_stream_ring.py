"""The v1 streaming peel (`csrc/peel_stream_ring.cu`: slots below 16
states, teams on the FP64 tensor cores from 16): its kernels' names in a
trace, and its count."""

from phylobench.counts.peel import bound_s, count  # noqa: F401

TRACE_NAMES = ("ring_slots_kernel", "ring_teams_kernel")

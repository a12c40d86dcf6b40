"""The deep level peel (`csrc/peel_stream.cu`, S = 4 trees too large for
the resident kernel): its kernel's name in a trace, and its count."""

from phylobench.counts.peel import bound_s, count  # noqa: F401

TRACE_NAMES = ("peel_levels_kernel",)

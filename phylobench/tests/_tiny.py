"""Sizes a test run holds, for each cell (the widths stay: 4 or 61
states, 4 categories, 50 skygrid cells), and a helper that runs a cell on
the CPU through the harness."""

import time

TINY = {
    "makona.mh.b64": {"taxa": 12, "patterns": 64, "sites": 300, "chains": 4},
    "makona.hmc.b8": {"taxa": 12, "patterns": 64, "sites": 300, "chains": 3},
    "codon.mh.b4": {"taxa": 10, "patterns": 24, "chains": 2},
}


def run_cpu(cell, seed=2147483901, seconds=1.0, trace=0, **extra):
    from phylobench import harness

    return harness.run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                       overrides={**TINY[cell], **extra},
                       log=lambda *a: None)

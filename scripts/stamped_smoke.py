#!/usr/bin/env python3
"""Run chip_smoke.py with every line it logs stamped with the seconds since
the start, to see where a run's time goes between its `[phase]` marks.

    python3 scripts/stamped_smoke.py [chip_smoke.py's arguments]

From the root of a checkout. Each line of chip_smoke.log reads
`[t  SECONDS] ...`; the gap to the line before is the time of the work that
line reports on (a profiler window's line comes after its parse). The exit
code is chip_smoke.py's; without a card it exits 1 as chip_smoke.py does.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402


def main():
    t0 = time.perf_counter()
    log = chip_smoke.log

    def stamped(*a):
        log(f"[t {time.perf_counter() - t0:8.2f}]", *a)

    chip_smoke.log = stamped
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())

"""The readings that `correct`'s limits are set from, on the card.

    python -m phylobench.control --workload <name> --seeds 1 2 3 ...
        [--seconds 3] [--out chiprun_out/control_<name>.jsonl]

For each seed, in one process: a short window of the cell at its own size
and load, then the program's gap to the float64 reference (the lower
reading) and the control's gap, the reference itself computed in float32
(the upper reading), at the same states, with the verdict that the
configuration's limits give each side: `correct` for the program's run,
`control_correct` for the control put in its place, which has to be
false. One JSON line a seed, to standard output and to --out. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m phylobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from phylobench import harness

    if not torch.cuda.is_available():
        print("phylobench.control: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            result, _ = harness.run(args.workload, seed, args.seconds, 0,
                                    "cuda:0", t0, control=torch.float32)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "correct": result["correct"],
                               "control_correct": result["readings"].pop(
                                   "control_correct"),
                               "readings": result["readings"],
                               "unmoved": result["checks"][
                                   "chains_unmoved"]["value"],
                               "metrics": result["metrics"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

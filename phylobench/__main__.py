"""python -m phylobench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card this process sees and prints
its result as the last line of standard output (one JSON object); the
numbers `correct` compared, each beside its limit, are the last lines of
standard error. Exits non-zero, printing no result, where there is no
CUDA card, where the program under test is missing, or where JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from phylobench import harness  # noqa: E402


def _fail(msg: str, code: int) -> int:
    print(f"phylobench: {msg}", file=sys.stderr, flush=True)
    return code


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout else "not read"


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m phylobench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    build = harness.CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    if importlib.util.find_spec(harness.PROGRAM) is None:
        return _fail(f"the program under test, {harness.PROGRAM}, is not "
                     "in this checkout", 2)
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    cell, _ = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device", 2)
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{cell['chips']} cards asked, "
                     f"{torch.cuda.device_count()} seen", 2)
    torch.cuda.init()
    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                args.trace, "cuda:0", T0, bench=bench)
    loaded = harness.forbidden_modules()
    if loaded:
        return _fail(f"forbidden modules loaded: {loaded}", 3)
    print(f"card {_power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

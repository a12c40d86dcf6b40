"""LogAnalyser: trace summaries with ESS (ref: src/dr/app/tools/
LogAnalyser.java — reads Tracer-format tab logs, reports mean/stderr/ESS
per column after burn-in).

The port's own copy of beast_mcmc_tpu/apps/loganalyser.py: host-side numpy
over this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from beast_mcmc_tpu_torch.inference.trace import TraceStats, analyze


def read_log(path_or_text: str, from_text: bool = False) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read a tab-delimited trace log. Returns (states, {column: values})."""
    text = path_or_text if from_text else open(path_or_text).read()
    header: Optional[List[str]] = None
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "[")):
            continue
        parts = line.split("\t")
        if header is None:
            header = parts
            continue
        rows.append([float(x) for x in parts])
    if header is None or not rows:
        raise ValueError("empty log")
    data = np.asarray(rows)
    cols = {h: data[:, i] for i, h in enumerate(header)}
    states = cols.pop(header[0])
    return states, cols


def analyze_log(path: str, burnin_fraction: float = 0.1) -> Dict[str, TraceStats]:
    states, cols = read_log(path)
    step = int(states[1] - states[0]) if len(states) > 1 else 1
    n_burn = int(len(states) * burnin_fraction)
    return {k: analyze(v[n_burn:], step_size=step) for k, v in cols.items()}


def report(path: str, burnin_fraction: float = 0.1) -> str:
    stats = analyze_log(path, burnin_fraction)
    lines = [f"{'statistic':<28} {'mean':>12} {'stderr':>12} {'ESS':>9}"]
    for k, s in stats.items():
        lines.append(f"{k:<28} {s.mean:>12.6g} {s.std_error_of_mean:>12.4g} "
                     f"{s.ess:>9.1f}")
    return "\n".join(lines)


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    burnin = 0.1
    files = []
    i = 0
    while i < len(args):
        if args[i] in ("-burnin", "--burnin"):
            burnin = float(args[i + 1])
            i += 2
        else:
            files.append(args[i])
            i += 1
    for f in files:
        print(f"== {f}")
        print(report(f, burnin))


if __name__ == "__main__":
    main()

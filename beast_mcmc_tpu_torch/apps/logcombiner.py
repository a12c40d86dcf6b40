"""LogCombiner: merge trace logs with burn-in removal and thinning
(ref: src/dr/app/tools/logcombiner/LogCombiner.java).

The port's own copy of beast_mcmc_tpu/apps/logcombiner.py: host-side numpy
over this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import sys
from typing import List, Sequence

import numpy as np

from beast_mcmc_tpu_torch.apps.loganalyser import read_log


def combine_logs(paths: Sequence[str], burnin: int = 0, resample: int = 0) -> str:
    """Concatenate logs (same columns), dropping `burnin` states from each
    and optionally thinning to every `resample` states. Restates the
    state column as a contiguous sequence."""
    all_cols = None
    chunks: List[np.ndarray] = []
    header: List[str] = []
    for p in paths:
        states, cols = read_log(p)
        if all_cols is None:
            all_cols = list(cols.keys())
            header = ["state"] + all_cols
        elif list(cols.keys()) != all_cols:
            raise ValueError(f"column mismatch in {p}")
        keep = states >= burnin
        data = np.column_stack([states[keep]] + [cols[c][keep] for c in all_cols])
        chunks.append(data)
    combined = np.concatenate(chunks)
    if resample:
        step = int(combined[1, 0] - combined[0, 0]) if len(combined) > 1 else 1
        stride = max(1, resample // max(step, 1))
        combined = combined[::stride]
    # renumber states contiguously
    n = len(combined)
    step_out = int(combined[1, 0] - combined[0, 0]) if n > 1 else 1
    combined[:, 0] = np.arange(n) * step_out
    lines = ["\t".join(header)]
    for row in combined:
        lines.append("\t".join([str(int(row[0]))] +
                               [f"{v:.10g}" for v in row[1:]]))
    return "\n".join(lines) + "\n"


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    burnin = 0
    resample = 0
    files = []
    i = 0
    while i < len(args):
        if args[i] in ("-burnin", "--burnin"):
            burnin = int(args[i + 1]); i += 2
        elif args[i] in ("-resample", "--resample"):
            resample = int(args[i + 1]); i += 2
        else:
            files.append(args[i]); i += 1
    *inputs, output = files
    open(output, "w").write(combine_logs(inputs, burnin, resample))


if __name__ == "__main__":
    main()

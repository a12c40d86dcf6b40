#!/usr/bin/env python3
"""Time one tree's launch (B = 1) of the three level-scheduled peel kernels
of a checkout of the PyTorch/CUDA port, on one CUDA card.

    python3 scripts/peel_b1_turns.py [ROOT ...]

Each ROOT (default: this checkout) is timed in its own process, in the
order given, so that two versions of the kernels can be compared in turns
on one card: e.g. a parent commit unpacked with `git archive` into a
directory that .gitignore lists, then this checkout, this checkout, the
parent. The inputs are the same for every ROOT (numpy, fixed seeds): a
coalescent tree of the main path's size, tips whose entries are 1 or 0.1,
row-stochastic branch matrices; f64. The kernels are called through the
single-tree `prepare_*` wrappers, whose signatures every version since the
level schedule shares: `peel_resident` at benchmark2 (62 taxa, C = 4, 5,632
patterns), `peel_stream` at Makona (1,610 taxa, C = 4, 2,048 patterns) and
at benchmark1's three partitions (1,441 taxa, K = 3, C = 1, 640 patterns),
`peel_mxu` at the protein shape (128 taxa, C = 4, S = 20, 1,024 patterns).
Each ROOT prints one JSON line: the card, the ROOT and the median ms of
CUDA-event timings of each launch. Without a card it exits 1.
"""

import json
import os
import statistics
import subprocess
import sys

SHAPES = {  # kernel label: (taxa, partitions, categories, states, patterns)
    "peel_resident benchmark2": (62, 0, 4, 4, 5632),
    "peel_stream makona": (1610, 0, 4, 4, 2048),
    "peel_stream benchmark1 K=3": (1441, 3, 1, 4, 640),
    "peel_mxu protein": (128, 0, 4, 20, 1024),
}
REPS = 50


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def one_root(root):
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from beast_mcmc_tpu_torch.ops import (
        cuda_mxu, cuda_peeling, cuda_stream, cuda_stream2)
    from beast_mcmc_tpu_torch.tree.topology import (
        make_tree_state, simulate_coalescent_tree)

    dev, f64 = "cuda", torch.float64
    res = {}
    for label, (n, k, c, s, p) in SHAPES.items():
        rng = np.random.default_rng(7)
        tr = make_tree_state(*simulate_coalescent_tree(rng, np.zeros(n), 1.0),
                             dtype=f64, device=dev)
        lead = (k,) if k else ()
        tips = (rng.random((*lead, n, s, p)) > 0.6) * 0.9 + 0.1
        pm = rng.random((*lead, 2 * n - 1, c, s, s)) * 0.2 + 0.01
        pm = pm / pm.sum(-1, keepdims=True)
        t = lambda x: torch.tensor(x, dtype=f64, device=dev)  # noqa: E731
        tips, pm = t(tips), t(pm)
        fr, cw = t(np.full((*lead, s), 1.0 / s)), t(np.full((*lead, c),
                                                            1.0 / c))
        sched = cuda_stream.level_schedule(tr.children, n, tr.parent)
        if label.startswith("peel_resident"):
            call = cuda_peeling.prepare_resident(tips, tr.children, None, pm,
                                                 fr, cw, sched)
        elif label.startswith("peel_mxu"):
            call = cuda_mxu.prepare_mxu(tips, tr.children, None, pm, fr, cw,
                                        sched)
        else:
            if not k:
                tips, pm, fr, cw = tips[None], pm[None], fr[None], cw[None]
            _, ids, pos, ls = sched
            pm_ord = pm[:, ids.long()].contiguous()
            call = cuda_stream2.prepare_deep(tips, ids, pos, ls, pm_ord, fr,
                                             cw)
        res[label] = time_ms(call.launch, REPS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "root": root, "ms": res}), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("peel_b1_turns: no CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one_root(os.path.abspath(sys.argv[2]))
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for root in sys.argv[1:] or [here]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

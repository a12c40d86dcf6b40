#!/usr/bin/env python3
"""Time the v1 streaming peel kernel (`peel_stream_ring`) of checkouts of
the PyTorch/CUDA port in turns, on one CUDA card.

    python3 scripts/peel_ring_turns.py [ROOT ...]

Each ROOT (default: this checkout) is timed in its own process, in the
order given, so that two designs of the kernel can be compared on one card:
e.g. a parent commit unpacked with `git archive` into a directory that
.gitignore lists, then this checkout, this checkout, the parent. The inputs
are the same for every ROOT (numpy, fixed seeds): a coalescent tree (or a
caterpillar), tips whose entries are 1 or 0.1, row-stochastic branch
matrices; f64. The shapes are those chip_smoke.py's phase 2 holds the
kernel at: one benchmark1 partition, Makona, the protein and codon chains'
inputs, the small ragged one, a caterpillar, S = 2 and S = 8, and the
GY94+Gamma4 chain at 1,441 taxa, singly and as B = 4 chains (a design
without a chain axis launches once a chain). A design that walks the
height order (`stream_schedule` and `_pick_chunk`) is called through its
`prepare_stream(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w)`; one that
walks the levels through `prepare_stream(tips, schedule, p_matrices, freqs,
cat_w)`. Then each ROOT runs the GY94+Gamma4 chain at 1,441 taxa x 593
codons (this checkout's `chip_smoke.codon_analysis` with four categories,
on the ROOT's package) for CHAIN_STEPS steps after CHAIN_WARM, one kernel
launch a step. Each ROOT prints one JSON line: the card, the ROOT, the
median ms of CUDA-event timings of each launch, and the chain's states/s
and launches. Without a card it exits 1.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_WARM, CHAIN_STEPS = 10, 50

SHAPES = {  # label: (taxa, categories, states, patterns, chains, caterpillar)
    "benchmark1 partition": (1441, 1, 4, 593, 1, False),
    "makona": (1610, 4, 4, 2048, 1, False),
    "protein": (128, 4, 20, 1024, 1, False),
    "codon": (64, 1, 61, 512, 1, False),
    "small ragged": (12, 4, 4, 130, 1, False),
    "caterpillar": (500, 4, 4, 203, 1, True),
    "S=2": (400, 1, 2, 1000, 1, False),
    "S=8": (40, 2, 8, 300, 1, False),
    "codon+gamma4": (1441, 4, 61, 593, 1, False),
    "codon+gamma4 B=4": (1441, 4, 61, 593, 4, False),
}


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


def tree(n, rng, caterpillar):
    import numpy as np

    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    if not caterpillar:
        return simulate_coalescent_tree(rng, np.zeros(n), 1.0)
    m = 2 * n - 1
    parent, children = np.full(m, -1), np.full((m, 2), -1)
    for i in range(1, n):
        children[n + i - 1] = (n + i - 2 if i > 1 else 0, i)
        parent[children[n + i - 1]] = n + i - 1
    return parent, children, np.r_[np.zeros(n), np.arange(1.0, n)], m - 1


def one_root(root):
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from beast_mcmc_tpu_torch.ops import cuda_stream
    from beast_mcmc_tpu_torch.ops.peeling import peel_order_from_heights
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state

    dev, f64 = "cuda", torch.float64
    by_height = hasattr(cuda_stream, "_pick_chunk")
    res = {}
    for label, (n, c, s, p, b_n, cat) in SHAPES.items():
        rng = np.random.default_rng(11)
        trees = [make_tree_state(*tree(n, rng, cat), dtype=f64, device=dev)
                 for _ in range(b_n)]
        tips = (rng.random((n, s, p)) > 0.6) * 0.9 + 0.1
        pm = rng.random((b_n, 2 * n - 1, c, s, s)) * 0.2 + 0.01
        pm = pm / pm.sum(-1, keepdims=True)
        t = lambda x: torch.tensor(x, dtype=f64, device=dev)  # noqa: E731
        tips, pm = t(tips), t(pm)
        fr, cw = t(np.full(s, 1.0 / s)), t(np.full(c, 1.0 / c))
        if by_height:
            calls = []
            for b, tr in enumerate(trees):
                order = peel_order_from_heights(tr.heights, n, tr.parent)
                ids, pos = cuda_stream.stream_schedule(tr.children, order)
                calls.append(cuda_stream.prepare_stream(
                    tips, ids, pos, pm[b][ids.long()], fr, cw))

            def run(calls=calls):
                for call in calls:
                    call.launch()
        else:
            ch = torch.stack([tr.children for tr in trees])
            par = torch.stack([tr.parent for tr in trees])
            call = cuda_stream.prepare_stream(
                tips, cuda_stream.level_schedule(ch, n, par), pm,
                fr.expand(b_n, s).contiguous(),
                cw.expand(b_n, c).contiguous())
            run = call.launch
        res[label] = time_ms(run, 5 if n * c * s > 100000 else 20)
        del run
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "root": root,
                      "design": "height order" if by_height else "levels",
                      "ms": res, "chain": chain(cuda_stream)}), flush=True)


def chain(cuda_stream):
    """States/s and launches of the GY94+Gamma4 chain on the imported
    package (the ROOT's), built by this checkout's chip_smoke.py."""
    import torch

    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_mcmc_step, run_chain)

    spec = importlib.util.spec_from_file_location(
        "smoke_here", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, ops, p0, t0, aux = smoke.codon_analysis(1441, 593, 0, torch.float64,
                                               "cuda", n_categories=4)
    lpc = aux["log_post_cached"]
    step = make_mcmc_step(lpc, ops, derived=aux["derived"])
    state = init_mcmc_state(p0, t0, torch.Generator(device="cuda")
                            .manual_seed(3), ops, lpc)
    state, _ = run_chain(step, state, CHAIN_WARM)
    torch.cuda.synchronize()
    cuda_stream.launches = 0
    t = time.perf_counter()
    state, _ = run_chain(step, state, CHAIN_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return {"steps": CHAIN_STEPS, "states_per_s": CHAIN_STEPS / secs,
            "peel_stream_ring_launches": cuda_stream.launches,
            "log_posterior": float(state.log_posterior)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("peel_ring_turns: no CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one_root(os.path.abspath(sys.argv[2]))
        return 0
    for root in sys.argv[1:] or [HERE]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

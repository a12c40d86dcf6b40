"""Per-operator timing profiler: the mcmcprof / `-Dmcmc.evaluation.count`
role (MarkovChain.java:255-275, which accumulates each operator's
evaluation wall time into the operator analysis, and the standalone
mcmcprof tool).

Counterpart of beast_mcmc_tpu/apps/profiler.py. Each operator is timed as
its own single-operator chain segment (the same posterior, a fresh state
from the same start): one untimed warm-up segment (the kernels' build and
first launches), then a timed one whose clock stops after
torch.cuda.synchronize() where the chain runs on the card. The combined
schedule estimate weighs each operator's measured rate by its schedule
probability, giving the states/hour column BEAST logs (MCLogger.java:60).
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import torch

from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)


def profile_operators(log_post, operators: Sequence, params0: Dict, tree0,
                      seed: int = 0, n_steps: int = 200,
                      derived=None) -> Dict:
    """Time each operator's full MH step (propose + posterior + accept).

    Returns {"rows": [{name, weight, steps_per_sec, us_per_step}, ...],
             "states_per_hour": combined-schedule estimate}."""
    dev = tree0.heights.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    weights = [float(getattr(op, "weight", 1.0)) for op in operators]
    wsum = sum(weights) or 1.0
    inv_rate_weighted = 0.0
    for op, w in zip(operators, weights):
        step = make_mcmc_step(log_post, [op], derived=derived)

        def segment():
            state = init_mcmc_state(
                params0, tree0, torch.Generator(device=dev).manual_seed(seed),
                [op], log_post)
            sync()
            t0 = time.perf_counter()
            run_chain(step, state, n_steps)
            sync()
            return time.perf_counter() - t0

        segment()  # warm
        dt = segment()
        rate = n_steps / dt
        rows.append({
            "name": f"{type(op).__name__}({getattr(op, 'parameter', '') or ''})",
            "weight": w,
            "steps_per_sec": rate,
            "us_per_step": 1e6 * dt / n_steps,
        })
        inv_rate_weighted += (w / wsum) / rate
    combined = 1.0 / inv_rate_weighted if inv_rate_weighted > 0 else 0.0
    return {"rows": rows, "states_per_hour": combined * 3600.0}


def profile_report(profile: Dict) -> str:
    """Render the timing table (the reference's operator analysis 'Time'
    column, OperatorAnalysisPrinter.java)."""
    lines = [
        "operator                          weight  steps/sec   us/step",
    ]
    for r in profile["rows"]:
        lines.append(
            f"{r['name']:<32}  {r['weight']:<6.1f}  "
            f"{r['steps_per_sec']:<10.1f}  {r['us_per_step']:<9.1f}"
        )
    lines.append(
        f"combined schedule estimate: "
        f"{profile['states_per_hour']:.0f} states/hour")
    return "\n".join(lines)

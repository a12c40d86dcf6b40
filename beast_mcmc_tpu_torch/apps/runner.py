"""Analysis runner: spec -> chain -> log files (the BeastMain + MCMC role,
BeastMain.java:370, MCMC.java:143-202: run the chain, write the tab log and
the NEXUS tree log, print the operator analysis, save and load
checkpoints).

Counterpart of beast_mcmc_tpu/apps/runner.py. The chain's collector
returns device tensors every log_every steps; run_chain stacks them on the
device and they are copied to the host once, after the run, for the
writers (inference/loggers.py) and the ESS (inference/trace.py).
Metropolis-coupled chains (mc3_chains > 1) are one chain batch under the
builder's chain-axis posterior (Analysis.log_posterior_chains): one peel a
partition for all chains each step, the cold chain logged once a swap
round, no tree file and no checkpoint, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.builder import Analysis, build
from beast_mcmc_tpu_torch.inference.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from beast_mcmc_tpu_torch.inference.loggers import write_run_files
from beast_mcmc_tpu_torch.inference.mc3 import (
    chain_state,
    make_mc3_runner,
    replicate_state,
)
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    operator_report,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.trace import analyze
from beast_mcmc_tpu_torch.tree.topology import root_height
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE

@dataclasses.dataclass
class RunResult:
    state: object
    samples: Dict[str, np.ndarray]
    states: np.ndarray
    ess: Dict[str, float]
    states_per_sec: float
    report: str


def run_analysis(spec_or_analysis, log_file: Optional[str] = None,
                 tree_file: Optional[str] = None,
                 checkpoint_file: Optional[str] = None,
                 load_state: Optional[str] = None, verbose: bool = True,
                 mc3_chains: int = 1, mc3_delta: Optional[float] = None,
                 mc3_temperatures: Optional[list] = None,
                 mc3_swap: int = 100,
                 device=DEFAULT_DEVICE) -> RunResult:
    """Run one chain of the spec (or built Analysis) on `device`, writing
    the Tracer log, the NEXUS tree log and the checkpoint where asked; or,
    with mc3_chains > 1, mc3_chains Metropolis-coupled chains."""
    analysis = (spec_or_analysis if isinstance(spec_or_analysis, Analysis)
                else build(spec_or_analysis, device=device))
    if mc3_chains > 1:
        return _run_analysis_mc3(analysis, mc3_chains, mc3_delta,
                                 mc3_temperatures, mc3_swap,
                                 log_file=log_file, verbose=verbose)
    mcmc = analysis.spec.mcmc
    log_every = mcmc.log_every
    n_steps = mcmc.chain_length
    tree_every = mcmc.tree_log_every or log_every
    dev = analysis.tree0.heights.device

    step = make_mcmc_step(analysis.log_posterior, analysis.operators,
                          adaptation=mcmc.adaptation,
                          adaptation_delay=mcmc.adaptation_delay)
    state = init_mcmc_state(analysis.params0, analysis.tree0,
                            torch.Generator(device=dev).manual_seed(
                                mcmc.seed),
                            analysis.operators, analysis.log_posterior)
    if load_state:
        state = load_checkpoint(load_state, state, analysis.log_posterior)
        if verbose:
            print(f"resumed from {load_state} at state {state.step}",
                  file=sys.stderr)

    scalar_cols = [k for k, v in analysis.params0.items() if v.dim() == 0]

    def collector(s):
        out = {"posterior": s.log_posterior,
               "treeModel.rootHeight": root_height(s.tree)}
        for k in scalar_cols:
            out[k] = s.params[k]
        out["__tree.heights"] = s.tree.heights
        out["__tree.parent"] = s.tree.parent
        out["__tree.children"] = s.tree.children
        out["__tree.root"] = s.tree.root
        out["__step"] = torch.tensor(s.step)
        return out

    sync = _sync(dev)
    sync()
    t0 = time.perf_counter()
    state, out = run_chain(step, state, n_steps, collect_every=log_every,
                           collector=collector)
    sync()
    elapsed = time.perf_counter() - t0
    sps = n_steps / elapsed

    out = {k: v.cpu().numpy() for k, v in (out or {}).items()}
    states = out.pop("__step", np.zeros(0, np.int64))
    stride = max(1, tree_every // log_every)
    trees = [out.pop(f"__tree.{k}", np.zeros(0))[::stride]
             for k in ("parent", "children", "heights", "root")]
    columns = list(out.keys())
    write_run_files(analysis.taxa, states, out, states[::stride], trees,
                    log_file, tree_file, title="beast_mcmc_tpu_torch")
    if checkpoint_file:
        save_checkpoint(checkpoint_file, state)

    n_burn = max(1, len(states) // 10)
    ess = {c: analyze(out[c][n_burn:], step_size=log_every).ess
           for c in columns}
    report = operator_report(analysis.operators, state)
    if verbose:
        print(f"{n_steps} states in {elapsed:.1f}s = {sps:.1f} states/sec",
              file=sys.stderr)
        print(report, file=sys.stderr)
    return RunResult(state=state, samples=out, states=states, ess=ess,
                     states_per_sec=sps, report=report)


def _sync(dev):
    """A function that waits for `dev`'s queue (nothing on the CPU)."""
    return ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))


def _run_analysis_mc3(analysis, n_chains, delta, temperatures, swap_every,
                      log_file=None, verbose=True) -> RunResult:
    """Metropolis-coupled run, the BeastMain -mc3_* surface
    (BeastMain.java:436-440, MCMCMC.java): the chains are one batch (slot
    0 the cold chain) stepped by inference/mc3.py under
    analysis.log_posterior_chains; n_rounds = chain_length // swap_every
    rounds of swap_every steps and one swap attempt; the cold chain's
    scalar columns are logged once a round. The seeds are the JAX
    package's: the start state's device generator from the seed, the
    batch's (and its operator draws') from seed + 1, the swaps' CPU
    generator from seed + 2."""
    mcmc = analysis.spec.mcmc
    n_rounds = max(1, mcmc.chain_length // swap_every)
    dev = analysis.tree0.heights.device
    explicit = (None if temperatures is None
                else ([1.0] + list(temperatures))[:n_chains])
    run, temps = make_mc3_runner(
        analysis.log_posterior_chains, analysis.operators, n_chains,
        swap_every=swap_every, delta=(delta if delta is not None else 1.0),
        adaptation=mcmc.adaptation, temperatures=explicit)

    state0 = init_mcmc_state(
        analysis.params0, analysis.tree0,
        torch.Generator(device=dev).manual_seed(mcmc.seed),
        analysis.operators, analysis.log_posterior)
    states = replicate_state(
        state0, n_chains,
        torch.Generator(device=dev).manual_seed(mcmc.seed + 1))
    scalar_cols = [k for k, v in analysis.params0.items() if v.dim() == 0]

    def collector(cold):
        out = {"posterior": cold.log_posterior,
               "treeModel.rootHeight": root_height(cold.tree)}
        for k in scalar_cols:
            out[k] = cold.params[k]
        return out

    sync = _sync(dev)
    sync()
    t0 = time.perf_counter()
    states, outputs = run(states, torch.Generator().manual_seed(
        mcmc.seed + 2), n_rounds, collector)
    sync()
    elapsed = time.perf_counter() - t0
    sps = n_rounds * swap_every * n_chains / elapsed

    out = {k: v.cpu().numpy() for k, v in outputs.items()
           if not k.startswith("swap")}
    swap_rate = float(outputs["swap_accepted"].double().mean())
    steps_axis = np.arange(1, n_rounds + 1) * swap_every
    columns = list(out.keys())
    write_run_files(analysis.taxa, steps_axis, out, None, None, log_file,
                    title="beast_mcmc_tpu_torch mc3 cold chain")
    n_burn = max(1, n_rounds // 10)
    ess = {c: analyze(out[c][n_burn:], step_size=swap_every).ess
           for c in columns}
    report = (f"MC3: {n_chains} chains, temperatures "
              f"{[round(float(t), 4) for t in temps.tolist()]}, "
              f"swap every {swap_every}, swap acceptance {swap_rate:.3f}")
    if verbose:
        print(f"{n_rounds * swap_every} states x {n_chains} chains in "
              f"{elapsed:.1f}s = {sps:.1f} aggregate states/sec",
              file=sys.stderr)
        print(report, file=sys.stderr)
    return RunResult(state=chain_state(states, 0), samples=out,
                     states=steps_axis, ess=ess, states_per_sec=sps,
                     report=report)

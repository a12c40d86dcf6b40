"""Analysis runner: spec -> chain -> log files (the BeastMain + MCMC role,
BeastMain.java:370, MCMC.java:143-202: run the chain, write the tab log and
the NEXUS tree log, print the operator analysis, save and load
checkpoints).

Counterpart of beast_mcmc_tpu/apps/runner.py for one chain. The chain's
collector returns device tensors every log_every steps; run_chain stacks
them on the device and they are copied to the host once, after the run,
for the writers (inference/loggers.py) and the ESS (inference/trace.py).
Metropolis-coupled chains wait for a builder posterior over a chain axis
(ROADMAP queue A, "the builder's chain-axis posterior and the CLI's MC3").
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
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    operator_report,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.trace import analyze
from beast_mcmc_tpu_torch.tree.topology import root_height
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE

MC3_NOT_PORTED = ("mc3_chains > 1 needs the builder's posterior over a "
                  "chain axis, which is not ported yet (ROADMAP queue A: "
                  "the builder's chain-axis posterior and the CLI's MC3)")


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
                 mc3_chains: int = 1,
                 device=DEFAULT_DEVICE) -> RunResult:
    """Run one chain of the spec (or built Analysis) on `device`, writing
    the Tracer log, the NEXUS tree log and the checkpoint where asked."""
    if mc3_chains > 1:
        raise NotImplementedError(MC3_NOT_PORTED)
    analysis = (spec_or_analysis if isinstance(spec_or_analysis, Analysis)
                else build(spec_or_analysis, device=device))
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

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

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

"""The Metropolis-Hastings chain.

Counterpart of beast_mcmc_tpu/inference/mcmc.py. The JAX package runs the
chain as one lax.scan with a lax.switch over operators; here a host loop
steps the chain and the operator is a Python choice:

  - the operator index is drawn on a CPU generator, so the host never
    waits on the device to choose a branch;
  - proposal, posterior evaluation and acceptance stay on the device, and
    accept/reject is a torch.where select: no value is copied to the host
    in a step (except inside torch.linalg.eigh, see PERF.md);
  - Robbins-Monro adaptation p += (acc - target) / log(count + 2)
    (MarkovChain.java:559-590) updates the device statistics in place.

derived: {name: (fn(params) -> value, depends_on_param_names)} caches of
parameter-derived values (the eigensystem, the gamma rates). A step
rebuilds only the entries whose dependencies the chosen operator can
modify; a tree move never pays for the eigendecomposition.

An operator may return its own acceptance statistic as a fourth value
(NUTS's mean acceptance along its trajectory); NaN means "adapt on the
Metropolis probability". post_update(params) -> params runs on the state
after accept/reject every step: the home of in-chain adaptation statistics
such as AVMVN's running covariance (samplers.make_post_update).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.operators import Operator
from beast_mcmc_tpu_torch.inference.state import MCMCState, init_state
from beast_mcmc_tpu_torch.tree.topology import TreeState
from beast_mcmc_tpu_torch.utils.accum import accum_dtype

LogPosteriorFn = Callable[[Dict, TreeState], torch.Tensor]


def apply_derived(derived: Dict, params: Dict) -> Dict:
    """Recompute every derived entry from the raw parameters."""
    for name, (fn, _) in derived.items():
        params = {**params, name: fn(params)}
    return params


def _select(accept: torch.Tensor, new, old):
    """torch.where(accept, new, old) through dicts, tuples and dataclasses;
    an entry the proposal left untouched is passed through as it is."""
    if new is old:
        return new
    if isinstance(new, torch.Tensor):
        return torch.where(accept, new, old)
    if isinstance(new, dict):
        return {k: _select(accept, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_select(accept, a, b) for a, b in zip(new, old))
    if dataclasses.is_dataclass(new):
        return type(new)(**{f.name: _select(accept, getattr(new, f.name),
                                            getattr(old, f.name))
                            for f in dataclasses.fields(new)})
    raise TypeError(f"cannot select over {type(new)}")


def make_mcmc_step(log_posterior: LogPosteriorFn,
                   operators: Sequence[Operator],
                   adaptation: bool = True,
                   adaptation_delay: int = 0,
                   derived: Optional[Dict] = None,
                   post_update: Optional[Callable[[Dict], Dict]] = None):
    """Build `step(state, temperature=1.0) -> state`. Every operator that
    evaluates the posterior inside its proposal (HMC, NUTS, the PDMPs, the
    slice samplers) is bound to `log_posterior`; such an operator may not
    move a parameter that a derived entry depends on, since its in-proposal
    evaluations would read the stale cache. `post_update` is applied to the
    params after accept/reject."""
    deps = {d for _, ds in (derived or {}).values() for d in ds}
    for op in operators:
        if hasattr(op, "bind_log_posterior"):
            op.bind_log_posterior(log_posterior)
            moved = sorted(set(op.modified_params() or ()) & deps)
            if moved:
                raise ValueError(f"{type(op).__name__} moves {moved}, on "
                                 "which a derived cache depends")
    weights = np.asarray([op.weight for op in operators], np.float64)
    probs = weights / weights.sum()
    cum = np.cumsum(probs).tolist()
    stale = []
    for op in operators:
        mod = op.modified_params()
        stale.append([name for name, (_, deps) in (derived or {}).items()
                      if mod is None or set(deps) & set(mod)])

    def step_given_op(state: MCMCState, op_idx: int,
                      temperature: float = 1.0) -> MCMCState:
        """One MH step with the operator chosen by the caller."""
        op = operators[op_idx]
        gen = state.generator
        tuning = op.tuning(state.op_adapt[op_idx])
        params, tree, logh, *acc_stat = op.propose(state.params, state.tree,
                                                   gen, tuning)
        for name in stale[op_idx]:
            params = {**params, name: derived[name][0](params)}

        new_lp = log_posterior(params, tree).to(accum_dtype())
        new_lp = torch.where(torch.isnan(new_lp), -math.inf, new_lp)
        old_lp = state.log_posterior
        logr = (new_lp - old_lp) * temperature + logh
        # first evaluation: the old posterior is -inf, accept a finite one
        logr = torch.where(torch.isneginf(old_lp) & torch.isfinite(new_lp),
                           math.inf, logr)
        u = torch.rand((), generator=gen, dtype=old_lp.dtype,
                       device=old_lp.device)
        accept = torch.log(u) < logr

        params = _select(accept, params, state.params)
        tree = _select(accept, tree, state.tree)
        lp = torch.where(accept, new_lp, old_lp)
        if post_update is not None:
            params = post_update(params)

        acc_prob = torch.nan_to_num(torch.exp(torch.clamp_max(logr, 0.0)),
                                    nan=0.0)
        if acc_stat:  # the operator's own statistic where it is not NaN
            a = torch.as_tensor(acc_stat[0], dtype=acc_prob.dtype,
                                device=acc_prob.device)
            acc_prob = torch.where(torch.isnan(a), acc_prob, a)
        acc_i = accept.long()
        state.op_accept[op_idx] += acc_i
        state.op_reject[op_idx] += 1 - acc_i
        state.op_sum_accept[op_idx] += acc_prob.to(state.op_sum_accept.dtype)
        if op.adaptable and adaptation and state.step >= adaptation_delay:
            adt = state.op_adapt.dtype
            denom = torch.log(state.op_adapt_count[op_idx].to(adt) + 2.0)
            state.op_adapt[op_idx] += (
                (acc_prob.to(adt) - op.target_acceptance) / denom)
            state.op_adapt_count[op_idx] += 1
        return state.replace(params=params, tree=tree, log_posterior=lp,
                             step=state.step + 1)

    def step(state: MCMCState, temperature: float = 1.0) -> MCMCState:
        u = float(torch.rand((), generator=state.op_generator,
                             dtype=torch.float64))
        op_idx = min(bisect.bisect_right(cum, u), len(cum) - 1)
        return step_given_op(state, op_idx, temperature)

    return step


def init_mcmc_state(params: Dict, tree: TreeState,
                    generator: torch.Generator,
                    operators: Sequence[Operator],
                    log_posterior: Optional[LogPosteriorFn] = None,
                    dtype: torch.dtype = torch.float64,
                    derived: Optional[Dict] = None) -> MCMCState:
    """`generator` lives on the tree's device and seeds the chain; the CPU
    operator-draw generator is seeded from it. Operators with in-chain
    statistics (AVMVN) seed them into `params`."""
    for op in operators:
        if hasattr(op, "init_stats") and op.stats_key not in params:
            params = op.init_stats(params)
    if derived:
        params = apply_derived(derived, params)
    init_adapt = torch.tensor([op.initial_adapt() for op in operators],
                              dtype=dtype)
    state = init_state(params, tree, generator, len(operators), init_adapt,
                       dtype)
    if log_posterior is not None:
        lp = log_posterior(state.params, state.tree).to(accum_dtype())
        state = state.replace(log_posterior=lp)
    return state


def run_chain(step_fn, state: MCMCState, n_steps: int,
              collect_every: int = 0,
              collector: Optional[Callable[[MCMCState], Dict]] = None,
              temperature: float = 1.0):
    """Run n_steps. With collect_every > 0 and a collector, returns
    (state, {key: stacked collector outputs}) every collect_every steps;
    else (state, None)."""
    out = []
    for i in range(n_steps):
        state = step_fn(state, temperature)
        if collect_every and collector and (i + 1) % collect_every == 0:
            out.append(collector(state))
    if not out:
        return state, None
    return state, {k: torch.stack([o[k] for o in out]) for k in out[0]}


def full_evaluation_check(step_fn, log_posterior: LogPosteriorFn,
                          state: MCMCState, n_steps: int = 100,
                          temperature: float = 1.0,
                          derived: Optional[Dict] = None):
    """The reference's full-evaluation self-check (MarkovChain.java:336-373,
    tolerance 0.1): after every step the carried log posterior is compared
    with a fresh evaluation that also rebuilds every derived cache, then
    re-anchored to it. Returns (state, max |fresh - carried|) with the max
    as a 0-d device tensor."""
    max_dev = torch.zeros((), dtype=state.log_posterior.dtype,
                          device=state.log_posterior.device)
    for _ in range(n_steps):
        state = step_fn(state, temperature)
        p = apply_derived(derived, state.params) if derived else state.params
        fresh = log_posterior(p, state.tree).to(state.log_posterior.dtype)
        max_dev = torch.maximum(max_dev, torch.abs(fresh - state.log_posterior))
        state = state.replace(params=p, log_posterior=fresh)
    return state, max_dev


def operator_report(operators: Sequence[Operator], state: MCMCState) -> str:
    """End-of-run operator table (OperatorAnalysisPrinter.java)."""
    lines = ["operator                          weight  accepted  rejected  "
             "acc%    tuning"]
    acc_all = state.op_accept.tolist()
    rej_all = state.op_reject.tolist()
    for i, op in enumerate(operators):
        acc, rej = acc_all[i], rej_all[i]
        tuning = op.tuning(state.op_adapt[i])
        tstr = f"{float(tuning):.4f}" if tuning is not None else "-"
        name = f"{type(op).__name__}({getattr(op, 'parameter', '')})"
        lines.append(
            f"{name:<32}  {op.weight:<6.1f}  {acc:<8d}  {rej:<8d}  "
            f"{100.0 * acc / max(acc + rej, 1):<5.1f}  {tstr}")
    return "\n".join(lines)

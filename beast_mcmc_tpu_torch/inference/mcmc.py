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

components (inference/component_cache.py): the posterior as a sum of
cached addends, BEAST X's CompoundLikelihood dirty flags. Each operator
refreshes only the components that `affected_indices` gives it, and those
that read a derived entry it makes stale; the step's posterior is the sum
of the cached vector. The JAX package groups operators by their distinct
index sets, and switches over the groups, only to bound XLA's compile time;
nothing is compiled here, so each operator refreshes its own set.

Chain batches (make_multichain_step, inference/mc3.py): one MCMCState
whose tensors carry a leading chain axis B (params [B, ...], the tree's
fields [B, M], [B, M, 2] and [B], log_posterior [B], the statistics [B,
n_ops]) with one device generator and one CPU operator-draw generator; the
chains' draws are different elements of the same streams. A step draws
its operator index (or each chain's) on the CPU, runs each drawn
operator's proposal over its chains with torch.func.vmap (randomness
"different"), rebuilds the stale derived entries over the chain axis,
evaluates the chain-axis posterior of all B chains once (one kernel
launch), and accepts or rejects each chain with torch.where. An operator
that evaluates the posterior inside its proposal (HMC, NUTS, the PDMPs,
the slice samplers, the constrained HMC) cannot be vmapped (a ctypes
launch and torch.autograd.grad do not cross torch.func.vmap): it is bound
to the chain-axis posterior and runs its own chain-axis proposal
(`propose_chains`), a gradient of all its chains one launch and one level
adjoint; so does an operator whose proposal draws on the host (the
Bayesian bridge's local scales). Acceptance stays JAX's, (new - old) * T +
log Hastings, each chain with its own, and an operator's own acceptance
statistic (NUTS's) replaces the Metropolis probability of its chains.
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
TREE_FIELDS = ("parent", "children", "heights", "root")


def apply_derived(derived: Dict, params: Dict) -> Dict:
    """Recompute every derived entry from the raw parameters."""
    for name, (fn, _) in derived.items():
        params = {**params, name: fn(params)}
    return params


def _select(accept: torch.Tensor, new, old):
    """torch.where(accept, new, old) through dicts, tuples and dataclasses;
    an entry the proposal left untouched is passed through as it is. A
    chain batch's accept [B] selects along the leading axis."""
    if new is old:
        return new
    if isinstance(new, torch.Tensor):
        a = accept.reshape(accept.shape + (1,) * (new.dim() - accept.dim()))
        return torch.where(a, new, old)
    if isinstance(new, dict):
        return {k: _select(accept, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_select(accept, a, b) for a, b in zip(new, old))
    if dataclasses.is_dataclass(new):
        return type(new)(**{f.name: _select(accept, getattr(new, f.name),
                                            getattr(old, f.name))
                            for f in dataclasses.fields(new)})
    raise TypeError(f"cannot select over {type(new)}")


def map_tensors(fn, obj):
    """fn applied to every tensor in dicts, tuples and dataclasses (a
    state's params and tree); None passes through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(map_tensors(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if obj is None:
        return None
    raise TypeError(f"cannot map over {type(obj)}")


def _stale_sets(operators, derived):
    """For each operator, the derived entries its proposal can make stale."""
    out = []
    for op in operators:
        mod = op.modified_params()
        out.append([name for name, (_, deps) in (derived or {}).items()
                    if mod is None or set(deps) & set(mod)])
    return out


def _operator_cdf(operators):
    weights = np.asarray([op.weight for op in operators], np.float64)
    probs = weights / weights.sum()
    return probs, np.cumsum(probs).tolist()


def _draw(cum, u: float) -> int:
    return min(bisect.bisect_right(cum, u), len(cum) - 1)


def _bind_operators(operators, log_posterior, derived, chains=False):
    """Bind every operator that evaluates the posterior inside its proposal
    to `log_posterior` (the chain-axis one where `chains`); raise where
    such an operator moves a parameter that a derived entry depends on,
    since its in-proposal evaluations would read the stale cache."""
    deps = {d for _, ds in (derived or {}).values() for d in ds}
    for op in operators:
        if hasattr(op, "bind_log_posterior"):
            if chains:
                op.bind_log_posterior_chains(log_posterior)
            else:
                op.bind_log_posterior(log_posterior)
            moved = sorted(set(op.modified_params() or ()) & deps)
            if moved:
                raise ValueError(f"{type(op).__name__} moves {moved}, on "
                                 "which a derived cache depends")


def make_mcmc_step(log_posterior: LogPosteriorFn,
                   operators: Sequence[Operator],
                   adaptation: bool = True,
                   adaptation_delay: int = 0,
                   derived: Optional[Dict] = None,
                   post_update: Optional[Callable[[Dict], Dict]] = None,
                   components=None, op_tree_flags=None):
    """Build `step(state, temperature=1.0) -> state`. Every operator that
    evaluates the posterior inside its proposal (HMC, NUTS, the PDMPs, the
    slice samplers) is bound to `log_posterior`; such an operator may not
    move a parameter that a derived entry depends on, since its in-proposal
    evaluations would read the stale cache. `post_update` is applied to the
    params after accept/reject.

    components: a list of component_cache.Component, the posterior as the
    sum of the cached vector params[COMP_KEY] (seed it with
    seed_components); each operator refreshes its affected components
    (op_tree_flags[i]: whether operator i can move the tree, True where not
    given) and `log_posterior` stays the cache-free posterior that the
    operators above bind. The step exposes `given_op(state, op_idx,
    temperature)`, the step with the operator chosen by the caller,
    `log_probs`, the operators' log draw probabilities, and `refreshed`,
    each operator's component indices (None without components)."""
    _bind_operators(operators, log_posterior, derived)
    probs, cum = _operator_cdf(operators)
    stale = _stale_sets(operators, derived)
    if components is not None:
        from beast_mcmc_tpu_torch.inference.component_cache import (
            COMP_KEY,
            affected_indices,
            refresh_components,
        )

        refresh = []
        for i, op in enumerate(operators):
            idxs = set(affected_indices(
                components, op,
                op_tree_flags[i] if op_tree_flags is not None else True))
            # a component that reads a derived entry this operator rebuilds
            idxs |= {j for j, c in enumerate(components)
                     if c.deps is not None and c.deps & set(stale[i])}
            refresh.append(sorted(idxs))

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

        if components is not None:
            params = refresh_components(params, tree, components,
                                        refresh[op_idx])
            new_lp = torch.sum(params[COMP_KEY]).to(accum_dtype())
        else:
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
        return step_given_op(state, _draw(cum, u), temperature)

    step.given_op = step_given_op
    step.log_probs = torch.log(torch.as_tensor(probs))
    # the component indices each operator refreshes, where there are any
    step.refreshed = refresh if components is not None else None
    return step


def _propose_chains(op, params, tree, gen, tuning):
    """op.propose over the chain axis of params and tree, vmapped with
    randomness "different": each chain draws its own numbers from the one
    generator. Returns (the params entries the proposal replaced, the tree
    or None where it kept it, log Hastings [B], the operator's own
    acceptance statistic [B] where it returns one (the conjugate Gibbs
    draws), else None)."""
    touched = {}

    def one(p, t, tun):
        tr = TreeState(*t)
        p2, t2, logh, *acc = op.propose(p, tr, gen, tun)
        # vmap runs this once, so the Python-side identity checks are exact
        touched["params"] = [k for k in p2 if p2[k] is not p.get(k)]
        touched["tree"] = t2 is not tr
        touched["acc"] = bool(acc)
        acc = (torch.as_tensor(acc[0], dtype=logh.dtype) if acc
               else torch.full_like(logh, math.nan))
        return ({k: p2[k] for k in touched["params"]},
                tuple(getattr(t2, f) for f in TREE_FIELDS), logh, acc)

    p2, t2, logh, acc = torch.func.vmap(
        one, in_dims=(0, 0, None if tuning is None else 0),
        randomness="different")(params,
                                tuple(getattr(tree, f) for f in TREE_FIELDS),
                                tuning)
    return (p2, (TreeState(*t2) if touched["tree"] else None), logh,
            acc if touched["acc"] else None)


def _propose_bound(op, params, tree, gen, tuning):
    """The chain-axis proposal of an operator bound to the chain-axis
    posterior, in _propose_chains's form, with its acceptance statistic
    [B] (NaN where it has none) or None."""
    p2, t2, logh, *acc = op.propose_chains(params, tree, gen, tuning)
    return ({k: v for k, v in p2.items() if v is not params.get(k)},
            None if t2 is tree else t2, logh, acc[0] if acc else None)


def _chain_batch_core(log_posterior_chains, operators, derived, adaptation):
    """core(states, groups, op_of_chain, temperatures) -> states: one step
    of a chain batch. `groups` is [(operator index, chain indices as an
    int64 device tensor, or None for every chain)]; `op_of_chain` the
    operator index of each chain on the device, or None where one operator
    serves all. An operator that evaluates the posterior in its proposal
    is bound to `log_posterior_chains` and proposes over its chains
    itself, the posterior of those chains alone (gathered, and scattered
    back). See the module docstring."""
    _bind_operators(operators, log_posterior_chains, derived, chains=True)
    bound = [hasattr(op, "bind_log_posterior") for op in operators]
    # the operators with a chain-axis proposal of their own: the bound
    # ones, and those whose proposal cannot be vmapped (a host draw)
    own = [hasattr(op, "propose_chains") for op in operators]
    stale = _stale_sets(operators, derived)
    derived = derived or {}
    n_ops = len(operators)
    targets = torch.tensor([op.target_acceptance for op in operators],
                           dtype=torch.float64)
    adaptable = torch.tensor([bool(op.adaptable) for op in operators])
    on_device = {}

    def constants(dev):
        if dev not in on_device:
            on_device[dev] = (targets.to(dev), adaptable.to(dev))
        return on_device[dev]

    def core(states: MCMCState, groups, op_of_chain, temperatures):
        gen = states.generator
        old_lp = states.log_posterior
        b_n, dev = old_lp.shape[0], old_lp.device
        raw = {k: v for k, v in states.params.items() if k not in derived}
        params, tree = dict(states.params), states.tree
        logh = torch.zeros(b_n, dtype=old_lp.dtype, device=dev)
        acc_stat = None
        rebuild = set()
        for op_idx, idx in groups:
            op = operators[op_idx]
            rebuild.update(stale[op_idx])
            adapt = states.op_adapt[:, op_idx]
            # a bound operator reads the derived entries with the rest
            given = states.params if bound[op_idx] else raw
            propose = _propose_bound if own[op_idx] else _propose_chains
            if idx is None:
                p2, t2, lh, a = propose(op, given, states.tree, gen,
                                        op.tuning(adapt))
                params.update(p2)
                tree = tree if t2 is None else t2
                logh = lh.to(logh.dtype)
                acc_stat = a
                continue
            sub = map_tensors(lambda v: v[idx], states.tree)
            p2, t2, lh, a = propose(op, map_tensors(lambda v: v[idx], given),
                                    sub, gen, op.tuning(adapt[idx]))
            for k, v in p2.items():
                params[k] = params[k].index_copy(0, idx, v)
            if t2 is not None:
                tree = TreeState(*(getattr(tree, f).index_copy(
                    0, idx, getattr(t2, f)) for f in TREE_FIELDS))
            logh = logh.index_copy(0, idx, lh.to(logh.dtype))
            if a is not None:
                if acc_stat is None:
                    acc_stat = torch.full((b_n,), math.nan, dtype=a.dtype,
                                          device=dev)
                acc_stat = acc_stat.index_copy(0, idx, a)
        for name in derived:
            if name in rebuild:
                params[name] = derived[name][0](params)

        new_lp = log_posterior_chains(params, tree).to(accum_dtype())
        new_lp = torch.where(torch.isnan(new_lp), -math.inf, new_lp)
        logr = (new_lp - old_lp) * temperatures + logh
        logr = torch.where(torch.isneginf(old_lp) & torch.isfinite(new_lp),
                           math.inf, logr)
        u = torch.rand(b_n, generator=gen, dtype=old_lp.dtype, device=dev)
        accept = torch.log(u) < logr
        params = _select(accept, params, states.params)
        tree = _select(accept, tree, states.tree)
        lp = torch.where(accept, new_lp, old_lp)

        acc_prob = torch.nan_to_num(torch.exp(torch.clamp_max(logr, 0.0)),
                                    nan=0.0)
        if acc_stat is not None:  # an operator's own, where it is not NaN
            acc_prob = torch.where(torch.isnan(acc_stat), acc_prob,
                                   acc_stat.to(acc_prob.dtype))
        if op_of_chain is None:  # one operator for every chain
            hit = torch.zeros((b_n, n_ops), dtype=torch.bool, device=dev)
            hit[:, groups[0][0]] = True
        else:
            hit = op_of_chain[:, None] == torch.arange(n_ops, device=dev)
        acc_i = accept.long()[:, None] * hit
        states.op_accept += acc_i
        states.op_reject += hit.long() - acc_i
        states.op_sum_accept += torch.where(
            hit, acc_prob[:, None].to(states.op_sum_accept.dtype), 0.0)
        if adaptation:
            tgt, adapt_ok = constants(dev)
            adt = states.op_adapt.dtype
            do = hit & adapt_ok
            denom = torch.log(states.op_adapt_count.to(adt) + 2.0)
            states.op_adapt += torch.where(
                do, (acc_prob[:, None].to(adt) - tgt.to(adt)) / denom, 0.0)
            states.op_adapt_count += do.long()
        return states.replace(params=params, tree=tree, log_posterior=lp,
                              step=states.step + 1)

    return core


def make_multichain_step(log_posterior_chains, operators: Sequence[Operator],
                         derived: Optional[Dict] = None,
                         adaptation: bool = True):
    """Build `mstep(states, temperatures=1.0) -> states` over a chain batch
    (counterpart of the JAX package's make_multichain_step): ONE operator
    drawn a step, on the CPU, for all chains; its proposal runs over the
    chain axis, the stale derived entries are rebuilt over it, and
    `log_posterior_chains(params, tree) -> [B]` is evaluated once for all
    B chains. Each chain keeps its own proposal and acceptance draws.
    `temperatures` is a float or a [B] tensor. The composite kernel applies
    the same randomly chosen component kernel to every chain, each of which
    leaves the product distribution invariant. An operator that evaluates
    the posterior inside its proposal is bound to log_posterior_chains and
    proposes over all chains at once (`propose_chains`); as in
    make_mcmc_step, it may not move a parameter a derived entry depends
    on. `mstep.given_op(states, op_idx, temperatures)` is the step with
    the operator chosen by the caller."""
    core = _chain_batch_core(log_posterior_chains, operators, derived,
                             adaptation)
    _, cum = _operator_cdf(operators)

    def mstep(states: MCMCState, temperatures=1.0) -> MCMCState:
        u = float(torch.rand((), generator=states.op_generator,
                             dtype=torch.float64))
        return core(states, [(_draw(cum, u), None)], None, temperatures)

    def given_op(states: MCMCState, op_idx: int,
                 temperatures=1.0) -> MCMCState:
        """The batch step with the operator chosen by the caller."""
        return core(states, [(op_idx, None)], None, temperatures)

    mstep.given_op = given_op
    return mstep


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
    as a 0-d device tensor. Over a chain batch (a multichain step and a
    chain-axis posterior) the max is over chains and steps."""
    max_dev = torch.zeros((), dtype=state.log_posterior.dtype,
                          device=state.log_posterior.device)
    for _ in range(n_steps):
        state = step_fn(state, temperature)
        p = apply_derived(derived, state.params) if derived else state.params
        fresh = log_posterior(p, state.tree).to(state.log_posterior.dtype)
        max_dev = torch.maximum(
            max_dev, torch.abs(fresh - state.log_posterior).max())
        state = state.replace(params=p, log_posterior=fresh)
    return state, max_dev


def operator_report(operators: Sequence[Operator], state: MCMCState) -> str:
    """End-of-run operator table (OperatorAnalysisPrinter.java)."""
    lines = ["operator                          weight  accepted  rejected  "
             "acc%    tuning"]
    n_ops = len(operators)  # a chain batch's [B, n_ops] summed over chains
    acc_all = state.op_accept.reshape(-1, n_ops).sum(0).tolist()
    rej_all = state.op_reject.reshape(-1, n_ops).sum(0).tolist()
    for i, op in enumerate(operators):
        acc, rej = acc_all[i], rej_all[i]
        tuning = op.tuning(state.op_adapt[..., i])
        tstr = (f"{float(torch.as_tensor(tuning).mean()):.4f}"
                if tuning is not None else "-")
        name = f"{type(op).__name__}({getattr(op, 'parameter', '')})"
        lines.append(
            f"{name:<32}  {op.weight:<6.1f}  {acc:<8d}  {rej:<8d}  "
            f"{100.0 * acc / max(acc + rej, 1):<5.1f}  {tstr}")
    return "\n".join(lines)

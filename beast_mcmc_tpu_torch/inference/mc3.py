"""MC3: Metropolis-coupled MCMC (parallel tempering) over a chain batch.

Counterpart of beast_mcmc_tpu/inference/mc3.py (the reference's
MCMCMC.java:227-326, BEAST X's -mc3_chains). The chains are one MCMCState
with a leading chain axis (inference/state.py); chain b runs at
temperature T_b = 1 / (1 + delta b), chain 0 is the cold one and stays at
index 0. Every `swap_every` steps one random pair (i, j) proposes to swap
states, accepted on

    log r = (T_i - T_j) (lp_j - lp_i)            (MCMCMC.java:249-282)

Only the model state (params, tree, log posterior) moves between the
temperature slots; the operator statistics stay with the slot, so each
slot's tuning adapts to its own temperature (MCMCMC.java:289-316).

Differences from the JAX package, by design:
  - each chain draws its own operator, as JAX's vmap of `step` does, but
    the [B] indices come from the batch's one CPU generator; each drawn
    operator's proposal runs over the chains that drew it, and ONE
    chain-axis posterior evaluates all B chains: one kernel launch a step
    however many operators were drawn (mcmc.py::_chain_batch_core);
  - the swap's i, j and u are drawn on a CPU generator that the caller
    hands to `run` (JAX splits a key); `swap_with` is the swap's
    arithmetic given them, so that the tests can feed it JAX's draws;
  - the batch has one device generator where JAX gives each chain its own
    key: the chains' draws are different elements of one stream;
  - chains sharded over ranks (`make_mc3_runner(mesh=...)`) swap through
    parallel/distributed.py::swap_across_chain_shards, the port's form of
    what XLA inserts when swap_states runs on chain-sharded states.
An operator that evaluates the posterior inside its proposal (HMC, NUTS,
the PDMPs, the slice samplers) drawn by a subset of the chains proposes
over that subset alone, its in-proposal posterior the chain-axis one of
those chains (their params and trees gathered, the proposal scattered
back), as in make_multichain_step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from beast_mcmc_tpu_torch.inference.mcmc import (
    _chain_batch_core,
    _draw,
    _operator_cdf,
    map_tensors,
)
from beast_mcmc_tpu_torch.inference.state import MCMCState, init_state


def mc3_temperatures(n_chains: int, delta: float = 1.0,
                     dtype: torch.dtype = torch.float64,
                     device=None) -> torch.Tensor:
    """BEAST's ladder T_k = 1 / (1 + delta k)."""
    k = torch.arange(n_chains, dtype=dtype, device=device)
    return 1.0 / (1.0 + delta * k)


def swap_with(states: MCMCState, temperatures: torch.Tensor, i: int, j: int,
              log_u: float):
    """The swap of slots i != j given log u: (states, accepted as a 0-d
    device bool). Only params, tree and log posterior move; nothing is
    copied to the host."""
    lp = states.log_posterior
    n = lp.shape[0]
    logr = (temperatures[i] - temperatures[j]) * (lp[j] - lp[i])
    accept = log_u < logr
    ident = torch.arange(n, device=lp.device)
    perm = ident.clone()
    perm[i], perm[j] = j, i
    idx = torch.where(accept, perm, ident)

    def permute(x):
        return x[idx]

    return states.replace(params=map_tensors(permute, states.params),
                          tree=map_tensors(permute, states.tree),
                          log_posterior=lp[idx]), accept


def swap_draws(n: int, generator: torch.Generator):
    """(i, j, log u) of one swap attempt over n slots (JAX swap_states' law):
    i uniform over the slots, j uniform over the others, u uniform, all
    drawn on the CPU `generator`."""
    i = int(torch.randint(0, n, (), generator=generator))
    j = (i + 1 + int(torch.randint(0, n - 1, (), generator=generator))) % n
    u = float(torch.rand((), generator=generator, dtype=torch.float64))
    return i, j, math.log(u) if u > 0 else -math.inf


def swap_states(states: MCMCState, temperatures: torch.Tensor,
                generator: torch.Generator):
    """One random-pair swap attempt (JAX swap_states), drawn by
    `swap_draws`."""
    return swap_with(states, temperatures,
                     *swap_draws(temperatures.shape[0], generator))


def chain_state(states: MCMCState, b: int) -> MCMCState:
    """Chain b of the batch as a single-chain MCMCState (views)."""
    def pick(x):
        return x[b]

    return states.replace(
        params=map_tensors(pick, states.params),
        tree=map_tensors(pick, states.tree),
        log_posterior=states.log_posterior[b],
        op_adapt=states.op_adapt[b], op_adapt_count=states.op_adapt_count[b],
        op_accept=states.op_accept[b], op_reject=states.op_reject[b],
        op_sum_accept=states.op_sum_accept[b])


def make_mc3_runner(log_posterior, operators, n_chains: int,
                    swap_every: int = 100, delta: float = 1.0,
                    adaptation: bool = True, temperatures=None,
                    mesh=None):
    """(run, temperatures), the JAX signature. `log_posterior(params, tree)
    -> [B]` is the chain-axis posterior (apps/benchmarks.py's
    aux["log_post_chains"]). run(states, generator, n_rounds,
    collector=None) -> (states, outputs): each round is `swap_every` steps
    of the batch, each chain with its own operator draw, then one swap
    attempt drawn on the CPU `generator`; `collector(cold chain)` is taken
    each round, and outputs["swap_accepted"] is [n_rounds].

    With a `mesh` (parallel/mesh.py) the chains are sharded over its chains
    axis: this rank's batch is its n_chains / n_chain_shards slots, at
    their temperatures, and the swap is
    parallel/distributed.py::swap_across_chain_shards, whose `generator`
    must be seeded alike on every rank; the collector sees this rank's
    first slot, the cold chain on the ranks of chain coordinate 0."""
    core = _chain_batch_core(log_posterior, operators, None, adaptation)
    _, cum = _operator_cdf(operators)
    temps = (torch.as_tensor(temperatures, dtype=torch.float64)
             if temperatures is not None
             else mc3_temperatures(n_chains, delta))
    on_device = {}
    slots, swap = slice(None), swap_states
    if mesh is not None:
        from beast_mcmc_tpu_torch.parallel import distributed
        from beast_mcmc_tpu_torch.parallel.mesh import CHAINS_AXIS, axis_size

        shards = axis_size(mesh, CHAINS_AXIS)
        if n_chains % shards:
            raise ValueError(f"{n_chains} chains do not divide over "
                             f"{shards} chain shards")
        n_chains //= shards
        lo = mesh.get_local_rank(CHAINS_AXIS) * n_chains
        slots = slice(lo, lo + n_chains)

        def swap(states, temps_dev, generator):
            return distributed.swap_across_chain_shards(mesh, states,
                                                        temps_dev, generator)

    def step(states: MCMCState, temps_dev) -> MCMCState:
        u = torch.rand(n_chains, generator=states.op_generator,
                       dtype=torch.float64).tolist()
        drawn = [_draw(cum, x) for x in u]
        ops = sorted(set(drawn))
        if len(ops) == 1:
            return core(states, [(ops[0], None)], None, temps_dev)
        # the chains grouped by operator, and each chain's operator: one
        # copy to the device, which does not wait for it
        members = [b for i in ops for b, d in enumerate(drawn) if d == i]
        host = torch.tensor(members + drawn, dtype=torch.long)
        dev = temps_dev.device
        if dev.type == "cuda":
            host = host.pin_memory()
        idx = host.to(dev, non_blocking=True)
        groups, a = [], 0
        for i in ops:
            n = drawn.count(i)
            groups.append((i, idx[a:a + n]))
            a += n
        return core(states, groups, idx[n_chains:], temps_dev)

    def run(states: MCMCState, generator: torch.Generator, n_rounds: int,
            collector: Optional[Callable[[MCMCState], Dict]] = None):
        dev = states.log_posterior.device
        if dev not in on_device:
            full = temps.to(dev)
            on_device[dev] = full, full[slots]
        temps_dev, local = on_device[dev]
        outs = []
        for _ in range(n_rounds):
            for _ in range(swap_every):
                states = step(states, local)
            states, accepted = swap(states, temps_dev, generator)
            out = dict(collector(chain_state(states, 0))) if collector else {}
            out["swap_accepted"] = accepted
            outs.append(out)
        return states, {k: torch.stack([torch.as_tensor(o[k]) for o in outs])
                        for k in outs[0]} if outs else {}

    return run, temps


def replicate_state(state: MCMCState, n_chains: int,
                    generator: torch.Generator) -> MCMCState:
    """Tile a single-chain state into a batch of n_chains: every tensor
    gains the leading chain axis; `generator` (on the state's device) is
    the batch's one device generator, and the CPU operator-draw generator
    is seeded from it."""
    def tile(x):
        return x.expand(n_chains, *x.shape).clone()

    n_ops = state.op_adapt.shape[-1]
    fresh = init_state({}, state.tree, generator, n_ops, state.op_adapt,
                       state.op_adapt.dtype)
    return state.replace(
        params=map_tensors(tile, state.params),
        tree=map_tensors(tile, state.tree),
        log_posterior=tile(state.log_posterior),
        generator=generator, op_generator=fresh.op_generator,
        op_adapt=tile(state.op_adapt),
        op_adapt_count=tile(state.op_adapt_count),
        op_accept=tile(state.op_accept), op_reject=tile(state.op_reject),
        op_sum_accept=tile(state.op_sum_accept))

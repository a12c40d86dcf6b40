"""MC3 and the component cache of the port against the JAX package.

The swap's arithmetic (`swap_with`) is fed the i, j and u that JAX's
swap_states draws and must give JAX's permuted states and acceptance
exactly; the temperature ladder agrees to rounding. tests/test_mc3.py's
mode-crossing test is ported with its criterion unchanged at fewer steps.
The component cache's traced dependencies and each operator's affected
components equal JAX's on build_analysis's components for the three
models, and a cached chain's carried sum stays within 1e-9 of the full
posterior (float64 sums of the same addends in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jax_build_analysis
from beast_mcmc_tpu.inference import component_cache as jcc
from beast_mcmc_tpu.inference.mc3 import mc3_temperatures as jax_temperatures
from beast_mcmc_tpu.inference.mc3 import replicate_state as jax_replicate
from beast_mcmc_tpu.inference.mc3 import swap_states as jax_swap_states
from beast_mcmc_tpu.inference.mcmc import init_mcmc_state as jax_init_state
from beast_mcmc_tpu.inference.operators import (
    RandomWalkOperator as JaxRandomWalk,
)
from beast_mcmc_tpu.models import coalescent as jcoal
from beast_mcmc_tpu.models import priors as jpriors
from beast_mcmc_tpu.tree.topology import make_tree_state as jax_tree_state

import beast_mcmc_tpu_torch.models.treelikelihood as ttl
from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.convert import operator_from, states_from_numpy
from beast_mcmc_tpu_torch.inference import component_cache as cc
from beast_mcmc_tpu_torch.inference.mc3 import (
    make_mc3_runner,
    mc3_temperatures,
    replicate_state,
    swap_with,
)
from beast_mcmc_tpu_torch.inference.mcmc import (
    apply_derived,
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.operators import (
    TREE_HEIGHTS,
    RandomWalkOperator,
)
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    simulate_coalescent_tree,
)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,delta", [(4, 1.0), (6, 2.0), (5, 0.002)])
def test_temperatures_match_jax(n, delta):
    np.testing.assert_allclose(mc3_temperatures(n, delta).numpy(),
                               np.asarray(jax_temperatures(n, delta)),
                               rtol=1e-15)


def _swap_case():
    """The states of tests/test_mc3.py:69-101 in JAX and in the port."""
    parent = np.array([2, 2, -1])
    children = np.array([[-1, -1], [-1, -1], [0, 1]])
    tree0 = jax_tree_state(parent, children, np.array([0.0, 0.0, 1.0]), 2,
                           jnp.float64)

    def lp(params, tree):
        return -jnp.sum(params["x"] ** 2)

    state = jax_init_state({"x": jnp.asarray(1.0)}, tree0,
                           jax.random.PRNGKey(0), [], lp)
    states = jax_replicate(state, 4, jax.random.PRNGKey(1)).replace(
        log_posterior=jnp.asarray([-1.0, -2.0, -3.0, -4.0]),
        params={"x": jnp.asarray([1.0, 2.0, 3.0, 4.0])})
    port = states_from_numpy(jax.tree_util.tree_map(np.asarray, states),
                             torch.Generator(), device="cpu")
    return states, port


def test_swap_with_matches_jax_swap_states():
    """For PRNGKey(7) and 15 more keys: swap_with fed JAX's i, j and log u
    gives JAX's acceptance, params, tree and log posterior exactly; the
    operator statistics stay with their slot; both outcomes occur."""
    j_states, port = _swap_case()
    temps = jax_temperatures(4)
    t_temps = mc3_temperatures(4)
    port.op_accept = torch.arange(4)[:, None].expand(4, 1).clone()
    outcomes = set()
    for seed in [7, *range(100, 115)]:
        key = jax.random.PRNGKey(seed)
        ref, acc = jax_swap_states(j_states, temps, key)
        k1, k2, k3 = jax.random.split(key, 3)
        i = int(jax.random.randint(k1, (), 0, 4))
        j = (i + 1 + int(jax.random.randint(k2, (), 0, 3))) % 4
        log_u = math.log(float(jax.random.uniform(k3, dtype=jnp.float64)))
        got, t_acc = swap_with(port, t_temps, i, j, log_u)
        assert bool(t_acc) == bool(acc)
        outcomes.add(bool(acc))
        np.testing.assert_array_equal(got.params["x"].numpy(),
                                      np.asarray(ref.params["x"]))
        np.testing.assert_array_equal(got.log_posterior.numpy(),
                                      np.asarray(ref.log_posterior))
        np.testing.assert_array_equal(got.tree.heights.numpy(),
                                      np.asarray(ref.tree.heights))
        np.testing.assert_array_equal(got.op_accept[:, 0].numpy(),
                                      np.arange(4))
    assert outcomes == {True, False}


def _bimodal(params, tree):
    x = params["x"]
    return torch.logaddexp(-0.5 * (x - 2.0) ** 2 / 0.04,
                           -0.5 * (x + 2.0) ** 2 / 0.04)


def test_mc3_crosses_modes():
    """tests/test_mc3.py::test_mc3_crosses_modes at fewer steps, criterion
    unchanged: a single chain (4,000 steps) never leaves the mode it starts
    in; MC3 with 6 chains (delta 2, a swap every 20 steps, 400 rounds)
    swaps at a rate in (0.1, 1], its cold chain visits both modes, and
    occupies the positive one between 20% and 80% of the rounds. Each
    chain draws its own operator (one operator here)."""
    ops = [RandomWalkOperator(parameter="x", weight=1.0, window=1.0)]
    tree = make_tree_state(*simulate_coalescent_tree(
        np.random.default_rng(0), np.zeros(3), 1.0), dtype=F64, device="cpu")
    step = make_mcmc_step(_bimodal, ops)
    s0 = init_mcmc_state({"x": torch.tensor(2.0, dtype=F64)}, tree,
                         torch.Generator().manual_seed(0), ops, _bimodal)
    _, out = run_chain(step, s0, 4000, 20, lambda s: {"x": s.params["x"]})
    assert (out["x"].numpy() > 0).all()

    run, temps = make_mc3_runner(_bimodal, ops, n_chains=6, swap_every=20,
                                 delta=2.0)
    states = replicate_state(s0, 6, torch.Generator().manual_seed(1))
    states, outputs = run(states, torch.Generator().manual_seed(2), 400,
                          collector=lambda c: {"x": c.params["x"]})
    xs = outputs["x"].numpy()
    swap_rate = float(outputs["swap_accepted"].double().mean())
    assert 0.1 < swap_rate <= 1.0, swap_rate
    assert (xs > 0).any() and (xs < 0).any(), "cold chain never crossed"
    frac = (xs > 0).mean()
    assert 0.2 < frac < 0.8, frac
    np.testing.assert_allclose(temps.numpy(), 1.0 / (1.0 + 2.0 * np.arange(6)))


def test_mc3_evaluates_the_posterior_once_a_step(monkeypatch):
    """MC3 on build_analysis(10, 32): three chains, each its own operator
    draw; one chain-axis likelihood a step however many operators were
    drawn, the chains' operator counts differ, and every carried posterior
    equals a fresh evaluation within 1e-9."""
    log_post, ops, p0, t0, aux = build_analysis(10, 32, device="cpu")
    raw = {k: v for k, v in p0.items() if k not in aux["derived"]}
    s0 = init_mcmc_state(raw, t0, torch.Generator().manual_seed(3), ops,
                         log_post)
    states = replicate_state(s0, 3, torch.Generator().manual_seed(4))
    calls = []
    site = ttl._site_logliks

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return site(*a, **kw)

    monkeypatch.setattr(ttl, "_site_logliks", counted)
    run, _ = make_mc3_runner(aux["log_post_chains"], ops, 3, swap_every=6,
                             delta=0.01)
    states, out = run(states, torch.Generator().manual_seed(5), 4)
    assert calls == [(3, 19)] * 24
    drawn = (states.op_accept + states.op_reject).numpy()
    assert (drawn.sum(1) == 24).all() and not (drawn == drawn[0]).all()
    assert out["swap_accepted"].shape == (4,)
    fresh = aux["log_post_chains"](states.params, states.tree)
    np.testing.assert_allclose(fresh.numpy(), states.log_posterior.numpy(),
                               rtol=0, atol=1e-9)


def test_random_walk_operator_from_jax():
    op = operator_from(JaxRandomWalk(parameter="x", window=0.3, lower=-1.0,
                                     upper=2.0, reflect=True, weight=2.0))
    assert isinstance(op, RandomWalkOperator)
    assert (op.window, op.lower, op.upper, op.reflect, op.weight) == (
        0.3, -1.0, 2.0, True, 2.0)
    gen = torch.Generator().manual_seed(0)
    x = {"x": torch.tensor([0.5, 1.9], dtype=F64)}
    for _ in range(200):  # reflection keeps every proposal in bounds
        new, _, logh = op.propose(x, None, gen, torch.tensor(3.0, dtype=F64))
        assert float(logh) == 0.0
        assert bool(((new["x"] >= -1.0) & (new["x"] <= 2.0)).all())


def _jax_components(model, j_aux, n_taxa):
    lik = ((lambda p, t: j_aux["log_lik"](p, t, cached=True))
           if j_aux["derived"] else j_aux["log_lik"])
    return [(lik, "likelihood"),
            (lambda p, t: jcoal.constant_coalescent_loglik(
                t.heights, n_taxa, p["pop.size"]), "coalescent"),
            (lambda p, t: jpriors.one_on_x_logpdf(p["pop.size"]),
             "pop.size prior"),
            (lambda p, t: jpriors.lognormal_logpdf(p["clock.rate"], 0.0, 1.0),
             "clock.rate prior")]


@pytest.mark.parametrize("model", ["gtr_gamma", "hky", "hky_codon3"])
def test_trace_deps_and_affected_indices_match_jax(model):
    """Each component of build_analysis(12, 24): the port's traced
    dependencies equal JAX's jaxpr-sliced ones, and every operator's
    affected components equal JAX's, the operator taken as a tree move and
    as not."""
    _, j_ops, j_p0, j_t0, j_aux = jax_build_analysis(12, 24, model=model,
                                                     dtype=jnp.float64)
    _, ops, p0, t0, aux = build_analysis(12, 24, model=model, device="cpu")
    j_comps = jcc.make_components(_jax_components(model, j_aux, 12), j_p0,
                                  j_t0)
    comps = cc.make_components(aux["components"], p0, t0)
    assert [c.name for c in comps] == [c.name for c in j_comps]
    for c, jc in zip(comps, j_comps):
        assert (c.deps, c.uses_tree) == (jc.deps, jc.uses_tree), c.name
    assert [type(o).__name__ for o in ops] == [type(o).__name__
                                              for o in j_ops]
    for op, j_op in zip(ops, j_ops):
        for flag in (True, False):
            assert (cc.affected_indices(comps, op, flag)
                    == jcc.affected_indices(j_comps, j_op, flag))


def test_component_chain_carries_the_full_posterior():
    """A build_analysis(10, 32) chain with the derived cache and the
    component cache, tree operators flagged: 150 steps; the carried sum
    within 1e-9 of full_lp_fn on the rebuilt caches, and a pop.size scale
    refreshes no likelihood."""
    log_post, ops, p0, t0, aux = build_analysis(10, 32, device="cpu")
    comps = cc.make_components(aux["components"], p0, t0)
    flags = [op.modifies_params == () or TREE_HEIGHTS in (
        *getattr(op, "up", ()), *getattr(op, "down", ())) for op in ops]
    step = make_mcmc_step(log_post, ops, derived=aux["derived"],
                          components=comps, op_tree_flags=flags)
    pop = next(i for i, op in enumerate(ops)
               if getattr(op, "parameter", "") == "pop.size")
    assert step.refreshed[pop] == [1, 2]
    st = init_mcmc_state(cc.seed_components(p0, t0, comps), t0,
                         torch.Generator().manual_seed(6), ops,
                         cc.component_lp_fn(comps))
    st, _ = run_chain(step, st, 150)
    full = cc.full_lp_fn(comps)(apply_derived(aux["derived"], st.params),
                                st.tree)
    assert abs(float(full) - float(st.log_posterior)) < 1e-9
    assert sum(st.op_accept.tolist()) > 0

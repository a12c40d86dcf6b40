"""Chain-axis gradients of the port against jax.vmap(jax.grad) of the JAX
package.

A chain batch's posterior (aux["log_post_chains"] of build_analysis, [B])
is differentiable in every chain's heights and parameters: one forward of
the route's chain-axis peel with every chain's partials, and one level
adjoint for all B chains (ops/peeling.py::peel_adjoint_levels, the chains'
levels aligned at their roots). Held here, in float64 on the CPU, where
each route's wrapper takes its kernel's plain chain-axis version: B = 3
chains, each with its own tree and parameters from numpy seeds, against
jax.vmap(jax.grad(log_post)) of the JAX package's build_analysis with the
XLA scan peel, 1e-10 relative to each gradient's largest entry; the
resident, deep (one partition and benchmark1's three), matrix-product and
v1 streaming routes are forced as tests/test_torch_gradients.py forces
them. Kappa is left out at hky_codon3: JAX's gradient there goes through
a degenerate spectrum (ROADMAP reference caveat 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jax_build_analysis
from beast_mcmc_tpu.inference.mcmc import apply_derived as jax_apply_derived
from beast_mcmc_tpu.inference.state import init_state as jax_init_state
from beast_mcmc_tpu.tree.topology import make_tree_state as jax_tree_state

import beast_mcmc_tpu_torch.models.treelikelihood as ttl
from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.convert import states_from_numpy
from beast_mcmc_tpu_torch.ops import (
    cuda_mxu,
    cuda_peeling,
    cuda_stream,
    cuda_stream2,
)
from beast_mcmc_tpu_torch.ops import peeling as tpeel
from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

F64 = torch.float64
REL = 1e-10
B_N, N_TAXA, N_PATTERNS = 3, 14, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: small tensors under several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(model, seed):
    rng = np.random.default_rng(seed)
    p = {"clock.rate": rng.uniform(0.7, 1.3), "pop.size": rng.uniform(0.4, 1.0)}
    if model == "gtr_gamma":
        p.update({"gtr.rates": rng.uniform(0.3, 3.0, 6),
                  "alpha": rng.uniform(0.3, 2.0)})
    else:
        p["kappa"] = rng.uniform(1.5, 5.0, 3)
        mu = rng.uniform(0.5, 1.5, 3)
        p["mu"] = 3 * mu / mu.sum()
    return {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}


def _jax_batch(model, seed):
    """JAX's posterior and a vmapped state of B_N chains, each with its own
    tree and parameters, and the port's chain batch carried from it."""
    j_lp, j_ops, _, _, j_aux = jax_build_analysis(
        N_TAXA, N_PATTERNS, model=model, dtype=jnp.float64, use_pallas=False)
    states = []
    for b in range(B_N):
        tree = jax_tree_state(*simulate_coalescent_tree(
            np.random.default_rng(seed + b), np.zeros(N_TAXA), 0.5),
            dtype=jnp.float64)
        params = jax_apply_derived(j_aux["derived"],
                                   _jax_params(model, seed + b))
        states.append(jax_init_state(params, tree, jax.random.PRNGKey(b),
                                     len(j_ops), jnp.zeros(len(j_ops))))
    j_states = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    batch = states_from_numpy(jax.tree_util.tree_map(np.asarray, j_states),
                              torch.Generator(), device="cpu")
    return j_lp, j_states, batch


NAMES = {"gtr_gamma": ("clock.rate", "pop.size", "alpha", "gtr.rates"),
         "hky_codon3": ("clock.rate", "pop.size", "mu")}
PLAIN = {"resident": (cuda_peeling, "_resident_plain"),
         "deep": (cuda_stream2, "_deep_plain"),
         "mxu": (cuda_mxu, "_mxu_plain"),
         "stream": (cuda_stream, "_stream_plain")}


@pytest.mark.parametrize("model,route", [
    ("gtr_gamma", "resident"), ("gtr_gamma", "deep"), ("gtr_gamma", "mxu"),
    ("gtr_gamma", "stream"), ("hky_codon3", "deep")])
def test_chain_gradient_matches_jax_vmap_grad(monkeypatch, model, route):
    """The gradient of the sum of aux["log_post_chains"] over B_N chains in
    every chain's node heights and parameters, on the route forced here,
    against jax.vmap(jax.grad(log_post)); the route's plain chain-axis
    forward runs once a gradient, with autograd off, so the gradient is
    the level adjoint's."""
    monkeypatch.setattr(cuda_peeling, "peel_route", lambda *a: route)
    monkeypatch.setattr(ttl, "peel_route", lambda *a: route)
    mod, name = PLAIN[route]
    plain, calls = getattr(mod, name), []

    def counted(*a, **kw):
        # a chain-axis call (its per-chain recursion is not counted): the
        # schedule's or the matrices' leading chain axis
        lead = (a[2].dim() == 5 if route in ("mxu", "stream")
                else a[1].dim() == 3)
        if lead:
            calls.append(torch.is_grad_enabled())
        return plain(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    j_lp, j_states, batch = _jax_batch(model, 40 + len(route))
    names = NAMES[model]
    _, _, _, _, aux = build_analysis(N_TAXA, N_PATTERNS, model=model,
                                     device="cpu")
    leaves = [batch.tree.heights.clone().requires_grad_(True)] + [
        batch.params[n].clone().requires_grad_(True) for n in names]
    total = aux["log_post_chains"](
        {**batch.params, **dict(zip(names, leaves[1:]))},
        batch.tree.replace(heights=leaves[0]))
    assert total.shape == (B_N,)
    got = torch.autograd.grad(total.sum(), leaves)
    assert calls == [False]

    def f(params, tree, h, *xs):
        return j_lp({**params, **dict(zip(names, xs))},
                    tree.replace(heights=h))

    ref = jax.jit(jax.vmap(jax.grad(f, argnums=tuple(
        range(2, 2 + len(leaves))))))(
        j_states.params, j_states.tree, j_states.tree.heights,
        *[j_states.params[n] for n in names])
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        err = np.abs(g.numpy() - r).max()
        assert err <= REL * np.abs(r).max(), (err, np.abs(r).max())


@pytest.mark.parametrize("k_parts", [1, 3])
def test_adjoint_levels_of_b_trees_equal_each_trees(k_parts):
    """peel_adjoint_levels over B chains' trees (their level counts differ:
    the last a caterpillar) equals the adjoint of each tree on its own, to
    the last bit; schedule_levels puts the l-th level below every root in
    one step and ends at the roots."""
    rng = np.random.default_rng(5)
    n_taxa, c, s, p = 11, 2, 4, 6
    m = 2 * n_taxa - 1
    trees = [simulate_coalescent_tree(np.random.default_rng(60 + b),
                                      np.zeros(n_taxa), 1.0)
             for b in range(2)]
    parent, children = np.full(m, -1), np.full((m, 2), -1)
    for i in range(1, n_taxa):
        children[n_taxa + i - 1] = (n_taxa + i - 2 if i > 1 else 0, i)
        parent[children[n_taxa + i - 1]] = n_taxa + i - 1
    trees.append((parent, children, None, m - 1))
    ch = torch.tensor(np.stack([t[1] for t in trees]))
    sched = cuda_stream.level_schedule(ch, n_taxa)
    t = lambda x: torch.tensor(x, dtype=F64)  # noqa: E731
    tips = t((rng.random((k_parts, n_taxa, s, p)) > 0.5) * 0.9 + 0.1)
    pm = rng.random((3, k_parts, m, c, s, s)) + 0.05
    pm = t(pm / pm.sum(-1, keepdims=True))
    wcs = t(rng.dirichlet(np.ones(c * s), (3, k_parts)).reshape(
        3, k_parts, c, s))
    g = t(rng.random((3, k_parts, p)))
    pm_ord = cuda_stream2.chains_pm_ord(pm, sched[1])
    _, pos = cuda_stream2._deep_plain(tips, *sched[1:], pm_ord, wcs,
                                      want_post=True)
    post = tpeel.post_by_node(pos, tips, sched[0])
    d_p, d_wcs = tpeel.peel_adjoint_levels(post, g, pm, wcs, sched)
    levels = [int((sched[3][b] < n_taxa - 1).sum()) for b in range(3)]
    assert levels[2] == n_taxa - 1 and len(set(levels)) > 1
    roots, steps = tpeel.schedule_levels(sched, k_parts, m)
    assert len(steps) == max(levels)
    assert torch.equal(steps[0][0], roots)
    for b in range(3):
        one = slice(b, b + 1)  # the batch of one
        d_p1, d_wcs1 = tpeel.peel_adjoint_levels(
            post[one], g[one], pm[one], wcs[one], tuple(x[one] for x in sched))
        assert torch.equal(d_p[one], d_p1) and torch.equal(d_wcs[one],
                                                           d_wcs1)

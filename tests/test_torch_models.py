"""The port's models against the JAX package's, on the same numpy inputs.

JAX runs as tests/conftest.py sets it up (CPU, x64); the port runs on the
CPU in float64. Tolerance: atol 1e-10 unless stated (float64 functions of
the same arithmetic, summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import coalescent as jcoal
from beast_mcmc_tpu.models import priors as jpriors
from beast_mcmc_tpu.models import sitemodel as jsite
from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.models import treelikelihood as jtl
from beast_mcmc_tpu.ops import eigen as jeigen
from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.ops import special as jspecial
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models import coalescent as tcoal
from beast_mcmc_tpu_torch.models import priors as tpriors
from beast_mcmc_tpu_torch.models import sitemodel as tsite
from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.models import treelikelihood as ttl
from beast_mcmc_tpu_torch.ops import eigen as teigen
from beast_mcmc_tpu_torch.ops import peeling as tpeel
from beast_mcmc_tpu_torch.ops import special as tspecial

ATOL = 1e-10


def t64(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


def tl(x):
    return torch.tensor(np.array(x), dtype=torch.long)


def _tree(n_taxa, seed):
    rng = np.random.default_rng(seed)
    return simulate_coalescent_tree(rng, np.zeros(n_taxa), 1.0)


@pytest.mark.parametrize("alpha", [0.01, 0.137, 0.5, 5.0, 500.0])
def test_gamma_category_rates(alpha):
    ref_lq = jspecial.log_gamma_category_quantiles(jnp.asarray(alpha), 4)
    got_lq = tspecial.log_gamma_category_quantiles(t64(alpha), 4)
    np.testing.assert_allclose(got_lq.numpy(), np.asarray(ref_lq), atol=ATOL)
    r_ref, w_ref = jsite.discrete_gamma_rates(alpha, 4)
    r_got, w_got = tsite.discrete_gamma_rates(t64(alpha), 4)
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_ref), atol=ATOL)
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_ref), atol=ATOL)


def _random_model(seed):
    rng = np.random.default_rng(seed)
    rates6 = rng.uniform(0.2, 3.0, 6)
    freqs = rng.dirichlet(np.full(4, 5.0))
    return rates6, freqs


@pytest.mark.parametrize("seed", [0, 1])
def test_gtr_transition_probs(seed):
    """Compared on P, not on eigenvectors (their signs may differ)."""
    rates6, freqs = _random_model(seed)
    t = np.array([0.0, 1e-4, 0.01, 0.3, 1.0, 10.0])
    p_ref = jeigen.transition_probs(
        jsub.gtr_eigen(jnp.asarray(rates6), jnp.asarray(freqs)),
        jnp.asarray(t))
    p_got = teigen.transition_probs(tsub.gtr_eigen(t64(rates6), t64(freqs)),
                                    t64(t))
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), atol=ATOL)
    np.testing.assert_allclose(p_got.sum(-1).numpy(), 1.0, atol=ATOL)


def test_hky_and_jc_transition_probs():
    _, freqs = _random_model(3)
    t = np.array([0.05, 0.5, 2.0])
    p_ref = jeigen.transition_probs(
        jsub.hky_eigen(4.0, jnp.asarray(freqs)), jnp.asarray(t))
    p_got = teigen.transition_probs(tsub.hky_eigen(4.0, t64(freqs)), t64(t))
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), atol=ATOL)
    p_ref = jeigen.transition_probs(jsub.jc_eigen(), jnp.asarray(t))
    p_got = teigen.transition_probs(tsub.jc_eigen(device="cpu"), t64(t))
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), atol=ATOL)


def test_branch_transition_matrices():
    parent, children, heights, root = _tree(10, 4)
    rates6, freqs = _random_model(4)
    cat_rates = np.asarray(jsite.discrete_gamma_rates(0.7, 4)[0])
    ref = jtl.branch_transition_matrices(
        jsub.gtr_eigen(jnp.asarray(rates6), jnp.asarray(freqs)),
        jnp.asarray(parent), jnp.asarray(heights), 0.8, jnp.asarray(cat_rates))
    got = ttl.branch_transition_matrices(
        tsub.gtr_eigen(t64(rates6), t64(freqs)), tl(parent), t64(heights),
        0.8, t64(cat_rates))
    assert got.shape == (19, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("tie", [False, True])
def test_peel_order_from_heights(tie):
    parent, children, heights, root = _tree(12, 5)
    if tie:
        # a zero-length internal branch: the height sort alone is ambiguous
        node = next(i for i in range(12, 23) if i != root)
        heights = heights.copy()
        heights[node] = heights[parent[node]]
    for with_parent in (True, False):
        ref = jpeel.peel_order_from_heights(
            jnp.asarray(heights), 12,
            jnp.asarray(parent) if with_parent else None)
        got = tpeel.peel_order_from_heights(
            t64(heights), 12, tl(parent) if with_parent else None)
        if with_parent or not tie:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # child before parent in the port's order, tie or not
    pos = {int(n): i for i, n in enumerate(got.tolist())}
    for n in range(12, 23):
        if parent[n] >= 0:
            assert pos[n] < pos[int(parent[n])]


@pytest.mark.parametrize("pop_size", [0.3, 2.0])
def test_constant_coalescent_loglik(pop_size):
    tip_heights = np.array([0.0, 0.0, 0.1, 0.0, 0.4, 0.0, 0.0, 0.25])
    rng = np.random.default_rng(6)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, tip_heights, 1.0)
    ref = jcoal.constant_coalescent_loglik(jnp.asarray(heights), 8, pop_size)
    got = tcoal.constant_coalescent_loglik(t64(heights), 8, pop_size)
    np.testing.assert_allclose(float(got), float(ref), atol=ATOL)


@pytest.mark.parametrize("x", [0.3, 1.0, 2.5, -1.0])
def test_priors(x):
    ref = jpriors.lognormal_logpdf(jnp.asarray(x), 0.0, 1.0)
    got = tpriors.lognormal_logpdf(t64(x), 0.0, 1.0)
    np.testing.assert_allclose(float(got), float(ref), atol=ATOL)
    ref = jpriors.one_on_x_logpdf(jnp.asarray(x))
    got = tpriors.one_on_x_logpdf(t64(x))
    np.testing.assert_allclose(float(got), float(ref), atol=ATOL)

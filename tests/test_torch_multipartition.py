"""The port's multipartition likelihood and hky_codon3 analysis against the
JAX package's, on the same numpy inputs.

JAX runs as tests/conftest.py sets it up (CPU, x64) with the scan peel
(use_pallas=False); the port runs on the CPU in float64 with its plain
peel. Likelihoods are held at rtol 1e-10 and transition matrices at rtol
1e-12 (float64, the same arithmetic summed in other orders; eigenvectors
may differ in sign and order, so they are never compared). The chain is
held to the reference's 0.1 full-evaluation check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jax_build_analysis
from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.models import treelikelihood as jtl
from beast_mcmc_tpu.ops import eigen as jeigen
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.convert import params_from_numpy, tree_from_numpy
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_mcmc_step,
    operator_report,
    run_chain,
)
from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.models import treelikelihood as ttl
from beast_mcmc_tpu_torch.ops import eigen as teigen

from test_mcmc import check_tree_valid

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


def tl(x):
    return torch.tensor(np.array(x), dtype=torch.long)


def _partitions(k_parts, n_taxa, c, p, seed):
    """K nucleotide partitions on one tree: numpy tips [K,N,4,P] (partly
    ambiguous), weights [K,P], kappa, freqs [K,4], category rates and
    weights [K,C], and the tree."""
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    tips = (rng.random((k_parts, n_taxa, 4, p)) > 0.6) * 0.9 + 0.1
    weights = rng.integers(1, 9, size=(k_parts, p)).astype(np.float64)
    kappa = rng.uniform(1.0, 6.0, k_parts)
    freqs = rng.dirichlet(np.full(4, 5.0), size=k_parts)
    cat_rates = rng.uniform(0.3, 2.0, (k_parts, c))
    cat_w = rng.dirichlet(np.full(c, 3.0), size=k_parts)
    return (tips, weights, kappa, freqs, cat_rates, cat_w,
            (parent, children, heights, root))


def test_batched_hky_transition_probs():
    """hky_eigen over a leading K axis is one eigh call; P(t) agrees with
    jax.vmap(hky_eigen) and with the port's own unbatched systems."""
    _, _, kappa, freqs, *_ = _partitions(3, 5, 2, 8, seed=0)
    t = np.array([[0.0, 1e-4, 0.3], [0.01, 1.0, 10.0], [0.5, 2.0, 4.0]])
    j_eigs = jax.vmap(jsub.hky_eigen)(jnp.asarray(kappa), jnp.asarray(freqs))
    ref = jax.vmap(jeigen.transition_probs)(j_eigs, jnp.asarray(t))
    eigs = tsub.hky_eigen(t64(kappa), t64(freqs))
    assert eigs.values.shape == (3, 4) and eigs.U.shape == (3, 4, 4)
    got = teigen.transition_probs(eigs, t64(t))
    assert got.shape == (3, 3, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-15)
    for k in range(3):
        one = teigen.transition_probs(
            tsub.hky_eigen(float(kappa[k]), t64(freqs[k])), t64(t[k]))
        np.testing.assert_allclose(got[k].numpy(), one.numpy(), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("k_parts,n_taxa,c,p", [(3, 9, 1, 40), (2, 17, 4, 33)])
def test_multipartition_loglikelihood(k_parts, n_taxa, c, p):
    tips, w, kappa, freqs, cat_rates, cat_w, tree = _partitions(
        k_parts, n_taxa, c, p, seed=1)
    parent, children, heights, root = tree
    j_eigs = jax.vmap(jsub.hky_eigen)(jnp.asarray(kappa), jnp.asarray(freqs))
    ref = jtl.multipartition_loglikelihood(
        jnp.asarray(tips), jnp.asarray(w), jnp.asarray(parent),
        jnp.asarray(children), jnp.asarray(heights), root, j_eigs,
        jnp.asarray(freqs), jnp.asarray(cat_rates), jnp.asarray(cat_w), 0.7,
        use_pallas=False)
    eigs = tsub.hky_eigen(t64(kappa), t64(freqs))
    args = (tl(parent), tl(children), t64(heights), tl(root))
    got = ttl.multipartition_loglikelihood(
        t64(tips), t64(w), *args, eigs, t64(freqs), t64(cat_rates),
        t64(cat_w), 0.7)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    # the sum of the K single-partition likelihoods
    parts = sum(float(ttl.tree_loglikelihood(
        t64(tips[k]), t64(w[k]), *args,
        tsub.hky_eigen(float(kappa[k]), t64(freqs[k])), t64(freqs[k]),
        t64(cat_rates[k]), t64(cat_w[k]), 0.7)) for k in range(k_parts))
    np.testing.assert_allclose(float(got), parts, rtol=1e-12)


def test_tree_site_logliks_and_ascertainment():
    tips, w, kappa, freqs, cat_rates, cat_w, tree = _partitions(
        1, 11, 4, 50, seed=2)
    parent, children, heights, root = tree
    j_eig = jsub.hky_eigen(kappa[0], jnp.asarray(freqs[0]))
    ref = jtl.tree_site_logliks(
        jnp.asarray(tips[0]), jnp.asarray(parent), jnp.asarray(children),
        jnp.asarray(heights), root, j_eig, jnp.asarray(freqs[0]),
        jnp.asarray(cat_rates[0]), jnp.asarray(cat_w[0]), 1.3)
    eig = tsub.hky_eigen(float(kappa[0]), t64(freqs[0]))
    got = ttl.tree_site_logliks(
        t64(tips[0]), tl(parent), tl(children), t64(heights), tl(root), eig,
        t64(freqs[0]), t64(cat_rates[0]), t64(cat_w[0]), 1.3)
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    # the last 4 patterns stand for the excluded ones; shifted down so that
    # their probabilities sum below 1
    data, excl = np.asarray(ref)[:46], np.asarray(ref)[46:] - 3.0
    ref_corr = jtl.ascertainment_correction(jnp.asarray(excl))
    got_corr = ttl.ascertainment_correction(t64(excl))
    assert np.isfinite(float(ref_corr))
    np.testing.assert_allclose(float(got_corr), float(ref_corr), rtol=RTOL)
    ref_asc = jtl.ascertained_loglik(jnp.asarray(data), jnp.asarray(w[0, :46]),
                                     jnp.asarray(excl))
    got_asc = ttl.ascertained_loglik(got[:46], t64(w[0, :46]), got[46:] - 3.0)
    assert got_asc.dtype == torch.float64
    np.testing.assert_allclose(float(got_asc), float(ref_asc), rtol=RTOL)


@pytest.mark.parametrize("n_taxa,c,s,p", [(9, 2, 4, 40), (7, 1, 20, 21)])
def test_tree_loglikelihood_pmats(n_taxa, c, s, p):
    """Branch matrices built by the caller, any state count."""
    rng = np.random.default_rng(3)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    tips = (rng.random((n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    pm = rng.random((2 * n_taxa - 1, c, s, s)) * 0.2 + 0.01
    pm = pm / pm.sum(-1, keepdims=True)
    w = rng.integers(1, 5, size=p).astype(np.float64)
    freqs = rng.dirichlet(np.full(s, 5.0))
    cw = np.full(c, 1.0 / c)
    ref = jtl.tree_loglikelihood_pmats(
        jnp.asarray(tips), jnp.asarray(w), jnp.asarray(children),
        jnp.asarray(heights), root, jnp.asarray(parent), jnp.asarray(pm),
        jnp.asarray(freqs), jnp.asarray(cw))
    got = ttl.tree_loglikelihood_pmats(
        t64(tips), t64(w), tl(children), t64(heights), tl(root), tl(parent),
        t64(pm), t64(freqs), t64(cw))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def _to_numpy(tree_like):
    return jax.tree_util.tree_map(np.asarray, tree_like)


def test_hky_codon3_analysis_matches_jax():
    """One seed gives both packages the same tips and weights; convert.py
    carries JAX's [K]-shaped parameters and tree, and the log posteriors
    agree."""
    j_lp, j_ops, j_p0, j_tree, j_aux = jax_build_analysis(
        9, 40, model="hky_codon3", seed=4, dtype=jnp.float64,
        use_pallas=False)
    t_lp, t_ops, t_p0, t_tree, t_aux = build_analysis(
        9, 40, model="hky_codon3", seed=4, device="cpu")
    assert t_aux["tips"].shape == (3, 9, 4, 128)
    np.testing.assert_array_equal(t_aux["tips"].numpy(),
                                  np.asarray(j_aux["tips"]))
    np.testing.assert_array_equal(t_aux["weights"].numpy(),
                                  np.asarray(j_aux["weights"]))
    assert [type(o).__name__ for o in t_ops] == [
        type(o).__name__ for o in j_ops]
    assert [o.weight for o in t_ops] == [o.weight for o in j_ops]
    assert t_aux["derived"] == {} and t_aux["log_post_cached"] is t_lp
    tree = tree_from_numpy(*(np.asarray(x) for x in (
        j_tree.parent, j_tree.children, j_tree.heights, j_tree.root)),
        device="cpu")
    rng = np.random.default_rng(5)
    moved = {"kappa": jnp.asarray(rng.uniform(1.0, 5.0, 3)),
             "mu": jnp.asarray([0.6, 1.1, 1.3]),
             "clock.rate": jnp.asarray(0.9), "pop.size": jnp.asarray(0.7)}
    for j_params in (j_p0, moved):
        params = params_from_numpy(_to_numpy(j_params), device="cpu")
        assert params["kappa"].shape == (3,) and params["mu"].shape == (3,)
        assert params["kappa"].dtype == torch.float64
        ref = float(jax.jit(j_lp)(j_params, j_tree))
        got = t_lp(params, tree)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(float(got), ref, rtol=RTOL)
    # the port's own start values are JAX's
    for name, v in t_p0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_p0[name]))


def test_hky_codon3_chain_runs_and_self_checks():
    """200 steps of the three-partition chain on the CPU: finite, every
    operator tried, the chain moved, and the carried posterior agrees with
    fresh evaluations within the reference's 0.1 (MarkovChain.java:55)."""
    log_post, ops, params0, tree0, aux = build_analysis(
        8, 48, model="hky_codon3", device="cpu")
    step = make_mcmc_step(log_post, ops, derived=aux["derived"])
    state = init_mcmc_state(params0, tree0, torch.Generator().manual_seed(3),
                            ops, log_post)
    lp0 = float(state.log_posterior)
    assert np.isfinite(lp0)
    state, _ = run_chain(step, state, 200)
    report = operator_report(ops, state)
    assert bool(torch.isfinite(state.log_posterior)), report
    assert float(state.log_posterior) != lp0, report
    tried = (state.op_accept + state.op_reject).tolist()
    assert sum(tried) == 200 and min(tried) > 0, report
    assert not torch.equal(state.params["kappa"], params0["kappa"]), report
    assert not torch.equal(state.params["mu"], params0["mu"]), report
    np.testing.assert_allclose(float(state.params["mu"].sum()), 3.0,
                               rtol=1e-12)
    state, dev = full_evaluation_check(step, log_post, state, 50)
    assert float(dev) < 0.1, report
    check_tree_valid(state.tree.parent.numpy(), state.tree.children.numpy(),
                     state.tree.heights.numpy(), int(state.tree.root), 8)

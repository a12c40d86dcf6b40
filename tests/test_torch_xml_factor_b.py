"""The port's config/xml_factor.py against the JAX package's, part b: the
Gibbs operators and the tree tables.

The operators of part a's documents (the loadings rows, the tips'
factors, the loadings scale, the multiplicative-gamma multipliers)
propose JAX's state from the same injected draws (tests/
test_torch_gibbs_ext.py::_inject; 1e-9 relative: the factor draw's M^-1
is a Cholesky inverse here, JAX's an LU one). The streams differ, so each
operator's law is then held by Monte Carlo: its draws' mean and
covariance against the closed-form conditional (the loadings' and the
scale's conditional_np, the tips' factors' factor_posterior_np, the
first multiplier's gamma, the liability sweep's first entry's truncated
normal) within 5 standard errors. The factor draw's mean and covariance
equal JAX's factor_posterior_np to 1e-10; the MRCA table (by ancestor
bitsets and one matrix product) and the tree variance equal JAX's on
random, caterpillar and balanced trees.
"""

import types

import jax
import numpy as np
import pytest
import torch
from scipy.special import ndtr
from scipy.stats import norm

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config import xml_factor as jfactor
from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config import xml_factor

from test_torch_gibbs_ext import _inject
from test_torch_interpreter import _setup
from test_torch_xml_factor_a import DOCS

N_DRAWS = 2000
Z = 5.0  # standard errors a Monte Carlo check allows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operators(mod, path):
    _, _, ops, _, params, tree = _setup(mod, path, None if mod is jinterp
                                        else "cpu")
    return {type(o).__name__: o for o in ops}, params, tree


@pytest.mark.parametrize("doc,cls,normal_shapes,n_gammas", [
    ("latent_factor_gibbs", "LoadingsGibbsOperator", [(4, 2)], 0),
    ("latent_factor_upper_triangular_scaled_data", "LoadingsGibbsOperator",
     [(4, 2)], 0),
    ("integrated_hmc_shrinkage", "FactorTreeGibbsOperator", [(12,)], 0),
    ("integrated_standardized", "FactorTreeGibbsOperator", [(12,)], 0),
    ("scaled_loadings", "LoadingsScaleGibbsOperator", [(2,)], 0),
    ("integrated_hmc_shrinkage", "MultiplicativeGammaGibbsOperator", [], 2),
])
def test_gibbs_operators_match_jax_at_injected_draws(
        doc, cls, normal_shapes, n_gammas, tmp_path, monkeypatch):
    path = tmp_path / "doc.xml"
    path.write_text(DOCS[doc])
    jops, jp, jt = _operators(jinterp, str(path))
    ops, tp, tt = _operators(interp, str(path))
    rng = np.random.default_rng(7)
    normals = [rng.normal(size=s) for s in normal_shapes]
    gammas = [np.asarray(rng.gamma(3.0)) for _ in range(n_gammas)]
    _inject(monkeypatch, normals, gammas, [])
    j_out, _, jh = jops[cls].propose(jp, jt, jax.random.PRNGKey(0), None)
    t_out, _, th = ops[cls].propose(tp, tt, None, None)
    for k in jp:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    assert float(th) == float(jh) == float("inf")


def _draws(op, params, tree, names, n=N_DRAWS, seed=3):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        p2 = op.propose(params, tree, gen, None)[0]
        out.append(np.concatenate([p2[nm].reshape(-1).numpy()
                                   for nm in names]))
    return np.array(out)


def _check_moments(x, mean, cov):
    """Sample mean and covariance of draws x [N, d] within Z standard
    errors of (mean, cov)."""
    n = x.shape[0]
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(x.mean(0) - mean) <= Z * sd / np.sqrt(n) + 1e-12)
    c_hat = np.cov(x, rowvar=False)
    se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / n)
    assert np.all(np.abs(c_hat - cov) <= Z * se + 1e-12)


def _built(doc, tmp_path):
    path = tmp_path / "doc.xml"
    path.write_text(DOCS[doc])
    ax, _, ops, _, params, tree = _setup(interp, str(path), "cpu")
    return ax, {type(o).__name__: o for o in ops}, params, tree


@pytest.mark.parametrize("doc", ["latent_factor_gibbs",
                                 "latent_factor_upper_triangular_scaled_data"])
def test_loadings_draws_follow_their_conditional(doc, tmp_path):
    """Each row's draws (trait i: its K loadings, the upper-triangular
    rows only their free entries) against conditional_np."""
    ax, ops, params, tree = _built(doc, tmp_path)
    op = ops["LoadingsGibbsOperator"]
    mean, cov = op.conditional_np(params)
    x = _draws(op, params, tree, op.lfm.loadings.names)  # column-major
    p, k = op.lfm.p, op.lfm.k
    rows = x.reshape(-1, k, p).transpose(0, 2, 1)
    free = op._dim_mask() > 0
    for i in range(p):
        f = free[i]
        _check_moments(rows[:, i, f], mean[i, f], cov[i][np.ix_(f, f)])


@pytest.mark.parametrize("doc", ["integrated_hmc_shrinkage",
                                 "integrated_standardized"])
def test_factor_draw_equals_jax_factor_posterior(doc, tmp_path):
    """The tips' factors: the operator's conditional mean and covariance
    (the inverse of its precision) equal JAX's factor_posterior_np over
    JAX's tree_variance_np to 1e-10, and its draws follow them."""
    path = tmp_path / "doc.xml"
    path.write_text(DOCS[doc])
    jax_ax = jinterp.XmlAnalysis(str(path), seed=17)  # _setup's seed
    for eid in ("treeModel", "traitLik"):
        jax_ax.build(jax_ax._ids[eid])
    ax, ops, params, tree = _built(doc, tmp_path)
    op = ops["FactorTreeGibbsOperator"]
    P, _, mean, ok = op.moments(params, tree)
    assert bool(ok)
    fm = jax_ax.build(jax_ax._ids["factors"])
    meta = jax_ax._traits[(fm.tree_id, fm.trait_name)]
    n, p = meta["n_tips"], meta["dim"]
    Y = np.asarray(jax_ax.value_of(fm.trait_param), float).reshape(n, p)
    missing = np.asarray(meta["missing"], bool)
    if op.scale_mu is not None:
        Y = (Y - op.scale_mu) / op.scale_sd
    L_kp = np.stack([np.asarray(jax_ax.value_of(c), float)
                     for c in fm.loadings.names])
    lam = np.asarray(jax_ax.value_of(fm.precision), float)
    M = jfactor.tree_variance_np(jax_ax._trees[fm.tree_id], op.pss)
    mu, sig = jfactor.factor_posterior_np(M, np.eye(op.k), L_kp, lam, Y,
                                          missing)
    cov = np.linalg.inv(P.numpy())
    np.testing.assert_allclose(mean.numpy(), mu, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov, sig, rtol=1e-10, atol=1e-12)
    _check_moments(_draws(op, params, tree, [op.factors_param]), mu, sig)


def test_scale_draws_follow_their_conditional(tmp_path):
    ax, ops, params, tree = _built("scaled_loadings", tmp_path)
    op = ops["LoadingsScaleGibbsOperator"]
    mean, cov = op.conditional_np(params)
    _check_moments(_draws(op, params, tree, [op.scale_name]), mean, cov)


def test_multiplicative_gamma_first_draw_follows_its_gamma(tmp_path):
    """delta_1 ~ Gamma(a0 + p k / 2, rate0 + rate_1 / 2), rate_1 the
    provider's (JAX's stats_np) at the current state."""
    ax, ops, params, tree = _built("integrated_hmc_shrinkage", tmp_path)
    op = ops["MultiplicativeGammaGibbsOperator"]
    pr = op.provider
    counts, rates = pr.stats_np(ax.inject_derived(params))
    shape = op.prior_shape + 0.5 * counts[0]
    rate = op.prior_rate + 0.5 * rates[0]
    x = _draws(op, params, tree, [pr.mult_names[0]])
    _check_moments(x, np.array([shape / rate]),
                   np.array([[shape / rate ** 2]]))


def test_liability_sweep_first_entry_is_its_truncated_normal(tmp_path):
    """The sweep's first latent entry is drawn from the truncated normal
    N(m, s) on its datum's interval, m and s from the joint precision at
    the current tips; every drawn entry lies in its interval."""
    ax, ops, params, tree = _built("extended_liability", tmp_path)
    op = ops["ExtendedLatentLiabilityGibbsOperator"]
    P = op.precision.numpy()
    flat = params[op.tip_param].reshape(-1).numpy()
    i, j = op.entries[0]
    k = i * op.d + j
    m = flat[k] - (P[k] @ flat) / P[k, k]
    s = 1.0 / np.sqrt(P[k, k])
    a, b = (op.lo[i, j] - m) / s, (op.hi[i, j] - m) / s
    z = ndtr(b) - ndtr(a)
    t_mean = m + s * (norm.pdf(a) - norm.pdf(b)) / z
    fa = 0.0 if np.isinf(a) else a * norm.pdf(a)
    fb = 0.0 if np.isinf(b) else b * norm.pdf(b)
    t_var = s * s * (1 + (fa - fb) / z
                     - ((norm.pdf(a) - norm.pdf(b)) / z) ** 2)
    x = _draws(op, params, tree, [op.tip_param], n=1500)
    _check_moments(x[:, k:k + 1], np.array([t_mean]), np.array([[t_var]]))
    for e, (ii, jj) in enumerate(op.entries):
        col = x[:, ii * op.d + jj]
        assert np.all(col >= op.lo[ii, jj]) and np.all(col <= op.hi[ii, jj])


def _random_tree(n, rng, kind="random"):
    """(parent, children, heights, root) of an n-tip tree: random
    coalescence, a caterpillar or a balanced one."""
    m = 2 * n - 1
    parent = np.full(m, -1)
    children = np.full((m, 2), -1)
    heights = np.zeros(m)
    live = list(range(n))
    for node in range(n, m):
        if kind == "caterpillar":
            a, b = live.pop(0), live.pop(0)
        elif kind == "balanced":
            a, b = live.pop(0), live.pop(0)
            live.append(node)
        else:
            a, b = (live.pop(int(rng.integers(len(live)))) for _ in range(2))
        if kind != "balanced":
            live.insert(0 if kind == "caterpillar" else len(live), node)
        parent[[a, b]] = node
        children[node] = (a, b)
        heights[node] = max(heights[a], heights[b]) + rng.uniform(0.1, 1.0)
    return parent, children, heights, m - 1


@pytest.mark.parametrize("n,kind,seed", [(2, "random", 0), (7, "random", 1),
                                         (23, "random", 2),
                                         (40, "caterpillar", 3),
                                         (32, "balanced", 4),
                                         (61, "random", 5)])
def test_mrca_table_and_tree_variance_equal_jax(n, kind, seed):
    rng = np.random.default_rng(seed)
    parent, children, heights, root = _random_tree(n, rng, kind)
    tm = types.SimpleNamespace(parent=parent, children=children,
                               heights=heights, root=root)
    want = jfactor._mrca_table(tm)
    np.testing.assert_array_equal(xml_factor._mrca_table(tm), want)
    np.testing.assert_array_equal(
        xml_factor.mrca_table(parent, children, root, n).numpy(), want)
    for pss in (np.inf, 0.5):
        np.testing.assert_allclose(xml_factor.tree_variance_np(tm, pss),
                                   jfactor.tree_variance_np(tm, pss),
                                   rtol=1e-12, atol=1e-12)

"""The port's models/factor.py and models/liability.py against the JAX
package's.

Every function of models/factor.py on coalescent trees of 6 to 40 taxa,
the same float64 inputs through both, to 1e-10 relative: the factor-scale
tip potentials (diagonal and full residual covariance, missing entries),
the integrated factor likelihood, the canonical propagation with and
without exact (delta) tip observations and extra tip noise, the delta push
batched against jax.vmap, the dense oracle covariance and the host-side
long-double oracle (numpy in both). The cases of tests/test_factor.py
(the dense multivariate normal oracle, the loadings gradient) and
tests/test_msc_dollo_liability.py::test_liability_consistency are cases
here too, and the liability density is held against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

from beast_mcmc_tpu.models import factor as jf
from beast_mcmc_tpu.models import liability as jli

from beast_mcmc_tpu_torch.models import factor as tf
from beast_mcmc_tpu_torch.models import liability as tli
from beast_mcmc_tpu_torch.models.continuous import brownian_tip_covariance

from test_torch_continuous import spd, tree

REL = 1e-10
SIZES = (6, 17, 40)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rel=REL, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=rel, atol=atol)


def setup(n, k=2, p=4, seed=0):
    parent, children, heights, root, rng = tree(n, seed)
    return (parent, children, heights, root, rng.normal(size=(k, p)),
            rng.uniform(0.5, 3.0, p), rng.normal(size=(n, p)),
            rng.normal(size=k), rng)


def J(*a):
    return [jnp.asarray(np.asarray(x)) for x in a]


def T(*a):
    return [torch.as_tensor(np.asarray(x)) for x in a]


@pytest.mark.parametrize("n", SIZES)
def test_potentials_and_integrated_factor_match_jax(n):
    parent, children, heights, root, load, gam, data, mean0, rng = setup(
        n, seed=n)
    miss = rng.uniform(size=data.shape) < 0.3
    for got, want in zip(tf.factor_tip_potentials(*T(data, miss, load, gam)),
                         jf.factor_tip_potentials(*J(data, miss, load, gam))):
        close(got, want)
    noise = spd(4, rng)
    for got, want in zip(
            tf.factor_tip_potentials_cov(*T(data, miss, load, noise)),
            jf.factor_tip_potentials_cov(*J(data, miss, load, noise))):
        close(got, want)
    lam, scal = spd(2, rng), rng.uniform(0.5, 2.0, 2 * n - 1)
    tr = (parent, children, heights)
    for fp in (None, lam):
        kw_t = {} if fp is None else {"factor_precision": T(fp)[0]}
        kw_j = {} if fp is None else {"factor_precision": J(fp)[0]}
        close(tf.integrated_factor_loglikelihood(
            *T(data, miss, *tr), root, *T(load, gam), branch_rate_scalars=
            T(scal)[0], root_prior_mean=T(mean0)[0],
            root_prior_sample_size=1.7, **kw_t),
            jf.integrated_factor_loglikelihood(
                *J(data, miss, *tr), root, *J(load, gam), branch_rate_scalars=
                J(scal)[0], root_prior_mean=J(mean0)[0],
                root_prior_sample_size=1.7, **kw_j))


@pytest.mark.parametrize("n", SIZES)
def test_canonical_propagation_with_delta_tips_matches_jax(n):
    parent, children, heights, root, rng = tree(n, 50 + n)
    k = 3
    p0 = np.stack([spd(k, rng) * 0.3 for _ in range(n)])
    b0, g0 = rng.normal(size=(n, k)), rng.normal(size=n)
    lam_inv = np.linalg.inv(spd(k, rng))
    dmask = rng.uniform(size=(n, k)) < 0.4
    dvals = rng.normal(size=(n, k))
    extra = np.stack([np.diag(rng.uniform(0.1, 0.5, k)) for _ in range(n)])
    tr = (parent, children, heights)
    cases = [{}, {"tip_delta_mask": dmask, "tip_delta_values": dvals},
             {"tip_delta_mask": dmask, "tip_delta_values": dvals,
              "tip_cov_extra": extra}]
    for kw in cases:
        got = tf.canonical_bp_loglikelihood(
            *T(p0, b0, g0, *tr), root, T(lam_inv)[0],
            root_prior_mean=T(b0[0])[0], root_prior_sample_size=2.0,
            **{key: T(v)[0] for key, v in kw.items()})
        want = jf.canonical_bp_loglikelihood(
            *J(p0, b0, g0, *tr), root, J(lam_inv)[0],
            root_prior_mean=J(b0[0])[0], root_prior_sample_size=2.0,
            **{key: J(v)[0] for key, v in kw.items()})
        close(got, want)
    # the long-double oracle is the same numpy in both packages
    want = jf.canonical_bp_loglikelihood_np(
        p0, b0, g0, *tr, root, lam_inv, b0[0], 2.0, dmask, dvals)
    assert tf.canonical_bp_loglikelihood_np(
        p0, b0, g0, *tr, root, lam_inv, b0[0], 2.0, dmask, dvals) == want
    close(tf.canonical_bp_loglikelihood(
        *T(p0, b0, g0, *tr), root, T(lam_inv)[0], root_prior_mean=T(b0[0])[0],
        root_prior_sample_size=2.0, tip_delta_mask=T(dmask)[0],
        tip_delta_values=T(dvals)[0]), want, rel=1e-9)


def test_push_canonical_delta_batched_matches_jax_vmap():
    rng = np.random.default_rng(3)
    k, b_n = 3, 6
    p = np.stack([spd(k, rng) for _ in range(b_n)])
    b, g, t = rng.normal(size=(b_n, k)), rng.normal(size=b_n), \
        rng.uniform(0.1, 1.0, b_n)
    o, y = rng.uniform(size=(b_n, k)) < 0.5, rng.normal(size=(b_n, k))
    lam_inv, eye = np.linalg.inv(spd(k, rng)), np.eye(k)
    extra = np.stack([spd(k, rng) * 0.1 for _ in range(b_n)])
    want = jax.vmap(lambda *a: jf._push_canonical_delta(
        *a[:5], a[5], jnp.asarray(lam_inv), jnp.asarray(eye), a[6]))(
        *J(p, b, g, o, y, t, extra))
    got = tf._push_canonical_delta(*T(p, b, g, o, y, t, lam_inv, eye, extra))
    for x, w in zip(got, want):
        close(x, w)


def test_factor_marginal_mvn_matches_jax():
    parent, children, heights, root, load, gam, data, mean0, rng = setup(
        7, seed=2)
    cov = brownian_tip_covariance(parent, children, heights, root, 7,
                                  root_prior_sample_size=2.0)
    sig = spd(2, rng)
    close(tf.factor_marginal_mvn(*T(cov, load, gam)),
          jf.factor_marginal_mvn(*J(cov, load, gam)))
    close(tf.factor_marginal_mvn(*T(cov, load, gam, sig)),
          jf.factor_marginal_mvn(*J(cov, load, gam, sig)))


def _oracle(parent, children, heights, root, n, loadings, gamma, data,
            mean0, k0, lam, missing):
    sig_tree = brownian_tip_covariance(
        parent, children, heights, root, n, root_prior_sample_size=k0)
    lsl = loadings.T @ np.linalg.inv(lam) @ loadings
    cov = np.kron(sig_tree, lsl) + np.kron(np.eye(n), np.diag(1.0 / gamma))
    mean = np.tile(loadings.T @ mean0, n)
    keep = ~missing.reshape(-1)
    return multivariate_normal.logpdf(
        data.reshape(-1)[keep], mean[keep], cov[np.ix_(keep, keep)])


@pytest.mark.parametrize("n,k,p,with_missing", [(6, 2, 4, False),
                                                 (17, 3, 4, True),
                                                 (40, 2, 5, True)])
def test_factor_loglik_matches_dense_oracle(n, k, p, with_missing):
    """tests/test_factor.py's dense oracle: the integrated marginal is the
    multivariate normal of vec(data) with L^T Sigma_f L (x) the tree
    covariance plus the residual noise."""
    parent, children, heights, root, load, gam, data, mean0, rng = setup(
        n, k, p, seed=70 + n)
    lam = spd(k, rng) * 0.4 if with_missing else np.eye(k)
    miss = (rng.uniform(size=data.shape) < 0.3 if with_missing
            else np.zeros_like(data, bool))
    miss[0] = False
    got = tf.integrated_factor_loglikelihood(
        *T(data, miss, parent, children, heights), root, *T(load, gam),
        factor_precision=T(lam)[0], root_prior_mean=T(mean0)[0],
        root_prior_sample_size=1.5)
    close(got, _oracle(parent, children, heights, root, n, load, gam, data,
                       mean0, 1.5, lam, miss), rel=1e-9)


def test_loadings_gradient_matches_jax_grad():
    """tests/test_factor.py's loadings gradient, by torch.autograd against
    jax.grad (and so against its finite differences)."""
    parent, children, heights, root, load, gam, data, mean0, rng = setup(
        12, 2, 3, seed=5)
    miss = rng.uniform(size=data.shape) < 0.2

    def f_j(lo, ga):
        return jf.integrated_factor_loglikelihood(
            *J(data, miss, parent, children, heights), root, lo, ga,
            root_prior_sample_size=2.0)

    want = jax.grad(f_j, argnums=(0, 1))(*J(load, gam))
    x = [torch.tensor(v, requires_grad=True) for v in (load, gam)]
    got = torch.autograd.grad(tf.integrated_factor_loglikelihood(
        *T(data, miss, parent, children, heights), root, *x,
        root_prior_sample_size=2.0), x)
    for g, w in zip(got, want):
        close(g, w, atol=1e-10)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_liability_matches_jax(smooth):
    """tests/test_msc_dollo_liability.py::test_liability_consistency, and
    random ordinal data against JAX's density."""
    latent = torch.tensor([[-0.5, 2.0], [0.3, 0.1]], dtype=torch.float64)
    thresholds = torch.tensor([[0.0], [1.0]], dtype=torch.float64)
    ok = torch.tensor([[0, 1], [1, 0]])
    bad = torch.tensor([[1, 1], [1, 0]])
    v_ok = float(tli.liability_consistency_loglik(latent, ok, thresholds,
                                                  smooth))
    v_bad = float(tli.liability_consistency_loglik(latent, bad, thresholds,
                                                   smooth))
    assert v_ok == 0.0
    if smooth:
        assert v_bad < 0 and np.isfinite(v_bad)
    else:
        assert v_bad == -np.inf
    rng = np.random.default_rng(11)
    lat = rng.normal(size=(9, 3))
    thr = np.sort(rng.normal(size=(3, 2)), axis=1)
    for _ in range(4):
        data = rng.integers(0, 3, size=(9, 3))
        got = tli.liability_consistency_loglik(*T(lat, data, thr), smooth)
        want = jli.liability_consistency_loglik(*J(lat, data, thr), smooth)
        assert float(got) == float(want) or np.isclose(float(got),
                                                       float(want), rtol=REL)
    states = np.array([[0, 1], [1, 1]])
    np.testing.assert_array_equal(
        tli.binary_liability_data(torch.as_tensor(states)).numpy(),
        np.asarray(jli.binary_liability_data(jnp.asarray(states))))
    assert tli.binary_liability_data(torch.as_tensor(states)).dtype \
        == torch.int32

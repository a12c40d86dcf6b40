"""The port's models/continuous.py against the JAX package's.

Every function, on coalescent trees of 6 to 40 taxa drawn with numpy from
a seed, the same float64 inputs through both: Brownian motion (REML, a
conjugate root, relaxed-random-walk branch scalars, tip sampling
variance), drift, Ornstein-Uhlenbeck (stationary, conjugate and REML
roots), missing tip dimensions, the general affine Gaussian channels and
the node conditionals (means and covariances), each to 1e-10 relative.
The gradient with respect to the precision, the branch scalars and the
node heights is held against jax.grad, to 1e-10 relative. The JAX
package's dense oracles (tests/test_continuous.py, test_continuous2.py)
are cases too: each level-ordered walk against the dense multivariate
normal density of the tips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import continuous as jc
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models import continuous as tc

from scipy_free_mvn import mvn_logpdf

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


def tree(n, seed=0):
    """(parent, children, heights, root, rng) of a serially sampled
    coalescent tree of n taxa."""
    rng = np.random.default_rng(seed)
    tips = np.round(rng.uniform(0.0, 0.3, n), 3) * (np.arange(n) % 3 == 0)
    parent, children, heights, root = simulate_coalescent_tree(rng, tips, 1.0)
    return parent, children, heights, root, rng


def spd(d, rng):
    a = rng.normal(size=(d, d))
    return a @ a.T + d * np.eye(d)


def both(*arrays):
    """Each array as (jnp, torch) float64/int64 tensors."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        out.append((jnp.asarray(a), torch.as_tensor(a)))
    return out


def close(got, want, rel=REL, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=rel, atol=atol)


def channels(n, d, rng, m, parent, heights, kind):
    """(Q [M, D, D], r [M, D], Sigma [M, D, D], root mean, root cov) of a
    random affine branch model: Brownian (Q = I), drift or OU-like."""
    t = np.where(parent >= 0, heights[np.maximum(parent, 0)] - heights, 0.0)
    lam_inv = np.linalg.inv(spd(d, rng))
    sig = t[:, None, None] * lam_inv[None] + 1e-3 * np.eye(d)[None]
    q = np.broadcast_to(np.eye(d), (m, d, d)).copy()
    r = np.zeros((m, d))
    if kind in ("drift", "ou"):
        r = rng.normal(size=(m, d)) * t[:, None]
    if kind == "ou":
        q = q + 0.1 * rng.normal(size=(m, d, d)) * t[:, None, None]
    return q, r, sig, rng.normal(size=d), spd(d, rng) * 0.5


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("root_prior", [None, 2.5])
def test_brownian_matches_jax(n, root_prior):
    parent, children, heights, root, rng = tree(n, n)
    m, d = 2 * n - 1, 3
    traits, prec, scal, mean0 = (rng.normal(size=(n, d)), spd(d, rng),
                                 rng.uniform(0.5, 2.0, m), rng.normal(size=d))
    (jt, tt), (jp, tp), (jch, tch), (jh, th), (jl, tl), (js, ts), (jm, tm) = \
        both(traits, parent, children, heights, prec, scal, mean0)
    for tsv in (0.0, 0.05):
        want = jc.brownian_loglikelihood(
            jt, jp, jch, jh, root, jl, js, jm, root_prior, tsv)
        got = tc.brownian_loglikelihood(
            tt, tp, tch, th, root, tl, ts, tm, root_prior, tsv)
        close(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_drift_and_ou_match_jax(n):
    parent, children, heights, root, rng = tree(n, 100 + n)
    m, d = 2 * n - 1, 2
    traits, prec = rng.normal(size=(n, d)), spd(d, rng)
    drift, scal = rng.normal(size=(m, d)) * 0.5, rng.uniform(0.5, 2.0, m)
    theta, mean0 = rng.normal(size=d), rng.normal(size=d)
    (jt, tt), (jp, tp), (jch, tch), (jh, th), (jl, tl), (jd, td), \
        (js, ts), (jth, tth), (jm, tm) = both(
            traits, parent, children, heights, prec, drift, scal, theta,
            mean0)
    for k0 in (None, 1.5):
        close(tc.drift_brownian_loglikelihood(tt, tp, tch, th, root, tl, td,
                                              ts, tm, k0),
              jc.drift_brownian_loglikelihood(jt, jp, jch, jh, root, jl, jd,
                                              js, jm, k0))
    for stationary, k0 in ((True, None), (False, 1.5), (False, None)):
        for alpha in (0.3, 2.0):
            close(tc.ou_loglikelihood(tt, tp, tch, th, root, tl, alpha, tth,
                                      ts, stationary, k0),
                  jc.ou_loglikelihood(jt, jp, jch, jh, root, jl, alpha, jth,
                                      js, stationary, k0))


@pytest.mark.parametrize("n", SIZES)
def test_missing_matches_jax(n):
    parent, children, heights, root, rng = tree(n, 200 + n)
    m, d = 2 * n - 1, 3
    traits, prec = rng.normal(size=(n, d)), spd(d, rng)
    miss = rng.uniform(size=(n, d)) < 0.25
    miss[0] = True  # a tip with no data at all
    scal, mean0 = rng.uniform(0.5, 2.0, m), rng.normal(size=d)
    (jt, tt), (jmi, tmi), (jp, tp), (jch, tch), (jh, th), (jl, tl), \
        (js, ts), (jm, tm) = both(traits, miss, parent, children, heights,
                                  prec, scal, mean0)
    close(tc.brownian_loglikelihood_missing(tt, tmi, tp, tch, th, root, tl,
                                            ts, tm, 2.0),
          jc.brownian_loglikelihood_missing(jt, jmi, jp, jch, jh, root, jl,
                                            js, jm, 2.0))
    # no missing entry: the scalar recursion's value
    none = np.zeros((n, d), bool)
    close(tc.brownian_loglikelihood_missing(tt, torch.as_tensor(none), tp,
                                            tch, th, root, tl, ts, tm, 2.0),
          jc.brownian_loglikelihood(jt, jp, jch, jh, root, jl, js, jm, 2.0))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["brownian", "drift", "ou"])
def test_affine_and_conditionals_match_jax(n, kind):
    parent, children, heights, root, rng = tree(n, 300 + n)
    m, d = 2 * n - 1, 2
    traits = rng.normal(size=(n, d))
    miss = rng.uniform(size=(n, d)) < 0.2
    q, r, sig, mu0, v0 = channels(n, d, rng, m, parent, heights, kind)
    args = both(traits, miss, parent, children, heights)
    chans = both(q, r, sig, mu0, v0)
    j_in = [a for a, _ in args] + [root] + [a for a, _ in chans]
    t_in = [b for _, b in args] + [root] + [b for _, b in chans]
    close(tc.affine_gaussian_tree_loglikelihood(*t_in),
          jc.affine_gaussian_tree_loglikelihood(*j_in))
    means, covs = tc.affine_gaussian_node_conditionals(*t_in)
    j_means, j_covs = jc.affine_gaussian_node_conditionals(*j_in)
    close(means, j_means, atol=1e-9)
    # the tips' observed dims are conditioned with a 1e12 precision: their
    # covariances are 1e-12, held to round-off of that scale
    close(covs, j_covs, atol=1e-9)


def test_push_canonical_batched_matches_jax_vmap():
    rng = np.random.default_rng(7)
    k, b_n = 3, 5
    p = np.stack([spd(k, rng) for _ in range(b_n)])
    b, g, t = rng.normal(size=(b_n, k)), rng.normal(size=b_n), \
        rng.uniform(0.1, 1.0, b_n)
    lam_inv, eye = np.linalg.inv(spd(k, rng)), np.eye(k)
    cov = np.stack([spd(k, rng) for _ in range(b_n)])
    want = jax.vmap(lambda p_, b_, g_, t_: jc._push_canonical(
        p_, b_, g_, t_, jnp.asarray(lam_inv), jnp.asarray(eye)))(
        jnp.asarray(p), jnp.asarray(b), jnp.asarray(g), jnp.asarray(t))
    got = tc._push_canonical(*map(torch.as_tensor, (p, b, g, t, lam_inv,
                                                    eye)))
    for x, y in zip(got, want):
        close(x, y)
    want = jax.vmap(jc._push_canonical_cov)(*map(jnp.asarray, (p, b, g,
                                                               cov)))
    got = tc._push_canonical_cov(*map(torch.as_tensor, (p, b, g, cov)))
    for x, y in zip(got, want):
        close(x, y)


def test_tip_covariance_oracle_equals_jax():
    parent, children, heights, root, rng = tree(9, 3)
    scal = rng.uniform(0.5, 2.0, 17)
    for k0 in (None, 2.0):
        np.testing.assert_array_equal(
            tc.brownian_tip_covariance(parent, children, heights, root, 9,
                                       scal, k0),
            jc.brownian_tip_covariance(parent, children, heights, root, 9,
                                       scal, k0))


def _grad_inputs(n, seed):
    parent, children, heights, root, rng = tree(n, seed)
    m, d = 2 * n - 1, 2
    return (parent, children, heights, root, rng.normal(size=(n, d)),
            rng.uniform(size=(n, d)) < 0.2, spd(d, rng),
            rng.uniform(0.5, 2.0, m), rng.normal(size=d))


@pytest.mark.parametrize("n", (8, 25))
@pytest.mark.parametrize("fn", ["brownian", "missing", "affine"])
def test_gradients_match_jax_grad(n, fn):
    """d/d(precision, branch scalars, internal heights) of each density
    by torch.autograd against jax.grad."""
    parent, children, heights, root, traits, miss, prec, scal, mean0 = \
        _grad_inputs(n, 400 + n)
    d = traits.shape[1]

    def density(mod, A, lam, s, h_int):
        h = mod_cat(mod, A(heights[:n]), h_int)
        p, ch = A(parent), A(children)
        if fn == "brownian":
            return mod.brownian_loglikelihood(A(traits), p, ch, h, root, lam,
                                              s, A(mean0), 2.0)
        if fn == "missing":
            return mod.brownian_loglikelihood_missing(
                A(traits), A(miss), p, ch, h, root, lam, s, A(mean0), 2.0)
        t = mod_where(mod, p >= 0, h[mod_max(mod, p)] - h, 0.0 * h)
        v = mod_inv(mod, lam)
        eye = mod_eye(mod, d)
        sig = (t * s)[:, None, None] * v[None]
        q = eye[None] + 0.0 * sig
        r = 0.0 * sig[:, :, 0]
        return mod.affine_gaussian_tree_loglikelihood(
            A(traits), A(miss), p, ch, h, root, q, r, sig, A(mean0), v / 2.0)

    want = jax.grad(lambda lam, s, hi: density(jc, jnp.asarray, lam, s, hi),
                    argnums=(0, 1, 2))(jnp.asarray(prec), jnp.asarray(scal),
                                       jnp.asarray(heights[n:]))
    x = [torch.tensor(v, requires_grad=True)
         for v in (prec, scal, heights[n:])]
    got = torch.autograd.grad(density(tc, torch.as_tensor, *x), x)
    for g, w in zip(got, want):
        close(g, w, atol=1e-10)


def mod_cat(mod, a, b):
    return jnp.concatenate([a, b]) if mod is jc else torch.cat([a, b])


def mod_where(mod, c, a, b):
    return jnp.where(c, a, b) if mod is jc else torch.where(c, a, b)


def mod_max(mod, p):
    return jnp.maximum(p, 0) if mod is jc else torch.clamp_min(p, 0)


def mod_inv(mod, a):
    return jnp.linalg.inv(a) if mod is jc else torch.linalg.inv(a)


def mod_eye(mod, d):
    return (jnp.eye(d) if mod is jc
            else torch.eye(d, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the JAX package's dense oracles, held by the port's walks
# ---------------------------------------------------------------------------


def _dense(y, mean, sigma_tree, lam_inv):
    return mvn_logpdf(y.reshape(-1), mean.reshape(-1),
                      np.kron(sigma_tree, lam_inv))


@pytest.mark.parametrize("n", SIZES)
def test_brownian_and_rrw_match_dense_oracle(n):
    """tests/test_continuous.py: the conjugate-root and relaxed-random-walk
    densities are the matrix-normal density of the tips."""
    parent, children, heights, root, rng = tree(n, 500 + n)
    m, d = 2 * n - 1, 3
    traits, prec = rng.normal(size=(n, d)), spd(d, rng)
    scal, mean0, k0 = rng.uniform(0.3, 3.0, m), rng.normal(size=d), 2.5
    got = tc.brownian_loglikelihood(
        *map(torch.as_tensor, (traits, parent, children, heights)), root,
        torch.as_tensor(prec), torch.as_tensor(scal), torch.as_tensor(mean0),
        k0)
    sigma = tc.brownian_tip_covariance(parent, children, heights, root, n,
                                       scal, k0)
    want = _dense(traits, np.tile(mean0, (n, 1)), sigma, np.linalg.inv(prec))
    close(got, want, rel=1e-9)


@pytest.mark.parametrize("n", SIZES)
def test_drift_ou_missing_match_dense_oracles(n):
    """tests/test_continuous2.py: drift shifts each tip's mean by its
    path's drift; OU against its stationary covariance; missing dims
    marginalised from the dense density."""
    parent, children, heights, root, rng = tree(n, 600 + n)
    m, d = 2 * n - 1, 2
    traits, prec = rng.normal(size=(n, d)), spd(d, rng)
    lam_inv = np.linalg.inv(prec)
    mean0, k0 = rng.normal(size=d), 2.0
    A = torch.as_tensor
    tr = tuple(map(A, (parent, children, heights)))

    drift = rng.normal(size=(m, d)) * 0.5
    got = tc.drift_brownian_loglikelihood(A(traits), *tr, root, A(prec),
                                          A(drift), 1.0, A(mean0), k0)
    t = np.where(parent >= 0, heights[np.maximum(parent, 0)] - heights, 0.0)
    means = np.zeros((n, d))
    for i in range(n):
        j = i
        while parent[j] >= 0:
            means[i] += drift[j] * t[j]
            j = parent[j]
    sigma = tc.brownian_tip_covariance(parent, children, heights, root, n,
                                       1.0, k0)
    close(got, _dense(traits, means + mean0, sigma, lam_inv), rel=1e-9)

    alpha, theta = 0.7, rng.normal(size=d)
    got = tc.ou_loglikelihood(A(traits), *tr, root, A(prec), alpha,
                              A(theta))
    # stationary OU: Cov(x_i, x_j) = e^{-alpha (t_i + t_j)} / (2 alpha)
    # Lambda^-1 with t the times down to the MRCA's root distance
    depth = heights[root] - heights
    cov_t = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            anc_i, a = set(), i
            while a >= 0:
                anc_i.add(a)
                a = parent[a]
            b = j
            while b not in anc_i:
                b = parent[b]
            s = depth[b]
            cov_t[i, j] = np.exp(-alpha * (depth[i] + depth[j] - 2 * s)) \
                / (2 * alpha)
    close(got, _dense(traits, np.tile(theta, (n, 1)), cov_t, lam_inv),
          rel=1e-9)

    miss = rng.uniform(size=(n, d)) < 0.3
    got = tc.brownian_loglikelihood_missing(A(traits), A(miss), *tr, root,
                                            A(prec), 1.0, A(mean0), k0)
    keep = ~miss.reshape(-1)
    cov = np.kron(sigma, lam_inv)[np.ix_(keep, keep)]
    want = mvn_logpdf(traits.reshape(-1)[keep],
                      np.tile(mean0, n)[keep], cov)
    close(got, want, rel=1e-9)


def test_singular_precision_gives_nan_not_an_error():
    """A singular system is reported on the device: NaN, which rejects the
    proposal, as JAX's NaN does; nothing raises."""
    parent, children, heights, root, rng = tree(6, 9)
    traits = rng.normal(size=(6, 2))
    miss = np.zeros((6, 2), bool)
    out = tc.brownian_loglikelihood_missing(
        *map(torch.as_tensor, (traits, miss, parent, children, heights)),
        root, torch.zeros((2, 2), dtype=torch.float64))
    assert torch.isnan(out)

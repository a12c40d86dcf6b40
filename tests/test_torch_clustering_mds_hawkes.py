"""Nonparametric clustering, multidimensional scaling with the antigenic
likelihood, and the Hawkes process (queue item 4h-4's
models/clustering.py, mds.py and hawkes.py) against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - cluster_sizes, crp_log_prior, ddcrp_log_prior, hdp_log_prior and both
    antigenic drift priors against JAX's at 1e-12 relative;
  - dp_gibbs_sweep at JAX's draws: tests/test_clustering.py's two-group
    mixture, each reseating's uniform injected at the middle of JAX's
    categorical pick's share of the weights, equal to JAX's sweep seat for
    seat over 5 sweeps; and by law from the port's generator (the two
    groups apart after 25 sweeps, as the JAX test holds them);
    cluster_single_move at JAX's draws;
  - pairwise_distances, mds_loglikelihood (truncated or not),
    mds_location_gradient, antigenic_distance and antigenic_loglikelihood
    (all four measurement types, with and without drift and avidities)
    against JAX's; the location gradient against jax.grad;
  - hawkes_loglikelihood and hawkes_event_rates on 60 events against
    JAX's, and their gradients in the locations and theta against
    jax.grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import clustering as jcl
from beast_mcmc_tpu.models import hawkes as jhk
from beast_mcmc_tpu.models import mds as jmds

from beast_mcmc_tpu_torch.models import clustering as tcl
from beast_mcmc_tpu_torch.models import hawkes as thk
from beast_mcmc_tpu_torch.models import mds as tmds

from test_torch_operators_ext import Queue

F64 = torch.float64
REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, err


def test_priors_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 7, 40)
    np.testing.assert_array_equal(
        tcl.cluster_sizes(torch.tensor(a), 10).numpy(),
        np.asarray(jcl.cluster_sizes(jnp.asarray(a, jnp.int32), 10)))
    _close(tcl.crp_log_prior(torch.tensor(a), 0.8, 10),
           jcl.crp_log_prior(jnp.asarray(a, jnp.int32), 0.8, 10))
    d = np.abs(rng.normal(size=(25, 25)))
    links = rng.integers(0, 25, 25)
    _close(tcl.ddcrp_log_prior(torch.tensor(links), torch.tensor(d), 0.6,
                               1.3),
           jcl.ddcrp_log_prior(jnp.asarray(links), jnp.asarray(d), 0.6, 1.3))
    counts = rng.integers(0, 20, (6, 9))
    beta = rng.dirichlet(np.ones(9))
    _close(tcl.hdp_log_prior(torch.tensor(counts), torch.tensor(beta), 2.5,
                             1.7),
           jcl.hdp_log_prior(jnp.asarray(counts), jnp.asarray(beta), 2.5,
                             1.7))
    locs = rng.normal(size=(20, 3))
    dates = np.linspace(0, 10, 20)
    _close(tcl.antigenic_drift_prior(torch.tensor(locs), torch.tensor(dates),
                                     0.7, 1.3),
           jcl.antigenic_drift_prior(jnp.asarray(locs), jnp.asarray(dates),
                                     0.7, 1.3))
    _close(tmds.antigenic_drift_prior(torch.tensor(locs),
                                      torch.tensor(dates), 0.7, 1.3),
           jmds.antigenic_drift_prior(jnp.asarray(locs), jnp.asarray(dates),
                                      0.7, 1.3))


def _mixture():
    rng = np.random.default_rng(3)
    return np.concatenate([rng.normal(-5.0, 0.3, 12),
                           rng.normal(5.0, 0.3, 12)])


def _item_loglik(np_mod, x):
    """tests/test_clustering.py's collapsed Gaussian predictive over
    either package's arrays."""
    sigma2, prior_var = 0.25, 100.0

    def fn(i, k, a_wo):
        members = (a_wo == k)
        m = np_mod.sum(members)
        s = np_mod.sum(np_mod.where(members, x, 0.0))
        post_var = 1.0 / (1.0 / prior_var + m / sigma2)
        post_mean = post_var * s / sigma2
        pred_var = post_var + sigma2
        d = x[i] - post_mean
        return -0.5 * (np_mod.log(2 * np.pi * pred_var) + d * d / pred_var)

    return fn


def test_dp_gibbs_sweep_at_jax_draws():
    """Five sweeps: JAX's sweep, then the port's with each reseating's
    uniform at the middle of JAX's pick's share, seat for seat."""
    x = _mixture()
    n, max_k, alpha = len(x), 8, 1.0
    j_fn = _item_loglik(jnp, jnp.asarray(x))
    t_fn = _item_loglik(torch, torch.tensor(x))
    a_j = jnp.zeros(n, jnp.int32)
    a_t = torch.zeros(n, dtype=torch.long)
    key = jax.random.PRNGKey(0)
    for _ in range(5):
        key, sub = jax.random.split(key)
        start = np.asarray(a_j)
        a_j = jcl.dp_gibbs_sweep(sub, a_j, j_fn, alpha, max_k)
        seats = np.asarray(a_j)
        # each item's weights given the seats before it (JAX's reseat)
        u = np.zeros(n)
        cur = start.copy()
        for i in range(n):
            a_wo = cur.copy()
            a_wo[i] = -1
            sizes = np.bincount(a_wo[a_wo >= 0], minlength=max_k)[:max_k]
            ll = np.asarray(jax.vmap(lambda k: j_fn(i, k, jnp.asarray(
                a_wo)))(jnp.arange(max_k)))
            logw = np.where(sizes > 0, np.log(np.maximum(sizes, 1)) + ll,
                            -np.inf)
            first = int(np.argmax(sizes == 0))
            logw[first] = np.log(alpha) + ll[first]
            w = np.exp(logw - logw.max())
            cum = np.cumsum(w) / w.sum()
            c = seats[i]
            u[i] = (cum[c] + (cum[c - 1] if c else 0.0)) / 2
            cur[i] = c
        a_t = tcl.dp_gibbs_sweep(None, a_t, t_fn, alpha, max_k,
                                 uniforms=torch.tensor(u))
        np.testing.assert_array_equal(a_t.numpy(), seats)


def test_dp_gibbs_recovers_two_clusters():
    """tests/test_clustering.py's law on the port's own draws."""
    x = torch.tensor(_mixture())
    a = torch.zeros(24, dtype=torch.long)
    gen = torch.Generator().manual_seed(0)
    for _ in range(25):
        a = tcl.dp_gibbs_sweep(gen, a, _item_loglik(torch, x), 1.0, 8)
    a = a.numpy()
    assert set(a[:12]).isdisjoint(set(a[12:])), a
    lab1, lab2 = np.bincount(a[:12]).argmax(), np.bincount(a[12:]).argmax()
    assert (a[:12] == lab1).mean() >= 0.75 and (a[12:] == lab2).mean() >= 0.75


def test_cluster_single_move_at_jax_draws(monkeypatch):
    a = np.array([0, 0, 1, 1, 2])
    queue = Queue(monkeypatch)
    for i in range(30):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        jnew, jlh = jcl.cluster_single_move(key, jnp.asarray(a, jnp.int32), 4)
        k1, k2 = jax.random.split(key)
        queue.items = [int(jax.random.randint(k1, (), 0, 5)),
                       int(jax.random.randint(k2, (), 0, 4, jnp.int32))]
        tnew, tlh = tcl.cluster_single_move(None, torch.tensor(a), 4)
        assert queue.items == []
        np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
        assert float(tlh) == float(jlh) == 0.0


@pytest.mark.parametrize("truncated", [True, False])
def test_mds_matches_jax(truncated):
    rng = np.random.default_rng(1)
    n = 30
    locs = rng.normal(size=(n, 2))
    true = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    obs = true + rng.normal(0, 0.2, true.shape)
    mask = np.triu(rng.random((n, n)) < 0.5, 1)
    _close(tmds.pairwise_distances(torch.tensor(locs)),
           jmds.pairwise_distances(jnp.asarray(locs)))
    _close(tmds.mds_loglikelihood(torch.tensor(obs), torch.tensor(mask),
                                  torch.tensor(locs), 2.0, truncated),
           jmds.mds_loglikelihood(jnp.asarray(obs), jnp.asarray(mask),
                                  jnp.asarray(locs), 2.0, truncated))
    _close(tmds.mds_location_gradient(torch.tensor(obs), torch.tensor(mask),
                                      torch.tensor(locs), 2.0, truncated),
           jmds.mds_location_gradient(jnp.asarray(obs), jnp.asarray(mask),
                                      jnp.asarray(locs), 2.0, truncated),
           rel=1e-11)


@pytest.mark.parametrize("drift", [False, True])
def test_antigenic_likelihood_matches_jax(drift):
    rng = np.random.default_rng(2)
    v, s, m = 12, 5, 80
    vloc, sloc = rng.normal(size=(v, 2)), rng.normal(size=(s, 2))
    vi, si = rng.integers(0, v, m), rng.integers(0, s, m)
    pot, avi = rng.normal(8.0, 1.0, s), rng.normal(0, 0.5, v)
    voff, soff = rng.uniform(0, 5, v), rng.uniform(0, 5, s)
    types = np.tile([0, 1, 2, 3], m // 4)
    y = pot[si] + avi[vi] - 1.5 + rng.normal(0, 0.8, m)
    kw_t, kw_j = {}, {}
    if drift:
        kw_t = dict(virus_avidities=torch.tensor(avi), location_drift=0.3,
                    virus_offsets=torch.tensor(voff),
                    serum_offsets=torch.tensor(soff))
        kw_j = dict(virus_avidities=jnp.asarray(avi), location_drift=0.3,
                    virus_offsets=jnp.asarray(voff),
                    serum_offsets=jnp.asarray(soff))
    tl = torch.tensor(vloc, requires_grad=True)
    got = tmds.antigenic_loglikelihood(
        torch.tensor(y), torch.tensor(types), torch.tensor(vi),
        torch.tensor(si), tl, torch.tensor(sloc), torch.tensor(pot), 2.0,
        **kw_t)
    jf = lambda vl: jmds.antigenic_loglikelihood(  # noqa: E731
        jnp.asarray(y), jnp.asarray(types), jnp.asarray(vi),
        jnp.asarray(si), vl, jnp.asarray(sloc), jnp.asarray(pot), 2.0,
        **kw_j)
    np.testing.assert_allclose(float(got.detach()),
                               float(jf(jnp.asarray(vloc))), rtol=REL)
    (g,) = torch.autograd.grad(got, tl)
    _close(g, jax.grad(jf)(jnp.asarray(vloc)), rel=1e-10)
    args_t = (torch.tensor(vloc), torch.tensor(sloc), torch.tensor(vi),
              torch.tensor(si))
    args_j = (jnp.asarray(vloc), jnp.asarray(sloc), jnp.asarray(vi),
              jnp.asarray(si))
    extra_t = (0.3, torch.tensor(voff), torch.tensor(soff)) if drift else ()
    extra_j = (0.3, jnp.asarray(voff), jnp.asarray(soff)) if drift else ()
    _close(tmds.antigenic_distance(*args_t, *extra_t),
           jmds.antigenic_distance(*args_j, *extra_j))


def test_hawkes_matches_jax():
    rng = np.random.default_rng(4)
    n = 60
    locs = rng.normal(size=(n, 2))
    times = np.sort(rng.uniform(0, 10, n))
    args = (1.5, 0.3, 0.8, 2.0, 0.7, 1.1)
    tl = torch.tensor(locs, requires_grad=True)
    th = torch.tensor(0.7, dtype=F64, requires_grad=True)
    got = thk.hawkes_loglikelihood(tl, torch.tensor(times), 1.5, 0.3, 0.8,
                                   2.0, th, 1.1)
    jf = lambda lc, t: jhk.hawkes_loglikelihood(  # noqa: E731
        lc, jnp.asarray(times), 1.5, 0.3, 0.8, 2.0, t, 1.1)
    np.testing.assert_allclose(float(got.detach()),
                               float(jf(jnp.asarray(locs), 0.7)), rtol=REL)
    g_l, g_t = torch.autograd.grad(got, (tl, th))
    jg_l, jg_t = jax.grad(jf, argnums=(0, 1))(jnp.asarray(locs), 0.7)
    _close(g_l, jg_l, rel=1e-10)
    np.testing.assert_allclose(float(g_t), float(jg_t), rtol=1e-10)
    for a, b in zip(thk.hawkes_event_rates(torch.tensor(locs),
                                           torch.tensor(times), *args),
                    jhk.hawkes_event_rates(jnp.asarray(locs),
                                           jnp.asarray(times), *args)):
        _close(a, b)

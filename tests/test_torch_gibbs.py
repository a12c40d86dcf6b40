"""The port's inference/gibbs.py against the JAX package's.

  - GmrfBlockUpdateOperator: the proposal (the new precision, the Newton
    mode, the Laplace draw and the log Hastings ratio of the forward and
    backward proposal densities) given the same uniforms and normals, for
    a skygrid field on a grid and for uniform and time-aware skyride
    fields, in both branches of the precision mixture, to 1e-10;
  - the field's posterior law: a port chain driven by the block update
    alone against a long random-walk chain of the JAX package on the same
    skyride posterior (tests/test_gmrf_block.py's oracle);
  - EllipticalSliceOperator: the angle loop given the same prior draw,
    slice level, starting angle and shrinkage uniforms, to 1e-12, for a
    point found at once, one found after shrinking, and the cap's
    collapse to angle 0;
  - each operator over a chain batch (the block update vmapped as
    make_multichain_step proposes it, the slice sampler's chain-axis
    proposal) against single chains at the batch's draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.inference import gibbs as jgibbs
from beast_mcmc_tpu.tree.topology import (
    make_tree_state as j_tree_state,
    simulate_coalescent_tree,
)

from beast_mcmc_tpu_torch.inference import gibbs
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from test_gmrf_block import _posterior_mean


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inject(monkeypatch, uniforms, normals):
    """Both packages' draws replaced: JAX's jax.random.uniform and normal,
    the port's gibbs._uniform, _uniforms and _normal, each handing out
    the given values in order (the last uniform repeating)."""
    u_j, n_j = list(uniforms), list(normals)
    u_t, n_t = list(uniforms), list(normals)

    def take(seq):
        return seq.pop(0) if len(seq) > 1 else seq[0]

    def j_uniform(key, shape=(), dtype=jnp.float64, *a, **k):
        return jnp.full(shape, take(u_j), dtype)

    def j_normal(key, shape=(), dtype=jnp.float64, *a, **k):
        return jnp.asarray(take(n_j), dtype).reshape(shape)

    def t_uniforms(gen, like, shape=()):
        return torch.full(tuple(shape), take(u_t), dtype=like.dtype)

    def t_normal(gen, like, shape=()):
        return torch.as_tensor(take(n_t), dtype=like.dtype).reshape(shape)

    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(jax.random, "normal", j_normal)
    monkeypatch.setattr(gibbs, "_uniform",
                        lambda gen, like: t_uniforms(gen, like))
    monkeypatch.setattr(gibbs, "_uniforms", t_uniforms)
    monkeypatch.setattr(gibbs, "_normal", t_normal)


def _trees(n_taxa, seed):
    parent, children, heights, root = simulate_coalescent_tree(
        np.random.default_rng(seed), np.zeros(n_taxa), 1.0)
    return (j_tree_state(parent, children, heights, root, jnp.float64),
            make_tree_state(parent, children, heights, root, torch.float64,
                            "cpu"))


GMRF_CASES = {
    "skygrid": dict(cut_points=(0.1, 0.3, 0.6), time_aware=False, f=4),
    "skyride uniform": dict(cut_points=None, time_aware=False, f=7),
    "skyride time-aware": dict(cut_points=None, time_aware=True, f=7),
}


@pytest.mark.parametrize("u1", [0.2, 0.9])
@pytest.mark.parametrize("case", sorted(GMRF_CASES))
def test_gmrf_block_update_matches_jax(case, u1, monkeypatch):
    kw = dict(GMRF_CASES[case])
    f = kw.pop("f")
    jtree, tree = _trees(8, 3)
    rng = np.random.default_rng(7)
    gamma = rng.normal(0.3, 0.5, f)
    z = rng.normal(size=f)
    _inject(monkeypatch, [u1, 0.35], [z])
    common = dict(field="g", precision="tau", n_taxa=8, **kw)
    jp, jt, jh = jgibbs.GmrfBlockUpdateOperator(**common).propose(
        {"g": jnp.asarray(gamma), "tau": jnp.asarray(1.5)}, jtree,
        jax.random.PRNGKey(0), jnp.asarray(2.0))
    tp, _, th = gibbs.GmrfBlockUpdateOperator(**common).propose(
        {"g": torch.tensor(gamma),
         "tau": torch.tensor(1.5, dtype=torch.float64)}, tree, None,
        torch.tensor(2.0, dtype=torch.float64))
    assert np.isfinite(float(jh))
    np.testing.assert_allclose(tp["tau"].numpy(), np.asarray(jp["tau"]),
                               rtol=1e-12)
    np.testing.assert_allclose(tp["g"].numpy(), np.asarray(jp["g"]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(th), float(jh), rtol=1e-10, atol=1e-10)


def test_gmrf_block_update_samples_the_field_posterior():
    """A port chain moved by the block update alone samples the skyride
    posterior of tests/test_gmrf_block.py as the JAX package's random-walk
    chain does (the field's mean within 0.25, the precision's within
    30%)."""
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state,
        make_mcmc_step,
        run_chain,
    )
    from beast_mcmc_tpu_torch.models.coalescent import (
        gmrf_skyride_loglik,
        gmrf_skyride_uniform_prior,
    )
    from beast_mcmc_tpu_torch.models.priors import gamma_logpdf
    from beast_mcmc_tpu.inference.operators import (
        RandomWalkOperator,
        ScaleOperator,
    )
    from beast_mcmc_tpu.models.coalescent import (
        gmrf_skyride_loglik as j_skyride,
        gmrf_skyride_uniform_prior as j_prior,
    )
    from beast_mcmc_tpu.models.priors import gamma_logpdf as j_gamma

    n = 6
    parent, children, heights, root = simulate_coalescent_tree(
        np.random.default_rng(11), np.zeros(n), 1.0)

    def j_log_post(params, tree):
        g, tau = params["skyride.logPopSize"], params["skyride.precision"]
        return (j_skyride(tree.heights, n, g) + j_prior(g, tau)
                + j_gamma(tau, 1.0, 1.0))

    g_rw, tau_rw, _ = _posterior_mean(
        j_log_post, {"skyride.logPopSize": jnp.zeros(n - 1),
                     "skyride.precision": jnp.asarray(1.0)},
        j_tree_state(parent, children, heights, root, jnp.float64),
        [RandomWalkOperator(parameter="skyride.logPopSize", weight=3.0,
                            window=0.8),
         ScaleOperator(parameter="skyride.precision", weight=1.0,
                       scale_factor=0.75)], 60_000, 1)

    def log_post(params, tree):
        g, tau = params["skyride.logPopSize"], params["skyride.precision"]
        return (gmrf_skyride_loglik(tree.heights, n, g)
                + gmrf_skyride_uniform_prior(g, tau)
                + gamma_logpdf(tau, 1.0, 1.0))

    block = gibbs.GmrfBlockUpdateOperator(
        field="skyride.logPopSize", precision="skyride.precision", n_taxa=n,
        time_aware=False)
    tree = make_tree_state(parent, children, heights, root, torch.float64,
                           "cpu")
    params = {"skyride.logPopSize": torch.zeros(n - 1, dtype=torch.float64),
              "skyride.precision": torch.tensor(1.0, dtype=torch.float64)}
    step = make_mcmc_step(log_post, [block])
    state = init_mcmc_state(params, tree, torch.Generator().manual_seed(0),
                            [block], log_post)
    state, trace = run_chain(step, state, 4_000, 10, lambda s: {
        "g": s.params["skyride.logPopSize"],
        "tau": s.params["skyride.precision"]})
    burn = trace["g"].shape[0] // 4
    # the update moves (its scale adapts to an acceptance of 0.234)
    assert int(state.op_accept.sum()) > 400
    np.testing.assert_allclose(trace["g"][burn:].mean(0).numpy(), g_rw,
                               atol=0.25)
    assert float(trace["tau"][burn:].mean()) == pytest.approx(tau_rw,
                                                              rel=0.3)


ESS_CASES = {
    # (slice level uniform, starting angle uniform, shrinkage uniform)
    "found at once": (0.5, 0.02, 0.3),
    "found after shrinking": (0.999, 0.45, 0.97),
    # a level above the likelihood's maximum: no point is ever found
    "cap": (1e30, 0.5, 0.5),
}


@pytest.mark.parametrize("case", sorted(ESS_CASES))
def test_elliptical_slice_matches_jax(case, monkeypatch):
    u, a, v = ESS_CASES[case]
    mean = np.array([0.5, -0.5])
    prec = np.array([[2.0, 0.5], [0.5, 1.0]])
    chol = np.linalg.cholesky(np.linalg.inv(prec))
    x0 = np.array([0.2, 0.1])
    z = np.array([1.3, -0.7])
    target = np.array([1.0, 0.4])

    def make(mod, xp, asarray):
        prec_x = asarray(prec)

        def prior(vv, mu):
            d = vv - mu
            if xp is torch:
                return -0.5 * torch.einsum("...i,ij,...j->...", d, prec_x, d)
            return -0.5 * d @ prec_x @ d

        def log_post(params, tree):
            x = params["x"]
            like = -0.5 * xp.sum((x - asarray(target)) ** 2) / 0.05
            return prior(x, asarray(mean)) + like

        op = mod.EllipticalSliceOperator(
            parameter="x", prior_mean=mean, prior_chol=chol,
            prior_logpdf=prior)
        op.bind_log_posterior(log_post)
        return op

    _inject(monkeypatch, [u, a, v], [z])
    jtree, tree = _trees(4, 1)
    jop = make(jgibbs, jnp, jnp.asarray)
    top = make(gibbs, torch, torch.tensor)
    jp, _, jh = jop.propose({"x": jnp.asarray(x0)}, jtree,
                            jax.random.PRNGKey(0), None)
    tp, _, th = top.propose({"x": torch.tensor(x0)}, tree, None, None)
    assert float(jh) == float(th) == math.inf
    np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]),
                               rtol=1e-12, atol=1e-14)
    if case == "cap":
        np.testing.assert_allclose(tp["x"].numpy(), x0, rtol=1e-15)
        assert top.last_n_evaluations == 1 + top.max_iters
    else:
        assert not np.allclose(tp["x"].numpy(), x0)


def _replay(monkeypatch, b_n):
    """A chain batch's draws handed to single chains: while `chain[0]` is
    b, each draw helper of gibbs draws the batch's shape from the
    generator and returns chain b's part. A vmapped proposal (the block
    update) draws `shape` a chain, [B, *shape] in all; a chain-axis one
    (the slice sampler) draws [B, ...] outright, and its batch of one
    [1, ...]."""
    chain = [None]
    real = {"_uniform": gibbs._uniform, "_uniforms": gibbs._uniforms,
            "_normal": gibbs._normal}

    def part(draw, gen, like, shape):
        b, shape = chain[0], tuple(shape)
        if shape[:1] == (1,):  # a chain-axis proposal's batch of one
            return draw((b_n, *shape[1:]), generator=gen,
                        dtype=like.dtype)[b:b + 1]
        return draw((b_n, *shape), generator=gen, dtype=like.dtype)[b]

    def wrap(name, draw):
        def helper(gen, like, shape=()):
            if chain[0] is None:
                return (real[name](gen, like) if name == "_uniform"
                        else real[name](gen, like, shape))
            return part(draw, gen, like, shape)
        return helper

    monkeypatch.setattr(gibbs, "_uniform", wrap("_uniform", torch.rand))
    monkeypatch.setattr(gibbs, "_uniforms", wrap("_uniforms", torch.rand))
    monkeypatch.setattr(gibbs, "_normal", wrap("_normal", torch.randn))
    return chain


@pytest.mark.parametrize("case", sorted(GMRF_CASES))
def test_gmrf_block_update_chain_batch_equals_single_chains(case,
                                                             monkeypatch):
    """Three chains, each with its own tree, field, precision and scale
    factor: the block update vmapped over the batch (make_multichain_step's
    _propose_chains) against three single proposals at the batch's draws,
    to 1e-10."""
    from beast_mcmc_tpu_torch.inference.mcmc import (
        TREE_FIELDS,
        _propose_chains,
    )
    from beast_mcmc_tpu_torch.tree.topology import TreeState

    kw = dict(GMRF_CASES[case])
    f = kw.pop("f")
    b_n, seed = 3, 4
    trees = [_trees(8, 20 + b)[1] for b in range(b_n)]
    rng = np.random.default_rng(9)
    params = {"g": torch.tensor(rng.normal(0.3, 0.5, (b_n, f))),
              "tau": torch.tensor(rng.uniform(0.8, 2.0, b_n))}
    tuning = torch.tensor(rng.uniform(1.5, 3.0, b_n))
    op = gibbs.GmrfBlockUpdateOperator(field="g", precision="tau", n_taxa=8,
                                       **kw)
    chain = _replay(monkeypatch, b_n)
    batch_tree = TreeState(*(torch.stack([getattr(t, fld) for t in trees])
                             for fld in TREE_FIELDS))
    p_b, t_b, logh_b, _ = _propose_chains(
        op, params, batch_tree, torch.Generator().manual_seed(seed), tuning)
    assert t_b is None and set(p_b) == {"g", "tau"}
    assert torch.isfinite(logh_b).all()
    # the chains' draws differ, so their proposals do
    assert not torch.allclose(p_b["tau"] / params["tau"],
                              (p_b["tau"] / params["tau"])[0])
    for b in range(b_n):
        chain[0] = b
        p1, _, logh1 = op.propose({k: v[b] for k, v in params.items()},
                                  trees[b],
                                  torch.Generator().manual_seed(seed),
                                  tuning[b])
        chain[0] = None
        for k in ("g", "tau"):
            torch.testing.assert_close(p_b[k][b], p1[k], rtol=1e-10,
                                       atol=1e-12)
        torch.testing.assert_close(logh_b[b], logh1, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("max_iters", [64, 2])
def test_elliptical_slice_chain_batch_equals_single_chains(max_iters,
                                                           monkeypatch):
    """Five chains from their own points near the peak of a sharp
    likelihood, so that they find their angles after different numbers of
    shrinkages (and, with a cap of 2, some collapse to angle 0): the chain-axis proposal
    against five single proposals at the batch's draws, to 1e-12."""
    b_n, seed = 5, 2
    mean = np.array([0.5, -0.5, 0.0])
    prec = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 1.5]])
    chol = np.linalg.cholesky(np.linalg.inv(prec))
    prec_t, mean_t = torch.tensor(prec), torch.tensor(mean)
    target = torch.tensor([1.0, 0.4, -0.3])

    def prior(v, mu):
        d = v - mu
        return -0.5 * torch.einsum("...i,ij,...j->...", d, prec_t, d)

    def log_post(params, tree):  # one chain [d] or a batch [B, d]
        x = params["x"]
        return prior(x, mean_t) - 0.5 * torch.sum((x - target) ** 2,
                                                  -1) / 1e-3

    op = gibbs.EllipticalSliceOperator(parameter="x", prior_mean=mean,
                                       prior_chol=chol, prior_logpdf=prior,
                                       max_iters=max_iters)
    op.bind_log_posterior(log_post)
    op.bind_log_posterior_chains(log_post)
    _, tree = _trees(4, 1)
    # near the likelihood's peak, where the slice is a short arc
    x0 = target + torch.tensor(
        np.random.default_rng(3).normal(0.0, 0.03, (b_n, 3)))
    chain = _replay(monkeypatch, b_n)
    p_b, _, logh_b = op.propose_chains(
        {"x": x0}, tree, torch.Generator().manual_seed(seed), None)
    n_batch = op.last_n_evaluations
    assert (logh_b == math.inf).all()
    n_single, moved = [], []
    for b in range(b_n):
        chain[0] = b
        p1, _, logh1 = op.propose({"x": x0[b]}, tree,
                                  torch.Generator().manual_seed(seed), None)
        chain[0] = None
        assert float(logh1) == math.inf
        torch.testing.assert_close(p_b["x"][b], p1["x"], rtol=1e-12,
                                   atol=1e-14)
        n_single.append(op.last_n_evaluations)
        moved.append(not torch.equal(p1["x"], x0[b]))
    # the batch runs until its slowest chain is done
    assert n_batch == max(n_single)
    if max_iters == 64:
        assert all(moved) and len(set(n_single)) > 1
    else:
        assert not all(moved)

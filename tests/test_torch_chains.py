"""Chain batches of the port against single chains and the JAX package.

A chain batch carries a leading chain axis B from the state down to the
peel kernels (inference/mcmc.py::make_multichain_step). On the CPU every
kernel wrapper takes its plain chain-axis version. Held here, in float64:
the chain-axis schedule row by row against the single-tree schedule
(exactly); the chain-axis plain peels against the single-chain plain peels
chain by chain and against jax.vmap of the JAX scan peel (rtol 1e-12: the
same arithmetic in another order); the chain-axis posteriors of
build_analysis against JAX's vmapped log_post at the same params and trees
(rtol 1e-10, as tests/test_torch_chain.py); the batch step's laws on exact
targets (Monte Carlo tolerances stated at each test); and the guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jax_build_analysis
from beast_mcmc_tpu.inference.mcmc import apply_derived as jax_apply_derived
from beast_mcmc_tpu.inference.state import init_state as jax_init_state
from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.tree.topology import make_tree_state as jax_tree_state

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.convert import states_from_numpy
from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_multichain_step,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.operators import (
    DeltaExchangeOperator,
    NarrowExchangeOperator,
    RandomWalkOperator,
    RootHeightScaleOperator,
    ScaleOperator,
    UniformNodeHeightOperator,
    UpDownOperator,
    WideExchangeOperator,
    WilsonBaldingOperator,
)
from beast_mcmc_tpu_torch.models.coalescent import constant_coalescent_loglik
from beast_mcmc_tpu_torch.ops import cuda_mxu, cuda_peeling, cuda_stream
from beast_mcmc_tpu_torch.ops import cuda_stream2
from beast_mcmc_tpu_torch.ops.peeling import (
    node_depths,
    parent_from_children,
    peel_order_from_heights,
)
from beast_mcmc_tpu_torch.tree.topology import (
    TreeState,
    make_tree_state,
    simulate_coalescent_tree,
)

from test_operator_uniformity import exact_topology_probs
from test_torch_chain import _topology_id

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_np(n_taxa, seed, caterpillar=False):
    if not caterpillar:
        return simulate_coalescent_tree(np.random.default_rng(seed),
                                        np.zeros(n_taxa), 1.0)
    m = 2 * n_taxa - 1
    parent, children = np.full(m, -1), np.full((m, 2), -1)
    for i in range(1, n_taxa):
        children[n_taxa + i - 1] = (n_taxa + i - 2 if i > 1 else 0, i)
        parent[children[n_taxa + i - 1]] = n_taxa + i - 1
    return (parent, children, np.r_[np.zeros(n_taxa), np.arange(1.0, n_taxa)],
            m - 1)


def _chains(n_taxa, b_n, seed, caterpillar_at=()):
    """B trees (chain b a caterpillar where b is in caterpillar_at, else a
    coalescent tree from seed + b), stacked: (TreeState with [B, ...]
    fields, the numpy trees)."""
    trees = [_tree_np(n_taxa, seed + b, b in caterpillar_at)
             for b in range(b_n)]
    ts = [make_tree_state(*t, dtype=F64, device="cpu") for t in trees]
    return TreeState(*(torch.stack([getattr(t, f) for t in ts])
                       for f in ("parent", "children", "heights", "root"))
                     ), trees


@pytest.mark.parametrize("n_taxa,caterpillar_at", [(9, ()), (40, (1,)),
                                                   (300, (2,))])
def test_chain_schedule_rows_are_single_tree_schedules(n_taxa, caterpillar_at):
    """parent_from_children, node_depths, peel_order_from_heights,
    stream_schedule and level_schedule on [B, ...] trees: row b equals the
    single-tree result of chain b, exactly."""
    tree, _ = _chains(n_taxa, 3, 5, caterpillar_at)
    par = parent_from_children(tree.children, n_taxa)
    np.testing.assert_array_equal(par.numpy(), tree.parent.numpy())
    depth = node_depths(tree.parent)
    order = peel_order_from_heights(tree.heights, n_taxa, tree.parent)
    sched = cuda_stream.level_schedule(tree.children, n_taxa, tree.parent)
    stream = cuda_stream.stream_schedule(tree.children, order)
    for b in range(3):
        np.testing.assert_array_equal(
            depth[b].numpy(), node_depths(tree.parent[b]).numpy())
        np.testing.assert_array_equal(order[b].numpy(), peel_order_from_heights(
            tree.heights[b], n_taxa, tree.parent[b]).numpy())
        for got, want in zip(sched, cuda_stream.level_schedule(
                tree.children[b], n_taxa, tree.parent[b])):
            np.testing.assert_array_equal(got[b].numpy(), want.numpy())
        for got, want in zip(stream, cuda_stream.stream_schedule(
                tree.children[b], order[b])):
            np.testing.assert_array_equal(got[b].numpy(), want.numpy())


def _peel_problem(n_taxa, b_n, k, c, s, p, seed):
    """Tips shared by the chains ([K,] N, S, P), B trees, and per-chain
    matrices [B, (K,) M, C, S, S], freqs and category weights, as numpy."""
    rng = np.random.default_rng(seed)
    lead = (k,) if k else ()
    tips = (rng.random((*lead, n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    pm = rng.random((b_n, *lead, 2 * n_taxa - 1, c, s, s)) * 0.2 + 0.01
    pm /= pm.sum(-1, keepdims=True)
    fr = rng.dirichlet(np.ones(s), (b_n, *lead))
    cw = rng.dirichlet(np.ones(c), (b_n, *lead))
    tree, trees = _chains(n_taxa, b_n, seed, (b_n - 1,))
    return tips, pm, fr, cw, tree, trees


def _jax_site(tips, pm, fr, cw, trees, k):
    """jax.vmap of the JAX scan peel over the chains (and the partitions)."""
    orders = [np.asarray(peel_order_from_heights(
        torch.tensor(h), len(h) // 2 + 1, torch.tensor(p)))
        for p, _, h, _ in trees]
    peel = jpeel.peel_site_loglik
    if k:
        peel = jax.vmap(peel, in_axes=(0, None, None, None, 0, 0, 0))
    j = jax.vmap(peel, in_axes=(None, 0, 0, 0, 0, 0, 0))
    return np.asarray(j(jnp.asarray(tips),
                        jnp.asarray(np.stack([t[1] for t in trees])),
                        jnp.asarray(np.stack(orders)),
                        jnp.asarray(np.array([t[3] for t in trees])),
                        jnp.asarray(pm), jnp.asarray(fr), jnp.asarray(cw)))


@pytest.mark.parametrize("kernel,n_taxa,b_n,k,c,s,p", [
    ("peel_resident", 12, 3, 0, 4, 4, 24),
    ("peel_stream", 220, 3, 0, 4, 4, 8),
    ("peel_stream", 30, 2, 3, 2, 4, 10),
    ("peel_mxu", 10, 3, 0, 2, 20, 16),
])
def test_chain_plain_peels_match_single_chains_and_jax(kernel, n_taxa, b_n,
                                                       k, c, s, p):
    """Each kernel's plain chain-axis version (B chains, the last a
    caterpillar, so that their level counts differ) against its
    single-chain plain version chain by chain and against jax.vmap of the
    JAX scan peel, rtol 1e-12; K = 3 partitions with B = 2 on the deep
    route."""
    tips_np, pm_np, fr_np, cw_np, tree, trees = _peel_problem(
        n_taxa, b_n, k, c, s, p, seed=21)
    t = lambda x: torch.tensor(x, dtype=F64)  # noqa: E731
    tips, pm, fr, cw = t(tips_np), t(pm_np), t(fr_np), t(cw_np)
    wcs = cw[..., None] * fr[..., None, :]
    sched = cuda_stream.level_schedule(tree.children, n_taxa, tree.parent)
    order, ids, pos, ls = sched
    if kernel == "peel_resident":
        got = cuda_peeling._resident_plain(tips, ids, pos, ls, pm, wcs)
        one = [cuda_peeling._resident_plain(tips, ids[b], pos[b], ls[b],
                                            pm[b], wcs[b])
               for b in range(b_n)]
    elif kernel == "peel_mxu":
        got, post = cuda_mxu._mxu_plain(tips, sched, pm, wcs)
        one = [cuda_mxu._mxu_plain(tips, tuple(x[b] for x in sched), pm[b],
                                   wcs[b]) for b in range(b_n)]
        for b in range(b_n):
            np.testing.assert_array_equal(post[b].numpy(), one[b][1].numpy())
        one = [o[0] for o in one]
    else:
        got = cuda_stream2.peel_deep_chains(tips, tree.children, pm, fr, cw,
                                            sched)
        one = [cuda_stream2.peel_site_loglik_deep(
            tips, tree.children[b], None, None, pm[b], fr[b], cw[b],
            tuple(x[b] for x in sched)) for b in range(b_n)]
    for b in range(b_n):
        np.testing.assert_allclose(got[b].numpy(), one[b].numpy(),
                                   rtol=1e-12)
    np.testing.assert_allclose(
        got.numpy(), _jax_site(tips_np, pm_np, fr_np, cw_np, trees, k),
        rtol=1e-12)


@pytest.mark.parametrize("n_taxa,c", [(12, 4), (220, 4)])
def test_chain_entry_point_dispatches_one_peel(monkeypatch, n_taxa, c):
    """peel_site_loglik_auto with [B, M, 2] children: one call of the
    route's plain chain-axis version for all B chains (the resident route
    at 12 taxa, the deep one at 220), equal to the chain-by-chain peels."""
    tips_np, pm_np, fr_np, cw_np, tree, _ = _peel_problem(n_taxa, 3, 0, c, 4,
                                                          12, seed=22)
    t = lambda x: torch.tensor(x, dtype=F64)  # noqa: E731
    tips, pm, fr, cw = t(tips_np), t(pm_np), t(fr_np), t(cw_np)
    route = cuda_peeling.peel_route(2 * n_taxa - 1, c, 4, 8)
    calls = []
    mod, name = ((cuda_peeling, "_resident_plain") if route == "resident"
                 else (cuda_stream2, "_deep_plain"))
    plain = getattr(mod, name)

    def counted(*a, **kw):
        calls.append(a[1].dim())
        return plain(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    sched = cuda_stream.level_schedule(tree.children, n_taxa, tree.parent)
    order = sched[0]
    got = cuda_peeling.peel_site_loglik_auto(tips, tree.children, order,
                                             tree.root, pm, fr, cw, sched)
    assert got.shape == (3, 12)
    assert calls[0] == 3  # the first call takes the chain-axis schedule
    monkeypatch.setattr(mod, name, plain)
    for b in range(3):
        one = cuda_peeling.peel_site_loglik_auto(
            tips, tree.children[b], order[b], tree.root[b], pm[b], fr[b],
            cw[b], tuple(x[b] for x in sched))
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=1e-12)


def _jax_params(model, seed):
    rng = np.random.default_rng(seed)
    p = {"clock.rate": rng.uniform(0.7, 1.3), "pop.size": rng.uniform(0.4, 1.0)}
    if model == "gtr_gamma":
        p.update({"gtr.rates": rng.uniform(0.3, 3.0, 6),
                  "alpha": rng.uniform(0.3, 2.0)})
    elif model == "hky":
        p["kappa"] = rng.uniform(1.5, 5.0)
    else:
        p["kappa"] = rng.uniform(1.5, 5.0, 3)
        mu = rng.uniform(0.5, 1.5, 3)
        p["mu"] = 3 * mu / mu.sum()
    return {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}


@pytest.mark.parametrize("model", ["gtr_gamma", "hky", "hky_codon3"])
def test_chain_posterior_matches_jax_vmap(model):
    """aux["log_post_chains"] and aux["log_post_cached_chains"] of
    build_analysis(16, 40) on a batch of three chains, each with its own
    params and tree, carried from JAX's vmapped MCMCState by
    convert.states_from_numpy, against jax.vmap of JAX's log_post, rtol
    1e-10."""
    j_lp, j_ops, _, _, j_aux = jax_build_analysis(16, 40, model=model,
                                                  dtype=jnp.float64)
    _, _, _, _, aux = build_analysis(16, 40, model=model, device="cpu")
    states = []
    for b in range(3):
        tree = jax_tree_state(*simulate_coalescent_tree(
            np.random.default_rng(30 + b), np.zeros(16), 0.5),
            dtype=jnp.float64)
        params = jax_apply_derived(j_aux["derived"], _jax_params(model, b))
        states.append(jax_init_state(params, tree, jax.random.PRNGKey(b),
                                     len(j_ops), jnp.zeros(len(j_ops))))
    j_states = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    ref = np.asarray(jax.jit(jax.vmap(j_lp))(j_states.params, j_states.tree))
    j_states = j_states.replace(log_posterior=jnp.asarray(ref))
    batch = states_from_numpy(jax.tree_util.tree_map(np.asarray, j_states),
                              torch.Generator(), device="cpu")
    assert batch.log_posterior.shape == (3,)
    np.testing.assert_allclose(batch.log_posterior.numpy(), ref, rtol=1e-10)
    for fn in (aux["log_post_chains"], aux["log_post_cached_chains"]):
        got = fn(batch.params, batch.tree)
        assert got.shape == (3,) and got.dtype == F64
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)


def _analysis_batch(b_n=3, seed=0):
    log_post, ops, p0, t0, aux = build_analysis(10, 32, device="cpu")
    st = init_mcmc_state(p0, t0, torch.Generator().manual_seed(seed), ops,
                         aux["log_post_cached"])
    return (log_post, ops, aux,
            replicate_state(st, b_n, torch.Generator().manual_seed(seed + 1)))


def test_multichain_step_draws_one_operator_for_all_chains():
    """40 steps of three chains: every chain has drawn the same operator in
    each step (identical per-operator counts), the chains moved apart, and
    the state keeps its chain axis."""
    _, ops, aux, states = _analysis_batch()
    mstep = make_multichain_step(aux["log_post_cached_chains"], ops,
                                 derived=aux["derived"])
    states, _ = run_chain(mstep, states, 40)
    drawn = (states.op_accept + states.op_reject).numpy()
    assert drawn.shape == (3, len(ops))
    assert (drawn == drawn[0]).all() and drawn[0].sum() == 40
    assert states.log_posterior.shape == (3,)
    assert len(set(states.log_posterior.tolist())) == 3
    assert states.tree.children.shape == (3, 19, 2)
    assert states.params["site.rates"][0].shape == (3, 4)


def test_multichain_full_evaluation_deviation():
    """A build_analysis(10, 32) batch of three chains through 30 steps
    after 20: the carried posterior of every chain within 1e-9 of a fresh
    chain-axis evaluation that rebuilds the derived caches."""
    _, ops, aux, states = _analysis_batch(seed=2)
    mstep = make_multichain_step(aux["log_post_cached_chains"], ops,
                                 derived=aux["derived"])
    states, _ = run_chain(mstep, states, 20)
    states, dev = full_evaluation_check(mstep, aux["log_post_chains"], states,
                                        30, derived=aux["derived"])
    assert float(dev) < 1e-9
    assert bool(torch.isfinite(states.log_posterior).all())


@pytest.mark.parametrize("op", [NarrowExchangeOperator(weight=10.0),
                                WideExchangeOperator(weight=10.0),
                                WilsonBaldingOperator(weight=10.0)],
                         ids=["narrow", "wide", "wilson_balding"])
def test_topology_law_on_a_batch(op):
    """tests/test_torch_chain.py's exact-distribution test on a batch: 8
    chains of 1,600 steps under the constant coalescent on 4 taxa (the
    first 200 of each dropped), with UniformNodeHeight and RootHeightScale;
    the pooled topology frequencies within 4.5 standard errors of 1/18 and
    2/18, estimated from 32 batch means (4 a chain)."""
    ops = [op, UniformNodeHeightOperator(weight=5.0),
           RootHeightScaleOperator(weight=2.0)]
    tree0 = make_tree_state(*_tree_np(4, 1), dtype=F64, device="cpu")

    def log_post(params, tree):
        return constant_coalescent_loglik(tree.heights, 4, 1.0)

    st = init_mcmc_state({}, tree0, torch.Generator().manual_seed(7), ops,
                         log_post)
    states = replicate_state(st, 8, torch.Generator().manual_seed(8))
    mstep = make_multichain_step(log_post, ops)
    tids = []
    for i in range(1600):
        states = mstep(states)
        if i >= 200:
            tids.append([_topology_id(TreeState(
                *(getattr(states.tree, f)[b] for f in
                  ("parent", "children", "heights", "root"))))
                for b in range(8)])
    tids = np.asarray(tids).T  # [chains, steps]
    exact = exact_topology_probs()
    assert set(np.unique(tids)) == set(exact)
    batches = tids.reshape(32, -1)
    for tid, p in exact.items():
        freq = (batches == tid).mean(1)
        se = freq.std(ddof=1) / np.sqrt(len(freq))
        assert abs(freq.mean() - p) < 4.5 * se, (tid, freq.mean(), p, se)


def test_parameter_operator_laws_on_a_batch():
    """A toy on exact targets, 8 chains of 2,500 steps (the first 300 of
    each dropped): x ~ N((1, -2), diag(0.5, 2)^2) by RandomWalk, y and z
    log-normal(0, 0.5) by Scale on y and UpDown (y up, z down), w / 3 ~
    Dirichlet(2, 3, 4) by DeltaExchange. Each pooled mean, and the
    variances of x, log y and log z, within 4.5 standard errors from 32
    batch means."""
    m, sd = np.array([1.0, -2.0]), np.array([0.5, 2.0])
    alpha = torch.tensor([2.0, 3.0, 4.0], dtype=F64)

    def log_post(params, tree):  # [B]
        x, y, z, w = (params[k] for k in ("x", "y", "z", "w"))
        ly, lz = torch.log(y), torch.log(z)
        return (-0.5 * (((x - torch.tensor(m)) / torch.tensor(sd)) ** 2).sum(-1)
                - 0.5 * (ly / 0.5) ** 2 - ly - 0.5 * (lz / 0.5) ** 2 - lz
                + ((alpha - 1.0) * torch.log(w)).sum(-1))

    ops = [RandomWalkOperator(parameter="x", window=1.0, weight=2.0),
           ScaleOperator(parameter="y", weight=1.0),
           UpDownOperator(up=("y",), down=("z",), weight=1.0),
           DeltaExchangeOperator(parameter="w", delta=0.3, weight=1.0)]
    params = {"x": torch.tensor(m), "y": torch.tensor(1.0, dtype=F64),
              "z": torch.tensor(1.0, dtype=F64),
              "w": torch.tensor([1.0, 1.0, 1.0], dtype=F64)}
    tree0 = make_tree_state(*_tree_np(3, 1), dtype=F64, device="cpu")
    st = init_mcmc_state(params, tree0, torch.Generator().manual_seed(3), ops)
    states = replicate_state(st, 8, torch.Generator().manual_seed(4))
    states = states.replace(log_posterior=log_post(states.params,
                                                   states.tree))
    mstep = make_multichain_step(log_post, ops)
    rows = []
    for i in range(2500):
        states = mstep(states)
        if i >= 300:
            p = states.params
            rows.append(torch.cat([p["x"], torch.log(p["y"])[:, None],
                                   torch.log(p["z"])[:, None], p["w"]],
                                  1).numpy())
    draws = np.transpose(np.asarray(rows), (1, 0, 2))  # [chains, steps, 7]
    mean = np.r_[m, 0.0, 0.0, 3 * alpha.numpy() / 9.0]
    var = np.r_[sd ** 2, 0.25, 0.25]
    batches = draws.reshape(32, -1, 7)
    for stat, want in ((batches.mean(1), mean),
                       (((batches[..., :4] - mean[:4]) ** 2).mean(1), var)):
        se = stat.std(0, ddof=1) / np.sqrt(32)
        assert (np.abs(stat.mean(0) - want) < 4.5 * se).all(), (
            stat.mean(0), want, se)
    assert (states.op_accept > 0).all()


@pytest.mark.parametrize("kernel", ["peel_resident", "peel_stream",
                                    "peel_mxu", "peel_stream_ring"])
def test_chain_entry_with_grad_raises(monkeypatch, kernel):
    """A chain-axis entry whose matrices require grad returns the gradient
    of every chain, equal to each chain's single-tree gradient, with the
    route's plain version run with autograd off (the plain versions are
    replaced by a check of that): the level adjoint gives the gradient, no
    plain peel is differentiated. A chain-axis kernel entry (prepare_*)
    still raises."""
    n_taxa, c, s, p = {"peel_resident": (12, 4, 4, 8),
                       "peel_stream": (220, 4, 4, 8),
                       "peel_mxu": (10, 2, 20, 8),
                       "peel_stream_ring": (10, 2, 8, 8)}[kernel]
    tips_np, pm_np, fr_np, cw_np, tree, _ = _peel_problem(n_taxa, 2, 0, c, s,
                                                          p, seed=23)
    t = lambda x: torch.tensor(x, dtype=F64)  # noqa: E731
    tips, fr, cw = t(tips_np), t(fr_np), t(cw_np)
    pm = t(pm_np).requires_grad_(True)
    ran = []

    def untraced(fn):
        def call(*a, **kw):
            if torch.is_grad_enabled():
                raise AssertionError("a plain peel ran under autograd")
            ran.append(fn.__name__)
            return fn(*a, **kw)
        return call

    for mod, name in ((cuda_peeling, "_resident_plain"),
                      (cuda_stream2, "_deep_plain"),
                      (cuda_mxu, "_mxu_plain"),
                      (cuda_stream, "_stream_plain")):
        monkeypatch.setattr(mod, name, untraced(getattr(mod, name)))
    assert cuda_peeling.peel_route(2 * n_taxa - 1, c, s, 8) == {
        "peel_resident": "resident", "peel_stream": "deep",
        "peel_mxu": "mxu", "peel_stream_ring": "stream"}[kernel]
    sched = cuda_stream.level_schedule(tree.children, n_taxa, tree.parent)
    order = sched[0]
    g = t(np.random.default_rng(4).random((2, p)))
    site = cuda_peeling.peel_site_loglik_auto(tips, tree.children, order,
                                              tree.root, pm, fr, cw, sched)
    got = torch.autograd.grad(torch.sum(g * site), pm)[0]
    assert ran and got.shape == pm.shape
    for b in range(2):
        leaf = pm[b].detach().requires_grad_(True)
        one = cuda_peeling.peel_site_loglik_auto(
            tips, tree.children[b], order[b], tree.root[b], leaf, fr[b],
            cw[b], tuple(x[b] for x in sched))
        ref = torch.autograd.grad(torch.sum(g[b] * one), leaf)[0]
        torch.testing.assert_close(got[b], ref, rtol=1e-12, atol=1e-13)
    _, ids, pos, ls = sched
    with pytest.raises(RuntimeError, match="grad"):
        if kernel == "peel_resident":
            cuda_peeling.prepare_resident(tips, tree.children, None, pm, fr,
                                          cw, sched)
        elif kernel == "peel_mxu":
            cuda_mxu.prepare_mxu(tips, tree.children, None, pm, fr, cw, sched)
        elif kernel == "peel_stream_ring":
            cuda_stream.prepare_stream(tips, sched, pm, fr, cw)
        else:
            cuda_stream2.prepare_deep(
                tips[None], ids, pos, ls,
                cuda_stream2.chains_pm_ord(pm[:, None], ids), fr[:, None],
                cw[:, None])

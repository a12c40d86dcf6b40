"""The port's chain against the JAX package's analysis and the exact laws.

JAX runs as tests/conftest.py sets it up (CPU, x64); the port runs on the
CPU in float64, with its plain peel. The log posterior is held against JAX
at rtol 1e-10 (float64, the same arithmetic summed in other orders). The
operators are held to the tree invariants and, through short chains, to
exact distributions, with Monte Carlo tolerances stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jax_build_analysis
from beast_mcmc_tpu.inference.mcmc import apply_derived as jax_apply_derived
from beast_mcmc_tpu.inference.trace import analyze

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.convert import params_from_numpy, tree_from_numpy
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_mcmc_step,
    operator_report,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.operators import (
    DeltaExchangeOperator,
    NarrowExchangeOperator,
    RootHeightScaleOperator,
    UniformNodeHeightOperator,
    WideExchangeOperator,
    WilsonBaldingOperator,
)
from beast_mcmc_tpu_torch.models.coalescent import constant_coalescent_loglik
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    simulate_coalescent_tree,
)

from test_mcmc import check_tree_valid
from test_operator_uniformity import exact_topology_probs


def _to_numpy(tree_like):
    return jax.tree_util.tree_map(np.asarray, tree_like)


def _jax_params(model, seed):
    rng = np.random.default_rng(seed)
    p = {"clock.rate": 0.9, "pop.size": 0.7}
    if model == "gtr_gamma":
        p.update({"gtr.rates": rng.uniform(0.3, 3.0, 6), "alpha": 0.8})
    else:
        p["kappa"] = 3.5
    return {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}


@pytest.mark.parametrize("model", ["gtr_gamma", "hky"])
def test_log_post_matches_jax(model):
    """convert.py carries JAX's params (the derived eig / site.rates caches
    included) and tree; the port's log_post and log_post_cached agree with
    JAX's on them."""
    j_lp, _, j_p0, j_tree, j_aux = jax_build_analysis(
        16, 200, model=model, dtype=jnp.float64)
    t_lp, _, _, _, t_aux = build_analysis(16, 200, model=model, device="cpu")
    tree = tree_from_numpy(*(np.asarray(x) for x in (
        j_tree.parent, j_tree.children, j_tree.heights, j_tree.root)),
        device="cpu")
    for j_params in (j_p0, _jax_params(model, 1)):
        if j_aux["derived"]:
            j_params = jax_apply_derived(j_aux["derived"], j_params)
        params = params_from_numpy(_to_numpy(j_params), device="cpu")
        for j_fn, t_fn in ((j_lp, t_lp),
                           (j_aux["log_post_cached"], t_aux["log_post_cached"])):
            ref = float(jax.jit(j_fn)(j_params, j_tree))
            got = t_fn(params, tree)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(float(got), ref, rtol=1e-10)


def test_hky_codon3_waits_for_multipartition():
    with pytest.raises(NotImplementedError):
        build_analysis(8, 64, model="hky_codon3", device="cpu")


def _main_path_operators():
    """The eight operators of the main path, DeltaExchange on a 3-vector."""
    _, ops, params, tree, _ = build_analysis(10, 32, device="cpu")
    ops = ops + [DeltaExchangeOperator(parameter="mu", weight=1.0)]
    params = {**params, "mu": torch.tensor([0.5, 1.0, 1.5],
                                           dtype=torch.float64)}
    return ops, params, tree


@pytest.mark.parametrize("op_index", range(10))
def test_operator_keeps_tree_valid(op_index):
    """200 proposals, each taken when its Hastings ratio is finite: the
    tree keeps parent above child and a consistent children/parent pair,
    and parameter moves keep their support (DeltaExchange its sum)."""
    ops, params, tree = _main_path_operators()
    op = ops[op_index]
    gen = torch.Generator().manual_seed(op_index)
    tuning = op.tuning(torch.tensor(op.initial_adapt(), dtype=torch.float64))
    n_taken = 0
    for _ in range(200):
        new_params, new_tree, logh = op.propose(params, tree, gen, tuning)
        assert logh.shape == () and not bool(torch.isnan(logh))
        if bool(torch.isfinite(logh)):
            params, tree = new_params, new_tree
            n_taken += 1
            check_tree_valid(tree.parent.numpy(), tree.children.numpy(),
                             tree.heights.numpy(), int(tree.root), 10)
    assert n_taken > 0
    for name in ("gtr.rates", "alpha", "pop.size", "clock.rate", "mu"):
        assert bool(torch.all(params[name] > 0)), name
    np.testing.assert_allclose(float(params["mu"].sum()), 3.0, rtol=1e-12)


def _topology_id(tree, n_taxa=4):
    """Labeled-topology id of test_operator_uniformity.topology_id: the
    internal nodes' descendant-tip bitmasks, sorted, packed base 16."""
    children = tree.children.numpy()
    heights = tree.heights.numpy()
    masks = [1 << i for i in range(n_taxa)] + [0] * (n_taxa - 1)
    for node in np.argsort(heights[n_taxa:], kind="stable") + n_taxa:
        masks[node] = masks[children[node, 0]] | masks[children[node, 1]]
    a, b, c = sorted(masks[n_taxa:])
    return a * 256 + b * 16 + c


def _coalescent_chain(ops, n_taxa, seed, n_steps, every, record):
    """Sample the constant coalescent prior (theta 1); `record(state)` is
    taken every `every` steps."""
    rng = np.random.default_rng(1)
    tree0 = make_tree_state(*simulate_coalescent_tree(rng, np.zeros(n_taxa),
                                                      1.0), device="cpu")

    def log_post(params, tree):
        return constant_coalescent_loglik(tree.heights, n_taxa, 1.0)

    step = make_mcmc_step(log_post, ops)
    state = init_mcmc_state({}, tree0, torch.Generator().manual_seed(seed),
                            ops, log_post)
    state, out = run_chain(step, state, n_steps, every,
                           lambda s: {"x": torch.as_tensor(record(s))})
    return state, out["x"].numpy()


@pytest.mark.parametrize("op", [NarrowExchangeOperator(weight=10.0),
                                WideExchangeOperator(weight=10.0),
                                WilsonBaldingOperator(weight=10.0)],
                         ids=["narrow", "wide", "wilson_balding"])
def test_topology_operator_exact_distribution(op):
    """Under the constant coalescent on 4 contemporaneous taxa the labeled
    topologies have exact probabilities 1/18 (caterpillars) and 2/18
    (balanced), as tests/test_operator_uniformity.py checks for the JAX
    operators. 12,000 steps, the first 1,000 dropped; each frequency must
    lie within 4.5 standard errors, estimated from 20 batch means, which
    carry the chain's autocorrelation."""
    ops = [op, UniformNodeHeightOperator(weight=5.0),
           RootHeightScaleOperator(weight=2.0)]
    state, tids = _coalescent_chain(ops, 4, 7, 12_000, 1,
                                    lambda s: _topology_id(s.tree))
    tids = tids[1000:]
    exact = exact_topology_probs()
    assert set(np.unique(tids)) == set(exact), operator_report(ops, state)
    n_batch = 20
    size = len(tids) // n_batch
    for tid, p in exact.items():
        batches = (tids[:n_batch * size] == tid).reshape(n_batch, size)
        freq = batches.mean(1)
        se = freq.std(ddof=1) / np.sqrt(n_batch)
        assert abs(freq.mean() - p) < 4.5 * se, (
            f"topology {tid:x}: {freq.mean():.4f} vs exact {p:.4f} "
            f"(se {se:.4f})\n" + operator_report(ops, state))


def test_prior_sampling_root_height_expectation():
    """tests/test_mcmc.py:88 at 4 taxa: sampling the constant coalescent
    prior with the tree operators of the main path gives E[root height] =
    theta * sum_{k=2..n} 2/(k(k-1)) = 1.5, within 3.5 standard errors of
    the mean (from the effective sample size)."""
    ops = [UniformNodeHeightOperator(weight=5.0),
           RootHeightScaleOperator(weight=6.0),
           NarrowExchangeOperator(weight=3.0),
           WideExchangeOperator(weight=3.0),
           WilsonBaldingOperator(weight=3.0)]
    state, rh = _coalescent_chain(ops, 4, 8, 20_000, 5,
                                  lambda s: s.tree.heights[s.tree.root])
    stats = analyze(rh[200:])
    assert stats.ess > 100, operator_report(ops, state)
    assert abs(stats.mean - 1.5) < 3.5 * stats.std_error_of_mean, (
        f"E[root height] {stats.mean:.4f} +/- {stats.std_error_of_mean:.4f}"
        "\n" + operator_report(ops, state))
    check_tree_valid(state.tree.parent.numpy(), state.tree.children.numpy(),
                     state.tree.heights.numpy(), int(state.tree.root), 4)


def test_chain_runs_and_self_checks():
    """300 steps of the GTR+Gamma4 chain (8 taxa, 64 patterns) with the
    derived caches: the posterior stays finite, every operator is tried,
    and the carried posterior agrees with fresh evaluations within the
    reference's 0.1 (MarkovChain.java:55)."""
    log_post, ops, params0, tree0, aux = build_analysis(8, 64, device="cpu")
    lpc = aux["log_post_cached"]
    step = make_mcmc_step(lpc, ops, derived=aux["derived"])
    state = init_mcmc_state(params0, tree0, torch.Generator().manual_seed(0),
                            ops, lpc)
    assert bool(torch.isfinite(state.log_posterior))
    state, _ = run_chain(step, state, 300)
    report = operator_report(ops, state)
    assert bool(torch.isfinite(state.log_posterior)), report
    assert state.step == 300
    tried = (state.op_accept + state.op_reject).tolist()
    assert sum(tried) == 300 and min(tried) > 0, report
    assert sum(state.op_accept.tolist()) > 0, report
    state, dev = full_evaluation_check(step, log_post, state, 50,
                                       derived=aux["derived"])
    assert float(dev) < 0.1, report
    check_tree_valid(state.tree.parent.numpy(), state.tree.children.numpy(),
                     state.tree.heights.numpy(), int(state.tree.root), 8)

"""The tree operators of beast_mcmc_tpu/inference/tree_operators.py that
the subtree slide's slice left, against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - move by move: for 200 JAX keys each, JAX's own draws injected into the
    port's proposal (its draw helpers replaced by a queue) give JAX's
    topology and root, its heights to 1e-15 relative and its log Hastings
    to 1e-12; the edge pick of a masked draw is injected as the uniform
    that lands on JAX's rank, a categorical one as the middle of JAX's
    pick's share;
  - the exact labelled-topology law on 4 taxa (1/18 and 2/18) of every
    topology operator of tests/test_operator_uniformity.py but the
    constrained uniform SPR (queue item 4g), from a make_multichain_step
    batch of 256 chains with JAX's tolerance, the Gibbs moves on a
    chain-axis coalescent-only posterior;
  - the prior expectation of the root height under the node-height moves
    (tests/test_tree_operators2.py) and the uniform law of a tip's height
    under the three tip moves;
  - the Gibbs moves: chunked scores equal to unchunked ones, scores at
    build_analysis(8, 64) within 1e-10 of JAX's vmapped ones, the pick and
    Hastings of JAX at an injected uniform;
  - a chain batch gives each chain what one chain gives at the same draws;
  - chip_smoke.py's phase 14 rehearsed on the CPU at 24 taxa.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jbuild
from beast_mcmc_tpu.inference import operators as jops
from beast_mcmc_tpu.inference import tree_operators as jtops
from beast_mcmc_tpu.tree.topology import make_tree_state as jax_tree_state

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference import tree_operators as tops
from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_multichain_step,
    map_tensors,
)
from beast_mcmc_tpu_torch.models.coalescent import constant_coalescent_loglik
from beast_mcmc_tpu_torch.tree.topology import (
    TreeState,
    make_tree_state,
    simulate_coalescent_tree,
)

from test_mcmc import check_tree_valid
from test_operator_uniformity import exact_topology_probs
from test_torch_operators_ext import Queue, chains_against_singles

F64 = torch.float64
N_KEYS = 200
FIELDS = ("parent", "children", "heights", "root")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dated_np(seed, n=16):
    rng = np.random.default_rng(seed)
    tips = np.round(rng.uniform(0.0, 2.0, n), 3)
    tips -= tips.min()
    return simulate_coalescent_tree(rng, tips, 1.0)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _np_tree(t):
    return tuple(np.asarray(getattr(t, f)) for f in FIELDS)


def _rank_u(mask, idx, count):
    """The uniform that sample_masked turns into JAX's pick idx."""
    rank = jnp.cumsum(mask)[idx] - 1
    return (rank + 0.5) / jnp.maximum(count, 1)


def _jax_leap_draws(j_op, tree, key, tuning, tip):
    m = tree.parent.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    z = jax.random.normal(k1, dtype=jnp.float64)
    delta = jnp.abs(z) * tuning
    if tip:
        pool = jnp.arange(j_op.n_tips)
        k = jax.random.randint(k2, (), 0, pool.shape[0])
        node, first = pool[k], k
    else:
        first = jax.random.randint(k2, (), 0, m - 1, dtype=tree.parent.dtype)
        node = jops.sample_excluding(k2, m, tree.root[None])
    par = tree.parent[node]
    sib = jops.other_child(tree.children, par, node)
    dmask, dh = jtops._get_destinations(tree.parent, tree.children,
                                        tree.heights, node, par, sib, delta)
    if tip:
        dmask = dmask & (dh > tree.heights[node])
    idx, count = jtops.sample_masked(k3, dmask)
    return [z, first, _rank_u(dmask, idx, count)]


def _jax_fhspr_draws(tree, key):
    m = tree.parent.shape[0]
    k1, k2 = jax.random.split(key)
    root = tree.root
    ex = jnp.stack([root, tree.children[root, 0], tree.children[root, 1]])
    r = jax.random.randint(k1, (), 0, m - 3, dtype=tree.parent.dtype)
    i = jops.sample_excluding(k1, m, ex)
    ip = tree.parent[i]
    cip = jops.other_child(tree.children, ip, i)
    cand = jtops.intersecting_edges(tree.parent, tree.heights,
                                    jnp.ones((m,), bool), tree.heights[ip])
    cand = cand.at[i].set(False).at[cip].set(False)
    idx, count = jtops.sample_masked(k2, cand)
    return [r, _rank_u(cand, idx, count)]


def _jax_jump_draws(j_op, tree, key, tuning):
    m = tree.parent.shape[0]
    k1, k2 = jax.random.split(key)
    root = tree.root
    ex = jnp.stack([root, tree.children[root, 0], tree.children[root, 1]])
    r = jax.random.randint(k1, (), 0, m - 3, dtype=tree.parent.dtype)
    i = jops.sample_excluding(k1, m, ex)
    ip = tree.parent[i]
    cip = jops.other_child(tree.children, ip, i)
    h = tree.heights
    cand = jtops.intersecting_edges(tree.parent, h, jnp.ones((m,), bool),
                                    h[ip])
    cand = cand.at[i].set(False).at[cip].set(False)
    size = tuning if j_op.adaptable else jnp.asarray(j_op.size, h.dtype)
    logw = j_op._log_weights(tree.parent, h, ip, h[ip], cand, size)
    j = jax.random.categorical(k2, logw)
    w = jnp.exp(logw - jnp.max(logw))
    c = jnp.cumsum(w)
    lo = jnp.where(j > 0, c[jnp.maximum(j - 1, 0)], 0.0)
    return [r, 0.5 * (lo + c[j]) / c[-1]]


def _scale_height_draws(tree, key, m, n):
    k1, k2 = jax.random.split(key)
    return [jax.random.randint(k1, (), 0, m - n - 1, dtype=tree.parent.dtype),
            jax.random.uniform(k2, dtype=jnp.float64)]


def _fnpr_draws(tree, key, m):
    k1, k2 = jax.random.split(key)
    return [jax.random.randint(k1, (), 0, m - 1, dtype=tree.parent.dtype),
            jax.random.randint(k2, (), 0, m, dtype=tree.parent.dtype)]


def _nni_draws(tree, key, m):
    return [jax.random.randint(key, (), 0, m - 3, dtype=tree.parent.dtype)]


def _tip_u(tree, key):
    return [jax.random.uniform(key, (), jnp.float64)]


N16, M16 = 16, 31
# name: (JAX operator, port operator, tuning, draws(JAX tree, key) in the
# port's order of draws)
INJECTED = {
    "subtree_leap": (jtops.SubtreeLeapOperator(size=0.5),
                     tops.SubtreeLeapOperator(size=0.5), 0.5,
                     lambda t, k: _jax_leap_draws(None, t, k, 0.5, False)),
    "tip_leap": (jtops.TipLeapOperator(size=0.5, n_tips=N16),
                 tops.TipLeapOperator(size=0.5, n_tips=N16), 0.5,
                 lambda t, k: _jax_leap_draws(
                     jtops.TipLeapOperator(n_tips=N16), t, k, 0.5, True)),
    "fnpr": (jtops.FNPROperator(), tops.FNPROperator(), None,
             lambda t, k: _fnpr_draws(t, k, M16)),
    "nni": (jtops.NNIOperator(), tops.NNIOperator(), None,
            lambda t, k: _nni_draws(t, k, M16)),
    "fixed_height_spr": (jtops.FixedHeightSPROperator(),
                         tops.FixedHeightSPROperator(), None,
                         _jax_fhspr_draws),
    "subtree_jump": (jtops.SubtreeJumpOperator(size=0.3),
                     tops.SubtreeJumpOperator(size=0.3), 0.3,
                     lambda t, k: _jax_jump_draws(
                         jtops.SubtreeJumpOperator(size=0.3), t, k, 0.3)),
    "subtree_jump_uniform": (
        jtops.SubtreeJumpOperator(uniform=True, adaptable=False),
        tops.SubtreeJumpOperator(uniform=True, adaptable=False), None,
        lambda t, k: _jax_jump_draws(
            jtops.SubtreeJumpOperator(uniform=True, adaptable=False), t, k,
            None)),
    "scale_node_height": (jtops.ScaleNodeHeightOperator(),
                          tops.ScaleNodeHeightOperator(), 0.8,
                          lambda t, k: _scale_height_draws(t, k, M16, N16)),
    "random_walk_node_height": (
        jtops.RandomWalkNodeHeightOperator(),
        tops.RandomWalkNodeHeightOperator(),
        0.3, lambda t, k: _scale_height_draws(t, k, M16, N16)),
    "tip_height_random_walk": (jtops.TipHeightRandomWalkOperator(tip=5),
                               tops.TipHeightRandomWalkOperator(tip=5), 1.5,
                               _tip_u),
    "tip_height_uniform": (jtops.TipHeightUniformOperator(tip=6),
                           tops.TipHeightUniformOperator(tip=6), None, _tip_u),
    "tip_height_scale": (jtops.TipHeightScaleOperator(tip=7),
                         tops.TipHeightScaleOperator(tip=7), 0.3, _tip_u),
}


# the operators whose draws on this tree are rejected now and then (the
# fixed-height moves reject only a height no other edge spans)
REJECTING = {"fnpr", "nni", "scale_node_height", "random_walk_node_height",
             "tip_height_random_walk", "tip_height_scale"}


@pytest.mark.parametrize("name", sorted(INJECTED))
def test_injected_draws_match_jax(monkeypatch, name):
    """For 200 JAX keys on a 16-taxon tree with dated tips: JAX's proposal
    against the port's at JAX's draws. A finite log Hastings gives the same
    tree (heights to 1e-15 relative) and a valid one; an infinite one the
    same; both finite and infinite ratios occur for the operators that
    reject on this tree."""
    j_op, t_op, tuning, draws = INJECTED[name]
    tree_np = _dated_np(sorted(INJECTED).index(name) + 3)
    j_tree = jax_tree_state(*tree_np, dtype=jnp.float64)
    t_tree = make_tree_state(*tree_np, F64, "cpu")
    tun_j = 1.0 if tuning is None else tuning

    def jax_side(key):
        _, new, logq = j_op.propose({}, j_tree, key, tun_j)
        return new, logq, draws(j_tree, key)

    keys = jax.random.split(jax.random.PRNGKey(7), N_KEYS)
    j_new, j_logq, j_draws = _np(jax.jit(jax.vmap(jax_side))(keys))
    j_trees = _np_tree(j_new)
    queue = Queue(monkeypatch)
    tun = None if tuning is None else torch.tensor(tuning, dtype=F64)
    finite = 0
    for n in range(N_KEYS):
        queue.items = [d[n] for d in j_draws]
        _, t_new, t_logq = t_op.propose({}, t_tree, None, tun)
        assert not queue.items
        ref = float(j_logq[n])
        got = float(t_logq)
        if math.isfinite(ref):
            finite += 1
            assert got == pytest.approx(ref, rel=1e-12, abs=1e-12), n
            got_tree = _np_tree(t_new)
            np.testing.assert_array_equal(got_tree[0], j_trees[0][n])
            np.testing.assert_array_equal(got_tree[1], j_trees[1][n])
            assert int(got_tree[3]) == int(j_trees[3][n])
            np.testing.assert_allclose(got_tree[2], j_trees[2][n],
                                       rtol=1e-15, atol=0)
            check_tree_valid(*got_tree, N16)
        else:
            assert got == ref, n
    assert finite > 0
    if name in REJECTING:
        assert finite < N_KEYS


def test_destinations_and_mrca_match_jax():
    """The pointer-doubling destination set and MRCA heights against JAX's
    walks, at every node of a dated tree and three distances."""
    tree_np = _dated_np(11, 24)
    j_tree = jax_tree_state(*tree_np, dtype=jnp.float64)
    t_tree = make_tree_state(*tree_np, F64, "cpu")
    m = tree_np[0].shape[0]
    nodes = np.repeat([n for n in range(m) if n != int(tree_np[3])], 3)
    deltas = np.tile([0.05, 0.4, 3.0], len(nodes) // 3)

    def jax_side(node, delta):
        par = j_tree.parent[node]
        sib = jops.other_child(j_tree.children, par, node)
        return (*jtops._get_destinations(j_tree.parent, j_tree.children,
                                         j_tree.heights, node, par, sib,
                                         delta),
                jtops.mrca_heights_from(j_tree.parent, j_tree.heights, node))

    j_mask, j_h, j_mrca = _np(jax.jit(jax.vmap(jax_side))(
        jnp.asarray(nodes), jnp.asarray(deltas)))
    for n, (node, delta) in enumerate(zip(nodes, deltas)):
        nd = torch.tensor([int(node)])
        tpar = t_tree.parent[nd]
        tm, th = tops._get_destinations(
            t_tree.parent, t_tree.heights, nd, tpar,
            ops.other_child(t_tree.children, tpar, nd),
            torch.tensor(delta, dtype=F64))
        np.testing.assert_array_equal(tm.numpy(), j_mask[n])
        np.testing.assert_allclose(th.numpy(), j_h[n], rtol=1e-15)
        np.testing.assert_array_equal(
            tops.mrca_heights_from(t_tree.parent, t_tree.heights,
                                   nd).numpy(), j_mrca[n])


# ---------------------------------------------------------------------------
# laws on chain batches
# ---------------------------------------------------------------------------


def _topology_ids(parent, children, n_taxa=4):
    """The labelled-topology id of tests/test_operator_uniformity.py for a
    batch of trees (numpy [B, M], [B, M, 2])."""
    b_n, m = parent.shape
    masks = np.zeros((b_n, m), np.int64)
    masks[:, :n_taxa] = 1 << np.arange(n_taxa)
    rows = np.arange(b_n)[:, None]
    for _ in range(n_taxa - 1):  # every internal node from its children
        internal = masks[rows, children[:, n_taxa:, 0]] | \
            masks[rows, children[:, n_taxa:, 1]]
        masks[:, n_taxa:] = internal
    internal = np.sort(masks[:, n_taxa:], axis=1)
    return internal[:, 0] * 256 + internal[:, 1] * 16 + internal[:, 2]


def _coalescent4(params, tree):
    return constant_coalescent_loglik(tree.heights, 4, 1.0)


LAW_OPERATORS = {
    "subtree_slide": lambda: tops.SubtreeSlideOperator(weight=10.0, size=1.0),
    "subtree_leap": lambda: tops.SubtreeLeapOperator(weight=10.0, size=1.0),
    "narrow_exchange": lambda: ops.NarrowExchangeOperator(weight=10.0),
    "wide_exchange": lambda: ops.WideExchangeOperator(weight=10.0),
    "wilson_balding": lambda: ops.WilsonBaldingOperator(weight=10.0),
    "fnpr": lambda: tops.FNPROperator(weight=10.0),
    "nni": lambda: tops.NNIOperator(weight=10.0),
    "fixed_height_spr": lambda: tops.FixedHeightSPROperator(weight=10.0),
    "subtree_jump": lambda: tops.SubtreeJumpOperator(weight=10.0, size=1.0),
    "subtree_jump_uniform": lambda: tops.SubtreeJumpOperator(
        weight=10.0, uniform=True, adaptable=False),
    "gibbs_prune_regraft": lambda: tops.GibbsPruneAndRegraftOperator(
        weight=10.0),
    "gibbs_subtree_swap": lambda: tops.GibbsSubtreeSwapOperator(weight=10.0),
    "tip_leap": lambda: tops.TipLeapOperator(weight=10.0, size=1.0, n_tips=4),
}
LAW_CHAINS, LAW_STEPS, LAW_BURN, LAW_EVERY = 256, 600, 100, 2


@pytest.mark.parametrize("name", sorted(LAW_OPERATORS))
def test_topology_law_exact_on_a_batch(monkeypatch, name):
    """tests/test_operator_uniformity.py's exact labelled-topology law on
    4 taxa with its tolerance (5 standard errors at an effective size of
    the samples / 50, plus 0.005), from 256 chains of 600 steps (the first
    100 dropped, every second kept) with UniformNodeHeight and
    RootHeightScale under the constant coalescent; all 15 topologies
    reached. The Gibbs moves score each enumeration of the 256 chains in
    one chunk (the chunk leaves the law as it is:
    test_gibbs_chunked_scores_equal_unchunked)."""
    monkeypatch.setattr(tops, "CPU_CHUNK", 4096)
    tree_np = simulate_coalescent_tree(np.random.default_rng(1), np.zeros(4),
                                       1.0)
    operators = [LAW_OPERATORS[name](), ops.UniformNodeHeightOperator(
        weight=5.0), ops.RootHeightScaleOperator(weight=2.0)]
    tree0 = make_tree_state(*tree_np, F64, "cpu")
    st = init_mcmc_state({}, tree0, torch.Generator().manual_seed(7),
                         operators, _coalescent4)
    states = replicate_state(st, LAW_CHAINS, torch.Generator().manual_seed(8))
    mstep = make_multichain_step(_coalescent4, operators)
    tids = []
    for s in range(LAW_STEPS):
        states = mstep(states)
        if s >= LAW_BURN and (s - LAW_BURN) % LAW_EVERY == 0:
            tids.append(_topology_ids(states.tree.parent.numpy(),
                                      states.tree.children.numpy()))
    tids = np.concatenate(tids)
    exact = exact_topology_probs()
    assert set(np.unique(tids)) == set(exact), name
    n_eff = len(tids) / 50.0
    for tid, p in exact.items():
        freq = float(np.mean(tids == tid))
        tol = 5.0 * math.sqrt(p * (1 - p) / n_eff) + 0.005
        assert abs(freq - p) < tol, (name, hex(tid), freq, p, tol)
    assert int(states.op_accept[:, 0].sum()) > 0


def _node_height_chain(op, n_chains=64, n_steps=400, burn=100, seed=4):
    """(root heights [kept steps, chains], states) of a batch with `op`
    and RootHeightScale on a 6-taxon coalescent tree (theta 1)."""
    tree_np = simulate_coalescent_tree(np.random.default_rng(seed),
                                       np.zeros(6), 1.0)

    def log_post(params, tree):
        return constant_coalescent_loglik(tree.heights, 6, 1.0)

    operators = [op, ops.RootHeightScaleOperator(weight=3.0)]
    tree0 = make_tree_state(*tree_np, F64, "cpu")
    st = init_mcmc_state({}, tree0, torch.Generator().manual_seed(seed),
                         operators, log_post)
    states = replicate_state(st, n_chains,
                             torch.Generator().manual_seed(seed + 1))
    mstep = make_multichain_step(log_post, operators)
    rh = []
    for s in range(n_steps):
        states = mstep(states)
        if s >= burn:
            rows = torch.arange(n_chains)
            rh.append(states.tree.heights[rows, states.tree.root].numpy())
    return np.asarray(rh), states


@pytest.mark.parametrize("op", [
    tops.ScaleNodeHeightOperator(weight=8.0),
    tops.RandomWalkNodeHeightOperator(window=0.5, weight=8.0),
    tops.NNIOperator(weight=5.0),
    tops.FixedHeightSPROperator(weight=5.0)],
    ids=["scale_h", "walk_h", "nni", "fhspr"])
def test_height_and_topology_moves_prior_expectation(op):
    """tests/test_tree_operators2.py's oracle on a batch: the root height's
    mean under the constant coalescent on 6 taxa, theta sum 2 / (k (k - 1))
    = 1.6667, within 4 standard errors of 32 batch means (64 chains of 300
    kept steps, the node-height moves with RootHeightScale alone, NNI and
    FHSPR with UniformNodeHeight too); the operator accepted; the trees
    valid."""
    if isinstance(op, (tops.NNIOperator, tops.FixedHeightSPROperator)):
        op = [op, ops.UniformNodeHeightOperator(weight=8.0)]
    ops_ = op if isinstance(op, list) else [op]
    rh, states = _node_height_chain(ops_[0] if len(ops_) == 1 else
                                    ops.JointOperator(sub_operators=ops_,
                                                      weight=8.0))
    expected = sum(2.0 / (k * (k - 1)) for k in range(2, 7))
    batches = rh.T.reshape(32, -1).mean(1)
    se = batches.std(ddof=1) / math.sqrt(32)
    assert abs(batches.mean() - expected) < 4.0 * se, (batches.mean(), se)
    assert int(states.op_accept[:, 0].sum()) > 100
    for b in range(0, 64, 16):
        check_tree_valid(*(getattr(states.tree, f)[b].numpy()
                           for f in FIELDS), 6)


@pytest.mark.parametrize("op", [
    tops.TipHeightRandomWalkOperator(tip=2, window=0.3),
    tops.TipHeightUniformOperator(tip=2),
    tops.TipHeightScaleOperator(tip=2, scale_factor=0.5)],
    ids=lambda o: type(o).__name__)
def test_tip_height_moves_uniform_law(op):
    """A flat posterior in a tip's height on a fixed tree: the tip's height
    is uniform on [0, its parent's height), mean h/2 and variance h^2/12,
    within 4.5 standard errors of 32 batch means (64 chains of 300 kept
    steps); a rejected move leaves the height as it was."""
    par, ch, h, root = simulate_coalescent_tree(np.random.default_rng(2),
                                                np.zeros(5), 1.0)
    h_p = float(h[par[2]])
    h = h.copy()
    h[2] = 0.5 * h_p  # a scale move never leaves 0
    tree0 = make_tree_state(par, ch, h, root, F64, "cpu")

    def log_post(params, tree):
        return torch.zeros(tree.heights.shape[:-1], dtype=F64)

    st = init_mcmc_state({}, tree0, torch.Generator().manual_seed(3), [op],
                         log_post)
    states = replicate_state(st, 64, torch.Generator().manual_seed(5))
    mstep = make_multichain_step(log_post, [op])
    tip = []
    for s in range(400):
        states = mstep(states)
        if s >= 100:
            tip.append(states.tree.heights[:, 2].numpy().copy())
    tip = np.asarray(tip).T
    assert (tip >= 0).all() and (tip < h_p).all()
    for stat, want in ((tip, h_p / 2), ((tip - h_p / 2) ** 2, h_p ** 2 / 12)):
        b = stat.reshape(32, -1).mean(1)
        se = b.std(ddof=1) / math.sqrt(32)
        assert abs(b.mean() - want) < 4.5 * se, (b.mean(), want, se)


# ---------------------------------------------------------------------------
# the Gibbs moves
# ---------------------------------------------------------------------------


def _gibbs_setup():
    """JAX's and the port's build_analysis(8, 64) posteriors on one random
    tree: (j_lp, j_params, j_tree, lp_chains, params, tree)."""
    j_lp, _, j_p0, _, _ = jbuild(8, 64, dtype=jnp.float64)
    _, _, p0, _, aux = build_analysis(8, 64, device="cpu")
    tree_np = simulate_coalescent_tree(np.random.default_rng(12), np.zeros(8),
                                       0.4)
    return (j_lp, j_p0, jax_tree_state(*tree_np, dtype=jnp.float64),
            aux["log_post_chains"], p0, make_tree_state(*tree_np, F64, "cpu"))


def _jax_regraft(tree, ip, cip, pip, j):
    jp = tree.parent[j]
    ch = jops.replace_child(tree.children, pip, ip, cip)
    ch = jops.replace_child(ch, jp, j, ip)
    ch = jops.replace_child(ch, ip, cip, j)
    par = tree.parent.at[cip].set(pip).at[ip].set(jp).at[j].set(ip)
    return tree.replace(parent=par, children=ch)


def _jax_swap(tree, a, b):
    ap, bp = tree.parent[a], tree.parent[b]
    par = tree.parent.at[a].set(bp).at[b].set(ap)
    ch = jops.replace_child(tree.children, ap, a, b)
    ch = jops.replace_child(ch, bp, b, a)
    return tree.replace(parent=par, children=ch)


def _jax_partners(t, a, root, m):
    apar = t.parent[a]
    ar = jnp.arange(m)
    return ((ar != a) & (ar != root) & (t.parent != apar) & (ar != apar)
            & (t.parent != a) & (t.heights < t.heights[apar])
            & (t.heights[a] < t.heights[t.parent]))


def _mid_share(scores, j):
    """The uniform in the middle of pick j's share of softmax(scores)."""
    w = np.exp(scores - scores.max())
    c = np.cumsum(w)
    return 0.5 * ((c[j - 1] if j > 0 else 0.0) + c[j]) / c[-1]


class ChainDraws:
    """The Gibbs moves' draws (`_chain_randint`, `_chain_uniforms`) given."""

    def __init__(self, monkeypatch):
        self.ints, self.us = [], []
        monkeypatch.setattr(tops, "_chain_randint", lambda g, high, b, d:
                            torch.tensor(self.ints.pop(0)))
        monkeypatch.setattr(tops, "_chain_uniforms", lambda g, like, b:
                            torch.tensor(self.us.pop(0), dtype=like.dtype))


def test_gibbs_prune_regraft_matches_jax(monkeypatch):
    """For 8 JAX keys at build_analysis(8, 64): every candidate's score
    within 1e-10 relative of JAX's vmapped score (only the candidates
    scored, the rest -inf), and at JAX's node and the uniform in the middle
    of JAX's pick's share, JAX's tree and log Hastings (1e-10)."""
    j_lp, j_p0, j_tree, lp_chains, p0, tree = _gibbs_setup()
    m = j_tree.parent.shape[0]
    nodes = jnp.arange(m, dtype=jnp.int32)  # as JAX's proposal enumerates
    j_op = jtops.GibbsPruneAndRegraftOperator()
    j_op.bind_log_posterior(j_lp)

    def jax_side(key):
        _, new, logq = j_op.propose(j_p0, j_tree, key, None)
        k1, k2 = jax.random.split(key)
        root = j_tree.root
        ex = jnp.stack([root, j_tree.children[root, 0],
                        j_tree.children[root, 1]])
        r = jax.random.randint(k1, (), 0, m - 3, dtype=j_tree.parent.dtype)
        i = jops.sample_excluding(k1, m, ex)
        ip = j_tree.parent[i]
        cip = jops.other_child(j_tree.children, ip, i)
        pip = j_tree.parent[ip]
        cand = jtops.intersecting_edges(j_tree.parent, j_tree.heights,
                                        jnp.ones((m,), bool),
                                        j_tree.heights[ip])
        cand = cand.at[i].set(False).at[cip].set(False)
        scores = jax.vmap(lambda j: j_lp(j_p0, _jax_regraft(
            j_tree, ip, cip, pip, j)))(nodes)
        scores = jnp.where(cand, scores, -jnp.inf)
        return new, logq, r, scores, jax.random.categorical(k2, scores)

    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    j_new, j_logq, rs, j_scores, j_picks = _np(
        jax.jit(jax.vmap(jax_side))(keys))
    j_trees = _np_tree(j_new)
    op = tops.GibbsPruneAndRegraftOperator(log_posterior_chains=lp_chains)
    draws = ChainDraws(monkeypatch)
    for n in range(8):
        scores = j_scores[n]
        cand = np.isfinite(scores)
        draws.ints = [np.array([rs[n]])]
        draws.us = [np.array([_mid_share(scores, int(j_picks[n]))])]
        _, t_new, t_logq = op.propose(p0, tree, None, None)
        assert not draws.ints and not draws.us
        got = op.last_scores[0][0].numpy()
        assert op.last_candidates == [int(cand.sum())]
        np.testing.assert_array_equal(np.isfinite(got), cand)
        np.testing.assert_allclose(got[cand], scores[cand], rtol=1e-10)
        np.testing.assert_array_equal(t_new.parent.numpy(), j_trees[0][n])
        np.testing.assert_array_equal(t_new.children.numpy(), j_trees[1][n])
        assert float(t_logq) == pytest.approx(float(j_logq[n]), rel=1e-10,
                                              abs=1e-10)


def test_gibbs_subtree_swap_matches_jax(monkeypatch):
    """As the prune-and-regraft test, for the swap: the forward
    enumeration's scores and the reverse one's (its tree at the pick, the
    current tree, scored apart) within 1e-10 of JAX's, JAX's tree and log
    Hastings at JAX's node and the middle of its pick's share."""
    j_lp, j_p0, j_tree, lp_chains, p0, tree = _gibbs_setup()
    m = j_tree.parent.shape[0]
    nodes = jnp.arange(m, dtype=jnp.int32)  # as JAX's proposal enumerates
    j_op = jtops.GibbsSubtreeSwapOperator()
    j_op.bind_log_posterior(j_lp)
    root = j_tree.root

    def jax_side(key):
        _, new, logq = j_op.propose(j_p0, j_tree, key, None)
        k1, k2 = jax.random.split(key)
        r = jax.random.randint(k1, (), 0, m - 1, dtype=j_tree.parent.dtype)
        i = jops.sample_excluding(k1, m, root[None])
        cand = _jax_partners(j_tree, i, root, m)
        scores = jnp.where(cand, jax.vmap(lambda j: j_lp(
            j_p0, _jax_swap(j_tree, i, j)))(nodes), -jnp.inf)
        j = jax.random.categorical(k2, scores).astype(jnp.int32)
        t2 = _jax_swap(j_tree, i, j)
        cand_b = _jax_partners(t2, i, root, m)
        scores_b = jnp.where(cand_b, jax.vmap(lambda k: j_lp(
            j_p0, _jax_swap(t2, i, k)))(nodes), -jnp.inf)
        return new, logq, r, scores, j, scores_b

    keys = jax.random.split(jax.random.PRNGKey(4), 8)
    j_new, j_logq, rs, j_scores, j_picks, j_back = _np(
        jax.jit(jax.vmap(jax_side))(keys))
    j_trees = _np_tree(j_new)
    op = tops.GibbsSubtreeSwapOperator(log_posterior_chains=lp_chains)
    draws = ChainDraws(monkeypatch)
    for n in range(8):
        draws.ints = [np.array([rs[n]])]
        draws.us = [np.array([_mid_share(j_scores[n], int(j_picks[n]))])]
        _, t_new, t_logq = op.propose(p0, tree, None, None)
        for got, ref in zip(op.last_scores, (j_scores[n], j_back[n])):
            got = got[0].numpy()
            np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
            ok = np.isfinite(ref)
            np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-10)
        assert op.last_candidates == [int(np.isfinite(j_scores[n]).sum()),
                                      int(np.isfinite(j_back[n]).sum()) - 1]
        np.testing.assert_array_equal(t_new.parent.numpy(), j_trees[0][n])
        np.testing.assert_array_equal(t_new.children.numpy(), j_trees[1][n])
        assert float(t_logq) == pytest.approx(float(j_logq[n]), rel=1e-10,
                                              abs=1e-10)


@pytest.mark.parametrize("cls", [tops.GibbsPruneAndRegraftOperator,
                                 tops.GibbsSubtreeSwapOperator],
                         ids=["prune_regraft", "subtree_swap"])
def test_gibbs_chunked_scores_equal_unchunked(monkeypatch, cls):
    """Three chains of build_analysis(8, 64), each with its own tree: the
    scores, trees and log Hastings of a proposal in chunks of CPU_CHUNK
    trees (a chunk boundary crossed) equal, exactly, those of one chunk
    for all (chain, candidate) pairs; the posterior calls are the current
    trees' one and ceil(candidates / chunk) an enumeration."""
    _, _, p0, _, aux = build_analysis(8, 64, device="cpu")
    trees = [make_tree_state(*simulate_coalescent_tree(
        np.random.default_rng(40 + b), np.zeros(8), 0.4), F64, "cpu")
        for b in range(3)]
    tree = TreeState(*(torch.stack([getattr(t, f) for t in trees])
                       for f in FIELDS))
    params = map_tensors(lambda v: torch.stack([v] * 3), p0)
    op = cls()
    op.bind_log_posterior_chains(aux["log_post_chains"])
    out = []
    small = tops.CPU_CHUNK
    for chunk in (small, 4096):
        monkeypatch.setattr(tops, "CPU_CHUNK", chunk)
        _, new, logq = op.propose_chains(
            params, tree, torch.Generator().manual_seed(5), None)
        assert op.last_calls == 1 + sum(-(-n // chunk)
                                        for n in op.last_candidates)
        out.append((op.last_scores, new, logq, list(op.last_candidates)))
    assert max(out[0][3]) > small
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    for f in FIELDS:
        assert torch.equal(getattr(out[0][1], f), getattr(out[1][1], f))
    assert torch.equal(out[0][2], out[1][2])
    assert torch.isfinite(out[0][2]).any()


CHAIN_OPS = {
    "subtree_leap": (lambda: tops.SubtreeLeapOperator(), 0.5),
    "tip_leap": (lambda: tops.TipLeapOperator(n_tips=12), 0.5),
    "fnpr": (lambda: tops.FNPROperator(), None),
    "nni": (lambda: tops.NNIOperator(), None),
    "fixed_height_spr": (lambda: tops.FixedHeightSPROperator(), None),
    "subtree_jump": (lambda: tops.SubtreeJumpOperator(), 0.3),
    "subtree_jump_uniform": (lambda: tops.SubtreeJumpOperator(
        uniform=True, adaptable=False), None),
    "scale_node_height": (lambda: tops.ScaleNodeHeightOperator(), 0.8),
    "random_walk_node_height": (lambda: tops.RandomWalkNodeHeightOperator(),
                                0.2),
    "tip_height_random_walk": (lambda: tops.TipHeightRandomWalkOperator(
        tip=3), 0.5),
    "tip_height_uniform": (lambda: tops.TipHeightUniformOperator(tip=3),
                           None),
    "tip_height_scale": (lambda: tops.TipHeightScaleOperator(tip=3), 0.6),
    "gibbs_prune_regraft": (lambda: tops.GibbsPruneAndRegraftOperator(),
                            None),
    "gibbs_subtree_swap": (lambda: tops.GibbsSubtreeSwapOperator(), None),
}


@pytest.mark.parametrize("name", sorted(CHAIN_OPS))
def test_chain_batch_equals_single_chains(monkeypatch, name):
    """Four chains of build_analysis(12, 32) (the Gibbs moves score by its
    chain-axis posterior), each on its own dated tree and tuning: the
    batch's proposal (vmapped; the Gibbs moves' own chain-axis one) against
    four single proposals at the batch's draws, rtol 1e-12."""
    make, tuning = CHAIN_OPS[name]
    op = make()
    _, _, p0, _, aux = build_analysis(12, 32, device="cpu")
    trees = [make_tree_state(*_dated_np(60 + b, 12), F64, "cpu")
             for b in range(4)]
    params = {k: torch.stack([p0[k]] * 4)
              for k in ("gtr.rates", "alpha", "clock.rate", "pop.size")}
    if hasattr(op, "bind_log_posterior"):
        op.bind_log_posterior_chains(aux["log_post_chains"])
        op.log_posterior_chains = aux["log_post_chains"]
    tun = (None if tuning is None else
           torch.tensor([tuning * (1 + 0.1 * b) for b in range(4)],
                        dtype=F64))
    logh = chains_against_singles(monkeypatch, op, params, trees, tun)
    assert torch.isfinite(logh).any()


def test_phase14_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's phase 14 on the CPU at 24 taxa (phase 12's document
    shape, 300 sites): the likelihood evaluations counted where the card
    counts peel_stream launches, so each part's exact launch count holds;
    every deviation, tree and density check passes."""
    import time

    import chip_smoke
    from beast_mcmc_tpu_torch.models import treelikelihood as tl

    calls = [0]
    site = tl._site_logliks

    def counted(*a, **k):
        calls[0] += 1
        return site(*a, **k)

    monkeypatch.setattr(tl, "_site_logliks", counted)

    def reset():
        calls[0] = 0

    def read():
        return {"peel_resident": 0, "peel_stream": calls[0],
                "peel_stream_ring": 0, "peel_mxu": 0}

    def device_ms(fn, label, n=1, top=6):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0) / n, None

    doc = str(tmp_path / "doc.xml")
    chip_smoke.spec_document(doc, 24, 300, 666, "cpu")
    rec, launches = chip_smoke.operators_path(
        doc, reset, read, device_ms, "cpu", n_steps=36, n_profile=4,
        c_steps=20, c_profile=3, d_steps=20, bssvs_shape=(10, 60))
    assert launches["P14 14a one chain"]["peel_stream"] == 1 + 2 * 36 + 4
    assert len(rec["14b"]) == chip_smoke.B14_PAR + chip_smoke.B14_SWAP
    assert all(r["launches"] == 2 + sum(-(-n // r["chunk"])
                                        for n in r["candidates"])
               for r in rec["14b"])
    assert rec["14c"]["max_deviation"] <= chip_smoke.FULL_EVAL_TOL
    assert rec["14d"]["densities"] == 38

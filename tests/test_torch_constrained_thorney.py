"""Constrained trees for Thorney BEAST (queue item 4h-3's
tree/constrained.py) against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - parse_multifurcating_newick, build_constrained_tree (the same numpy
    Generator gives the same tree, heights and groups) and
    clades_of_constraints equal to JAX's, through
    convert.constrained_tree_from_numpy too;
  - the eligible-node mask against JAX's;
  - ConstrainedNNIOperator and ConstrainedUniformSPROperator at JAX's
    draws: for 40 JAX keys each, JAX's Gumbel pick injected as the uniform
    that lands on its rank and JAX's attachment uniform as it is, the
    port's tree equals JAX's (heights to 1e-15) and its log Hastings to
    1e-12;
  - by law: tests/test_constrained_thorney.py's chains (constrained NNI,
    then the constrained SPR, with node-height moves under the Poisson
    branch-length likelihood on 40 tips) keep every constraint clade in
    every kept tree and change the topology; the exact labelled-topology
    law on 4 taxa (tests/test_operator_uniformity.py, all groups equal)
    of both operators from a batch of 256 chains; each chain-axis proposal
    equals single proposals at the batch's draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.tree import constrained as jcon
from beast_mcmc_tpu.tree.topology import make_tree_state as jax_tree_state

from beast_mcmc_tpu_torch import convert
from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    make_multichain_step,
    run_chain,
)
from beast_mcmc_tpu_torch.models.coalescent import constant_coalescent_loglik
from beast_mcmc_tpu_torch.models.thorney import poisson_branch_length_loglik
from beast_mcmc_tpu_torch.tree import constrained as tcon
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from test_constrained_thorney import (
    _descendant_sets,
    _random_constraints_newick,
)
from test_operator_uniformity import exact_topology_probs
from test_torch_operators_ext import Queue, chains_against_singles
from test_torch_tree_operators_ext import _rank_u, _topology_ids

F64 = torch.float64
FIELDS = ("parent", "children", "heights", "root")
N_KEYS = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _built(seed, n_tips=40):
    rng = np.random.default_rng(seed)
    newick = _random_constraints_newick(rng, n_tips)
    state = rng.bit_generator.state
    got = tcon.build_constrained_tree(newick, rng)
    rng.bit_generator.state = state
    want = jcon.build_constrained_tree(newick, rng)
    return newick, got, want


@pytest.mark.parametrize("seed", [5, 9])
def test_construction_matches_jax(seed):
    newick, got, want = _built(seed)
    assert tcon.parse_multifurcating_newick(newick) == \
        jcon.parse_multifurcating_newick(newick)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[5] == want[5]
    assert tcon.clades_of_constraints(newick) == \
        jcon.clades_of_constraints(newick)
    tree, groups = convert.constrained_tree_from_numpy(*want[:5], F64, "cpu")
    for f, a in zip(FIELDS, want[:4]):
        np.testing.assert_array_equal(getattr(tree, f).numpy(), a)
    np.testing.assert_array_equal(groups, want[4])
    jt = jax_tree_state(*want[:4])
    np.testing.assert_array_equal(
        tcon._eligible_nni_mask(tree.parent, torch.tensor(groups)).numpy(),
        np.asarray(jcon._eligible_nni_mask(jt, jnp.asarray(want[4]))))


def _jax_draws(name, tree, groups, key):
    """The port's draws that reproduce JAX's proposal with `key`: the
    uniform landing on the rank of JAX's Gumbel pick, and for the SPR
    JAX's attachment uniform."""
    mask = jcon._eligible_nni_mask(tree, groups)
    count = jnp.sum(mask)
    k1 = key if name == "nni" else jax.random.split(key)[0]
    g = jax.random.gumbel(k1, mask.shape)
    i = jnp.argmax(jnp.where(mask, g, -jnp.inf))
    draws = [float(_rank_u(mask, i, count))]
    if name == "spr":
        k2 = jax.random.split(key)[1]
        draws.append(float(jax.random.uniform(k2, (), jnp.float64)))
    return draws


@pytest.mark.parametrize("name", ["nni", "spr"])
def test_operators_at_jax_draws(monkeypatch, name):
    """For N_KEYS JAX keys: JAX's proposal against the port's at JAX's
    draws, on a constrained 40-taxon tree."""
    _, _, want = _built(5)
    groups = want[4]
    jt = jax_tree_state(*want[:4])
    tt = make_tree_state(*want[:4], F64, "cpu")
    cls = {"nni": "ConstrainedNNIOperator",
           "spr": "ConstrainedUniformSPROperator"}[name]
    j_op = getattr(jcon, cls)(groups=groups)
    t_op = getattr(tcon, cls)(groups=groups)
    queue = Queue(monkeypatch)
    jg = jnp.asarray(groups)
    finite = 0
    for k in range(N_KEYS):
        key = jax.random.PRNGKey(k)
        _, jt2, jlogh = j_op.propose({}, jt, key, None)
        queue.items = _jax_draws(name, jt, jg, key)
        _, tt2, tlogh = t_op.propose({}, tt, None, None)
        assert queue.items == []
        for f in ("parent", "children", "root"):
            np.testing.assert_array_equal(getattr(tt2, f).numpy(),
                                          np.asarray(getattr(jt2, f)))
        np.testing.assert_allclose(tt2.heights.numpy(),
                                   np.asarray(jt2.heights), rtol=1e-15)
        if math.isfinite(float(jlogh)):
            finite += 1
            np.testing.assert_allclose(float(tlogh), float(jlogh),
                                       rtol=1e-12, atol=1e-15)
        else:
            assert float(tlogh) == float(jlogh)
    assert finite > N_KEYS // 4


def _clades_kept(trace, names, constraints):
    n_tips = len(names)
    topos = set()
    for parent, children, root in trace:
        clades = _descendant_sets(parent, children, root, n_tips, names)
        for c in constraints:
            if len(c) < n_tips:
                assert c in clades, f"constraint clade broken: {sorted(c)}"
        topos.add(frozenset(clades))
    return topos


@pytest.mark.parametrize("name", ["nni", "spr"])
def test_constrained_chain_preserves_clades_and_mixes(name):
    """tests/test_constrained_thorney.py's chains on the port: 1,500 steps
    (the tree kept every 100th), every constraint clade in every kept
    tree, the constrained move accepted more than 10 times and more than
    one topology."""
    newick, _, want = _built(5 if name == "nni" else 9)
    parent, children, heights, root, groups, names = want
    tree0 = make_tree_state(parent, children, heights, root, F64, "cpu")
    rng = np.random.default_rng(3)
    t = np.where(parent >= 0, heights[np.maximum(parent, 0)] - heights, 0.0)
    muts = torch.tensor(rng.poisson(t * 100.0 + 0.5), dtype=F64)

    def log_post(params, tree):
        return poisson_branch_length_loglik(muts, tree.parent, tree.heights,
                                            params["clock.rate"], 100.0)

    move = (tcon.ConstrainedNNIOperator(groups=groups, weight=10.0)
            if name == "nni" else
            tcon.ConstrainedUniformSPROperator(groups=groups, weight=10.0))
    operators = [move, ops.UniformNodeHeightOperator(weight=10.0 if name ==
                                                     "nni" else 5.0),
                 ops.RootHeightScaleOperator(weight=2.0),
                 ops.ScaleOperator(parameter="clock.rate", weight=2.0)]
    step = make_mcmc_step(log_post, operators)
    st = init_mcmc_state({"clock.rate": torch.tensor(1.0, dtype=F64)}, tree0,
                         torch.Generator().manual_seed(3), operators,
                         log_post)
    trace = []
    for _ in range(15):
        st, _ = run_chain(step, st, 100)
        trace.append(tuple(getattr(st.tree, f).numpy() for f in
                           ("parent", "children")) + (int(st.tree.root),))
    assert math.isfinite(float(st.log_posterior))
    assert int(st.op_accept[0]) > 10, int(st.op_accept[0])
    topos = _clades_kept(trace, names, set(tcon.clades_of_constraints(
        newick)))
    assert len(topos) > 1, "topology never changed"


LAW_CHAINS, LAW_STEPS, LAW_BURN, LAW_EVERY = 256, 600, 100, 2


def _coalescent4(params, tree):
    return constant_coalescent_loglik(tree.heights, 4, 1.0)


@pytest.mark.parametrize("cls", ["ConstrainedNNIOperator",
                                 "ConstrainedUniformSPROperator"])
def test_topology_law_exact_with_equal_groups(cls):
    """tests/test_operator_uniformity.py's exact labelled-topology law on 4
    taxa with its tolerance, all groups equal (the unconstrained move; the
    JAX test holds the uniform SPR so), from a batch of 256 chains of 600
    steps with UniformNodeHeight and RootHeightScale under the constant
    coalescent; all 15 topologies reached."""
    from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

    tree_np = simulate_coalescent_tree(np.random.default_rng(1), np.zeros(4),
                                       1.0)
    operators = [getattr(tcon, cls)(weight=10.0, groups=np.zeros(7, np.int32)),
                 ops.UniformNodeHeightOperator(weight=5.0),
                 ops.RootHeightScaleOperator(weight=2.0)]
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
    assert set(np.unique(tids)) == set(exact), cls
    n_eff = len(tids) / 50.0
    for tid, p in exact.items():
        freq = float(np.mean(tids == tid))
        tol = 5.0 * math.sqrt(p * (1 - p) / n_eff) + 0.005
        assert abs(freq - p) < tol, (cls, hex(tid), freq, p, tol)
    assert int(states.op_accept[:, 0].sum()) > 0


@pytest.mark.parametrize("cls", ["ConstrainedNNIOperator",
                                 "ConstrainedUniformSPROperator"])
def test_chain_axis_proposal_equals_single_chains(monkeypatch, cls):
    """Four chains on four constrained resolutions of one constraints
    tree: the vmapped proposal against four single proposals at the
    batch's draws."""
    rng = np.random.default_rng(21)
    newick = _random_constraints_newick(rng, 16)
    built = [tcon.build_constrained_tree(newick, rng) for _ in range(4)]
    groups = built[0][4]
    trees = [make_tree_state(*b[:4], F64, "cpu") for b in built]
    assert all(np.array_equal(b[4], groups) for b in built)
    logh = chains_against_singles(monkeypatch,
                                  getattr(tcon, cls)(groups=groups), {},
                                  trees, None)
    assert torch.isfinite(logh).any()

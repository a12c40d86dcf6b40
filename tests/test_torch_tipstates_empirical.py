"""Tip-data error models, the Thorney branch-length likelihood and the
empirical tree set (queue item 4h-3's models/tipstates.py, thorney.py and
tree/empirical.py) against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - sequence_error_partials (all substitutions and transitions only, with
    and without age-related damage, ambiguous codes) and
    hypermutant_error_partials and hypermutation_count_statistic against
    JAX's at 1e-12 relative on random states; the sequence error model's
    HKY likelihood against JAX's, its gradient in the rate (under
    autograd_peel) against central differences;
  - poisson_branch_length_loglik (scalar and per-branch rates) and its
    clock-rate gradient against JAX's; mutation_counts_from_branch_lengths;
  - stack_trees, tree_at and convert.empirical_trees_from_numpy against
    JAX's stacked set; EmpiricalTreeOperator's chain against the exact
    finite target (tests/test_empirical_coalgen.py's softmax frequencies,
    a batch of 64 chains) and its chain-axis proposal against single
    proposals at the batch's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import thorney as jth
from beast_mcmc_tpu.models import tipstates as jts
from beast_mcmc_tpu.models.sitemodel import single_rate as jsingle
from beast_mcmc_tpu.models.substitution import hky_eigen as jhky
from beast_mcmc_tpu.models.treelikelihood import (
    tree_loglikelihood as jtree_loglik,
)
from beast_mcmc_tpu.tree import empirical as jemp
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch import convert
from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_multichain_step,
)
from beast_mcmc_tpu_torch.models import thorney as tth
from beast_mcmc_tpu_torch.models import tipstates as tts
from beast_mcmc_tpu_torch.models.substitution import hky_eigen as thky
from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
from beast_mcmc_tpu_torch.ops.peeling import autograd_peel
from beast_mcmc_tpu_torch.tree import empirical as temp
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from fixtures import primate_patterns, primate_tree
from test_empirical_coalgen import _samples
from test_torch_operators_ext import chains_against_singles

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


@pytest.mark.parametrize("ts_only", [False, True])
@pytest.mark.parametrize("aged", [False, True])
def test_sequence_error_partials_match_jax(ts_only, aged):
    rng = np.random.default_rng(3 + 2 * ts_only + aged)
    states = rng.integers(0, 6, (7, 23))  # 4 and 5 ambiguous
    ages = rng.uniform(0.0, 3.0, 7)
    kw = dict(age_related_rate=0.4, tip_ages=ages) if aged else {}
    got = tts.sequence_error_partials(
        torch.tensor(states), torch.tensor(0.07, dtype=F64),
        **{k: (torch.tensor(v) if k == "tip_ages" else v)
           for k, v in kw.items()}, transitions_only=ts_only)
    want = jts.sequence_error_partials(
        jnp.asarray(states), 0.07, **kw, transitions_only=ts_only)
    _close(got, want)


def test_hypermutation_partials_and_statistic_match_jax():
    rng = np.random.default_rng(8)
    states = rng.integers(0, 5, (6, 31))
    ctx = rng.random((6, 31)) > 0.4
    hyper = rng.random(6) > 0.5
    for rate in (0.3, rng.uniform(0.1, 0.9, 6)):
        _close(tts.hypermutant_error_partials(
            torch.tensor(states), torch.tensor(ctx), torch.tensor(hyper),
            torch.as_tensor(rate, dtype=F64)),
            jts.hypermutant_error_partials(
                jnp.asarray(states), jnp.asarray(ctx), jnp.asarray(hyper),
                rate))
    assert int(tts.hypermutation_count_statistic(
        torch.tensor(ctx), torch.tensor(hyper))) == int(
        jts.hypermutation_count_statistic(jnp.asarray(ctx),
                                          jnp.asarray(hyper)))


def test_sequence_error_likelihood_and_gradient_match_jax():
    """The primate HKY likelihood over sequence-error tips against JAX's,
    and its derivative in the error rate against central differences of
    JAX's likelihood. The peels' adjoints take the tip partials as data
    (JAX's jax.grad gives 0 here), so the derivative goes through the
    plain peel (ops/peeling.py::autograd_peel)."""
    pats = primate_patterns()
    parent, children, heights, root, _ = primate_tree()
    states = np.asarray(pats.tip_states_unambiguous())
    weights = np.asarray(pats.weights)
    freqs = np.asarray(pats.empirical_frequencies())
    cr, cw = jsingle()

    @jax.jit
    def jll(err):
        return jtree_loglik(
            jts.sequence_error_partials(jnp.asarray(states), err),
            jnp.asarray(weights), jnp.asarray(parent),
            jnp.asarray(children), jnp.asarray(heights), root,
            jhky(jnp.asarray(2.0), jnp.asarray(freqs)), jnp.asarray(freqs),
            cr, cw, 1.0)

    tl = lambda x: torch.tensor(np.asarray(x), dtype=torch.long)  # noqa
    tfreqs = torch.tensor(freqs)
    err = torch.tensor(0.01, dtype=F64, requires_grad=True)
    with autograd_peel():  # the peels' adjoints take tips as data
        ll = tree_loglikelihood(
            tts.sequence_error_partials(torch.tensor(states), err),
            torch.tensor(weights), tl(parent), tl(children),
            torch.tensor(heights), tl(root), thky(2.0, tfreqs), tfreqs,
            torch.ones(1, dtype=F64), torch.ones(1, dtype=F64), 1.0)
        (g,) = torch.autograd.grad(ll, err)
    np.testing.assert_allclose(float(ll.detach()), float(jll(0.01)),
                               rtol=REL)
    # JAX's peel VJP takes the tips as data too: its jax.grad here is 0
    assert float(jax.grad(jll)(0.01)) == 0.0
    h = 1e-6
    numeric = (float(jll(0.01 + h)) - float(jll(0.01 - h))) / (2 * h)
    np.testing.assert_allclose(float(g), numeric, rtol=1e-6)


@pytest.mark.parametrize("per_branch", [False, True])
def test_poisson_branch_length_loglik_matches_jax(per_branch):
    rng = np.random.default_rng(11)
    parent, _, heights, root = simulate_coalescent_tree(
        rng, rng.uniform(0, 0.2, 15), 1.0)
    m = len(parent)
    muts = rng.poisson(4.0, m).astype(float)
    muts[:3] = 0.0
    rates = rng.uniform(0.5, 1.5, m) if per_branch else 0.8
    tr = torch.tensor(rates, requires_grad=True) if per_branch else \
        torch.tensor(rates, dtype=F64, requires_grad=True)
    got = tth.poisson_branch_length_loglik(
        torch.tensor(muts), torch.tensor(parent, dtype=torch.long),
        torch.tensor(heights), tr, 100.0)
    jfn = lambda r: jth.poisson_branch_length_loglik(  # noqa: E731
        jnp.asarray(muts), jnp.asarray(parent), jnp.asarray(heights), r,
        100.0)
    np.testing.assert_allclose(float(got.detach()),
                               float(jfn(jnp.asarray(rates))),
                               rtol=REL)
    (g,) = torch.autograd.grad(got, tr)
    _close(g, jax.grad(jfn)(jnp.asarray(rates)), rel=1e-10)
    _close(tth.mutation_counts_from_branch_lengths(
        torch.tensor([0.012, 0.0031]), 1000),
        jth.mutation_counts_from_branch_lengths(jnp.asarray([0.012, 0.0031]),
                                                1000))


def _sets():
    samples = _samples()
    return temp.stack_trees(samples, F64, "cpu"), jemp.stack_trees(samples)


def test_stack_trees_and_tree_at_match_jax():
    t_set, j_set = _sets()
    conv = convert.empirical_trees_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_set), F64, "cpu")
    for got in (t_set, conv):
        for f in ("parents", "children", "heights", "roots"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(j_set, f)))
    assert t_set.n_trees == j_set.n_trees == 3
    for i in range(3):
        tt, jt = temp.tree_at(t_set, i), jemp.tree_at(j_set, i)
        for f in ("parent", "children", "heights", "root"):
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)))


def _which_tree(tree):
    """Topology 0, 1, 2 of tests/test_empirical_coalgen.py's three trees:
    tip 0's sibling less one; a batch gives [B]."""
    pa = tree.parent[..., 0]
    row = torch.gather(tree.children, -2,
                       pa[..., None, None].expand(*pa.shape, 1, 2))[..., 0, :]
    sib = torch.where(row[..., 0] == 0, row[..., 1], row[..., 0])
    return sib - 1


def test_empirical_chain_matches_target_frequencies():
    """EmpiricalTreeOperator over the three trees with log weights (0, 1,
    -0.5): 64 chains of 150 steps, the draws' frequencies at the softmax
    within 0.03 (the JAX test's tolerance)."""
    t_set, _ = _sets()
    logw = torch.tensor([0.0, 1.0, -0.5], dtype=F64)

    def log_post_chains(params, tree):
        return logw[_which_tree(tree)]

    op = temp.EmpiricalTreeOperator(trees=t_set, weight=1.0)
    st = init_mcmc_state({}, temp.tree_at(t_set, 0),
                         torch.Generator().manual_seed(3), [op],
                         lambda p, t: log_post_chains(p, t))
    states = replicate_state(st, 64, torch.Generator().manual_seed(4))
    mstep = make_multichain_step(log_post_chains, [op])
    drawn = []
    for _ in range(150):
        states = mstep(states)
        drawn.append(_which_tree(states.tree).numpy())
    freq = np.bincount(np.concatenate(drawn), minlength=3) / (150 * 64)
    np.testing.assert_allclose(freq, torch.softmax(logw, 0).numpy(),
                               atol=0.03)


def test_empirical_operator_chain_axis_equals_single_chains(monkeypatch):
    t_set, _ = _sets()
    op = temp.EmpiricalTreeOperator(trees=t_set)
    trees = [temp.tree_at(t_set, b % 3) for b in range(4)]
    logh = chains_against_singles(monkeypatch, op, {}, trees, None)
    assert bool((logh == 0).all())
    tree = make_tree_state(*(np.asarray(x) for x in (
        t_set.parents[1], t_set.children[1], t_set.heights[1],
        t_set.roots[1])), F64, "cpu")
    _, new, lh = op.propose({}, tree, torch.Generator().manual_seed(0), None)
    assert float(lh) == 0.0 and new.root.shape == tree.root.shape

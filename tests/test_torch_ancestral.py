"""The port's joint ancestral draw (ops/ancestral.py) against the JAX
package's and against the exact conditionals.

The port walks the tree's levels from the root down, one batched draw a
level; JAX walks the nodes in a scan. The random streams differ, so the
draw is held to its law: on trees of up to six tips, with S = 4 and 5
states and C = 1 and 2 categories, the frequencies of each node's state
(and of the category) over many draws of one site match the exact
marginals of the joint conditional, computed by enumerating every
assignment of states in numpy, by a chi-square test whose p-value must
stay above P_FLOOR. Tips keep their data (tests/test_ancestral.py:81), and
the site log-likelihoods of the level walk equal JAX's to 1e-10.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from beast_mcmc_tpu.ops.ancestral import (
    sample_ancestral_states as jax_sample_ancestral_states,
)
from beast_mcmc_tpu.ops.peeling import (
    peel_order_from_heights as jax_peel_order,
)

from beast_mcmc_tpu_torch.data import Alignment, SitePatterns
from beast_mcmc_tpu_torch.models.sitemodel import single_rate
from beast_mcmc_tpu_torch.models.substitution import hky_eigen
from beast_mcmc_tpu_torch.models.treelikelihood import (
    branch_transition_matrices,
)
from beast_mcmc_tpu_torch.ops.ancestral import sample_ancestral_states
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    parse_newick,
    simulate_coalescent_tree,
)

from fixtures import PRIMATE_NEWICK, PRIMATE_SEQS, PRIMATE_TAXA

P_FLOOR = 1e-4  # each node's chi-square p-value, at a fixed seed
SITE_TOL = 1e-10
DRAWS = 40_000  # copies of the one site, drawn in one call


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: small tensors, and six test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _primate():
    pats = SitePatterns.from_alignment(
        Alignment.from_sequences(PRIMATE_TAXA, PRIMATE_SEQS))
    parent, children, heights, root, _ = parse_newick(PRIMATE_NEWICK,
                                                      taxa=PRIMATE_TAXA)
    tips = np.swapaxes(pats.tip_partials(), 1, 2)
    return pats, (parent, children, heights, root), tips


def test_tips_keep_their_data():
    pats, tree, tips = _primate()
    tr = make_tree_state(*tree, device="cpu")
    freqs = torch.tensor(pats.empirical_frequencies())
    rates, cat_w = single_rate(device="cpu")
    pm = branch_transition_matrices(hky_eigen(torch.tensor(20.0), freqs),
                                    tr.parent, tr.heights, 1.0, rates)
    states, cats, _ = sample_ancestral_states(
        torch.tensor(tips), tr.children, tr.root, pm, freqs, cat_w,
        torch.Generator().manual_seed(0))
    assert states.shape == (11, pats.n_patterns)
    assert bool((states >= 0).all()) and bool((states < 4).all())
    assert bool((cats == 0).all())
    obs = pats.states
    unamb = obs < 4
    np.testing.assert_array_equal(states[:6].numpy()[unamb], obs[unamb])


def test_site_loglik_matches_jax():
    """The level walk's site log-likelihoods against JAX's scan, on the
    primate data under HKY+Gamma4 (the same matrices handed to both)."""
    pats, tree, tips = _primate()
    tr = make_tree_state(*tree, device="cpu")
    freqs = torch.tensor(pats.empirical_frequencies())
    rates = torch.tensor([0.1, 0.5, 1.1, 2.3])
    cat_w = torch.full((4,), 0.25, dtype=torch.float64)
    pm = branch_transition_matrices(hky_eigen(torch.tensor(8.0), freqs),
                                    tr.parent, tr.heights, 1.0, rates)
    _, _, site = sample_ancestral_states(
        torch.tensor(tips), tr.children, tr.root, pm, freqs, cat_w,
        torch.Generator().manual_seed(1))
    order = jax_peel_order(jnp.asarray(tree[2]), 6)
    _, _, ref = jax_sample_ancestral_states(
        jnp.asarray(tips), jnp.asarray(tree[1]), order, tree[3],
        jnp.asarray(pm.numpy()), jnp.asarray(freqs.numpy()),
        jnp.asarray(cat_w.numpy()), jax.random.PRNGKey(0))
    np.testing.assert_allclose(site.numpy(), np.asarray(ref), rtol=SITE_TOL,
                               atol=0)


def _exact_marginals(tree, tips, pm, freqs, cat_w):
    """Each node's and the category's marginal under the joint
    conditional, by enumerating every (category, assignment) in numpy;
    a tip takes only the states its partial allows."""
    parent, children, _, root = tree
    m = len(parent)
    n_tips, s = tips.shape
    allowed = [np.flatnonzero(tips[i]) if i < n_tips else np.arange(s)
               for i in range(m)]
    assign = np.array(list(itertools.product(*allowed)))  # [A, M]
    joint = []
    for c in range(len(cat_w)):
        w = cat_w[c] * freqs[assign[:, root]]
        for node in range(m):
            if node != root:
                w = w * pm[node, c, assign[:, parent[node]], assign[:, node]]
            if node < n_tips:
                w = w * tips[node, assign[:, node]]
        joint.append(w)
    joint = np.stack(joint)  # [C, A]
    joint = joint / joint.sum()
    node_marg = np.zeros((m, s))
    for node in range(m):
        np.add.at(node_marg[node], assign[:, node], joint.sum(0))
    return node_marg, joint.sum(1)


def _chi2_p(counts, probs):
    keep = probs * counts.sum() >= 5
    expect = probs[keep] * counts.sum()
    obs = counts[keep]
    rest_o, rest_e = counts[~keep].sum(), counts.sum() * probs[~keep].sum()
    stat = np.sum((obs - expect) ** 2 / expect)
    df = keep.sum() - 1
    if rest_e >= 5:
        stat += (rest_o - rest_e) ** 2 / rest_e
        df += 1
    assert rest_e >= 5 or rest_o <= 3  # no draws where the law puts none
    return 1.0 if df == 0 else chi2.sf(stat, df)


@pytest.mark.parametrize("n_tips,s,c,ambiguous", [
    (6, 4, 1, False), (6, 4, 2, False), (5, 5, 2, False),
    (4, 5, 1, True), (4, 4, 2, True)])
def test_draw_law_matches_exact_conditionals(n_tips, s, c, ambiguous):
    """One site copied DRAWS times and drawn in one call: every node's
    state frequencies and the categories' against the enumerated
    marginals."""
    rng = np.random.default_rng(100 * n_tips + 10 * s + c)
    tree = simulate_coalescent_tree(rng, np.zeros(n_tips), 0.7)
    m = 2 * n_tips - 1
    if ambiguous:  # partial rows: every state allowed, unevenly
        tips = rng.random((n_tips, s)) + 0.05
    else:
        tips = np.eye(s)[rng.integers(0, s, n_tips)]
    pm = rng.random((m, c, s, s)) + 0.1
    pm = pm / pm.sum(-1, keepdims=True)
    freqs = rng.random(s) + 0.2
    freqs = freqs / freqs.sum()
    cat_w = np.full(c, 1.0 / c) if c == 1 else np.array([0.3, 0.7])
    node_marg, cat_marg = _exact_marginals(tree, tips, pm, freqs, cat_w)

    tr = make_tree_state(*tree, device="cpu")
    t = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    states, cats, _ = sample_ancestral_states(
        t(np.repeat(tips[:, :, None], DRAWS, axis=2)), tr.children, tr.root,
        t(pm), t(freqs), t(cat_w), torch.Generator().manual_seed(7))
    states = states.numpy()
    for node in range(m):
        p = _chi2_p(np.bincount(states[node], minlength=s), node_marg[node])
        assert p > P_FLOOR, (node, p)
    assert _chi2_p(np.bincount(cats.numpy(), minlength=c), cat_marg) > P_FLOOR

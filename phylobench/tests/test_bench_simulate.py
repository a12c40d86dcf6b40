"""The simulated alignments: the tree, its Newick form as the program
reads it, the sites drawn down it, and the compression to a fixed width."""

import numpy as np
import pytest
import torch

from beast_mcmc_tpu_torch.tree.topology import parse_newick
from phylobench import simulate
from phylobench.reference import _plain


def _tree(n=30, seed=5):
    tips = np.random.default_rng(seed).uniform(0.0, 1.5, n)
    return tips, *simulate.coalescent_tree(np.random.default_rng(seed),
                                           tips, 2.0)


def test_coalescent_tree_is_a_dated_binary_tree():
    tips, parent, heights = _tree()
    n = tips.size
    assert parent[-1] == -1 and (parent[:-1] > np.arange(2 * n - 2)).all()
    assert (np.bincount(parent[:-1], minlength=2 * n - 1)[n:] == 2).all()
    assert (heights[parent[:-1]] >= heights[:-1]).all()
    np.testing.assert_array_equal(heights[:n], tips)
    kids = simulate.children(parent)
    assert (kids[:n] == -1).all() and (parent[kids[n:]] ==
                                       np.arange(n, 2 * n - 1)[:, None]).all()


def test_newick_gives_the_program_the_same_tree():
    tips, parent, heights = _tree()
    names = [f"t{i}" for i in range(tips.size)]
    _, _, h, root, _ = parse_newick(simulate.newick(parent, heights, names),
                                    taxa=names,
                                    tip_heights=dict(zip(names, tips)))
    assert float(h[root]) == pytest.approx(heights[-1], rel=1e-12)
    np.testing.assert_allclose(np.sort(h), np.sort(heights), atol=1e-12)


def test_sites_follow_the_tree():
    tips, parent, heights = _tree(n=6)
    freqs = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    q = _plain.reversible_q(torch.ones(4, 4, dtype=torch.float64), freqs)
    gen = torch.Generator().manual_seed(3)
    one = lambda rate: simulate.sequences(  # noqa: E731
        parent, heights, np.full(parent.size, rate), q, freqs,
        torch.ones(1, dtype=torch.float64), 4000, gen, "cpu")
    still = one(1e-9)
    assert (still == still[:1]).all()  # no time for a change
    root = np.bincount(still[0], minlength=4) / 4000
    np.testing.assert_allclose(root, freqs.numpy(), atol=0.03)
    far = one(1e3)  # saturated: each tip drawn from the frequencies
    np.testing.assert_allclose(np.bincount(far.ravel(), minlength=4)
                               / far.size, freqs.numpy(), atol=0.02)


def test_patterns_keep_every_site_at_a_fixed_width():
    rng = np.random.default_rng(7)
    sites = rng.integers(0, 4, size=(5, 40)).astype(np.int16)
    sites[:, 20:] = sites[:, :1]
    cols, weights = simulate.patterns(sites, 32)
    assert cols.shape == (5, 32) and weights.sum() == 40
    assert (weights >= 1).all()
    got = {}
    for col, w in zip(cols.T, weights):
        got[col.tobytes()] = got.get(col.tobytes(), 0) + w
    want = {}
    for col in sites.T:
        want[col.tobytes()] = want.get(col.tobytes(), 0) + 1
    assert got == want
    with pytest.raises(ValueError):
        simulate.patterns(sites, 10)

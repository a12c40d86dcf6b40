"""The multispecies coalescent and AlloppNet (queue item 4h-4's
models/msc.py and alloppnet.py) against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - _ancestor_matrix against JAX's on a random tree;
  - multispecies_coalescent_loglik on tests/test_msc_dollo_liability.py's
    cases (one species, the two-species hand tree, an incompatible
    embedding) and on random gene trees of dated tips under species trees
    made from their own clades (chip_smoke.py::species_tree_of: the
    coalescences interleave with the divergences) and under random
    species trees (some embeddings incompatible), against JAX's at 1e-12
    relative, -inf where JAX gives it;
  - mul_tree on tests/test_parallel_alloppnet.py's tiny network (valid and
    its three invalid variants) and on phase 21d's 4 + 2 network, and
    alloppnet_gene_tree_loglik of random gene trees in them, against
    JAX's; flip_assignment; convert.allopp_network_from_numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import alloppnet as jall
from beast_mcmc_tpu.models import msc as jmsc
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch import convert
from beast_mcmc_tpu_torch.models import alloppnet as tall
from beast_mcmc_tpu_torch.models import msc as tmsc

from chip_smoke import species_tree_of
from test_parallel_alloppnet import _tiny_network

F64 = torch.float64
REL = 1e-12
_jax_msc = jax.jit(jmsc.multispecies_coalescent_loglik)
_jax_allopp = jax.jit(jall.alloppnet_gene_tree_loglik)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want):
    got, want = float(got), float(want)
    if np.isfinite(want):
        np.testing.assert_allclose(got, want, rtol=REL)
    else:
        assert got == want


def _msc_both(gp, gc, gh, species, sp_parent, sp_heights, pops):
    i32 = lambda x: jnp.asarray(np.asarray(x), jnp.int32)  # noqa: E731
    tl = lambda x: torch.tensor(np.asarray(x), dtype=torch.long)  # noqa
    tf = lambda x: torch.tensor(np.asarray(x, float))  # noqa: E731
    got = tmsc.multispecies_coalescent_loglik(
        tl(gp), tl(gc), tf(gh), tl(species), tl(sp_parent), tf(sp_heights),
        tf(pops))
    want = _jax_msc(
        i32(gp), i32(gc), jnp.asarray(np.asarray(gh, float)), i32(species),
        i32(sp_parent), jnp.asarray(np.asarray(sp_heights, float)),
        jnp.asarray(np.asarray(pops, float)))
    return got, want


def test_ancestor_matrix_matches_jax():
    parent, *_ = simulate_coalescent_tree(np.random.default_rng(1),
                                          np.zeros(9), 1.0)
    np.testing.assert_array_equal(
        tmsc._ancestor_matrix(torch.tensor(parent)).numpy(),
        np.asarray(jmsc._ancestor_matrix(jnp.asarray(parent, jnp.int32))))


def test_msc_hand_cases_match_jax():
    rng = np.random.default_rng(0)
    gp, gc, gh, _ = simulate_coalescent_tree(rng, np.zeros(6), 0.7)
    _eq(*_msc_both(gp, gc, gh, np.zeros(6), [-1], [0.0], [0.7]))
    gc4 = [[-1, -1]] * 4 + [[0, 1], [2, 3], [4, 5]]
    gh4 = [0.0, 0.0, 0.0, 0.0, 0.3, 0.5, 2.0]
    _eq(*_msc_both([4, 4, 5, 5, 6, 6, -1], gc4, gh4, [0, 0, 1, 1],
                   [2, 2, -1], [0.0, 0.0, 1.0], [0.5, 0.8, 1.5]))
    got, want = _msc_both([4, 5, 4, 5, 6, 6, -1],
                          [[-1, -1]] * 4 + [[0, 2], [1, 3], [4, 5]], gh4,
                          [0, 0, 1, 1], [2, 2, -1], [0.0, 0.0, 1.0],
                          np.ones(3))
    assert float(got) == float(want) == -np.inf


@pytest.mark.parametrize("seed,n_species", [(3, 3), (4, 5), (5, 8)])
def test_msc_on_species_trees_of_clades_matches_jax(seed, n_species):
    rng = np.random.default_rng(seed)
    n = 30
    gp, gc, gh, gr = simulate_coalescent_tree(rng, rng.uniform(0, 0.2, n),
                                              1.0)
    sp_parent, sp_heights, species = species_tree_of(gp, gc, gh, gr, n,
                                                     n_species)
    pops = rng.uniform(0.3, 2.0, len(sp_parent))
    got, want = _msc_both(gp, gc, gh, species, sp_parent, sp_heights, pops)
    assert np.isfinite(float(want))
    _eq(got, want)


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_msc_on_random_species_trees_matches_jax(seed):
    """A random 4-species tree and random species labels: the embedding is
    compatible or not; the port gives JAX's number or -inf."""
    rng = np.random.default_rng(seed)
    gp, gc, gh, _ = simulate_coalescent_tree(rng, np.zeros(12), 1.0)
    sp_parent, _, sp_heights, _ = simulate_coalescent_tree(
        rng, np.zeros(4), 0.1)
    species = rng.integers(0, 4, 12)
    _eq(*_msc_both(gp, gc, gh, species, sp_parent, sp_heights,
                   rng.uniform(0.3, 2.0, 7)))


def _network_21d(low=1.0):
    """phase 21d's network of 4 diploid and 2 tetraploid tips (numpy)."""
    return dict(dip_parent=[4, 4, 5, 6, 5, 6, -1],
                dip_children=[[-1, -1]] * 4 + [[0, 1], [4, 2], [5, 3]],
                dip_heights=np.array([0, 0, 0, 0, 0.3, 0.6, 0.9]) * low,
                dip_root=6, tet_parent=[2, 2, -1],
                tet_children=[[-1, -1], [-1, -1], [0, 1]],
                tet_heights=np.array([0, 0, 0.2]) * low, tet_root=2,
                leg_a=1, leg_b=2, hyb_height=0.25 * low)


def _nets(net):
    """(JAX's AlloppNetwork, the port's by convert) of numpy fields."""
    j = jall.AlloppNetwork(**{
        k: jnp.asarray(np.asarray(v), jnp.float64 if "height" in k
                       else jnp.int32) for k, v in net.items()})
    return j, convert.allopp_network_from_numpy(
        jax.tree_util.tree_map(np.asarray, j), F64, "cpu")


@pytest.mark.parametrize("variant", ["tiny", "same legs", "hyb above leg",
                                     "old tetraploid", "21d"])
def test_mul_tree_matches_jax(variant):
    kw = {"tiny": dict(tet_h=0.0), "same legs": dict(leg_a=0, leg_b=0),
          "hyb above leg": dict(hyb=1.5), "old tetraploid": dict(tet_h=0.6)}
    if variant == "21d":
        jnet, tnet = _nets(_network_21d())
    else:
        jnet = _tiny_network(**kw[variant])
        tnet = convert.allopp_network_from_numpy(
            jax.tree_util.tree_map(np.asarray, jnet), F64, "cpu")
    got, want = tall.mul_tree(tnet), jall.mul_tree(jnet)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [9, 10])
def test_alloppnet_gene_tree_loglik_matches_jax(seed):
    """Random 20-tip gene trees in the 21d network (the MUL tips drawn for
    the sequences, the network's heights below the gene tree's lowest
    coalescence) and in the tiny one of tests/test_parallel_alloppnet.py
    (4 MUL tips), against JAX's; flip_assignment."""
    rng = np.random.default_rng(seed)
    gp, gc, gh, _ = simulate_coalescent_tree(rng, rng.uniform(0, 0.1, 20),
                                             1.0)
    n_int = gh[20:]
    for jnet, tnet, n_mul in (
            (*_nets(_network_21d(0.9 * n_int.min())), 8),
            (_tiny_network(tet_h=0.0), None, 4)):
        if tnet is None:
            tnet = convert.allopp_network_from_numpy(
                jax.tree_util.tree_map(np.asarray, jnet), F64, "cpu")
        species = rng.integers(0, n_mul, 20)
        pops = rng.uniform(0.5, 2.0, 2 * n_mul - 1)
        got = tall.alloppnet_gene_tree_loglik(
            torch.tensor(gp), torch.tensor(gc), torch.tensor(gh),
            torch.tensor(species), tnet, torch.tensor(pops))
        want = _jax_allopp(
            jnp.asarray(gp, jnp.int32), jnp.asarray(gc, jnp.int32),
            jnp.asarray(gh), jnp.asarray(species, jnp.int32), jnet,
            jnp.asarray(pops))
        _eq(got, want)
        np.testing.assert_array_equal(
            tall.flip_assignment(torch.tensor(species), 2, 5, 4, 2).numpy(),
            np.asarray(jall.flip_assignment(jnp.asarray(species), 2, 5, 4,
                                            2)))

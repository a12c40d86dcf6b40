"""Transmission-tree and case-to-case models (queue item 4h-4's
models/transmission.py and casetocase.py) against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - host_at on tests/test_transmission.py's chain; transmission_loglik on
    its hand oracles (one host, two hosts at three infection times, a
    three-host chain, an incompatible history) and on random histories
    of 12 hosts (one tip a host, each host infected on the branch above
    its subtree of initial_painting's painting, some infection times
    moved below a coalescence so the history is incompatible) against
    JAX's at 1e-12 relative, -inf where JAX gives it;
  - infection_time_move at JAX's draws (its host pick and uniform
    injected) against JAX's, 30 keys;
  - painting_is_valid, infection_events and case_to_case_loglik (with and
    without the spatial kernel) on tests/test_casetocase.py's tree and on
    random 12-case trees against JAX's; initial_painting equal to JAX's;
    PaintingRepaintOperator at JAX's draws, and its chain-axis proposal
    against single proposals at the batch's draws;
    convert.painting_from_numpy;
  - the four infectious-period priors against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import casetocase as jc2c
from beast_mcmc_tpu.models import transmission as jtr
from beast_mcmc_tpu.models.priors import gamma_logpdf as jgamma_logpdf
from beast_mcmc_tpu.tree.topology import (
    make_tree_state as jax_tree_state,
    simulate_coalescent_tree,
)

from beast_mcmc_tpu_torch import convert
from beast_mcmc_tpu_torch.models import casetocase as tc2c
from beast_mcmc_tpu_torch.models import transmission as ttr
from beast_mcmc_tpu_torch.models.priors import gamma_logpdf
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from test_casetocase import _tree4
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


def _eq(got, want):
    got = float(got)
    want = float(want)
    if np.isfinite(want):
        np.testing.assert_allclose(got, want, rtol=REL, atol=1e-300)
    else:
        assert got == want


def _history(seed, n_hosts=12, cut=None):
    """A random transmission history on a coalescent tree of one tip a
    host: the painting of initial_painting, each host infected on the
    branch above its subtree root at a uniform fraction; `cut` hosts get
    an infection time at a fraction 0.1 of their subtree root's height
    (below their lowest coalescence, which can make the history
    incompatible)."""
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, rng.uniform(0, 0.3, n_hosts), 1.0)
    painting = jc2c.initial_painting(parent, children, root, n_hosts)
    case_root = np.full(n_hosts, -1)
    for v in range(len(parent)):
        if v == root or painting[v] != painting[parent[v]]:
            case_root[painting[v]] = v
    frac = rng.uniform(0.05, 0.95, n_hosts)
    donor = np.where(case_root == root, np.arange(n_hosts),
                     painting[np.maximum(parent[case_root], 0)])
    t_inf = np.where(case_root == root, np.inf, heights[case_root] + frac * (
        heights[np.maximum(parent[case_root], 0)] - heights[case_root]))
    if cut:
        moved = rng.choice(np.flatnonzero(np.isfinite(t_inf)), cut,
                           replace=False)
        t_inf[moved] = 0.1 * heights[case_root[moved]] + 1e-3
    pops = rng.uniform(0.2, 2.0, n_hosts)
    return (parent, children, heights, root, painting, frac, donor, t_inf,
            pops)


_jax_transmission = jax.jit(jtr.transmission_loglik, static_argnums=3)
_jax_infection_move = jax.jit(jtr.infection_time_move, static_argnums=3)


def _both_transmission(parent, children, heights, n, tip_host, donor,
                       ttime, pops):
    got = ttr.transmission_loglik(
        torch.tensor(parent, dtype=torch.long),
        torch.tensor(children, dtype=torch.long),
        torch.tensor(heights, dtype=F64), n,
        torch.tensor(tip_host, dtype=torch.long),
        torch.tensor(donor, dtype=torch.long), torch.tensor(ttime, dtype=F64),
        torch.tensor(pops, dtype=F64))
    i32 = lambda x: jnp.asarray(np.asarray(x), jnp.int32)  # noqa: E731
    want = _jax_transmission(
        i32(parent), i32(children), jnp.asarray(heights), n, i32(tip_host),
        i32(donor), jnp.asarray(ttime), jnp.asarray(pops))
    return got, want


def test_host_at_and_the_hand_oracles_match_jax():
    donor = np.asarray([0, 0, 1])
    ttime = np.asarray([np.inf, 2.0, 1.0])
    for h in (0.5, 1.5, 3.0):
        assert int(ttr.host_at(2, torch.tensor(h), torch.tensor(donor),
                               torch.tensor(ttime))) == int(jtr.host_at(
            2, h, jnp.asarray(donor), jnp.asarray(ttime)))
    rng = np.random.default_rng(0)
    parent, children, heights, _ = simulate_coalescent_tree(
        rng, np.zeros(6), 1.0)
    _eq(*_both_transmission(parent, children, heights, 6, np.zeros(6, int),
                            [0], [np.inf], [1.4]))
    two = (np.asarray([3, 3, 4, 4, -1]),
           np.asarray([[-1, -1]] * 3 + [[0, 1], [3, 2]]),
           np.asarray([0.0, 0.0, 0.0, 0.5, 2.0]))
    for t1 in (1.0, 1.5, 0.4):
        _eq(*_both_transmission(*two, 3, [1, 1, 0], [0, 0], [np.inf, t1],
                                [2.0, 0.3]))
    got, want = _both_transmission(*two, 3, [1, 0, 0], [0, 0],
                                   [np.inf, 1.0], [1.0, 1.0])
    assert float(got) == float(want) == -np.inf
    _eq(*_both_transmission([2, 2, -1], [[-1, -1], [-1, -1], [0, 1]],
                            [0.0, 0.0, 3.0], 2, [2, 0], [0, 0, 1],
                            [np.inf, 2.0, 1.0], [1.5, 0.5, 0.25]))


@pytest.mark.parametrize("seed,cut", [(1, None), (2, None), (3, 3), (4, 5)])
def test_random_histories_match_jax(seed, cut):
    parent, children, heights, root, _, _, donor, t_inf, pops = _history(
        seed, cut=cut)
    _eq(*_both_transmission(parent, children, heights, 12, np.arange(12),
                            donor, t_inf, pops))


def test_infection_time_move_at_jax_draws(monkeypatch):
    tt = np.asarray([np.inf, 1.0, 2.0, 0.4])
    queue = Queue(monkeypatch)
    for i in range(30):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        jnew, jlh = _jax_infection_move(key, jnp.asarray(tt), 0.5, 0)
        k1, k2 = jax.random.split(key)
        queue.items = [int(jax.random.randint(k1, (), 0, 3, jnp.int32)),
                       float(jax.random.uniform(k2, dtype=jnp.float64))]
        tnew, tlh = ttr.infection_time_move(None, torch.tensor(tt), 0.5, 0)
        assert queue.items == []
        np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew),
                                   rtol=1e-15)
        assert float(tlh) == float(jlh)


def test_casetocase_on_the_hand_tree_matches_jax():
    parent, children, heights, root = _tree4()
    p = tc2c.initial_painting(parent, children, root, 4)
    np.testing.assert_array_equal(p, jc2c.initial_painting(
        parent, children, root, 4))
    bad = p.copy()
    bad[4] = 3
    for pt in (p, bad):
        assert bool(tc2c.painting_is_valid(
            torch.tensor(children), convert.painting_from_numpy(pt, "cpu"),
            4)) == bool(jc2c.painting_is_valid(jnp.asarray(children),
                                               jnp.asarray(pt), 4))
    painting = np.array([0, 1, 2, 3, 0, 2, 0])
    frac = np.full(4, 0.5)
    got = tc2c.infection_events(torch.tensor(parent),
                                torch.tensor(painting), torch.tensor(heights),
                                6, 4, torch.tensor(frac))
    want = jc2c.infection_events(jnp.asarray(parent), jnp.asarray(painting),
                                 jnp.asarray(heights), 6, 4,
                                 jnp.asarray(frac))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL)


def _c2c_both(parent, children, heights, root, painting, n, frac,
              dist=None, alpha=None):
    sh = heights[:n]
    got = tc2c.case_to_case_loglik(
        torch.tensor(parent), torch.tensor(children), torch.tensor(heights),
        root, torch.tensor(painting), n, torch.tensor(sh),
        torch.tensor(frac), 2.0, 0.4, 1.3,
        None if dist is None else torch.tensor(dist), alpha)
    want = jc2c.case_to_case_loglik(
        jnp.asarray(parent), jnp.asarray(children), jnp.asarray(heights),
        root, jnp.asarray(painting), n, jnp.asarray(sh), jnp.asarray(frac),
        2.0, 0.4, 1.3, None if dist is None else jnp.asarray(dist), alpha)
    return got, want


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_case_to_case_loglik_matches_jax(seed):
    """Random 12-case paintings: initial_painting's, one node repainted
    (valid or not), with and without the exponential spatial kernel."""
    parent, children, heights, root, painting, frac, *_ = _history(seed)
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 5, (12, 12))
    repainted = painting.copy()
    node = rng.integers(12, 23)
    repainted[node] = painting[children[node, 1]]
    for pt in (painting, repainted):
        for kernel in ((None, None), (dist, 0.3)):
            _eq(*_c2c_both(parent, children, heights, root, pt, 12, frac,
                           *kernel))


def test_painting_repaint_at_jax_draws(monkeypatch):
    parent, children, heights, root, painting, *_ = _history(8)
    jt = jax_tree_state(parent, children, heights, root)
    tt = make_tree_state(parent, children, heights, root, F64, "cpu")
    j_op = jc2c.PaintingRepaintOperator()
    t_op = tc2c.PaintingRepaintOperator()
    assert t_op.modified_params() == ("painting",)
    queue = Queue(monkeypatch)
    for i in range(40):
        key = jax.random.PRNGKey(i)
        jp, _, jlh = j_op.propose({"painting": jnp.asarray(painting)}, jt,
                                  key, None)
        k1, k2 = jax.random.split(key)
        queue.items = [int(jax.random.randint(k1, (), 12, 23)),
                       int(jax.random.randint(k2, (), 0, 2))]
        tp, _, tlh = t_op.propose({"painting": torch.tensor(painting)}, tt,
                                  None, None)
        assert queue.items == []
        np.testing.assert_array_equal(tp["painting"].numpy(),
                                      np.asarray(jp["painting"]))
        assert float(tlh) == float(jlh) == 0.0


def test_period_priors_match_jax():
    rng = np.random.default_rng(9)
    x = rng.gamma(3.0, 1.0, 17)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    _eq(tc2c.normal_period_prior_loglik(tx, 2.0, 1.5, 3.0, 2.0),
        jc2c.normal_period_prior_loglik(jx, 2.0, 1.5, 3.0, 2.0))
    _eq(tc2c.known_variance_normal_period_prior_loglik(tx, 1.3, 2.0, 0.7),
        jc2c.known_variance_normal_period_prior_loglik(jx, 1.3, 2.0, 0.7))
    _eq(tc2c.one_over_stdev_period_prior_loglik(tx),
        jc2c.one_over_stdev_period_prior_loglik(jx))
    _eq(tc2c.individual_period_prior_loglik(
        tx, lambda v: gamma_logpdf(v, 2.0, 1.5)),
        jc2c.individual_period_prior_loglik(
            jx, lambda v: jgamma_logpdf(v, 2.0, 1.5)))


def test_painting_repaint_chain_axis_equals_single_chains(monkeypatch):
    """Four chains, each its own painting on its own tree: the vmapped
    proposal against four single proposals at the batch's draws."""
    from test_torch_operators_ext import chains_against_singles

    hist = [_history(20 + b) for b in range(4)]
    trees = [make_tree_state(*h[:4], F64, "cpu") for h in hist]
    params = {"painting": torch.stack([torch.tensor(h[4], dtype=torch.long)
                                       for h in hist])}
    logh = chains_against_singles(monkeypatch,
                                  tc2c.PaintingRepaintOperator(), params,
                                  trees, None)
    assert bool((logh == 0).all())

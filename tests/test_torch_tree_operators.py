"""The joint analysis's operators and models against the JAX package.

JAX runs as tests/conftest.py sets it up (CPU, x64); the port runs on the
CPU in float64. The subtree slide (beast_mcmc_tpu/inference/
tree_operators.py:42-190) is held move by move: JAX's own draws of the
node, the slide and the regraft edge, injected into the port's `slide`,
give the same tree and Hastings ratio; its own draws are held to JAX's by
the case frequencies and moments over 2,000 proposals. ScaleOperator
"all"/"independent" and BitFlipOperator (operators.py:137-180,578) are
held by their exact Hastings relations and by moments; every tree move on
dated tips leaves a valid tree wherever its Hastings ratio is finite.
expm_taylor is held to scipy, the models (priors.py:45,61,95, clock.py:22,
36, coalescent.py:138-194, substitution.py:159, xml_geo.py:139,230,
treelikelihood.py:124) to JAX's at 1e-12 relative (expm paths 1e-10).
Monte Carlo tolerances are stated where they are used.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from beast_mcmc_tpu.inference import operators as jops
from beast_mcmc_tpu.inference import tree_operators as jtops
from beast_mcmc_tpu.models import clock as jclock
from beast_mcmc_tpu.models import coalescent as jcoal
from beast_mcmc_tpu.models import priors as jpriors
from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.models.treelikelihood import (
    tree_loglikelihood_q as jax_tree_loglikelihood_q,
)
from beast_mcmc_tpu.ops import expm as jexpm
from beast_mcmc_tpu.tree.topology import make_tree_state as jax_tree_state

from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference import tree_operators as tops
from beast_mcmc_tpu_torch.models import clock, coalescent, priors
from beast_mcmc_tpu_torch.models import substitution as sub
from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood_q
from beast_mcmc_tpu_torch.ops import expm
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    simulate_coalescent_tree,
)

from test_mcmc import check_tree_valid

N_TAXA = 16
N_PROPOSALS = 2000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and under six test
    workers torch's threads only contend (the 56-state chain's batched
    products took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dated_tree(seed=0, n=N_TAXA):
    """A coalescent tree on tips dated over two years (numpy)."""
    rng = np.random.default_rng(seed)
    tips = np.round(rng.uniform(0.0, 2.0, n), 3)
    tips -= tips.min()
    return simulate_coalescent_tree(rng, tips, 1.0)


def _trees(tree_np):
    return (make_tree_state(*tree_np, device="cpu"),
            jax_tree_state(*tree_np, dtype=jnp.float64))


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _np_tree(t):
    return tuple(np.asarray(getattr(t, f))
                 for f in ("parent", "children", "heights", "root"))


def test_subtree_slide_injected_draws_match_jax():
    """For 300 JAX keys (size 0.6 against branch lengths of ~0.1-1, so
    that every case occurs): JAX's proposal against the port's `slide` at
    JAX's node, delta and regraft edge: the same topology and root, the
    same heights to 1e-15 relative, the same ratio."""
    tree_np = _dated_tree(1)
    t_tree, j_tree = _trees(tree_np)
    j_op = jtops.SubtreeSlideOperator(size=0.6)
    tuning = 0.6
    m = tree_np[0].shape[0]

    def jax_draws(key):
        """JAX's proposal and the draws inside it (its own split)."""
        _, new, logq = j_op.propose({}, j_tree, key, tuning)
        k1, k2, k3 = jax.random.split(key, 3)
        i = jops.sample_excluding(k1, m, j_tree.root[None])
        delta = jax.random.normal(k2, dtype=jnp.float64) * tuning
        ip = j_tree.parent[i]
        cip = jops.other_child(j_tree.children, ip, i)
        emask = jtops.intersecting_edges(
            j_tree.parent, j_tree.heights,
            jtops.subtree_mask(j_tree.parent, cip), j_tree.heights[ip] + delta)
        idx, count = jtops.sample_masked(k3, emask)
        rank = jnp.cumsum(emask)[idx] - 1
        return new, logq, i, delta, (rank + 0.5) / jnp.maximum(count, 1)

    out = jax.jit(jax.vmap(jax_draws))(
        jax.random.split(jax.random.PRNGKey(0), 300))
    j_trees, j_logqs, idxs, deltas, us = _np(out)
    j_trees = _np_tree(j_trees)
    cases = set()
    for n in range(300):
        j_new = tuple(x[n] for x in j_trees)
        i, delta, u = int(idxs[n]), float(deltas[n]), float(us[n])
        t_new, t_logq = tops.slide(
            t_tree, torch.tensor([i]), torch.tensor([delta],
                                                    dtype=torch.float64),
            torch.tensor(u, dtype=torch.float64))
        j_logq = float(j_logqs[n])
        assert float(t_logq) == pytest.approx(j_logq, rel=1e-12, abs=0.0) \
            or (math.isinf(j_logq) and float(t_logq) == j_logq)
        if math.isfinite(j_logq):
            for got, ref in zip(_np_tree(t_new), j_new):
                # XLA may fuse the slide into one multiply-add: 1 ulp
                np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)
            check_tree_valid(*_np_tree(t_new), N_TAXA)
            topo = not np.array_equal(_np_tree(t_new)[0], tree_np[0])
            cases.add(("up" if delta > 0 else "down") if topo
                      else "no topology change")
        else:
            cases.add("invalid")
    assert cases == {"no topology change", "up", "down", "invalid"}


def _slide_stats(new_trees, logqs, tree_np):
    """(share valid, share topology-changing among valid, mean finite log
    Hastings, mean root height among valid)."""
    valid = np.isfinite(logqs)
    topo = np.array([not np.array_equal(p, tree_np[0])
                     for p, _ in new_trees])
    roots = np.array([h[r] for (_, (h, r)) in new_trees])
    return (valid.mean(), topo[valid].mean(), logqs[valid].mean(),
            roots[valid].mean())


def test_subtree_slide_moments_match_jax():
    """2,000 proposals of each from one dated tree: the share of valid
    proposals, of topology changes, the mean log Hastings and the mean
    root height agree within 5 standard errors of the difference; every
    valid proposal of the port is a valid tree."""
    tree_np = _dated_tree(2)
    t_tree, j_tree = _trees(tree_np)
    j_op = jtops.SubtreeSlideOperator(size=0.4)
    keys = jax.random.split(jax.random.PRNGKey(9), N_PROPOSALS)
    _, j_new, j_logq = jax.jit(jax.vmap(
        lambda k: j_op.propose({}, j_tree, k, 0.4)))(keys)
    j_par, j_h, j_root = (np.asarray(j_new.parent), np.asarray(j_new.heights),
                          np.asarray(j_new.root))
    j_trees = [(j_par[n], (j_h[n], j_root[n])) for n in range(N_PROPOSALS)]
    op = tops.SubtreeSlideOperator(size=0.4)
    gen = torch.Generator().manual_seed(4)
    t_trees, t_logq = [], []
    tun = torch.tensor(0.4, dtype=torch.float64)
    for _ in range(N_PROPOSALS):
        _, new, logq = op.propose({}, t_tree, gen, tun)
        arrs = _np_tree(new)
        if math.isfinite(float(logq)):
            check_tree_valid(*arrs, N_TAXA)
        t_trees.append((arrs[0], (arrs[2], int(arrs[3]))))
        t_logq.append(float(logq))
    a = _slide_stats(t_trees, np.array(t_logq), tree_np)
    b = _slide_stats(j_trees, np.asarray(j_logq), tree_np)
    n = N_PROPOSALS
    se_p = lambda p: math.sqrt(2 * p * (1 - p) / n)  # noqa: E731
    assert abs(a[0] - b[0]) < 5 * se_p(b[0])
    assert abs(a[1] - b[1]) < 5 * se_p(b[1]) + 1e-3
    finite = np.asarray(j_logq)[np.isfinite(j_logq)]
    assert abs(a[2] - b[2]) < 5 * math.sqrt(2 * finite.var() / len(finite))
    j_roots = np.array([h[r] for _, (h, r) in j_trees])
    assert abs(a[3] - b[3]) < 5 * math.sqrt(2 * j_roots.var() / n) + 1e-12


@pytest.mark.parametrize("op", [ops.NarrowExchangeOperator(),
                                ops.WideExchangeOperator(),
                                ops.WilsonBaldingOperator(),
                                ops.UniformNodeHeightOperator(),
                                ops.RootHeightScaleOperator()],
                         ids=lambda o: type(o).__name__)
def test_tree_moves_valid_on_dated_tips(op):
    """400 proposals on a dated tree: each with a finite Hastings ratio is
    a valid tree, no node below a child, and some are finite."""
    tree, _ = _trees(_dated_tree(3))
    gen = torch.Generator().manual_seed(5)
    tun = op.tuning(torch.tensor(op.initial_adapt(), dtype=torch.float64))
    n_valid = 0
    for _ in range(400):
        _, new, logq = op.propose({}, tree, gen, tun)[:3]
        if math.isfinite(float(logq)):
            check_tree_valid(*_np_tree(new), N_TAXA)
            n_valid += 1
    assert n_valid > 0


@pytest.mark.parametrize("mode", ["all", "independent"])
def test_scale_operator_modes_match_jax(mode):
    """The exact relation of each proposal's log Hastings to its factors
    (all: (dim - 2) log s, one s; independent: -sum log s_i), and the
    mean and variance of log s over 2,000 proposals of each package within
    5 standard errors."""
    x = np.linspace(0.5, 2.0, 7)
    sf = 0.6
    j_op = jops.ScaleOperator(parameter="x", mode=mode, scale_factor=sf)
    t_op = ops.ScaleOperator(parameter="x", mode=mode, scale_factor=sf)
    tree, j_tree = _trees(_dated_tree(0))
    keys = jax.random.split(jax.random.PRNGKey(1), N_PROPOSALS)
    j_p, _, j_logq = jax.jit(jax.vmap(lambda k: j_op.propose(
        {"x": jnp.asarray(x)}, j_tree, k, sf)))(keys)
    j_s = np.log(np.asarray(j_p["x"]) / x)
    gen = torch.Generator().manual_seed(6)
    px = {"x": torch.tensor(x)}
    tun = torch.tensor(sf, dtype=torch.float64)
    t_s, t_logq = [], []
    for _ in range(N_PROPOSALS):
        p, _, logq = t_op.propose(px, tree, gen, tun)
        t_s.append(np.log(p["x"].numpy() / x))
        t_logq.append(float(logq))
    t_s, t_logq = np.array(t_s), np.array(t_logq)
    for s, logq in ((t_s, t_logq), (j_s, np.asarray(j_logq))):
        if mode == "all":
            np.testing.assert_allclose(s, s[:, :1].repeat(7, 1), atol=1e-14)
            np.testing.assert_allclose(logq, 5 * s[:, 0], atol=1e-12)
        else:
            np.testing.assert_allclose(logq, -s.sum(1), atol=1e-12)
            assert np.abs(s[:, 0] - s[:, 1]).max() > 0.1
        assert np.all(np.abs(s) <= math.log(1 / sf) + 1e-12)
    se = math.sqrt(2 * j_s.var() / j_s.size)
    assert abs(t_s.mean() - j_s.mean()) < 5 * se
    assert abs(t_s.var() - j_s.var()) < 5 * math.sqrt(2 / j_s.size) \
        * j_s.var() * 2


def test_bit_flip_matches_jax():
    """One bit flipped a proposal, the position uniform (chi-square under
    its 0.999 quantile over 2,000 proposals), and the log Hastings JAX
    gives for a 0 -> 1 and a 1 -> 0 flip of the same vector."""
    from scipy.stats import chi2

    x = np.array([1.0, 0, 0, 1, 1, 0, 1, 0, 0, 0])
    tree, j_tree = _trees(_dated_tree(0))
    j_op = jops.BitFlipOperator(parameter="g")
    keys = jax.random.split(jax.random.PRNGKey(2), 200)
    j_p, _, j_logq = jax.jit(jax.vmap(lambda k: j_op.propose(
        {"g": jnp.asarray(x)}, j_tree, k, None)))(keys)
    j_pos = np.argmax(np.asarray(j_p["g"]) != x, axis=1)
    ref = {int(x[p]): float(q) for p, q in zip(j_pos, np.asarray(j_logq))}
    assert set(ref) == {0, 1}
    t_op = ops.BitFlipOperator(parameter="g")
    gen = torch.Generator().manual_seed(7)
    pos = []
    for _ in range(N_PROPOSALS):
        p, _, logq = t_op.propose({"g": torch.tensor(x)}, tree, gen, None)
        diff = np.flatnonzero(p["g"].numpy() != x)
        assert diff.size == 1 and p["g"].numpy()[diff[0]] == 1 - x[diff[0]]
        assert float(logq) == pytest.approx(ref[int(x[diff[0]])], rel=1e-14)
        pos.append(diff[0])
    c = np.bincount(pos, minlength=10)
    stat = np.sum((c - N_PROPOSALS / 10) ** 2 / (N_PROPOSALS / 10))
    assert stat < chi2.ppf(0.999, 9)


@pytest.mark.parametrize("scale", [1e-3, 0.7, 30.0, 2000.0])
def test_expm_taylor_matches_scipy(scale):
    """Rate matrices of inf-norm from ~1e-3 to ~1e5 (up to 19 squarings),
    S = 56, against scipy.linalg.expm, and transition_probs_expm against
    JAX's on the same generator and times."""
    rng = np.random.default_rng(int(scale * 7))
    qs = []
    for _ in range(3):
        q = rng.exponential(1.0, (56, 56))
        np.fill_diagonal(q, 0.0)
        q -= np.diag(q.sum(1))
        qs.append(q / np.abs(np.diag(q)).mean() * scale / 56)
    a = np.stack(qs)
    got = expm.expm_taylor(torch.tensor(a)).numpy()
    ref = np.stack([scipy.linalg.expm(x) for x in a])
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-13)
    t = rng.uniform(0.0, 3.0, (9, 2))
    got = expm.transition_probs_expm(torch.tensor(qs[0]), torch.tensor(t))
    ref = jexpm.transition_probs_expm(jnp.asarray(qs[0]), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-15)


def test_priors_and_clock_match_jax():
    """gamma, exponential, Poisson (with -inf off the support), the
    lognormal quantile and the discretised relaxed clock."""
    x = np.array([0.3, 1.7, 4.0, 1e-3])
    for t_fn, j_fn in ((lambda v: priors.gamma_logpdf(v, 0.001, 1000.0),
                        lambda v: jpriors.gamma_logpdf(v, 0.001, 1000.0)),
                       (lambda v: priors.gamma_logpdf(v, 2.5, 0.4),
                        lambda v: jpriors.gamma_logpdf(v, 2.5, 0.4)),
                       (lambda v: priors.exponential_logpdf(v, 0.001),
                        lambda v: jpriors.exponential_logpdf(v, 0.001)),
                       (lambda v: priors.poisson_logpmf(v, 38.8162),
                        lambda v: jpriors.poisson_logpmf(v, 38.8162))):
        for v in (x, np.array([3080.0]), np.array([-0.5, 1.0])):
            got = float(t_fn(torch.tensor(v)))
            ref = float(j_fn(jnp.asarray(v)))
            assert got == pytest.approx(ref, rel=1e-12) or got == ref
    chains = priors.gamma_logpdf(torch.tensor(np.stack([x, 2 * x])), 2.0, 1.5,
                                 True)
    assert chains.shape == (2,)
    cats = np.arange(31) % 30
    got = clock.discretized_clock_rates(torch.tensor(cats), 0.0012, 0.3)
    ref = jclock.discretized_lognormal_rates(jnp.asarray(cats), 0.0012, 0.3,
                                             30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    q = np.linspace(0.01, 0.99, 9)
    for mreal in (True, False):
        got = clock.lognormal_quantile(torch.tensor(q), 0.7, 0.5, mreal)
        ref = jclock.lognormal_quantile(jnp.asarray(q), 0.7, 0.5, mreal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_skygrid_matches_jax():
    """skygrid_loglik on dated trees (a coalescence on a grid point
    included) and gmrf_log_prior, against JAX."""
    rng = np.random.default_rng(3)
    gamma = rng.normal(0.5, 0.8, 50)
    cuts = coalescent.skygrid_cut_points(49, 2.0)
    np.testing.assert_array_equal(cuts.numpy(), np.linspace(2 / 49, 2.0, 49))
    for seed in range(3):
        par, ch, h, root = _dated_tree(seed, 30)
        if seed == 2:
            h = h.copy()
            h[30] = cuts[10].item()  # an event exactly at a grid point
        got = coalescent.skygrid_loglik(torch.tensor(h), 30,
                                        torch.tensor(gamma), cuts)
        ref = jcoal.skygrid_loglik(jnp.asarray(h), 30, jnp.asarray(gamma),
                                   jnp.asarray(cuts.numpy()))
        assert float(got) == pytest.approx(float(ref), rel=1e-12)
    for tau in (0.1, 3.0):
        got = coalescent.gmrf_log_prior(torch.tensor(gamma), tau)
        ref = jcoal.gmrf_log_prior(jnp.asarray(gamma), tau)
        assert float(got) == pytest.approx(float(ref), rel=1e-12)


def test_generators_and_connectivity_match_jax():
    """complex_q (row-major rates) against JAX's; general_complex_q
    against JAX's XML generator (the complex order); the BSSVS
    connectivity prior on strongly connected, weakly connected and
    disconnected indicator graphs, against JAX's; tree_loglikelihood_q at
    S = 6."""
    from beast_mcmc_tpu.config.xml_geo import (
        _complex_q_fn,
        svs_connectivity_prior,
    )

    rng = np.random.default_rng(8)
    k = 6
    f = rng.uniform(0.5, 1.5, k)
    r = rng.uniform(0.1, 3.0, k * (k - 1))
    got = sub.complex_q(torch.tensor(r), torch.tensor(f / f.sum()))
    ref = jsub.complex_q(jnp.asarray(r), jnp.asarray(f / f.sum()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=1e-15)
    q_fn = _complex_q_fn(None, lambda p: p["r"], "f", k)
    ref = q_fn({"r": jnp.asarray(r), "f": jnp.asarray(f)})
    got = sub.general_complex_q(torch.tensor(r), torch.tensor(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=1e-15)
    # connectivity: a directed ring is strongly connected; one edge of the
    # ring removed leaves it weakly connected; no edges at all, disconnected
    iu = np.triu_indices(k, 1)
    pos = {}
    for j, (a, b) in enumerate(zip(*iu)):
        pos[(a, b)] = j
        pos[(b, a)] = j + len(iu[0])
    ring = np.zeros(k * (k - 1))
    for a in range(k):
        ring[pos[(a, (a + 1) % k)]] = 1.0
    broken = ring.copy()
    broken[pos[(0, 1)]] = 0.0
    cases = {"ring": (ring, 0.0), "broken": (broken, -math.inf),
             "none": (np.zeros_like(ring), -math.inf),
             "all": (np.ones_like(ring), 0.0)}
    holder = types.SimpleNamespace(_svs_models={"m": ("r", "g", k,
                                                      k * (k - 1))})
    jax_prior = svs_connectivity_prior(holder, "m").fn
    for name, (ind, want) in cases.items():
        assert float(jax_prior({"g": jnp.asarray(ind)}, None)) == want, name
        assert float(sub.svs_connectivity_logprior(torch.tensor(ind),
                                                   k)) == want, name
    # the trait likelihood through the expm path at S = 6, C = 1, P = 1
    par, ch, h, root = _dated_tree(4, 20)
    tips = np.eye(k)[rng.integers(0, k, 20)][:, :, None]
    q = np.asarray(ref)
    one = np.ones(1)
    got = tree_loglikelihood_q(
        torch.tensor(tips), torch.tensor(one), torch.tensor(par),
        torch.tensor(ch), torch.tensor(h), torch.tensor(root),
        torch.tensor(q), torch.tensor(f / f.sum()), torch.tensor(one),
        torch.tensor(one), 1.0)
    ref = jax_tree_loglikelihood_q(
        jnp.asarray(tips), jnp.asarray(one), jnp.asarray(par),
        jnp.asarray(ch), jnp.asarray(h), root, jnp.asarray(q),
        jnp.asarray(f / f.sum()), jnp.asarray(one), jnp.asarray(one), 1.0)
    assert float(got) == pytest.approx(float(ref), rel=1e-10)

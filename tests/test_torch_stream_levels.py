"""The v1 streaming peel by levels (ops/cuda_stream.py) against the JAX
package.

peel_stream_ring walks the tree by levels of depth (level_schedule), B
chains' trees in one launch. Its plain version `_stream_plain`, the same
level walk and the path of CPU tensors, is held here: in float64 against
the JAX scan peel (`peel_site_loglik`, and `_peel_forward`'s partials
through the nodes), 1e-10 relative; in float32 against the TPU kernel it
replaces, `pallas_stream._stream_forward` in interpret mode, 5e-5 absolute
per site below 16 states and 1e-4 from 16 (tests/test_pallas_stream.py's
tolerances), 1e-5 on the partials, which lie in [0, 1]. The JAX kernel is
not run in float64: in interpret mode it stores float32 values into its
float64 buffers and raises. Also held: the chain axis (B = 3 trees from
their own seeds) against each chain alone, the route's gradient against
jax.grad of the JAX peel, the route that sends the GY94+Gamma4 codon chain
at 1,441 taxa to this kernel, the planner's envelope, and a small
GY94+Gamma4 analysis (chip_smoke.codon_analysis) against JAX's composition
of gy94_eigen, discrete_gamma_rates and tree_loglikelihood. The kernel
itself runs only on the card (chip_smoke.py, phases 2 and 11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import sitemodel as jsite
from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.models.coalescent import constant_coalescent_loglik
from beast_mcmc_tpu.models.priors import lognormal_logpdf, one_on_x_logpdf
from beast_mcmc_tpu.models.treelikelihood import tree_loglikelihood
from beast_mcmc_tpu.ops import pallas_stream as jstream
from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.ops import cuda_peeling, cuda_stream
from beast_mcmc_tpu_torch.ops.peeling import one_chain, post_by_node
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from chip_smoke import codon_analysis

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(n_taxa, seed, caterpillar=False):
    """(parent, children, heights, root) as numpy: a coalescent tree, or a
    caterpillar (each internal node joins the previous one and a tip)."""
    if not caterpillar:
        return simulate_coalescent_tree(np.random.default_rng(seed),
                                        np.zeros(n_taxa), 1.0)
    m = 2 * n_taxa - 1
    parent, children = np.full(m, -1), np.full((m, 2), -1)
    for i in range(1, n_taxa):
        children[n_taxa + i - 1] = (n_taxa + i - 2 if i > 1 else 0, i)
        parent[children[n_taxa + i - 1]] = n_taxa + i - 1
    return parent, children, np.r_[np.zeros(n_taxa),
                                   np.arange(1.0, n_taxa)], m - 1


def _data(n_taxa, c, s, p, seed, b=None):
    """Tips [N, S, P], row-stochastic matrices [(B,) M, C, S, S], freqs and
    category weights, as numpy."""
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    tips = (rng.random((n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    pm = rng.random((*lead, 2 * n_taxa - 1, c, s, s)) * 0.2 + 0.01
    pm /= pm.sum(-1, keepdims=True)
    return (tips, pm, rng.dirichlet(np.ones(s), lead or None),
            rng.dirichlet(np.ones(c), lead or None))


def _t(x, dt=F64):
    return torch.tensor(np.asarray(x), dtype=dt)


def _by_node(post_pos, tips, order):
    """Partials by position [n_int, C, S, P] as numpy by node [M, C, S, P]."""
    return post_by_node(post_pos[None], tips[None], order)[0].numpy()


SHAPES = [(9, 2, 2, 21), (14, 4, 4, 19), (11, 3, 8, 17), (10, 2, 20, 13),
          (8, 4, 61, 9)]  # taxa, categories, states, patterns


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_levels_match_jax_scan_f64(shape):
    """The plain level walk through the entry points against the JAX scan
    peel: the per-site log-likelihood, the pattern-weighted total, and the
    partials by level position against JAX's by node."""
    n, c, s, p = shape
    parent, children, heights, root = _tree(n, 50 + s)
    tips, pm, fr, cw = _data(n, c, s, p, 60 + s)
    order = np.asarray(jpeel.peel_order_from_heights(jnp.asarray(heights),
                                                      n))
    ref, ref_post, _ = jax.jit(jpeel._peel_forward)(
        jnp.asarray(tips), jnp.asarray(children), jnp.asarray(order),
        jnp.asarray(root), jnp.asarray(pm), jnp.asarray(fr), jnp.asarray(cw))
    ref = np.asarray(ref)
    args = (_t(tips), _t(children, torch.long), _t(order, torch.long),
            _t(root, torch.long), _t(pm), _t(fr), _t(cw))
    got = cuda_stream.peel_site_loglik_stream(*args)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)
    w = torch.arange(1.0, p + 1, dtype=F64)
    total = cuda_stream.peel_loglikelihood_stream(*args, w)
    np.testing.assert_allclose(float(total), float(w.numpy() @ ref),
                               rtol=1e-10)
    sched = cuda_stream.level_schedule(args[1], n)
    site, post = cuda_stream._stream_forward(*args[:3], *args[4:], sched)
    assert post.shape == (n - 1, c, s, p)
    np.testing.assert_array_equal(site.numpy(), got.numpy())
    # position i holds node sched[0][i]: the levels, not the heights
    np.testing.assert_allclose(post.numpy(),
                               np.asarray(ref_post)[sched[0].numpy()],
                               rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_levels_match_pallas_stream_f32(shape):
    """The TPU kernel peel_stream_ring replaces, in interpret mode, float32:
    the per-site log-likelihood, and the partials compared through the
    nodes (JAX's by height-order position, the port's by level
    position)."""
    n, c, s, p = shape
    parent, children, heights, root = _tree(n, 70 + s)
    tips, pm, fr, cw = _data(n, c, s, p, 80 + s)
    order = np.asarray(jpeel.peel_order_from_heights(jnp.asarray(heights),
                                                      n))
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    ref_site, ref_post = jstream._stream_forward(
        f32(tips), jnp.asarray(children), jnp.asarray(order), f32(pm),
        f32(fr), f32(cw), interpret=True)
    args = (_t(tips, torch.float32), _t(children, torch.long),
            _t(order, torch.long), _t(pm, torch.float32),
            _t(fr, torch.float32), _t(cw, torch.float32))
    sched = cuda_stream.level_schedule(args[1], n)
    site, post = cuda_stream._stream_forward(*args, sched)
    atol = 5e-5 if s < 16 else 1e-4
    np.testing.assert_allclose(site.numpy(), np.asarray(ref_site), atol=atol)
    np.testing.assert_allclose(
        _by_node(post, args[0], sched[0]),
        _by_node(torch.tensor(np.asarray(ref_post)), args[0], args[2]),
        atol=1e-5)


@pytest.mark.parametrize("n,c,s,p", [(12, 2, 8, 11), (9, 4, 61, 7)])
def test_chain_axis_matches_each_chain_alone(n, c, s, p):
    """B = 3 trees from their own seeds (the last a caterpillar, so that
    the level counts differ) in one plain chain-axis call against each
    chain alone, through `_stream_plain` and `peel_stream_chains`, and
    against the JAX scan peel chain by chain."""
    trees = [_tree(n, 90 + b, caterpillar=b == 2) for b in range(3)]
    tips, pm, fr, cw = _data(n, c, s, p, 91, b=3)
    tr = [make_tree_state(*t, dtype=F64, device="cpu") for t in trees]
    children = torch.stack([t.children for t in tr])
    parent = torch.stack([t.parent for t in tr])
    sched = cuda_stream.level_schedule(children, n, parent)
    assert [int((sched[3][b] < n - 1).sum()) for b in range(3)][2] == n - 1
    tips_t, pm_t, fr_t, cw_t = _t(tips), _t(pm), _t(fr), _t(cw)
    wcs = cw_t[:, :, None] * fr_t[:, None]
    site, post = cuda_stream._stream_plain(tips_t, sched, pm_t, wcs)
    got = cuda_stream.peel_stream_chains(tips_t, children, pm_t, fr_t, cw_t,
                                         sched)
    np.testing.assert_array_equal(got.numpy(), site.numpy())
    for b, (_, ch, h, root) in enumerate(trees):
        one = tuple(x[b] for x in sched)
        s_b, p_b = cuda_stream._stream_plain(tips_t, one_chain(one),
                                             pm_t[b:b + 1], wcs[b:b + 1])
        np.testing.assert_array_equal(site[b].numpy(), s_b[0].numpy())
        np.testing.assert_array_equal(post[b].numpy(), p_b[0].numpy())
        single = cuda_stream.peel_site_loglik_stream(
            tips_t, children[b], None, None, pm_t[b], fr_t[b], cw_t[b], one)
        np.testing.assert_allclose(got[b].numpy(), single.numpy(),
                                   rtol=1e-13)
        order = jpeel.peel_order_from_heights(jnp.asarray(h), n)
        ref = jax.jit(jpeel.peel_site_loglik)(
            jnp.asarray(tips), jnp.asarray(ch), order, jnp.asarray(root),
            jnp.asarray(pm[b]), jnp.asarray(fr[b]), jnp.asarray(cw[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref),
                                   rtol=1e-10)


@pytest.mark.parametrize("n,c,s,p", [(11, 2, 8, 9), (7, 4, 61, 5)])
def test_ring_route_gradient_matches_jax(n, c, s, p):
    """The gradient of sum(g * site logL) of B = 2 chains through
    peel_stream_chains (the plain forward with its partials, then one level
    adjoint) in the matrices, freqs and category weights against
    jax.vmap(jax.grad) of the JAX scan peel."""
    trees = [_tree(n, 100 + b) for b in range(2)]
    tips, pm, fr, cw = _data(n, c, s, p, 101, b=2)
    g = np.random.default_rng(102).random((2, p))
    tr = [make_tree_state(*t, dtype=F64, device="cpu") for t in trees]
    children = torch.stack([t.children for t in tr])
    leaves = [_t(x).requires_grad_(True) for x in (pm, fr, cw)]
    site = cuda_stream.peel_stream_chains(_t(tips), children, *leaves)
    got = torch.autograd.grad(torch.sum(_t(g) * site), leaves)
    orders = np.stack([np.asarray(jpeel.peel_order_from_heights(
        jnp.asarray(h), n)) for _, _, h, _ in trees])

    def f(pm_, fr_, cw_, ch, order, root, g_):
        return jnp.sum(g_ * jpeel.peel_site_loglik(
            jnp.asarray(tips), ch, order, root, pm_, fr_, cw_))

    ref = jax.jit(jax.vmap(jax.grad(f, argnums=(0, 1, 2))))(
        jnp.asarray(pm), jnp.asarray(fr), jnp.asarray(cw),
        jnp.asarray(np.stack([t[1] for t in trees])), jnp.asarray(orders),
        jnp.asarray(np.array([t[3] for t in trees])), jnp.asarray(g))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.all(np.isfinite(a.numpy()))
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()


def test_codon_gamma_route():
    """GY94+Gamma4 (61 states, 4 categories) at benchmark1's 1,441 taxa
    goes to this kernel, at 417 taxa still to the matrix-product one."""
    assert cuda_peeling.peel_route(2 * 1441 - 1, 4, 61) == "stream"
    assert cuda_peeling.peel_route(2 * 417 - 1, 4, 61) == "mxu"


def test_stream_plan_envelope():
    """Every shape of the envelope has a plan within the shared memory of a
    Hopper block and 16 warps: below 16 states slots of pw x C lanes (pw a
    power of two, 2..32 lanes), the block's slots the warps' groups; from
    16 a block of 8 patterns in at most 15 teams, at most 8 output tiles a
    warp, a team's matrix pieces dividing the node's 2C. Outside the
    envelope, or forced past it, the planner raises."""
    for itemsize in (4, 8):
        for c in range(1, 9):
            for s in range(2, 65):
                for p, b in ((7, 1), (593, 1), (593, 4), (2048, 1)):
                    plan = cuda_stream.stream_plan(p, c, s, itemsize, b)
                    assert plan.smem <= cuda_stream.SMEM_BUDGET < 227 * 1024
                    assert 1 <= plan.warps <= cuda_stream.MAX_WARPS
                    if s < cuda_stream.MMA_MIN_STATES:
                        lanes = plan.pw * c
                        assert 2 <= lanes <= 32 and plan.g == 0
                        assert plan.pw & (plan.pw - 1) == 0
                        assert plan.nodes == plan.warps * (32 // lanes)
                        assert (plan.pw >= 32 // itemsize
                                or lanes * 2 > 32)
                    else:
                        tw = plan.warps // plan.nodes
                        assert plan.pw == cuda_stream.TILE_W
                        assert 1 <= plan.nodes <= cuda_stream.MAX_TEAMS
                        assert plan.warps == plan.nodes * tw
                        assert -(-c * -(-s // 8) // tw) <= 8
                        assert (2 * c) % plan.g == 0
    for c, s in [(9, 4), (0, 4), (1, 1), (1, 65)]:
        with pytest.raises(ValueError):
            cuda_stream.stream_plan(128, c, s, 8)
    with pytest.raises(ValueError):  # 64 lanes
        cuda_stream.stream_plan(128, 4, 4, 8, pw=16)
    with pytest.raises(ValueError):  # 32 slots of [8, 15, 15] in f64
        cuda_stream.stream_plan(128, 8, 15, 8, warps=16)
    with pytest.raises(ValueError):  # 64 output tiles on one warp
        cuda_stream.stream_plan(128, 8, 64, 8, teams=1, warps=1)


def test_small_codon_gamma_analysis_matches_jax():
    """chip_smoke.codon_analysis with four Gamma categories (8 taxa x 16
    codons): its log posterior, fresh and from the derived cache, against
    the JAX package's gy94_eigen, discrete_gamma_rates, tree_loglikelihood
    and priors on the same data, at the start and at moved parameters."""
    log_post, ops, params0, tree0, aux = codon_analysis(8, 16, 4, F64, "cpu",
                                                        n_categories=4,
                                                        alpha=0.7)
    assert set(aux["derived"]) == {"eig", "site.rates"}
    assert aux["derived"]["site.rates"][1] == ("alpha",)
    assert {op.parameter for op in ops[:3]} == {"kappa", "omega", "alpha"}
    tips = jnp.asarray(aux["tips"].numpy())
    weights = jnp.asarray(aux["weights"].numpy())
    freqs = jnp.full(61, 1.0 / 61)
    parent, children, heights, root = (jnp.asarray(x.numpy()) for x in (
        tree0.parent, tree0.children, tree0.heights, tree0.root))

    @jax.jit
    def j_log_post(kappa, omega, alpha, rate, pop):
        rates, cw = jsite.discrete_gamma_rates(alpha, 4)
        return (tree_loglikelihood(tips, weights, parent, children, heights,
                                   root, jsub.gy94_eigen(kappa, omega, freqs),
                                   freqs, rates, cw, rate)
                + one_on_x_logpdf(pop) + lognormal_logpdf(rate, 0.0, 1.0)
                + constant_coalescent_loglik(heights, 8, pop))

    from beast_mcmc_tpu_torch.inference.mcmc import apply_derived

    for kappa, omega, alpha, rate, pop in ((2.0, 0.5, 0.7, 1.0, 0.5),
                                           (3.1, 0.2, 1.6, 0.8, 0.9)):
        params = apply_derived(aux["derived"], {
            **params0, "kappa": _t(kappa), "omega": _t(omega),
            "alpha": _t(alpha), "clock.rate": _t(rate), "pop.size": _t(pop)})
        ref = float(j_log_post(kappa, omega, alpha, rate, pop))
        np.testing.assert_allclose(float(log_post(params, tree0)), ref,
                                   rtol=1e-10)
        np.testing.assert_allclose(
            float(aux["log_post_cached"](params, tree0)), ref, rtol=1e-10)


def test_gy94_eigen_over_a_chain_batch():
    """gy94_eigen with kappa and omega [B], as phase 11's chain batch
    derives them: B systems from one batched eigh, each chain's transition
    matrices equal to its own system's (1e-12) and to JAX's (1e-10)."""
    from beast_mcmc_tpu_torch.models.substitution import gy94_eigen
    from beast_mcmc_tpu_torch.ops.eigen import transition_probs

    freqs = torch.full((61,), 1.0 / 61, dtype=F64)
    kappa, omega = _t([2.0, 3.5, 1.2]), _t([0.5, 0.1, 1.4])
    t = _t([[0.01, 0.3], [0.2, 1.0], [0.05, 2.0]])
    eig = gy94_eigen(kappa, omega, freqs)
    assert eig.values.shape == (3, 61)
    got = transition_probs(eig, t)
    for b in range(3):
        one = transition_probs(gy94_eigen(kappa[b], omega[b], freqs), t[b])
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=1e-12,
                                   atol=1e-14)
        j_eig = jsub.gy94_eigen(float(kappa[b]), float(omega[b]),
                                jnp.full(61, 1.0 / 61))
        ref = (np.asarray(j_eig.U)[None] * np.exp(
            np.asarray(j_eig.values)[None, None] * t[b].numpy()[:, None, None])
            ) @ np.asarray(j_eig.U_inv)[None]
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=1e-10,
                                   atol=1e-12)

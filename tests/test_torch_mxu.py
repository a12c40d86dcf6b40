"""The port's matrix-product peel against the JAX package's.

The plain PyTorch version of ops/cuda_mxu.py (the CPU path and the reference
of the CUDA kernel csrc/peel_mxu.cu) is held in float32 against the Pallas
kernel it replaces, pallas_mxu.py::_peel_kernel_mxu, run in interpret mode
(float32 is all that kernel takes): atol 1e-4 per site (the products run in
another summation order) and 1e-5 on the rescaled partials, which lie in
[0, 1]. In float64 it is held against the JAX scan peel at rtol 1e-12. The
kernel itself runs only on the card: chip_smoke.py holds it against this
plain version there. The dispatch rule and the launch planner are pure
functions of shapes and are held here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.ops import pallas_mxu as jmxu
from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.ops import cuda_mxu, cuda_peeling

SHAPES = [(6, 4, 4, 61), (9, 4, 20, 50), (7, 1, 61, 40)]
SMEM_LIMIT = 232448  # bytes a block may take on sm_90


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_taxa, c, s, p, seed=0):
    """Random tree, tips and row-stochastic matrices (numpy). Pattern 0 has
    a fully ambiguous tip (all ones); pattern 1 has an impossible one (all
    zeros), so its likelihood is 0 and every scale on its path is 1."""
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    m = 2 * n_taxa - 1
    tips = (rng.random((n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    tips[0, :, 0] = 1.0
    tips[1, :, 1] = 0.0
    pm = rng.random((m, c, s, s)) * 0.2 + 0.01
    pm = pm / pm.sum(-1, keepdims=True)
    order = np.asarray(jpeel.peel_order_from_heights(jnp.asarray(heights),
                                                      n_taxa))
    return (tips, children, order, root, pm, np.full(s, 1.0 / s),
            np.full(c, 1.0 / c))


def _torch(args, dt):
    tips, children, order, root, pm, freqs, cw = args
    f = lambda x: torch.tensor(np.array(x), dtype=dt)  # noqa: E731
    i = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    return (f(tips), i(children), i(order), i(root), f(pm), f(freqs), f(cw))


@pytest.mark.parametrize("shape", SHAPES)
def test_mxu_plain_matches_pallas_mxu_f32(shape):
    """The TPU kernel that peel_mxu replaces, in interpret mode, float32."""
    args = _problem(*shape, seed=5)
    tips, children, order, root, pm, freqs, cw = args
    f32 = jnp.float32
    ref_site, ref_post = jmxu._peel_forward_mxu(
        jnp.asarray(tips, f32), jnp.asarray(children), jnp.asarray(order),
        jnp.asarray(pm, f32), jnp.asarray(freqs, f32), jnp.asarray(cw, f32),
        interpret=True)
    t_tips, t_ch, t_order, _, t_pm, t_fr, t_cw = _torch(args, torch.float32)
    site, post = cuda_mxu._peel_forward_mxu(t_tips, t_ch, t_order, t_pm, t_fr,
                                            t_cw)
    n_taxa, c, s, p = shape
    assert site.dtype == torch.float32 and site.shape == (p,)
    assert post.shape == (2 * n_taxa - 1, c, s, p)
    ref_site = np.asarray(ref_site)
    assert ref_site[1] == -np.inf and np.isfinite(ref_site[0])
    np.testing.assert_allclose(site.numpy(), ref_site, atol=1e-4, rtol=0)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=1e-5,
                               rtol=0)
    site2, none = cuda_mxu._peel_forward_mxu(t_tips, t_ch, t_order, t_pm,
                                             t_fr, t_cw, want_post=False)
    assert none is None
    np.testing.assert_array_equal(site2.numpy(), site.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_mxu_plain_matches_jax_scan_f64(shape):
    """Through the entry points, float64, against the JAX scan peel; the
    partials by node against the scan's."""
    args = _problem(*shape, seed=6)
    tips, children, order, root, pm, freqs, cw = args
    f64 = jnp.float64
    ref, ref_post, _ = jpeel._peel_forward(
        jnp.asarray(tips, f64), jnp.asarray(children), jnp.asarray(order),
        jnp.asarray(root), jnp.asarray(pm, f64), jnp.asarray(freqs, f64),
        jnp.asarray(cw, f64))
    ref = np.asarray(ref)
    targs = _torch(args, torch.float64)
    got = cuda_mxu.peel_site_loglik_mxu(*targs)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    t_tips, t_ch, t_order, _, t_pm, t_fr, t_cw = targs
    _, post = cuda_mxu._peel_forward_mxu(t_tips, t_ch, t_order, t_pm, t_fr,
                                         t_cw)
    n_taxa = shape[0]
    np.testing.assert_allclose(post.numpy()[n_taxa:],
                               np.asarray(ref_post)[n_taxa:], rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_array_equal(
        post.numpy()[:n_taxa],
        np.broadcast_to(tips[:, None], (n_taxa, *shape[1:])))
    # the weighted total, without the impossible tip
    t_tips = t_tips.clone()
    t_tips[1, :, 1] = 1.0
    w = torch.arange(1, shape[3] + 1, dtype=torch.float64)
    site = cuda_mxu.peel_site_loglik_mxu(t_tips, *targs[1:])
    total = cuda_mxu.peel_loglikelihood_mxu(t_tips, *targs[1:], w)
    assert total.dtype == torch.float64 and bool(torch.isfinite(total))
    np.testing.assert_allclose(float(total), float(w @ site), rtol=1e-13)


@pytest.mark.parametrize("m,c,s,itemsize,route", [
    (123, 4, 4, 8, "resident"),      # benchmark2
    (3219, 4, 4, 8, "deep"),         # Makona
    (2881, 1, 4, 8, "deep"),         # a benchmark1 partition
    (255, 2, 8, 8, "stream"),        # below 16 states
    (255, 4, 15, 8, "stream"),
    (255, 4, 16, 8, "mxu"),
    (255, 4, 20, 8, "mxu"),          # the protein chain
    (127, 1, 61, 8, "mxu"),          # the codon chain
    (39, 4, 61, 8, "mxu"),
    (39, 4, 61, 4, "mxu"),
    (255, 8, 61, 8, "stream"),       # no plan within shared memory
    (255, 8, 61, 4, "mxu"),
    (30001, 4, 20, 8, "stream"),     # the schedule alone overflows
])
def test_peel_route_table(m, c, s, itemsize, route):
    assert cuda_peeling.peel_route(m, c, s, itemsize) == route
    if s >= cuda_peeling.MXU_MIN_STATES:
        assert cuda_mxu.resident_mxu_fits(m, c, s, itemsize) == (
            route == "mxu")


@pytest.mark.parametrize("itemsize", [4, 8])
def test_planner_stays_inside_shared_memory(itemsize):
    """For every S up to 64 and C up to 8 the kernel has a plan: it fits the
    card's limit, the block has at most 512 threads, a warp at most
    MAX_UNITS output tiles, at most 15 teams (a named barrier each), and
    the pieces per slot divide the node's 2*C. `resident_mxu_fits`, the
    route rule, keeps the shapes of the node-by-node design."""
    n_fit = 0
    for s in range(2, 65):
        for c in range(1, 9):
            for n_int in (7, 127, 4000):
                n_fit += cuda_mxu.resident_mxu_fits(2 * n_int + 1, c, s,
                                                    itemsize)
                plan = cuda_mxu.mxu_plan(n_int, c, s, itemsize)
                units = c * -(-s // 8)
                assert plan.smem <= cuda_mxu.SMEM_BUDGET < SMEM_LIMIT
                assert 1 <= plan.teams <= 15
                assert 32 * plan.teams * plan.tw <= 512
                assert -(-units // plan.tw) <= cuda_mxu.MAX_UNITS
                assert plan.g in (2 * c, 2, 1) and (2 * c) % plan.g == 0
                # the bytes the kernel will ask for (csrc/peel_mxu.cu)
                kp, mp = -(-s // 4) * 4, -(-s // 8) * 8
                lda = kp + (4 - kp) % 8
                assert lda % 8 == 4 and lda >= kp
                elems = (plan.teams * (plan.g * mp * lda + 2 * c * kp * 8)
                         + (plan.teams + 1) * plan.tw * 8)
                head = -(-(-(-(20 * n_int + 4) // 8) * 8 + 8 * plan.teams)
                         // 16) * 16
                assert plan.smem == (head + -(-elems * itemsize // 8) * 8
                                     + plan.teams * 64)
    assert n_fit > 1000
    # the chains' shapes: the whole node a slot at S = 20, a category's pair
    # at S = 61; as many teams as fit, the warps shared out
    assert cuda_mxu.mxu_plan(127, 4, 20, 8)[:3] == (5, 3, 8)
    assert cuda_mxu.mxu_plan(63, 1, 61, 8)[:3] == (2, 8, 2)
    assert cuda_mxu.mxu_plan(19, 4, 61, 8)[:3] == (2, 8, 2)
    assert cuda_mxu.mxu_plan(127, 8, 64, 8)[:3] == (1, 16, 2)


def test_prepare_mxu_takes_cuda_tensors_only():
    """The kernel's input check raises on a CPU tensor, and on shapes and
    types the kernel does not take, before anything is built."""
    args = _problem(6, 2, 20, 16)
    tips, ch, order, _, pm, fr, cw = _torch(args, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mxu.prepare_mxu(tips, ch, order, pm, fr, cw)
    with pytest.raises(TypeError):
        cuda_mxu.prepare_mxu(tips.half(), ch, order, pm.half(), fr.half(),
                             cw.half())
    with pytest.raises(TypeError):
        cuda_mxu.prepare_mxu(tips.float(), ch, order, pm, fr, cw)
    with pytest.raises(ValueError):
        cuda_mxu.prepare_mxu(tips, ch, order, pm[:, :, :19], fr, cw)
    with pytest.raises(ValueError):
        cuda_mxu.mxu_plan(5, 9, 20, 8)
    with pytest.raises(ValueError):
        cuda_mxu.mxu_plan(5, 2, 65, 8)

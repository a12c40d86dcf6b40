"""The resident and matrix-product peels by levels, against the JAX package.

Both kernels (csrc/peel_resident.cu, csrc/peel_mxu.cu) peel the tree by
levels of depth, from ops/cuda_stream.py::level_schedule, and so do their
plain versions (ops/cuda_peeling.py::_resident_plain and
ops/cuda_mxu.py::_mxu_plain, the deep kernel's level-by-level plain peel
with one partition). Here those plain versions, which a CPU tensor takes,
are held against:
- the JAX scan peel (`_peel_forward`) and the JAX level peel
  (`_peel_forward_levels`) in float64 at rtol 1e-12 per site: the same
  operations summed in other orders;
- the Pallas kernels they replace, in interpret mode, in float32:
  `_peel_forward_pallas` (S = 4) at rtol 2e-6, as tests/test_pallas_peeling.py
  holds it, and `_peel_forward_mxu` (S = 20 and 61) at 1e-4 absolute per
  site and 1e-5 on the partials by node, which lie in [0, 1];
on a coalescent tree, a caterpillar (one node a level) and pattern counts
that are no multiple of any tile. The dispatch tests check that on a CUDA
device the resident, matrix-product and v1 streaming routes hand their
kernels the level schedule, with one sort a peel: the kernel entries are
replaced by recorders, and the tips are CPU tensors that report themselves
as CUDA ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.ops import pallas_mxu as jmxu
from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.ops.pallas_peeling import _peel_forward_pallas
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.models import treelikelihood as ttl
from beast_mcmc_tpu_torch.ops import (
    cuda_mxu,
    cuda_peeling,
    cuda_stream,
    cuda_stream2,
)

SMEM_LIMIT = 232448  # bytes a block may take on sm_90


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caterpillar(n_taxa):
    m = 2 * n_taxa - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m)
    prev = 0
    for i in range(1, n_taxa):
        node = n_taxa + i - 1
        children[node] = (prev, i)
        parent[[prev, i]] = node
        heights[node] = float(i)
        prev = node
    return parent, children, heights, m - 1


def _problem(kind, n_taxa, c, s, p, seed):
    """Numpy tips (pattern 0 fully ambiguous at tip 0), a tree of this kind,
    row-stochastic matrices, its height order."""
    rng = np.random.default_rng(seed)
    if kind == "caterpillar":
        parent, children, heights, root = _caterpillar(n_taxa)
    else:
        parent, children, heights, root = simulate_coalescent_tree(
            rng, np.zeros(n_taxa), 1.0)
    m = 2 * n_taxa - 1
    tips = (rng.random((n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    tips[0, :, 0] = 1.0
    pm = rng.random((m, c, s, s)) * 0.2 + 0.01
    pm = pm / pm.sum(-1, keepdims=True)
    freqs = rng.dirichlet(np.full(s, 5.0))
    cw = rng.dirichlet(np.full(c, 3.0))
    order = np.asarray(jpeel.peel_order_from_heights(
        jnp.asarray(heights), n_taxa, jnp.asarray(parent)))
    return tips, children, order, root, pm, freqs, cw


def _jax(args, dt):
    tips, children, order, root, pm, freqs, cw = args
    return (jnp.asarray(tips, dt), jnp.asarray(children), jnp.asarray(order),
            jnp.asarray(root), jnp.asarray(pm, dt), jnp.asarray(freqs, dt),
            jnp.asarray(cw, dt))


def _torch(args, dt):
    tips, children, order, root, pm, freqs, cw = args
    f = lambda x: torch.tensor(np.array(x), dtype=dt)  # noqa: E731
    i = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    return (f(tips), i(children), i(order), i(root), f(pm), f(freqs), f(cw))


RESIDENT = [("coalescent", 40, 4, 4, 37), ("caterpillar", 20, 4, 4, 24),
            ("coalescent", 30, 2, 4, 13)]
MXU = [("coalescent", 10, 4, 20, 37), ("caterpillar", 8, 1, 61, 24),
       ("coalescent", 12, 2, 20, 13)]


@pytest.mark.parametrize("kind,n_taxa,c,s,p", RESIDENT + MXU)
def test_level_plain_matches_jax_scan_and_levels_f64(kind, n_taxa, c, s, p):
    """The plain version of the route's kernel against the JAX scan peel
    and the JAX level peel; the matrix-product one's partials by node
    against the scan's."""
    args = _problem(kind, n_taxa, c, s, p, seed=21)
    jargs = _jax(args, jnp.float64)
    scan, scan_post, _ = jpeel._peel_forward(*jargs)
    tips, children, order, root, pm, freqs, cw = jargs
    levels = jpeel._peel_forward_levels(tips, children, root, pm, freqs,
                                        cw)[0]
    targs = _torch(args, torch.float64)
    if s == 4:
        got = cuda_peeling.peel_site_loglik_cuda(*targs)
    else:
        t_tips, t_ch, t_order, _, t_pm, t_fr, t_cw = targs
        got, post = cuda_mxu._peel_forward_mxu(t_tips, t_ch, t_order, t_pm,
                                               t_fr, t_cw)
        np.testing.assert_allclose(post.numpy(), np.asarray(scan_post),
                                   rtol=1e-12, atol=1e-300)
    assert got.shape == (p,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(scan), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(levels), rtol=1e-12)


@pytest.mark.parametrize("kind,n_taxa,c,s,p", RESIDENT)
def test_resident_plain_matches_pallas_f32(kind, n_taxa, c, s, p):
    """The TPU kernel peel_resident replaces, interpret mode, float32."""
    args = _problem(kind, n_taxa, c, s, p, seed=22)
    tips, children, order, _, pm, freqs, cw = _jax(args, jnp.float32)
    ref = _peel_forward_pallas(tips, children, order, pm, freqs, cw,
                               interpret=True, want_post=False)[0]
    got = cuda_peeling.peel_site_loglik_cuda(*_torch(args, torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6)


@pytest.mark.parametrize("kind,n_taxa,c,s,p", MXU)
def test_mxu_plain_matches_pallas_mxu_levels_f32(kind, n_taxa, c, s, p):
    """The TPU kernel peel_mxu replaces, interpret mode, float32: the site
    log-likelihoods and the partials by node."""
    args = _problem(kind, n_taxa, c, s, p, seed=23)
    tips, children, order, _, pm, freqs, cw = _jax(args, jnp.float32)
    ref_site, ref_post = jmxu._peel_forward_mxu(tips, children, order, pm,
                                                freqs, cw, interpret=True)
    t_tips, t_ch, t_order, _, t_pm, t_fr, t_cw = _torch(args, torch.float32)
    site, post = cuda_mxu._peel_forward_mxu(t_tips, t_ch, t_order, t_pm, t_fr,
                                            t_cw)
    assert site.dtype == torch.float32 and post.shape == (2 * n_taxa - 1, c,
                                                          s, p)
    np.testing.assert_allclose(site.numpy(), np.asarray(ref_site), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kind", ["coalescent", "caterpillar"])
def test_mxu_plain_post_follows_the_level_order(kind):
    """`_mxu_plain` writes each position's partials to its node's row: the
    rows the level peel computes by position, scattered through `order`."""
    args = _problem(kind, 9, 2, 20, 11, seed=24)
    tips, children, _, _, pm, freqs, cw = _torch(args, torch.float64)
    sched = cuda_stream.level_schedule(children, 9)
    order, ids, pos, ls = sched
    wcs = cw[:, None] * freqs[None]
    site, post = cuda_mxu._mxu_plain(tips, sched, pm, wcs)
    site_pos, post_pos = cuda_stream2._deep_plain(
        tips[None], ids, pos, ls, pm[ids.long()][None], wcs[None],
        want_post=True)
    np.testing.assert_array_equal(site.numpy(), site_pos[0].numpy())
    np.testing.assert_array_equal(post[order].numpy(), post_pos[0].numpy())
    np.testing.assert_array_equal(post[:9].numpy(),
                                  tips[:, None].expand(9, 2, 20, 11).numpy())


def test_level_schedule_stays_in_range_on_a_cycle():
    """A proposal an operator rejects may rewire the tree into a cycle (a
    Wilson-Balding move below its own subtree); its likelihood is computed
    and thrown away. The schedule must still index inside its arrays, so
    that no kernel reads or writes out of range."""
    parent, children, _, _ = _caterpillar(8)
    children, parent = children.copy(), parent.copy()
    # nodes 9 and 10 become each other's child: a cycle cut off the root
    children[9], children[10] = (10, 2), (9, 3)
    parent[[10, 2]], parent[[9, 3]] = 9, 10
    n_int = 7
    order, ids, pos, ls = cuda_stream.level_schedule(
        torch.tensor(children), 8, torch.tensor(parent))
    assert sorted(order.tolist()) == list(range(8, 15))
    assert int(pos.max()) < n_int and int(pos.min()) >= -1
    assert ls.shape == (n_int + 1,) and int(ls[-1]) == n_int
    assert (torch.diff(ls) >= 0).all()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so that the
    likelihood takes its CUDA branch into the recorders below."""

    @property
    def is_cuda(self):
        return True


def _recording(monkeypatch):
    """Replace the resident, matrix-product and v1 streaming kernel entries
    with recorders that return their plain versions; count the sorts."""
    calls = []
    sorts = []
    real_sort = torch.sort

    def counted_sort(*a, **k):
        sorts.append(1)
        return real_sort(*a, **k)

    def plain(t):
        return t.as_subclass(torch.Tensor)

    def resident(tips, children, order, pm, freqs, cw, schedule,
                 want_post=False):
        calls.append(("resident", schedule))
        _, ids, pos, ls = schedule
        wcs = cw[..., None] * freqs[..., None, :]
        return cuda_peeling._resident_plain(plain(tips), ids, pos, ls, pm,
                                            wcs, want_post)

    def mxu(tips, children, order, pm, freqs, cw, schedule):
        calls.append(("mxu", schedule))
        return cuda_mxu._mxu_plain(plain(tips), schedule, pm,
                                   cw[..., None] * freqs[..., None, :])

    def ring(tips, schedule, pm, freqs, cw):
        calls.append(("stream", schedule))
        site, post = cuda_stream._stream_plain(
            plain(tips), schedule, pm, cw[..., None] * freqs[..., None, :])
        return site, post[:, None]  # the kernel's partials: one tile of P

    monkeypatch.setattr(cuda_peeling, "_peel_resident_kernel", resident)
    monkeypatch.setattr(cuda_mxu, "_peel_mxu_kernel", mxu)
    monkeypatch.setattr(cuda_stream, "_peel_stream_ring_kernel", ring)
    monkeypatch.setattr(torch, "sort", counted_sort)
    return calls, sorts


def _tree_args(n_taxa, seed):
    parent, children, heights, root = simulate_coalescent_tree(
        np.random.default_rng(seed), np.zeros(n_taxa), 1.0)
    tl = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    return (tl(parent), tl(children),
            torch.tensor(heights, dtype=torch.float64), tl(root))


@pytest.mark.parametrize("s,c,route", [(4, 4, "resident"), (20, 2, "mxu"),
                                       (8, 2, "stream")])
def test_site_logliks_hands_each_kernel_its_schedule(monkeypatch, s, c,
                                                     route):
    """tree_loglikelihood_pmats on a CUDA device: the resident,
    matrix-product and v1 streaming kernels get level_schedule (one sort),
    a batch of one; the totals agree with the CPU's height-ordered plain
    peel."""
    n_taxa, p = 14, 19
    parent, children, heights, root = _tree_args(n_taxa, 31)
    rng = np.random.default_rng(32)
    tips = torch.tensor((rng.random((n_taxa, s, p)) > 0.5) * 0.9 + 0.1)
    pm = torch.tensor(rng.random((2 * n_taxa - 1, c, s, s)) + 0.05)
    pm = pm / pm.sum(-1, keepdim=True)
    freqs = torch.full((s,), 1.0 / s, dtype=torch.float64)
    cw = torch.full((c,), 1.0 / c, dtype=torch.float64)
    w = torch.arange(1.0, p + 1, dtype=torch.float64)
    assert cuda_peeling.peel_route(2 * n_taxa - 1, c, s, 8) == route
    ref = ttl.tree_loglikelihood_pmats(tips, w, children, heights, root,
                                       parent, pm, freqs, cw)
    calls, sorts = _recording(monkeypatch)
    got = ttl.tree_loglikelihood_pmats(tips.as_subclass(_CudaLooking), w,
                                       children, heights, root, parent, pm,
                                       freqs, cw)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)
    assert [k for k, _ in calls] == [route]
    schedule = calls[0][1]
    assert len(sorts) == 1  # the kernel peels a batch of one
    want = cuda_stream.level_schedule(children[None], n_taxa, parent[None])
    assert len(schedule) == len(want)
    for a, b in zip(schedule, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("c", [1, 4])
def test_multipartition_hands_one_level_schedule_to_every_partition(
        monkeypatch, c):
    """multipartition_loglikelihood on a CUDA device, resident route: one
    level schedule (one sort) for the K partitions, each partition one
    launch, the total as on the CPU."""
    k_parts, n_taxa, p = 3, 12, 17
    parent, children, heights, root = _tree_args(n_taxa, 33)
    rng = np.random.default_rng(34)
    tips = torch.tensor((rng.random((k_parts, n_taxa, 4, p)) > 0.5) * 0.9
                        + 0.1)
    w = torch.tensor(rng.integers(1, 9, size=(k_parts, p)),
                     dtype=torch.float64)
    kappa = torch.tensor(rng.uniform(1.0, 6.0, k_parts))
    freqs = torch.tensor(rng.dirichlet(np.full(4, 5.0), size=k_parts))
    rates = torch.tensor(rng.uniform(0.3, 2.0, (k_parts, c)))
    cat_w = torch.tensor(rng.dirichlet(np.full(c, 3.0), size=k_parts))
    assert cuda_peeling.peel_route(2 * n_taxa - 1, c, 4, 8) == "resident"
    args = (w, parent, children, heights, root, tsub.hky_eigen(kappa, freqs),
            freqs, rates, cat_w, 0.9)
    ref = ttl.multipartition_loglikelihood(tips, *args)
    calls, sorts = _recording(monkeypatch)
    got = ttl.multipartition_loglikelihood(tips.as_subclass(_CudaLooking),
                                           *args)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)
    assert [k for k, _ in calls] == ["resident"] * k_parts
    assert all(a.data_ptr() == b.data_ptr()  # the one schedule's tensors
               for _, sch in calls for a, b in zip(sch, calls[0][1]))
    assert len(sorts) == 1
    want = cuda_stream.level_schedule(children, n_taxa, parent)
    for a, b in zip(calls[0][1], want):  # the kernel peels a batch of one
        np.testing.assert_array_equal(a.numpy(), b[None].numpy())


@pytest.mark.parametrize("itemsize", [4, 8])
def test_resident_planner_stays_inside_the_card(itemsize):
    """Every plan the resident planner gives, where resident_plan_fits, at
    every category count and with the planner's defaults or a forced tile,
    fits the card's shared memory and 1,024 threads, and its slots divide
    among its pattern tiles."""
    n = 0
    for c in range(1, 33):
        m_max = max(m for m in range(3, 4000, 2)
                    if cuda_peeling.resident_plan_fits(m, c, 4, itemsize))
        for m in (3, m_max // 2 | 1, m_max):
            for forced in ({}, {"warps": 16, "tiles": 1},
                           {"warps": 32, "tiles": 4}):
                plan = cuda_peeling.resident_plan(m, c, itemsize, **forced)
                n += 1
                assert plan.smem <= SMEM_LIMIT
                assert 32 * plan.warps <= 1024
                assert plan.slots % plan.tiles == 0
                assert plan.pw * c <= 32 and plan.pw & (plan.pw - 1) == 0
                assert plan.smem == (m * c * 16 * itemsize
                                     + plan.slots * plan.pw * 8)
    assert n == 32 * 3 * 3
    # benchmark2: 8 patterns x 4 categories, one slot, a warp; the
    # planner's defaults
    plan = cuda_peeling.resident_plan(123, 4, 8)
    assert plan[:4] == (8, cuda_peeling.WARPS, cuda_peeling.TILES,
                        cuda_peeling.WARPS)
    with pytest.raises(ValueError):
        cuda_peeling.resident_plan(123, 4, 8, warps=3, tiles=2)
    with pytest.raises(ValueError, match="categories"):
        cuda_peeling.resident_plan(123, 33, 8)


def test_resident_kernel_takes_cuda_tensors_only():
    """The resident kernel's own entry raises on CPU tensors: no fallback."""
    args = _torch(_problem("coalescent", 9, 2, 4, 16, seed=1), torch.float64)
    tips, children, order, _, pm, freqs, cw = args
    with pytest.raises(ValueError, match="CUDA"):
        cuda_peeling.prepare_resident(tips, children, order, pm, freqs, cw)

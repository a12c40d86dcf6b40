"""The deep peel's level schedule and its plain version against the JAX
package's.

The schedule (ops/cuda_stream.py::level_schedule) is held against
beast_mcmc_tpu/ops/peeling.py::_internal_depths on a coalescent, a balanced
and a caterpillar tree. The plain version of the deep kernel
(ops/cuda_stream2.py::_deep_plain, level by level, batched over the nodes
of a level and over partitions) is held against the JAX scan peel and the
JAX level peel in float64 (rtol 1e-12 per site: the same operations summed
in other orders), against the TPU kernel it replaces
(pallas_stream2.py::_deep_kernel, interpret mode) in float32 (atol 5e-5 per
site, as tests/test_pallas_stream.py), and through
multipartition_loglikelihood against the JAX one at K = 3 (rtol 1e-12).
The kernel itself runs only on the card: chip_smoke.py holds it against
this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.models import treelikelihood as jtl
from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.ops.pallas_stream2 import peel_site_loglik_deep
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.models import treelikelihood as ttl
from beast_mcmc_tpu_torch.ops import cuda_peeling, cuda_stream, cuda_stream2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _balanced(n_taxa):
    """A balanced tree on n_taxa (a power of two): (parent, children,
    heights, root), internal nodes joined level by level."""
    m = 2 * n_taxa - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m)
    layer, nxt, h = list(range(n_taxa)), n_taxa, 1.0
    while len(layer) > 1:
        up = []
        for a, b in zip(layer[::2], layer[1::2]):
            children[nxt] = (a, b)
            parent[[a, b]] = nxt
            heights[nxt] = h
            up.append(nxt)
            nxt += 1
        layer, h = up, h + 1.0
    return parent, children, heights, m - 1


def _caterpillar(n_taxa):
    """Each internal node joins the previous one and the next tip: n_int
    levels of one node."""
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


def _tree(kind, n_taxa, seed=0):
    if kind == "coalescent":
        return simulate_coalescent_tree(np.random.default_rng(seed),
                                        np.zeros(n_taxa), 1.0)
    return _balanced(n_taxa) if kind == "balanced" else _caterpillar(n_taxa)


def _levels(level_start, n_int):
    """The level index (0 = deepest) of every position."""
    ls = np.asarray(level_start)
    return np.searchsorted(ls, np.arange(n_int), side="right") - 1


TREES = [("coalescent", 50), ("balanced", 32), ("caterpillar", 20)]


@pytest.mark.parametrize("kind,n_taxa", TREES)
def test_level_schedule_depths_match_jax(kind, n_taxa):
    """The order visits every internal node once, deepest first; each
    position's level is its depth counted from the deepest level, with the
    depths of the JAX package's level peel; lr_ids are the children in
    that order."""
    parent, children, _, _ = _tree(kind, n_taxa)
    n_int = n_taxa - 1
    depth = np.asarray(jpeel._internal_depths(jnp.asarray(children), n_taxa))
    order, lr_ids, lr_pos, ls = cuda_stream.level_schedule(
        torch.tensor(children), n_taxa)
    order = order.numpy()
    assert sorted(order.tolist()) == list(range(n_taxa, 2 * n_taxa - 1))
    d = depth[order]
    assert (np.diff(d) <= 0).all()
    np.testing.assert_array_equal(d, d.max() - _levels(ls, n_int))
    np.testing.assert_array_equal(lr_ids.numpy(), children[order])
    assert lr_ids.dtype == lr_pos.dtype == ls.dtype == torch.int32
    # `parent` given or derived from the children: the same schedule
    again = cuda_stream.level_schedule(torch.tensor(children), n_taxa,
                                       torch.tensor(parent))
    for a, b in zip(again, (torch.tensor(order), lr_ids, lr_pos, ls)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kind,n_taxa", TREES)
def test_children_lie_one_level_deeper(kind, n_taxa):
    """Every internal child sits in the level just deeper than its parent's
    (so before the parent's level starts); a tip has position -1."""
    _, children, _, _ = _tree(kind, n_taxa)
    n_int = n_taxa - 1
    order, lr_ids, lr_pos, ls = cuda_stream.level_schedule(
        torch.tensor(children), n_taxa)
    lvl = _levels(ls, n_int)
    pos = lr_pos.numpy()
    ids = lr_ids.numpy()
    where = {int(n): i for i, n in enumerate(order.tolist())}
    for i in range(n_int):
        for k in range(2):
            if ids[i, k] < n_taxa:
                assert pos[i, k] == -1
            else:
                assert pos[i, k] == where[int(ids[i, k])]
                assert lvl[pos[i, k]] == lvl[i] - 1
                assert pos[i, k] < ls[lvl[i]]


@pytest.mark.parametrize("kind,n_taxa,n_levels", [
    ("coalescent", 50, None), ("balanced", 32, 5), ("caterpillar", 20, 19)])
def test_level_start_is_monotone_and_ends_at_n_int(kind, n_taxa, n_levels):
    """level_start has the fixed size n_int + 1, starts at 0, rises
    strictly over the levels and stays at n_int after the last one: the
    sentinel at which the kernel stops. The root is the last level alone."""
    _, children, _, root = _tree(kind, n_taxa)
    n_int = n_taxa - 1
    order, _, _, ls = cuda_stream.level_schedule(torch.tensor(children),
                                                 n_taxa)
    ls = ls.numpy()
    assert ls.shape == (n_int + 1,) and ls[0] == 0 and ls[-1] == n_int
    assert (np.diff(ls) >= 0).all()
    n_lev = int(np.argmax(ls == n_int))
    assert (np.diff(ls[:n_lev + 1]) > 0).all()
    depth = np.asarray(jpeel._internal_depths(jnp.asarray(children), n_taxa))
    assert n_lev == depth[n_taxa:].max() + 1
    if n_levels is not None:
        assert n_lev == n_levels
    assert ls[n_lev - 1] == n_int - 1 and int(order[-1]) == root


def _problem(kind, n_taxa, c, p, seed):
    """Numpy tips, a tree of this kind, row-stochastic matrices."""
    rng = np.random.default_rng(seed)
    parent, children, heights, root = _tree(kind, n_taxa, seed)
    m = 2 * n_taxa - 1
    tips = (rng.random((n_taxa, 4, p)) > 0.6) * 0.9 + 0.1
    pm = rng.random((m, c, 4, 4)) * 0.2 + 0.01
    pm = pm / pm.sum(-1, keepdims=True)
    freqs = rng.dirichlet(np.full(4, 5.0))
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


@pytest.mark.parametrize("kind,n_taxa,c,p", [
    ("coalescent", 60, 4, 37), ("coalescent", 250, 1, 20),
    ("balanced", 16, 2, 24), ("caterpillar", 30, 4, 9)])
def test_deep_plain_matches_jax_scan_and_levels_f64(kind, n_taxa, c, p):
    args = _problem(kind, n_taxa, c, p, seed=3)
    jargs = _jax(args, jnp.float64)
    scan = np.asarray(jpeel.peel_site_loglik(*jargs))
    tips, children, order, root, pm, freqs, cw = jargs
    levels = np.asarray(jpeel._peel_forward_levels(tips, children, root, pm,
                                                   freqs, cw)[0])
    got = cuda_stream2.peel_site_loglik_deep(*_torch(args, torch.float64))
    assert got.shape == (p,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), scan, rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), levels, rtol=1e-12)


@pytest.mark.parametrize("kind,n_taxa,c,p", [
    ("coalescent", 12, 2, 64), ("coalescent", 40, 4, 130),
    ("caterpillar", 10, 1, 37), ("balanced", 8, 4, 13)])
def test_deep_plain_matches_pallas_deep_f32(kind, n_taxa, c, p):
    """The TPU kernel the CUDA one replaces, interpret mode, float32, with
    pattern counts that are no multiple of its tiles (128 on the TPU, 8 or 4
    patterns a block on the card)."""
    args = _problem(kind, n_taxa, c, p, seed=7)
    ref = np.asarray(peel_site_loglik_deep(*_jax(args, jnp.float32), True))
    got = cuda_stream2.peel_site_loglik_deep(*_torch(args, torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


def _partitions(k_parts, n_taxa, c, p, seed):
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    tips = (rng.random((k_parts, n_taxa, 4, p)) > 0.6) * 0.9 + 0.1
    weights = rng.integers(1, 9, size=(k_parts, p)).astype(np.float64)
    kappa = rng.uniform(1.0, 6.0, k_parts)
    freqs = rng.dirichlet(np.full(4, 5.0), size=k_parts)
    cat_rates = rng.uniform(0.3, 2.0, (k_parts, c))
    cat_w = rng.dirichlet(np.full(c, 3.0), size=k_parts)
    return (tips, weights, kappa, freqs, cat_rates, cat_w,
            (parent, children, heights, root))


@pytest.mark.parametrize("n_taxa,c", [(220, 4), (820, 1)])
def test_multipartition_deep_route_matches_jax_f64(monkeypatch, n_taxa, c):
    """K = 3 partitions on a tree whose matrices take the deep route: one
    plain peel for all three partitions, against the JAX multipartition
    likelihood (scan peel) and the port's per-partition peels."""
    k_parts, p = 3, 24
    tips, w, kappa, freqs, cat_rates, cat_w, tree = _partitions(
        k_parts, n_taxa, c, p, seed=11)
    parent, children, heights, root = tree
    assert cuda_peeling.peel_route(2 * n_taxa - 1, c, 4, 8) == "deep"
    calls = []
    plain = cuda_stream2._deep_plain

    def counted(tips_k, *rest):
        calls.append(tips_k.shape[0])
        return plain(tips_k, *rest)

    monkeypatch.setattr(cuda_stream2, "_deep_plain", counted)
    j_eigs = jax.vmap(jsub.hky_eigen)(jnp.asarray(kappa), jnp.asarray(freqs))
    ref = jtl.multipartition_loglikelihood(
        jnp.asarray(tips), jnp.asarray(w), jnp.asarray(parent),
        jnp.asarray(children), jnp.asarray(heights), root, j_eigs,
        jnp.asarray(freqs), jnp.asarray(cat_rates), jnp.asarray(cat_w), 0.7,
        use_pallas=False)
    t64 = lambda x: torch.tensor(np.array(x), dtype=torch.float64)  # noqa
    tl = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    args = (tl(parent), tl(children), t64(heights), tl(root))
    got = ttl.multipartition_loglikelihood(
        t64(tips), t64(w), *args, tsub.hky_eigen(t64(kappa), t64(freqs)),
        t64(freqs), t64(cat_rates), t64(cat_w), 0.7)
    assert calls == [k_parts]
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)
    parts = sum(float(ttl.tree_loglikelihood(
        t64(tips[k]), t64(w[k]), *args,
        tsub.hky_eigen(float(kappa[k]), t64(freqs[k])), t64(freqs[k]),
        t64(cat_rates[k]), t64(cat_w[k]), 0.7)) for k in range(k_parts))
    assert calls == [k_parts] + [1] * k_parts
    np.testing.assert_allclose(float(got), parts, rtol=1e-12)


@pytest.mark.parametrize("p,k,c,itemsize,pw,slots,blocks", [
    (2048, 1, 4, 8, 8, 16, 256),   # Makona
    (640, 3, 1, 8, 8, 64, 240),    # benchmark1, three partitions
    (2048, 1, 4, 4, 8, 16, 256),
    (640, 3, 1, 4, 8, 64, 240),
    (256, 1, 4, 8, 4, 32, 64),     # small: narrowed to one sector a row
    (5632, 1, 4, 8, 8, 16, 704),
    (100, 1, 3, 8, 4, 32, 25),     # a category count that is no power of 2
    (64, 2, 32, 8, 1, 8, 128),     # the most categories: 8 warps fit
])
def test_deep_plan(p, k, c, itemsize, pw, slots, blocks):
    """The planner: the widest pattern tile a warp takes at C categories,
    narrowed while the grid of (tiles, partitions) leaves SMs idle, not
    below one 32-byte sector a state row; shared memory well inside a
    block's 227 KB."""
    plan = cuda_stream2.deep_plan(p, k, c, itemsize)
    assert (plan.pw, plan.slots) == (pw, slots)
    assert -(-p // plan.pw) * k == blocks
    assert plan.pw * c <= 32 and plan.warps * (32 // (pw * c)) == slots
    assert plan.smem == slots * (2 * (32 * c * itemsize + 16) + 8 * pw)
    assert plan.smem <= 200 * 1024
    forced = cuda_stream2.deep_plan(p, k, c, itemsize, pw=pw,
                                    warps=plan.warps // 2)
    assert 2 * forced.slots == slots


def test_deep_plan_refuses_what_shared_memory_cannot_hold():
    """32 categories in f64: 8 warps fit, 16 do not (two buffers of 8 KB of
    matrices a slot); forced, they raise."""
    assert cuda_stream2.deep_plan(64, 1, 32, 8).warps == 8
    with pytest.raises(ValueError, match="shared memory"):
        cuda_stream2.deep_plan(64, 1, 32, 8, warps=16)


def test_deep_kernel_takes_cuda_tensors_only():
    """A CPU tensor handed to the kernel's own entry raises: no fallback."""
    args = _torch(_problem("coalescent", 9, 2, 16, seed=1), torch.float64)
    tips, children, order, root, pm, freqs, cw = args
    _, ids, pos, ls = cuda_stream.level_schedule(children, 9)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_stream2.prepare_deep(tips[None], ids, pos, ls,
                                  pm[ids.long()][None], freqs[None], cw[None])
    with pytest.raises(ValueError, match="categories"):
        cuda_stream2.deep_plan(16, 1, 33, 8)

"""The port's peels against the JAX package's.

The plain PyTorch peels (the CPU path and the references of the three CUDA
kernels) are held against the JAX scan peel in float64 (rtol 1e-12: the
same operations in another summation order), and in float32 against the
three Pallas kernels they replace, run in interpret mode (atol 5e-5 per
site at S = 4 and 1e-4 at S = 61, as tests/test_pallas_stream.py holds the
streaming kernel; atol 1e-5 on its rescaled partials, which lie in [0, 1]).
The kernels themselves run only on the card: chip_smoke.py holds them
against these plain versions there. The dispatch rule and the streaming
kernel's launch planner are pure functions of shapes and are held here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.ops import pallas_stream as jstream
from beast_mcmc_tpu.ops.pallas_peeling import peel_site_loglik_pallas
from beast_mcmc_tpu.ops.pallas_stream2 import peel_site_loglik_deep
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models.sitemodel import (
    discrete_gamma_rates,
    single_rate,
)
from beast_mcmc_tpu_torch.models.substitution import (
    gtr_eigen,
    hky_eigen,
    jc_eigen,
)
from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
from beast_mcmc_tpu_torch.ops import cuda_peeling, cuda_stream, cuda_stream2
from beast_mcmc_tpu_torch.ops import peeling as tpeel

from fixtures import primate_patterns, primate_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_taxa, c, s, p, seed=0):
    """Random tree, tips and row-stochastic matrices (numpy)."""
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    m = 2 * n_taxa - 1
    tips = (rng.random((n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    pm = rng.random((m, c, s, s)) * 0.2 + 0.01
    pm = pm / pm.sum(-1, keepdims=True)
    freqs = np.full(s, 1.0 / s)
    cw = np.full(c, 1.0 / c)
    order = np.asarray(jpeel.peel_order_from_heights(jnp.asarray(heights),
                                                      n_taxa))
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


SHAPES = [(6, 4, 4, 40), (33, 1, 4, 200), (64, 2, 4, 130), (1025, 2, 4, 128)]
STREAM_SHAPES = [(6, 4, 4, 40), (33, 1, 4, 200), (64, 2, 4, 130),
                 (9, 1, 61, 40)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_peel_matches_jax_scan_f64(shape):
    args = _problem(*shape, seed=3)
    ref = np.asarray(jpeel.peel_site_loglik(*_jax(args, jnp.float64)))
    targs = _torch(args, torch.float64)
    got = tpeel.peel_site_loglik(*targs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    # the deep kernel's plain version reads the peel-ordered schedule
    got = cuda_stream2.peel_site_loglik_deep(*targs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("shape,rtol", [(s, 1e-12) for s in STREAM_SHAPES]
                         + [((1025, 2, 4, 128), 1e-10)])
def test_stream_plain_matches_jax_scan_f64(shape, rtol):
    """The v1 streaming kernel's plain version, through its entry points,
    against the JAX scan; its partials, by level position, against the
    scan's through the nodes (position i holds node level_schedule's
    order[i])."""
    args = _problem(*shape, seed=3)
    jargs = _jax(args, jnp.float64)
    ref, ref_post, _ = jpeel._peel_forward(*jargs)
    targs = _torch(args, torch.float64)
    got = cuda_stream.peel_site_loglik_stream(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol)
    tips, children, order, root, pm, freqs, cw = targs
    site, post_pos = cuda_stream._stream_forward(tips, children, order, pm,
                                                 freqs, cw)
    assert post_pos.shape == (shape[0] - 1, *shape[1:])
    np.testing.assert_array_equal(site.numpy(), got.numpy())
    lvl_order = cuda_stream.level_schedule(children, shape[0])[0]
    np.testing.assert_allclose(post_pos.numpy(),
                               np.asarray(ref_post)[lvl_order.numpy()],
                               rtol=rtol, atol=1e-300)
    # the plain peel returns what the JAX one does where a test needs it
    p_site, p_post = tpeel._peel_forward(*targs)
    np.testing.assert_allclose(p_site.numpy(), np.asarray(ref), rtol=rtol)
    np.testing.assert_allclose(p_post.numpy(), np.asarray(ref_post),
                               rtol=rtol, atol=1e-300)
    w = torch.arange(1, shape[3] + 1, dtype=torch.float64)
    total = cuda_stream.peel_loglikelihood_stream(*targs, w)
    np.testing.assert_allclose(float(total), float(np.dot(w.numpy(), ref)),
                               rtol=max(rtol, 1e-11))


@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_stream_plain_matches_pallas_stream_f32(shape):
    """The TPU kernel this package's peel_stream_ring replaces, in interpret
    mode, float32: the per-site log-likelihood, and the partials compared
    through the nodes (the TPU kernel's by height-order position, the
    port's by level position)."""
    args = _problem(*shape, seed=7)
    tips, children, order, root, pm, freqs, cw = _jax(args, jnp.float32)
    ref_site, ref_post = jstream._stream_forward(tips, children, order, pm,
                                                 freqs, cw, interpret=True)
    ref_entry = jstream.peel_site_loglik_stream(tips, children, order, root,
                                                pm, freqs, cw, True)
    targs = _torch(args, torch.float32)
    got = cuda_stream.peel_site_loglik_stream(*targs)
    atol = 5e-5 if shape[2] < 16 else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_entry), atol=atol)
    sched = cuda_stream.level_schedule(targs[1], shape[0])
    _, post_pos = cuda_stream._stream_forward(targs[0], targs[1], targs[2],
                                              *targs[4:], sched)
    by_node = [tpeel.post_by_node(pos[None], targs[0][None], o)[0].numpy()
               for pos, o in ((post_pos, sched[0]),
                              (torch.tensor(np.asarray(ref_post)),
                               targs[2]))]
    np.testing.assert_allclose(*by_node, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_site), atol=atol)


@pytest.mark.parametrize("shape", [(6, 4, 4, 40), (33, 1, 4, 200),
                                   (12, 2, 4, 64)])
def test_plain_peel_matches_pallas_kernels_f32(shape):
    """Both TPU kernels of the main path, interpret mode, float32."""
    args = _problem(*shape, seed=5)
    jargs = _jax(args, jnp.float32)
    targs = _torch(args, torch.float32)
    resident = np.asarray(peel_site_loglik_pallas(*jargs, True))
    deep = np.asarray(peel_site_loglik_deep(*jargs, True))
    got = cuda_peeling.peel_site_loglik_cuda(*targs).numpy()
    np.testing.assert_allclose(got, resident, atol=5e-5)
    np.testing.assert_allclose(got, deep, atol=5e-5)
    got = cuda_stream2.peel_site_loglik_deep(*targs).numpy()
    np.testing.assert_allclose(got, deep, atol=5e-5)


@pytest.fixture(scope="module")
def primates():
    pats = primate_patterns()
    parent, children, heights, root, taxa = primate_tree()
    f = lambda x: torch.tensor(np.array(x), dtype=torch.float64)  # noqa: E731
    i = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    return {
        "tips": f(np.swapaxes(pats.tip_partials(), 1, 2)),
        "weights": f(pats.weights),
        "parent": i(parent), "children": i(children),
        "heights": f(heights), "root": i(root),
        "freqs_emp": f(pats.empirical_frequencies()),
    }


def _loglik(st, eig, freqs, rates, weights):
    return float(tree_loglikelihood(
        st["tips"], st["weights"], st["parent"], st["children"],
        st["heights"], st["root"], eig, freqs, rates, weights,
        branch_rates=1.0))


def _golden(name, st):
    """(logL, expected) for the oracles of tests/test_peeling.py
    (LikelihoodTest.java)."""
    quarter = torch.full((4,), 0.25, dtype=torch.float64)
    emp = st["freqs_emp"]
    one = single_rate(device="cpu")
    if name == "jc69":
        return _loglik(st, jc_eigen(device="cpu"), quarter, *one), -1992.20564
    if name == "k80":
        return (_loglik(st, hky_eigen(27.402591, quarter), quarter, *one),
                -1856.30305)
    if name == "hky85":
        return _loglik(st, hky_eigen(29.739445, emp), emp, *one), -1825.21317
    if name == "hky85_gamma":
        rates = discrete_gamma_rates(torch.tensor(0.137064, dtype=torch.float64), 4)
        return _loglik(st, hky_eigen(38.829740, emp), emp, *rates), -1789.75936
    eig = gtr_eigen(torch.ones(6, dtype=torch.float64), emp)
    return _loglik(st, eig, emp, *one), -1969.14584


@pytest.mark.parametrize("name", ["jc69", "k80", "hky85", "hky85_gamma", "gtr"])
def test_golden_oracles(primates, name):
    got, expected = _golden(name, primates)
    np.testing.assert_allclose(got, expected, atol=2e-5)


def test_non_divisible_patterns(primates):
    """P = 61: the wrappers take a ragged pattern count as it is, and
    pad_patterns' all-ones, zero-weight columns leave the total unchanged."""
    st = primates
    tips = st["tips"][:, :, :61].contiguous()
    w = st["weights"][:61]
    freqs = st["freqs_emp"]
    rates, cw = discrete_gamma_rates(torch.tensor(0.5, dtype=torch.float64), 4)
    eig = gtr_eigen(torch.tensor([1.0, 2.0, 0.7, 1.1, 3.0, 1.0],
                                 dtype=torch.float64), freqs)
    from beast_mcmc_tpu_torch.models.treelikelihood import (
        branch_transition_matrices,
    )

    pm = branch_transition_matrices(eig, st["parent"], st["heights"], 1.0,
                                    rates)
    order = tpeel.peel_order_from_heights(st["heights"], 6, st["parent"])
    args = (st["children"], order, st["root"], pm, freqs, cw)
    site = cuda_peeling.peel_site_loglik_cuda(tips, *args)
    assert site.shape == (61,)
    ref = peel_site_loglik_pallas(
        jnp.asarray(tips.numpy(), jnp.float32), jnp.asarray(st["children"]),
        jnp.asarray(order.numpy()), jnp.asarray(st["root"]),
        jnp.asarray(pm.numpy(), jnp.float32), jnp.asarray(freqs, jnp.float32),
        jnp.asarray(cw, jnp.float32), True)
    np.testing.assert_allclose(site.numpy(), np.asarray(ref), atol=5e-5)
    np.testing.assert_allclose(
        cuda_stream2.peel_site_loglik_deep(tips, *args).numpy(),
        site.numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        cuda_stream.peel_site_loglik_stream(tips, *args).numpy(),
        site.numpy(), rtol=1e-12)
    tips_p, w_p = tpeel.pad_patterns(tips, w, 128)
    assert tips_p.shape[2] == 128 and float(w_p[61:].abs().sum()) == 0.0
    site_p = cuda_peeling.peel_site_loglik_cuda(tips_p, *args)
    assert bool(torch.isfinite(site_p).all())
    np.testing.assert_allclose(
        float(tpeel.peel_loglikelihood(tips_p, *args, w_p)),
        float(tpeel.peel_loglikelihood(tips, *args, w)), rtol=1e-12)


@pytest.mark.parametrize("dtype,itemsize", [(torch.float64, 8),
                                            (torch.float32, 4)])
def test_resident_plan_cut_over(dtype, itemsize):
    """Re-derived for Hopper shared memory: the benchmark2 tree's matrices
    fit (resident), the Makona tree's do not (streaming)."""
    b2_m, mak_m = 2 * 62 - 1, 2 * 1610 - 1
    assert cuda_peeling.resident_plan_fits(b2_m, 4, 4, itemsize)
    assert not cuda_peeling.resident_plan_fits(mak_m, 4, 4, itemsize)
    # the cut-over sits where [M,C,S,S] + the reduction buffer meet 200 KB
    m_max = max(m for m in range(1, 4000)
                if cuda_peeling.resident_plan_fits(m, 4, 4, itemsize))
    assert (m_max * 64 + 256) * itemsize <= 200 * 1024 < (
        (m_max + 1) * 64 + 256) * itemsize


@pytest.mark.parametrize("m,c,s,itemsize,route", [
    (2 * 62 - 1, 4, 4, 8, "resident"),     # benchmark2
    (2 * 1610 - 1, 4, 4, 8, "deep"),       # Makona
    (2 * 1441 - 1, 1, 4, 8, "deep"),       # one benchmark1 partition
    (2 * 1441 - 1, 1, 4, 4, "resident"),   # in float32 its 184 KB fit
    (11, 4, 20, 8, "mxu"),                 # amino acids, however small
    (2 * 1610 - 1, 1, 61, 4, "mxu"),       # codons
    (11, 1, 2, 8, "stream"),
    (11, 4, 15, 8, "stream"),              # below the matrix-product kernel
])
def test_peel_route(m, c, s, itemsize, route):
    """S = 4 goes by resident_plan_fits as in the JAX dispatcher; S >= 16
    goes to the matrix-product kernel (its own table is in
    tests/test_torch_mxu.py); any other S goes to the v1 streaming kernel."""
    assert cuda_peeling.peel_route(m, c, s, itemsize) == route


@pytest.mark.parametrize("shape", [
    (6, 4, 4, 40),       # resident
    (1025, 2, 4, 128),   # deep
    (9, 1, 61, 40),      # mxu
    (9, 2, 8, 40),       # stream
])
def test_auto_dispatchers_on_cpu_tensors(shape):
    """Each route of the per-site dispatcher, and the total built on it,
    against the JAX scan; CPU tensors take each wrapper's plain version."""
    args = _problem(*shape, seed=5)
    ref = np.asarray(jpeel.peel_site_loglik(*_jax(args, jnp.float64)))
    targs = _torch(args, torch.float64)
    got = cuda_peeling.peel_site_loglik_auto(*targs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)
    w = torch.arange(1, shape[3] + 1, dtype=torch.float64)
    total = cuda_peeling.peel_loglikelihood_auto(*targs, w)
    assert total.dtype == torch.float64
    np.testing.assert_allclose(float(total), float(np.dot(w.numpy(), ref)),
                               rtol=1e-10)


def test_check_kernel_inputs_takes_the_states_a_kernel_supports():
    """The two S = 4 kernels go on refusing 20 states; the streaming
    kernel's envelope lets them through to the device check, which CPU
    tensors then fail; 9 categories are outside it."""
    def args(c, s):
        return (torch.zeros((3, s, 8)), torch.zeros((5, c, s, s)),
                torch.zeros(s), torch.zeros(c))

    with pytest.raises(ValueError, match="states"):
        cuda_peeling.check_kernel_inputs(*args(1, 20))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_peeling.check_kernel_inputs(*args(1, 4))
    envelope = dict(states=cuda_stream.STATES,
                    max_categories=cuda_stream.MAX_CATEGORIES)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_peeling.check_kernel_inputs(*args(8, 20), **envelope)
    with pytest.raises(ValueError, match="states"):
        cuda_peeling.check_kernel_inputs(*args(1, 65), **envelope)
    with pytest.raises(ValueError, match="categories"):
        cuda_peeling.check_kernel_inputs(*args(9, 20), **envelope)
    with pytest.raises(TypeError):
        cuda_peeling.check_kernel_inputs(
            *(t.half() for t in args(1, 20)), **envelope)


@pytest.mark.parametrize("p,c,s,itemsize,b,pw,warps,nodes,g", [
    (593, 1, 4, 8, 1, 4, 16, 128, 0),   # one benchmark1 partition: 149 tiles
    (2048, 4, 4, 8, 1, 8, 16, 16, 0),   # Makona: 256 tiles of 8
    (5632, 4, 4, 8, 1, 8, 16, 16, 0),   # benchmark2
    (593, 1, 4, 4, 1, 8, 16, 64, 0),    # float32: one 32-byte sector
    (300, 2, 8, 8, 1, 4, 8, 32, 0),     # S = 8: 8 warps' slots fit
    (300, 2, 8, 8, 4, 8, 16, 32, 0),    # four chains: 152 blocks of 8
    (100, 1, 2, 8, 1, 4, 16, 128, 0),   # S = 2
    (130, 8, 15, 8, 1, 4, 2, 2, 0),     # the largest slots: two warps
    (1024, 4, 20, 8, 1, 8, 15, 3, 8),   # amino acids: a whole node a buffer
    (512, 1, 61, 8, 1, 8, 16, 2, 1),    # codons, one category: a piece
    (593, 4, 61, 8, 1, 8, 16, 2, 1),    # codon+Gamma4: two teams
    (593, 4, 61, 8, 4, 8, 16, 2, 1),    # the same for four chains
    (64, 8, 64, 8, 1, 8, 16, 1, 2),     # the corner: one team
])
def test_stream_plan(p, c, s, itemsize, b, pw, warps, nodes, g):
    """The streaming kernel's planner, from Hopper's 227 KB of shared
    memory a block and 132 SMs. Below 16 states: slots of pw x C lanes, pw
    the widest power of two with pw x C <= 32, halved while the grid of
    ceil(P / pw) x B blocks leaves SMs idle, down to one 32-byte sector;
    16 warps, fewer where the slots' two buffers of a node's matrices
    overflow. From 16: 8 patterns a block, teams of warps, as many as fit,
    each with two buffers of a whole node's matrices, else a category's
    pair, else one piece, the most that leaves room for a second team."""
    plan = cuda_stream.stream_plan(p, c, s, itemsize, b)
    assert (plan.pw, plan.warps, plan.nodes, plan.g) == (pw, warps, nodes, g)
    assert plan.smem <= cuda_stream.SMEM_BUDGET < 227 * 1024
    assert plan.warps * 32 <= 512
    if s < cuda_stream.MMA_MIN_STATES:
        per16 = 16 // itemsize
        ne_pad = -(-c * s * s // per16) * per16
        assert plan.smem == nodes * (4 * ne_pad * itemsize + 8 * pw)
        tiles = -(-p // pw) * b
        assert pw == 32 // itemsize or tiles >= cuda_stream.N_SM or (
            2 * pw * c > 32)
    else:
        assert pw == cuda_stream.TILE_W and (2 * c) % g == 0
        assert plan.smem == cuda_stream._teams_smem(c, s, g, nodes,
                                                    warps // nodes, itemsize)
        units = c * -(-s // 8)
        tw_min = -(-units // 8)
        tw_more = min(units, max(tw_min, 16 // (nodes + 1)))
        assert (nodes == cuda_stream.MAX_TEAMS or (nodes + 1) * tw_min > 16
                or cuda_stream._teams_smem(c, s, g, nodes + 1, tw_more,
                                           itemsize)
                > cuda_stream.SMEM_BUDGET)  # as many teams as fit


def test_stream_plan_covers_the_envelope_and_refuses_outside():
    for itemsize in (4, 8):
        for c in range(1, 9):
            for s in range(2, 65):
                plan = cuda_stream.stream_plan(1000, c, s, itemsize)
                assert plan.pw >= 1 and plan.smem <= cuda_stream.SMEM_BUDGET
    for c, s in [(9, 4), (0, 4), (1, 1), (1, 65)]:
        with pytest.raises(ValueError):
            cuda_stream.stream_plan(128, c, s, 8)


def test_stream_schedule():
    """lr_ids are the children in peel order, lr_pos their positions, -1 for
    tips; a child always sits before its parent."""
    args = _problem(20, 1, 4, 8, seed=2)
    _, children, order, *_ = _torch(args, torch.float64)
    lr_ids, lr_pos = cuda_stream.stream_schedule(children, order)
    assert lr_ids.dtype == lr_pos.dtype == torch.int32
    np.testing.assert_array_equal(lr_ids.numpy(), args[1][args[2]])
    pos = {int(n): i for i, n in enumerate(order.tolist())}
    for i in range(19):
        for k in range(2):
            child = int(lr_ids[i, k])
            assert int(lr_pos[i, k]) == pos.get(child, -1) < i

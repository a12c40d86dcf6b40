"""The port's parallel/ layer in one process, against the JAX package.

The mesh's shape rule and errors equal JAX make_mesh's on the 8 virtual
CPU devices of tests/conftest.py; each sharding's slices equal the shards
that jax.device_put makes; the swap twin's permutation equals JAX
mc3_swap_across_hosts' given JAX's draws from the same key. A world of one
gloo rank (a file:// rendezvous under tmp_path: never a world larger than
one in the pytest process) runs sharded_pattern_loglik against JAX's
unsharded and sharded totals, and MC3 over a 1 x 1 mesh against MC3
without one. The several-rank paths are tests/test_torch_distributed.py.
"""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.ops.peeling import peel_order_from_heights as jax_order
from beast_mcmc_tpu.ops.peeling import peel_site_loglik as jax_site_loglik
from beast_mcmc_tpu.parallel import distributed as JD
from beast_mcmc_tpu.parallel import mesh as JM

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.inference.mc3 import (
    make_mc3_runner,
    replicate_state,
    swap_states,
)
from beast_mcmc_tpu_torch.inference.mcmc import init_mcmc_state
from beast_mcmc_tpu_torch.parallel import distributed as D
from beast_mcmc_tpu_torch.parallel import mesh as M
from beast_mcmc_tpu_torch.parallel.__main__ import (
    _batch,
    likelihood_inputs,
    likelihood_site_fn,
)

# tests/test_parallel_alloppnet.py's tolerance for a sharded likelihood
LIK_REL_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world_of_one(tmp_path):
    """A world of one gloo CPU rank, destroyed after the test."""
    D.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        yield
    finally:
        D.shutdown()


def jax_totals(n_taxa, n_categories, n_patterns, seed):
    """JAX's unsharded total of `likelihood_inputs` and its
    sharded_pattern_loglik over the 8 virtual devices (a 2 x 4 mesh)."""
    x = likelihood_inputs(n_taxa, n_categories, n_patterns, seed)
    children = jnp.asarray(x["children"])
    order = jax_order(jnp.asarray(x["heights"]), n_taxa)
    args = (children, order, int(x["root"]), jnp.asarray(x["pm"]),
            jnp.asarray(x["freqs"]), jnp.asarray(x["cat_w"]))
    tips, w = jnp.asarray(x["tips"]), jnp.asarray(x["weights"])
    unsharded = float(jnp.dot(w, jax.jit(jax_site_loglik)(tips, *args)))
    mesh = JD.global_mesh(n_chains=2)
    axes = mesh.axis_names
    from jax.sharding import NamedSharding, PartitionSpec as P

    total = JD.sharded_pattern_loglik(mesh, lambda tp: jax_site_loglik(
        tp, *args))
    sharded = float(jax.jit(total)(
        jax.device_put(tips, NamedSharding(mesh, P(None, None, axes))),
        jax.device_put(w, NamedSharding(mesh, P(axes)))))
    return unsharded, sharded


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_and_errors_match_jax(n):
    devices = jax.devices()[:n]
    for a, b in itertools.product([None, 1, 2, 3, 4, 8], repeat=2):
        try:
            want = JM.make_mesh(a, b, devices=devices).devices.shape
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                M.mesh_shape(a, b, n)
            continue
        assert M.mesh_shape(a, b, n) == want, (a, b, n)


def test_make_mesh_in_a_world_of_one(world_of_one):
    mesh = M.make_mesh()
    assert mesh.shape == (1, 1)
    assert mesh.mesh_dim_names == (M.CHAINS_AXIS, M.PATTERNS_AXIS)
    assert M.make_mesh(1, 1, devices=[0]).shape == (1, 1)
    assert D.global_mesh(1).shape == (1, 1)
    assert D.process_index() == 0 and D.local_device() == torch.device("cpu")
    # JAX's messages on one device
    for a, b in ((2, None), (None, 2), (2, 1)):
        with pytest.raises(ValueError) as want:
            JM.make_mesh(a, b, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            M.make_mesh(a, b)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="2 chains do not divide 1 devices"):
        D.global_mesh(2)
    with pytest.raises(ValueError, match="each of the world's 1 ranks"):
        M.make_mesh(1, 1, devices=[1])


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharding_slices_match_jax_device_put(shape, world_of_one):
    """Every device's part of an array under each sharding equals the
    shard JAX's device_put gives it; the specs equal JAX's."""
    jmesh = JM.make_mesh(*shape)
    tmesh = M.make_mesh(1, 1)
    rng = np.random.default_rng(3)
    cases = [
        (JM.pattern_sharding(jmesh, 2), M.pattern_sharding(tmesh, 2),
         rng.random((3, 4, 16))),
        (JM.pattern_sharding(jmesh, 0), M.pattern_sharding(tmesh, 0),
         rng.random(16)),
        (JM.chain_sharding(jmesh), M.chain_sharding(tmesh),
         rng.random((8, 3))),
        (JM.replicated(jmesh), M.replicated(tmesh), rng.random((5, 4))),
    ]
    positions = {d.id: np.argwhere(jmesh.devices == d)[0]
                 for d in jmesh.devices.flat}
    for jsh, tsh, arr in cases:
        assert tuple(jsh.spec) == tsh.spec
        for shard in jax.device_put(arr, jsh).addressable_shards:
            idx = M.shard_slices(tsh.spec, arr.shape, shape,
                                 positions[shard.device.id])
            np.testing.assert_array_equal(np.asarray(shard.data), arr[idx])
    # both axes at once, chains first (sharded_pattern_loglik's layout)
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = (None, None, (M.CHAINS_AXIS, M.PATTERNS_AXIS))
    arr = rng.random((2, 4, 16))
    for shard in jax.device_put(arr, NamedSharding(
            jmesh, P(*spec))).addressable_shards:
        idx = M.shard_slices(spec, arr.shape, shape,
                             positions[shard.device.id])
        np.testing.assert_array_equal(np.asarray(shard.data), arr[idx])


def test_shard_patterns_raises_where_jax_device_put_does(world_of_one):
    jmesh = JM.make_mesh(1, 8)
    with pytest.raises(ValueError):
        jax.device_put(np.ones((3, 4, 12)), JM.pattern_sharding(jmesh, 2))
    with pytest.raises(ValueError, match="does not divide axis 2"):
        M.shard_slices((None, None, M.PATTERNS_AXIS), (3, 4, 12), (1, 8),
                       (0, 0))
    tips = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(M.shard_patterns(M.make_mesh(), tips, 2), tips)


@pytest.mark.parametrize("n", [2, 4, 5, 8])
def test_swap_permutation_matches_jax_given_its_draws(n):
    rng = np.random.default_rng(n)
    temps = jnp.asarray(1.0 / (1.0 + 0.3 * np.arange(n)))
    swapped = 0
    for seed in range(40):
        energies = jnp.asarray(rng.normal(-10.0, 3.0, n))
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        i = int(jax.random.randint(k1, (), 0, n))
        j_raw = int(jax.random.randint(k2, (), 0, n - 1))
        log_u = float(jnp.log(jax.random.uniform(jax.random.fold_in(key, 7))))
        want = np.asarray(JD.mc3_swap_across_hosts(key, energies, temps))
        got = D.swap_permutation(torch.tensor(np.asarray(energies)),
                                 torch.tensor(np.asarray(temps)), i,
                                 j_raw, log_u)
        np.testing.assert_array_equal(got.numpy(), want)
        swapped += bool((want != np.arange(n)).any())
    assert 0 < swapped < 40  # both outcomes were exercised


def test_mc3_swap_across_hosts_follows_its_draws():
    g = torch.Generator().manual_seed(5)
    energies = torch.tensor([-10.0, -12.0, -9.0, -20.0], dtype=torch.float64)
    temps = torch.tensor([1.0, 0.8, 0.6, 0.4], dtype=torch.float64)
    perm = D.mc3_swap_across_hosts(g, energies, temps)
    g = torch.Generator().manual_seed(5)
    i = int(torch.randint(0, 4, (), generator=g))
    j_raw = int(torch.randint(0, 3, (), generator=g))
    u = float(torch.rand((), generator=g, dtype=torch.float64))
    assert torch.equal(perm, D.swap_permutation(energies, temps, i, j_raw,
                                                np.log(u)))


def test_world_of_one_sharded_loglik_matches_jax(world_of_one):
    shape = (8, 2, 64)
    site_fn, x = likelihood_site_fn(likelihood_inputs(*shape, 0), "cpu")
    got = D.sharded_pattern_loglik(M.make_mesh(), site_fn)(x["tips"],
                                                           x["weights"])
    assert got.dim() == 0 and got.dtype == torch.float64
    unsharded, sharded = jax_totals(*shape, 0)
    np.testing.assert_allclose(float(got), unsharded, rtol=LIK_REL_TOL)
    np.testing.assert_allclose(float(got), sharded, rtol=LIK_REL_TOL)
    # a chain batch gives [B]
    batch = D.sharded_pattern_loglik(M.make_mesh(), lambda tp: torch.stack(
        [site_fn(tp), 2 * site_fn(tp)]))(x["tips"], x["weights"])
    np.testing.assert_allclose(batch.numpy(), [float(got), 2 * float(got)],
                               rtol=1e-15)


def test_chain_sharded_swap_and_runner_on_a_1x1_mesh(world_of_one):
    """With one chain shard the sharded swap is swap_states, and MC3 over
    the mesh is MC3 without one, given the same streams."""
    mesh = M.make_mesh()
    states = _batch(4, 6, 3, "cpu")
    temps = torch.tensor([1.0, 0.5, 0.3, 0.2], dtype=torch.float64)
    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    plain, sharded = states, states
    for _ in range(12):
        plain, acc_p = swap_states(plain, temps, a)
        sharded, acc_s = D.swap_across_chain_shards(mesh, sharded, temps, b)
        assert bool(acc_p) == bool(acc_s)
        assert torch.equal(plain.log_posterior, sharded.log_posterior)
        assert torch.equal(plain.tree.parent, sharded.tree.parent)
        assert torch.equal(plain.params["v"], sharded.params["v"])

    log_post, ops, p0, t0, aux = build_analysis(8, 64, device="cpu")
    p0 = {k: v for k, v in p0.items() if k not in aux["derived"]}
    outs = []
    for m in (None, mesh):
        run, _ = make_mc3_runner(aux["log_post_chains"], ops, 4,
                                 swap_every=3, delta=0.5, mesh=m)
        st = init_mcmc_state(p0, t0, torch.Generator().manual_seed(1), ops,
                             log_post)
        st = replicate_state(st, 4, torch.Generator().manual_seed(2))
        outs.append(run(st, torch.Generator().manual_seed(3), 4))
    (s0, o0), (s1, o1) = outs
    assert torch.equal(o0["swap_accepted"], o1["swap_accepted"])
    assert torch.equal(s0.log_posterior, s1.log_posterior)
    assert torch.equal(s0.tree.heights, s1.tree.heights)


def test_initialize_refuses_what_it_cannot_do(tmp_path):
    url = f"file://{tmp_path / 'rendezvous'}"
    with pytest.raises(ValueError, match="local_device_count=2"):
        D.initialize(url, 1, 0, local_device_count=2, device="cpu")
    with pytest.raises(ValueError, match="nccl.*takes CUDA ranks"):
        D.initialize(url, 1, 0, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.initialize(url, 1, 0)
    with pytest.raises(RuntimeError, match="initialize"):
        D.local_device()
    # two ranks posting one GPU: every rank raises, naming gloo
    import torch.distributed as dist

    store = dist.HashStore()
    store.set("beast_mcmc_device/1", "host/GPU-0")
    with pytest.raises(ValueError, match="backend='gloo'"):
        D._check_one_rank_a_gpu(store, 0, 2, "host/GPU-0")
    store = dist.HashStore()
    store.set("beast_mcmc_device/1", "host/GPU-1")
    D._check_one_rank_a_gpu(store, 0, 2, "host/GPU-0")

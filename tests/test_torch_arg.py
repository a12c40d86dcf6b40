"""The ancestral recombination graph (queue item 4h-4's models/arg.py)
against the JAX package, and chip_smoke.py's phase 21 rehearsed on the
CPU.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - arg_from_tree, effective_parent and convert.arg_from_numpy against
    JAX's;
  - arg_partition_site_loglik, both partitions, by the plain peel (the
    CPU's route) and by the level route the kernels take on the card
    (levels=True: the level schedule of `schedule_from_levels` with the
    dummy tips and the inactive slots in the deepest level, through its
    plain version), against JAX's per site at 1e-12 relative: on
    tests/test_arg.py's tree without reassortment and its hand-built
    one-event ARG, and on random ARGs of 5 and 12 events on dated trees
    (chip_smoke.py::arg_with_reassortments); arg_loglikelihood's total;
    under autograd_peel the plain peel on tips that report themselves as
    CUDA tensors;
  - arg_coalescent_loglik against JAX's on the same ARGs;
  - reassort_height_move and partition_flip_move at JAX's draws (its
    pick's rank and its uniforms injected), 40 keys each, the heights to
    1e-14 (JAX's jitted move fuses its arithmetic), and their rejection
    where there is no reassortment;
  - phase 21 of chip_smoke.py at 40 taxa: every path of `p21_paths`
    with its launches counted as the card counts them (one
    `_site_logliks` call of the S = 8 peel as peel_stream_ring, of the
    S = 4 one and each ARG level peel as peel_stream), the functions and
    the C7 report on the CPU against themselves.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.inference import tree_operators as jtops
from beast_mcmc_tpu.models import arg as jarg
from beast_mcmc_tpu.models.substitution import hky_eigen as jhky
from beast_mcmc_tpu.ops.eigen import transition_probs as jtp
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

import chip_smoke
from beast_mcmc_tpu_torch import convert
from beast_mcmc_tpu_torch.models import arg as targ
from beast_mcmc_tpu_torch.models import treelikelihood as ttl
from beast_mcmc_tpu_torch.models.substitution import hky_eigen as thky
from beast_mcmc_tpu_torch.ops import peeling
from beast_mcmc_tpu_torch.ops.eigen import transition_probs as ttp

from test_arg import _manual_one_event_arg
from test_torch_operators_ext import Queue
from test_torch_substitution_ext import _CudaLooking
from test_torch_tree_operators_ext import _rank_u

F64 = torch.float64
REL = 1e-12
FREQS = np.array([0.3, 0.25, 0.2, 0.25])
RATES = np.array([0.3, 0.8, 1.2, 1.7])
FIELDS = ("parent_left", "parent_right", "children", "heights", "side",
          "is_reassort", "active", "root")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JE = jhky(2.5, jnp.asarray(FREQS))
_TE = thky(2.5, torch.tensor(FREQS))
_CW = np.full(4, 0.25)


def _jtf(t):
    return jtp(_JE, t[:, None] * jnp.asarray(RATES)[None])


_jax_site_loglik = jax.jit(jarg.arg_partition_site_loglik,
                           static_argnums=(1, 3))
_jax_height_move = jax.jit(jarg.reassort_height_move)
_jax_flip_move = jax.jit(jarg.partition_flip_move)


def _ttf(t):
    return ttp(_TE, t[:, None] * torch.tensor(RATES)[None])


def _both(fields):
    """(JAX's ARGState, the port's) of numpy fields."""
    ja = jarg.ARGState(**{k: jnp.asarray(v, jnp.int32) if k in (
        "parent_left", "parent_right", "children", "root") else
        jnp.asarray(v) for k, v in fields.items()})
    return ja, convert.arg_from_numpy(jax.tree_util.tree_map(np.asarray, ja),
                                      F64, "cpu")


def _random_arg(seed, n=14, events=5, parts=2):
    rng = np.random.default_rng(seed)
    tree = simulate_coalescent_tree(rng, rng.uniform(0, 0.3, n), 1.0)
    return chip_smoke.arg_with_reassortments(*tree, events, parts, rng), rng


def _args():
    """(label, JAX ARG, port ARG, tips numpy) of every case."""
    out = []
    rng = np.random.default_rng(0)
    tree = simulate_coalescent_tree(rng, np.zeros(7), 1.0)
    tips = (rng.random((7, 4, 12)) > 0.5) * 0.9 + 0.1
    out.append(("tree", *_both({k: np.asarray(getattr(
        jarg.arg_from_tree(*(jnp.asarray(x) for x in tree[:3]), tree[3], 2,
                           3), k)) for k in FIELDS}), tips))
    manual = jax.tree_util.tree_map(np.asarray, _manual_one_event_arg())
    out.append(("manual", *_both({k: getattr(manual, k) for k in FIELDS}),
                (rng.random((3, 4, 16)) > 0.5) * 0.9 + 0.1))
    for seed, events in ((1, 5), (2, 12)):
        fields, rng2 = _random_arg(seed, events=events)
        out.append((f"random {events}", *_both(fields),
                    (rng2.random((14, 4, 21)) > 0.4) * 0.9 + 0.1))
    return out


CASES = _args()


def test_arg_state_and_routing_match_jax():
    rng = np.random.default_rng(4)
    tree = simulate_coalescent_tree(rng, np.zeros(6), 1.0)
    ja = jarg.arg_from_tree(*(jnp.asarray(x) for x in tree[:3]), tree[3], 2,
                            3)
    ta = targ.arg_from_tree(*(torch.tensor(x) for x in tree[:3]), tree[3],
                            2, 3)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ta, f)),
                                      np.asarray(getattr(ja, f)))
    assert ta.capacity == ja.capacity
    for _, ja, ta, _ in CASES:
        for p in range(2):
            np.testing.assert_array_equal(
                targ.effective_parent(ta, p).numpy(),
                np.asarray(jarg.effective_parent(ja, p)))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_partition_site_logliks_match_jax(case):
    """Both partitions by the plain peel and by the level route, against
    JAX's per site; the total over partitions."""
    _, ja, ta, tips = next(c for c in CASES if c[0] == case)
    sites = []
    for p in range(2):
        want = np.asarray(_jax_site_loglik(
            ja, p, jnp.asarray(tips), _jtf, jnp.asarray(FREQS),
            jnp.asarray(_CW)))
        for levels in (False, True):
            got = targ.arg_partition_site_loglik(
                ta, p, torch.tensor(tips), _ttf, torch.tensor(FREQS),
                torch.tensor(_CW), levels=levels).numpy()
            scale = np.maximum(np.abs(want), 1.0)
            assert np.abs(got - want).max() / scale.max() <= REL, (
                p, levels, np.abs(got - want).max())
        sites.append(want)
    w = np.arange(1.0, tips.shape[-1] + 1)
    got = targ.arg_loglikelihood(ta, [torch.tensor(tips)] * 2,
                                 [torch.tensor(w)] * 2, _ttf,
                                 torch.tensor(FREQS), torch.tensor(_CW))
    np.testing.assert_allclose(float(got), float(w @ sites[0] + w @ sites[1]),
                               rtol=REL)


def test_autograd_peel_takes_the_plain_peel_for_cuda_tensors(monkeypatch):
    """Under autograd_peel a CUDA-looking tensor's partition takes the
    plain peel (the kernel entries replaced by failing recorders)."""
    _, ja, ta, tips = CASES[2]

    def fail(*a, **k):
        raise AssertionError("a kernel entry reached")

    monkeypatch.setattr(targ, "peel_site_loglik_auto", fail)
    monkeypatch.setattr(targ, "peel_site_loglik_deep", fail)
    want = targ.arg_partition_site_loglik(ta, 0, torch.tensor(tips), _ttf,
                                          torch.tensor(FREQS),
                                          torch.tensor(_CW), levels=False)
    with peeling.autograd_peel():
        got = targ.arg_partition_site_loglik(
            ta, 0, torch.tensor(tips).as_subclass(_CudaLooking), _ttf,
            torch.tensor(FREQS), torch.tensor(_CW))
    np.testing.assert_allclose(got.as_subclass(torch.Tensor).numpy(),
                               want.numpy(), rtol=REL)
    with pytest.raises(AssertionError, match="kernel entry"):
        targ.arg_partition_site_loglik(
            ta, 0, torch.tensor(tips).as_subclass(_CudaLooking), _ttf,
            torch.tensor(FREQS), torch.tensor(_CW))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_arg_coalescent_matches_jax(case):
    _, ja, ta, tips = next(c for c in CASES if c[0] == case)
    n = tips.shape[0]
    for pop, rho in ((1.7, 0.0), (2.0, 0.8), (0.6, 3.0)):
        want = float(jarg.arg_coalescent_loglik(ja, n, pop, rho))
        got = float(targ.arg_coalescent_loglik(ta, n, pop, rho))
        if np.isfinite(want):
            np.testing.assert_allclose(got, want, rtol=REL)
        else:
            assert got == want


@pytest.mark.parametrize("move", ["height", "flip"])
def test_moves_at_jax_draws(monkeypatch, move):
    """40 keys on the 12-event ARG: JAX's move against the port's with
    JAX's pick (the uniform at its rank) and uniform or partition
    injected; no reassortment rejects."""
    _, ja, ta, _ = CASES[3]
    queue = Queue(monkeypatch)
    mask = ja.active & ja.is_reassort
    for i in range(40):
        key = jax.random.PRNGKey(i)
        k1, k2 = jax.random.split(key)
        node, count = jtops.sample_masked(k1, mask)
        pick = float(_rank_u(mask, node, count))
        if move == "height":
            jnew, jlh = _jax_height_move(ja, key, 0.2)
            queue.items = [pick, float(jax.random.uniform(k2,
                                                          dtype=jnp.float64))]
            tnew, tlh = targ.reassort_height_move(ta, None, 0.2)
        else:
            jnew, jlh = _jax_flip_move(ja, key)
            queue.items = [pick, int(jax.random.randint(k2, (), 0, 2))]
            tnew, tlh = targ.partition_flip_move(ta, None)
        assert queue.items == []
        for f in FIELDS:
            np.testing.assert_allclose(
                np.asarray(getattr(tnew, f), float),
                np.asarray(getattr(jnew, f), float), rtol=1e-14)
        assert float(tlh) == float(jlh)
    ta0 = CASES[0][2]  # no reassortment
    queue.items = [0.5, 0.5]
    assert float(targ.reassort_height_move(ta0, None, 0.1)[1]) == -np.inf
    queue.items = [0.5, 1]
    assert float(targ.partition_flip_move(ta0, None)[1]) == -np.inf


def test_phase21_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's phase 21 on the CPU at 40 taxa x 400 sites (21c at
    300 tips, 21d at small sizes): every path runs and checks itself, the
    launches counted where the card counts them."""
    counts = {k: 0 for k in chip_smoke.KERNELS}
    real_site = ttl._site_logliks

    def site(*a):
        counts["peel_stream_ring" if a[5].shape[-2] == 8
               else "peel_stream"] += 1
        return real_site(*a)

    monkeypatch.setattr(ttl, "_site_logliks", site)
    for name in ("peel_site_loglik_deep", "peel_site_loglik_auto"):
        real = getattr(targ, name)

        def wrap(*a, _real=real, **k):
            counts["peel_stream"] += 1
            return _real(*a, **k)

        monkeypatch.setattr(targ, name, wrap)

    def reset():
        for k in counts:
            counts[k] = 0

    def device_ms(fn, label, n=1, top=6):
        t0 = time.perf_counter()
        fn()
        device_ms.events = 0
        return 1e3 * (time.perf_counter() - t0) / n, None

    for k, v in dict(P21_HOSTS=30, P21_ITEMS=60, P21_LOCATIONS=50,
                     P21_EVENTS=300, P21_POINTS=2000, P21_RASTER=8,
                     P21_ROWS=500).items():
        monkeypatch.setattr(chip_smoke, k, v)
    rec, launches = chip_smoke.p21_paths(
        str(tmp_path), reset, lambda: dict(counts), device_ms, "cpu",
        n_taxa=40, n_sites=400, steps=10, arg_events=4, arg_steps=6,
        thorney_tips=300, thorney_steps=10, emp_trees=8, emp_steps=6,
        c7=(12, 200))
    assert launches["P21 21a chain"]["peel_stream_ring"] == 10
    assert launches["P21 21b chain"]["peel_stream"] == 12
    assert launches["P21 21c empirical"]["peel_stream"] == 6
    assert not any(launches["P21 21c thorney"].values())
    assert rec["21a"]["kernel_max_rel_err"] <= 1e-10
    assert rec["21b"]["kernel_max_rel_err"] <= 1e-10
    assert rec["21d"]["functions"] >= 20
    assert rec["C7"]["values"] == 6 and len(rec["C7"]["hessian"]) == 6

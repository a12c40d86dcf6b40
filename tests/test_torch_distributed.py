"""The port's parallel/ layer across processes: real gloo ranks on the CPU.

Each test starts a world of worker processes, `python -m
beast_mcmc_tpu_torch.parallel`, by chip_smoke.py's launcher, as the GPU
smoke run does: a file:// rendezvous under tmp_path (no port to collide
between test workers), each process within a timeout and killed in a
`finally`.
  - 2 ranks, the counterpart of tests/test_distributed.py: the
    pattern-sharded likelihood and the cross-rank swap permutation;
  - 4 ranks on a 2 x 2 mesh, the counterpart of
    tests/test_parallel_alloppnet.py:18-52 and of tests/test_mc3.py's
    chain-sharded swap: the sharded swap equals swap_states of the
    unsharded batch;
  - a dry run (the counterpart of __graft_entry__.py::dryrun_multichip)
    at 12 taxa and 64 patterns on 2 ranks, in both layouts, through
    chip_smoke.py's phase 22 (its rehearsal on CPU ranks).
Every sharded total is held against JAX's unsharded value and JAX's
sharded_pattern_loglik on the 8 virtual devices, both computed here, at
1e-10 relative, and every rank's total is equal bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import LIK_REL_TOL, jax_totals

import chip_smoke
from beast_mcmc_tpu_torch.inference.mc3 import mc3_temperatures, swap_states
from beast_mcmc_tpu_torch.parallel.__main__ import SWAP_BAND, _batch
from beast_mcmc_tpu_torch.parallel.distributed import swap_permutation

RANK_TIMEOUT = 240  # seconds a rank may take, start-up included
DRY_DELTA = 0.5  # the ladder for a 12-taxon logL scale (JAX's 0.002 is
# tuned to benchmark1's, __graft_entry__.py:90-94)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for; the ranks take one each too (OMP_NUM_THREADS)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def run_ranks(world, args, tmp_path):
    """Each rank's RESULT records of `world` gloo CPU ranks of the worker
    with `args` (chip_smoke.py's launcher); any rank failing fails the
    test."""
    return chip_smoke.finish_ranks(chip_smoke.start_ranks(
        args, tmp_path / "rendezvous", "cpu", world), RANK_TIMEOUT)


def check_likelihood(recs, shape):
    """Every rank's sharded total equal bit for bit, and equal to JAX's
    unsharded and sharded totals within LIK_REL_TOL."""
    unsharded, sharded = jax_totals(*shape, 0)
    totals = {r["total"] for r in recs}
    assert len(totals) == 1, totals
    for r in recs:
        assert r["shape"] == list(shape)
        np.testing.assert_allclose(r["total"], unsharded, rtol=LIK_REL_TOL)
        np.testing.assert_allclose(r["total"], sharded, rtol=LIK_REL_TOL)
        np.testing.assert_allclose(r["unsharded"], unsharded,
                                   rtol=LIK_REL_TOL)
        assert r["kernel_vs_plain"] <= 1e-10


def check_swaps(recs, n_chains, rounds, seed):
    """The ranks' chain-sharded swaps equal swap_states of the unsharded
    batch with the same draws, run here; every rank's cross-host
    permutation is the one its draws give."""
    full = _batch(n_chains, 6, seed, "cpu")
    temps = mc3_temperatures(n_chains, 1.0)
    g = torch.Generator().manual_seed(seed + 1)
    accepted = []
    for _ in range(rounds):
        full, acc = swap_states(full, temps, g)
        accepted.append(bool(acc))
    assert 0 < sum(accepted) < rounds  # both outcomes were exercised
    g = torch.Generator().manual_seed(42)
    i = int(torch.randint(0, 4, (), generator=g))
    j_raw = int(torch.randint(0, 3, (), generator=g))
    u = float(torch.rand((), generator=g, dtype=torch.float64))
    perm = swap_permutation(
        torch.tensor([-10.0, -12.0, -9.0, -20.0], dtype=torch.float64),
        torch.tensor([1.0, 0.8, 0.6, 0.4], dtype=torch.float64), i, j_raw,
        np.log(u)).tolist()
    for r in recs:
        assert r["equal_to_unsharded"] and r["accepted"] == accepted
        lo, hi = r["slots"]
        assert r["log_posterior"] == full.log_posterior[lo:hi].tolist()
        assert r["hosts_permutation"] == perm


def test_two_ranks_pattern_sharded_loglik_and_swaps(tmp_path):
    res = run_ranks(2, ["likelihood", "--taxa", "8", "--categories", "2",
                        "--patterns", "64", "--mesh", "1x2",
                        "swap", "--chains", "4", "--mesh", "2x1",
                        "--rounds", "30"], tmp_path)
    lik, swaps = zip(*res)
    assert [r["shard_patterns"] for r in lik] == [32, 32]
    check_likelihood(lik, (8, 2, 64))
    check_swaps(swaps, 4, 30, 0)


def test_four_ranks_on_a_2x2_mesh(tmp_path):
    """Patterns split over all four ranks (JAX's P(None, None, (chains,
    patterns))), and 4 chains over 2 chain shards, each held by a pair of
    pattern shards."""
    res = run_ranks(4, ["likelihood", "--taxa", "8", "--categories", "2",
                        "--patterns", "64", "--mesh", "2x2",
                        "swap", "--chains", "4", "--mesh", "2x2",
                        "--rounds", "30"], tmp_path)
    lik, swaps = zip(*res)
    assert [r["shard_patterns"] for r in lik] == [16] * 4
    check_likelihood(lik, (8, 2, 64))
    check_swaps(swaps, 4, 30, 0)
    assert [r["slots"] for r in swaps] == [[0, 2], [0, 2], [2, 4], [2, 4]]


def test_dry_run_at_small_width_in_both_layouts(tmp_path):
    """chip_smoke.py's phase 22 (`parallel_path`) on two CPU ranks at small
    width: 22a at 8 taxa, the dry run at 12 taxa and 64 patterns in both
    layouts, 22c in a world of one gloo rank here; every check of the
    phase holds (the ranks check their own: posterior evaluations, the
    swap band, the deviation)."""
    rec, launches = chip_smoke.parallel_path(
        lambda: None, lambda: {k: 0 for k in chip_smoke.KERNELS}, "cpu",
        str(tmp_path), lik=(8, 2, 64), dry=(12, 64), delta=DRY_DELTA)
    assert rec["22a"]["shard_patterns"] == [32, 32]
    assert rec["22c"]["equal_to_unsharded"]
    chains, patterns = (rec["22b"][m] for m in ("2x1", "1x2"))
    for r in (chains, patterns):
        assert all(SWAP_BAND[0] <= a <= SWAP_BAND[1]
                   for a in r["swap_acceptance"])
        assert max(r["full_evaluation_deviation"]) < 0.1
    # 2 x 1: two slots a rank, every pattern; the ranks' chains differ,
    # their swaps agree
    assert chains["slots"] == [[0, 2], [2, 4]]
    assert chains["patterns_local"] == [64, 64]
    assert chains["state_digest"][0] != chains["state_digest"][1]
    assert chains["swaps_accepted"][0] == chains["swaps_accepted"][1]
    # 1 x 2: all four chains on each rank, half the patterns, equal states
    assert patterns["slots"] == [[0, 4], [0, 4]]
    assert patterns["patterns_local"] == [32, 32]
    assert patterns["state_digest"][0] == patterns["state_digest"][1]
    assert set(launches) >= {"P22 22a rank 0", "P22 22b 1x2 rank 1"}

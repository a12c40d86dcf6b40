"""One rank of the multi-process layer, for tests and the GPU smoke run.

    python -m beast_mcmc_tpu_torch.parallel --init URL --world N --rank R \\
        [--backend gloo|nccl] [--device cuda:0|cpu] MODE [options] [MODE ...]

or, one rank a GPU, under torchrun (no --init: the launcher's environment,
env://):

    torchrun --standalone --nproc_per_node N -m beast_mcmc_tpu_torch.parallel \\
        MODE [options] ...

The modes run in the order given, in one world, and each prints one line
`RESULT {json}` a rank. A failed check raises, and the process exits
non-zero.

  likelihood  parallel/distributed.py::sharded_pattern_loglik of random
              inputs (`likelihood_inputs`) over a mesh: this rank's total,
              the unsharded total (within TOTAL_REL_TOL), its shard's peel
              per site against the node-by-node plain peel (within
              SITE_REL_TOL), the kernels' launches;
  swap        swap_across_chain_shards over a batch of random chains
              against inference/mc3.py::swap_states of the whole batch
              given the same draws (equal bit for bit), and the
              permutation of mc3_swap_across_hosts;
  dryrun      the counterpart of __graft_entry__.py::dryrun_multichip: a
              tempered ensemble of GTR+Gamma4 chains
              (apps/benchmarks.py::build_analysis, float64) on a
              (chains, patterns) mesh, the likelihood of this rank's
              pattern shard all-reduced over the patterns axis and the
              priors and coalescent added after it, once; make_mc3_runner
              over the mesh; the swap acceptance (inside SWAP_BAND), the
              launches a batch step, the cold chain's log posterior, the
              full-evaluation deviation (below FULL_EVAL_TOL) and the
              shard's peel per site against the node-by-node plain peel.

The worker imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np
import torch

SITE_REL_TOL = 1e-10  # per site, over max(|site logL|, 1)
TOTAL_REL_TOL = 1e-12  # the sharded total against the unsharded one
SWAP_BAND = (0.05, 0.95)  # __graft_entry__.py:118-123
FULL_EVAL_TOL = 0.1  # MarkovChain.java:55
# patterns a warp's slot of the deep kernel takes at 4 categories in
# float64 (ops/cuda_stream2.py::deep_plan): each pattern shard a multiple
PATTERN_MULTIPLE = 8
MODES = ("likelihood", "swap", "dryrun")
KERNELS = {"resident": "peel_resident", "deep": "peel_stream",
           "mxu": "peel_mxu", "stream": "peel_stream_ring"}


def likelihood_inputs(n_taxa: int, n_categories: int, n_patterns: int,
                      seed: int) -> dict:
    """Numpy inputs of one nucleotide peel, from `seed`: a coalescent tree,
    tips in [0.1, 1), row-stochastic branch matrices [2N-1, C, 4, 4],
    uniform frequencies and category weights, integer weights in [1, 4)."""
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    tips = rng.random((n_taxa, 4, n_patterns)) * 0.9 + 0.1
    pm = rng.random((2 * n_taxa - 1, n_categories, 4, 4)) * 0.2 + 0.01
    return {"parent": parent, "children": children, "heights": heights,
            "root": root, "tips": tips,
            "pm": pm / pm.sum(-1, keepdims=True),
            "freqs": np.full(4, 0.25),
            "cat_w": np.full(n_categories, 1.0 / n_categories),
            "weights": rng.integers(1, 4, n_patterns).astype(np.float64)}


def likelihood_site_fn(x: dict, dev):
    """(site_fn, x on `dev`) of `likelihood_inputs`' arrays x: site_fn(tips)
    is the per-site peel of those tips [N, 4, P'] on x's tree, through the
    route ops/cuda_peeling.py::peel_site_loglik_auto picks (the route's
    kernel on a CUDA device, its plain version on the CPU)."""
    from beast_mcmc_tpu_torch.ops.cuda_peeling import peel_site_loglik_auto
    from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule

    x = {k: torch.as_tensor(v, device=dev) for k, v in x.items()}
    children, root = x["children"].long(), x["root"].long()
    schedule = level_schedule(children, x["tips"].shape[0],
                              x["parent"].long())

    def site_fn(tips):
        return peel_site_loglik_auto(tips, children, None, root, x["pm"],
                                     x["freqs"], x["cat_w"], schedule)

    return site_fn, x


def _counters():
    from beast_mcmc_tpu_torch.ops import (
        cuda_mxu, cuda_peeling, cuda_stream, cuda_stream2)

    return {"peel_resident": cuda_peeling, "peel_stream": cuda_stream2,
            "peel_stream_ring": cuda_stream, "peel_mxu": cuda_mxu}


def _reset():
    for mod in _counters().values():
        mod.launches = 0


def _read():
    return {k: mod.launches for k, mod in _counters().items()}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"rank check failed: {what}")


def _mesh_arg(text: str):
    a, b = text.lower().split("x")
    return int(a), int(b)


def likelihood(args, dev):
    """The `likelihood` mode (see the module docstring)."""
    from beast_mcmc_tpu_torch.ops.peeling import (
        peel_order_from_heights, peel_site_loglik)
    from beast_mcmc_tpu_torch.parallel.distributed import (
        process_index, sharded_pattern_loglik)
    from beast_mcmc_tpu_torch.parallel.mesh import make_mesh
    from beast_mcmc_tpu_torch.utils.accum import stable_dot

    t0 = time.perf_counter()
    mesh = make_mesh(*args.mesh)
    peel, x = likelihood_site_fn(likelihood_inputs(
        args.taxa, args.categories, args.patterns, args.seed), dev)
    n = args.taxa
    parent, children, root = (x[k].long() for k in ("parent", "children",
                                                    "root"))
    calls = []

    def site_fn(tips):
        calls.append((tips, peel(tips)))
        return calls[-1][1]

    _reset()
    total = float(sharded_pattern_loglik(mesh, site_fn)(x["tips"],
                                                        x["weights"]))
    shard_tips, shard_site = calls[0]
    unsharded = float(stable_dot(x["weights"], site_fn(x["tips"])))
    launches = _read()
    # the shard's launch against the node-by-node plain peel, per site
    plain = peel_site_loglik(
        shard_tips, children, peel_order_from_heights(x["heights"], n,
                                                      parent),
        root, x["pm"], x["freqs"], x["cat_w"])
    rec = {"mode": "likelihood", "rank": process_index(),
           "mesh": list(mesh.shape), "device": str(dev),
           "shape": [n, args.categories, args.patterns],
           "shard_patterns": shard_tips.shape[-1],
           "total": total, "unsharded": unsharded,
           "rel_err_vs_unsharded": abs(total - unsharded) / abs(unsharded),
           "kernel_vs_plain": float(((shard_site - plain).abs()
                                     / plain.abs().clamp_min(1.0)).max()),
           "launches": launches, "seconds": time.perf_counter() - t0}
    _check(rec["kernel_vs_plain"] <= SITE_REL_TOL,
           f"shard peel vs plain {rec['kernel_vs_plain']}")
    _check(rec["rel_err_vs_unsharded"] <= TOTAL_REL_TOL,
           f"sharded total {total!r} vs unsharded {unsharded!r}")
    return rec


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _batch(n_chains: int, n_taxa: int, seed: int, dev):
    """A batch of n_chains states of random trees, parameters and log
    posteriors (no posterior is evaluated), from `seed`."""
    from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
    from beast_mcmc_tpu_torch.inference.mcmc import init_mcmc_state
    from beast_mcmc_tpu_torch.tree.topology import (
        make_tree_state, simulate_coalescent_tree)

    rng = np.random.default_rng(seed)
    trees = [make_tree_state(*simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0), dtype=torch.float64, device=dev)
        for _ in range(n_chains)]
    state = init_mcmc_state({"x": torch.zeros((), dtype=torch.float64,
                                              device=dev)},
                            trees[0], torch.Generator(device=dev), [])
    states = replicate_state(state, n_chains, torch.Generator(device=dev))
    tree = states.tree.replace(**{
        f: torch.stack([getattr(t, f) for t in trees])
        for f in ("parent", "children", "heights", "root")})
    return states.replace(
        params={"x": torch.as_tensor(rng.normal(size=n_chains), device=dev),
                "v": torch.as_tensor(rng.normal(size=(n_chains, 3)),
                                     device=dev)},
        tree=tree, log_posterior=torch.as_tensor(
            -rng.gamma(2.0, 2.0, n_chains), device=dev))


def swap(args, dev):
    """The `swap` mode (see the module docstring)."""
    from beast_mcmc_tpu_torch.inference.mc3 import (
        mc3_temperatures, swap_states)
    from beast_mcmc_tpu_torch.inference.mcmc import map_tensors
    from beast_mcmc_tpu_torch.parallel.distributed import (
        mc3_swap_across_hosts, process_index, swap_across_chain_shards)
    from beast_mcmc_tpu_torch.parallel.mesh import (
        CHAINS_AXIS, axis_size, make_mesh)

    t0 = time.perf_counter()
    mesh = make_mesh(*args.mesh)
    n = args.chains
    k = n // axis_size(mesh, CHAINS_AXIS)
    lo = mesh.get_local_rank(CHAINS_AXIS) * k
    full = _batch(n, 6, args.seed, dev)
    local = full.replace(
        params=map_tensors(lambda t: t[lo:lo + k], full.params),
        tree=map_tensors(lambda t: t[lo:lo + k], full.tree),
        log_posterior=full.log_posterior[lo:lo + k])
    temps = mc3_temperatures(n, 1.0, device=dev)
    g_full = torch.Generator().manual_seed(args.seed + 1)
    g_local = torch.Generator().manual_seed(args.seed + 1)
    accepted, equal = [], True
    for _ in range(args.rounds):
        full, acc_full = swap_states(full, temps, g_full)
        local, acc = swap_across_chain_shards(mesh, local, temps, g_local)
        accepted.append(bool(acc))
        want = [full.log_posterior[lo:lo + k], full.tree.heights[lo:lo + k],
                full.tree.parent[lo:lo + k], full.params["v"][lo:lo + k]]
        got = [local.log_posterior, local.tree.heights, local.tree.parent,
               local.params["v"]]
        equal &= bool(acc) == bool(acc_full) and all(
            torch.equal(a, b) for a, b in zip(got, want))
    perm = mc3_swap_across_hosts(
        torch.Generator().manual_seed(42),
        torch.tensor([-10.0, -12.0, -9.0, -20.0], dtype=torch.float64),
        torch.tensor([1.0, 0.8, 0.6, 0.4], dtype=torch.float64))
    rec = {"mode": "swap", "rank": process_index(), "mesh": list(mesh.shape),
           "device": str(dev), "slots": [lo, lo + k], "accepted": accepted,
           "equal_to_unsharded": equal,
           "log_posterior": local.log_posterior.tolist(),
           "hosts_permutation": perm.tolist(),
           "seconds": time.perf_counter() - t0}
    _check(equal, "the chain-sharded swap differs from swap_states")
    return rec


def dryrun(args, dev):
    """The `dryrun` mode (see the module docstring)."""
    from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
    from beast_mcmc_tpu_torch.inference.mc3 import (
        chain_state, make_mc3_runner, replicate_state)
    from beast_mcmc_tpu_torch.inference.mcmc import init_mcmc_state
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik)
    from beast_mcmc_tpu_torch.models.priors import (
        lognormal_logpdf, one_on_x_logpdf)
    from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates
    from beast_mcmc_tpu_torch.models.substitution import gtr_eigen
    from beast_mcmc_tpu_torch.models.treelikelihood import (
        branch_transition_matrices, tree_loglikelihood, tree_site_logliks)
    from beast_mcmc_tpu_torch.ops.cuda_peeling import peel_route
    from beast_mcmc_tpu_torch.ops.peeling import (
        peel_order_from_heights, peel_site_loglik)
    from beast_mcmc_tpu_torch.parallel.distributed import (
        process_index, psum)
    from beast_mcmc_tpu_torch.parallel.mesh import (
        CHAINS_AXIS, PATTERNS_AXIS, axis_size, make_mesh, shard_patterns)

    t0 = time.perf_counter()
    mesh = make_mesh(*args.mesh)
    shards = axis_size(mesh, CHAINS_AXIS)
    n_chains = max(args.chains, 2 * shards)
    n_taxa = args.taxa
    f64 = torch.float64
    _, operators, params0, tree0, aux = build_analysis(
        n_taxa, args.patterns, "gtr_gamma", args.seed, f64,
        pad_multiple=PATTERN_MULTIPLE * axis_size(mesh, PATTERNS_AXIS),
        device=dev)
    # no derived cache under MC3, as in JAX: the model parameters only
    params0 = {k: v for k, v in params0.items() if k not in aux["derived"]}
    tips = shard_patterns(mesh, aux["tips"], 2)
    weights = shard_patterns(mesh, aux["weights"], 0)
    freqs = aux["freqs"]
    evaluations = [0]

    def sharded_log_post(params, tree):
        """JAX's sharded_log_post (__graft_entry__.py:72-88) over this
        rank's pattern shard, for one chain or a chain batch: the
        likelihood all-reduced over the patterns axis, then the priors and
        the coalescent added once."""
        evaluations[0] += 1
        chains = tree.parent.dim() == 2
        eig = gtr_eigen(params["gtr.rates"], freqs)
        rates, cat_w = discrete_gamma_rates(params["alpha"], 4, dtype=f64)
        ll = tree_loglikelihood(tips, weights, tree.parent, tree.children,
                                tree.heights, tree.root, eig, freqs, rates,
                                cat_w, params["clock.rate"])
        return (psum(mesh, ll, (PATTERNS_AXIS,))
                + one_on_x_logpdf(params["pop.size"], chains)
                + lognormal_logpdf(params["clock.rate"], 0.0, 1.0, chains)
                + constant_coalescent_loglik(tree.heights, n_taxa,
                                             params["pop.size"]))

    run, temps = make_mc3_runner(sharded_log_post, operators, n_chains,
                                 swap_every=args.swap_every,
                                 delta=args.delta, mesh=mesh)
    c = mesh.get_local_rank(CHAINS_AXIS)
    _reset()
    state = init_mcmc_state(params0, tree0, torch.Generator(
        device=dev).manual_seed(args.seed), operators, sharded_log_post)
    # each chain shard its own streams; pattern shards of one chain shard
    # alike, so that their states stay equal
    states = replicate_state(state, n_chains // shards, torch.Generator(
        device=dev).manual_seed(args.seed + 101 + c))
    t_run = time.perf_counter()
    states, out = run(states, torch.Generator().manual_seed(args.seed + 7),
                      args.rounds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t_run
    fresh = sharded_log_post(states.params, states.tree)
    # this rank's shard through the kernel against the node-by-node plain
    # peel, per site, on the first slot's tree
    p, tr = ({k: v[0] for k, v in states.params.items()},
             chain_state(states, 0).tree)
    eig = gtr_eigen(p["gtr.rates"], freqs)
    rates, cat_w = discrete_gamma_rates(p["alpha"], 4, dtype=f64)
    kernel = tree_site_logliks(tips, tr.parent, tr.children, tr.heights,
                               tr.root, eig, freqs, rates, cat_w,
                               p["clock.rate"])
    launches = _read()
    plain = peel_site_loglik(
        tips, tr.children, peel_order_from_heights(tr.heights, n_taxa,
                                                   tr.parent),
        tr.root, branch_transition_matrices(eig, tr.parent, tr.heights,
                                            p["clock.rate"], rates),
        freqs, cat_w)
    steps = args.rounds * args.swap_every
    # the start, a batch step each, the full evaluation; the shard check
    expected = 1 + steps + 1
    kname = KERNELS[peel_route(2 * n_taxa - 1, 4, 4, 8)]
    swaps = out["swap_accepted"].tolist()
    lp = states.log_posterior
    tr = states.tree
    rec = {"mode": "dryrun", "rank": process_index(),
           "mesh": list(mesh.shape), "device": str(dev), "taxa": n_taxa,
           "patterns_local": tips.shape[-1], "chains": n_chains,
           "slots": [c * lp.shape[0], (c + 1) * lp.shape[0]],
           "temperatures": temps.tolist(), "steps": steps,
           "swaps_accepted": swaps,
           "swap_acceptance": sum(swaps) / len(swaps),
           "evaluations": evaluations[0], "expected_evaluations": expected,
           "kernel": kname, "launches": launches,
           "launches_per_batch_step": ((launches[kname] - 3) / steps
                                       if dev.type == "cuda" else None),
           "log_posterior": lp.tolist(),
           "cold_log_posterior": lp[0].item() if c == 0 else None,
           "full_evaluation_deviation": float((fresh - lp).abs().max()),
           "kernel_vs_plain": float(((kernel - plain).abs()
                                     / plain.abs().clamp_min(1.0)).max()),
           "state_digest": _digest(lp, tr.heights, tr.parent,
                                   *(states.params[k] for k in
                                     sorted(states.params))),
           "aggregate_states_per_s": lp.shape[0] * steps / run_s,
           "seconds": time.perf_counter() - t0}
    lo, hi = SWAP_BAND
    _check(lo <= rec["swap_acceptance"] <= hi,
           f"swap acceptance {rec['swap_acceptance']} outside {SWAP_BAND}")
    _check(rec["kernel_vs_plain"] <= SITE_REL_TOL,
           f"shard peel vs plain {rec['kernel_vs_plain']}")
    _check(rec["full_evaluation_deviation"] < FULL_EVAL_TOL,
           f"full-evaluation deviation {rec['full_evaluation_deviation']}")
    _check(bool(torch.isfinite(lp).all()), f"log posterior {lp.tolist()}")
    _check(evaluations[0] == expected,
           f"{evaluations[0]} posterior evaluations, expected {expected}")
    if dev.type == "cuda":
        _check(launches == {**{k: 0 for k in launches}, kname: expected + 1},
               f"launches {launches}, expected {expected + 1} of {kname}")
    return rec


def _parsers():
    common = argparse.ArgumentParser(
        prog="python -m beast_mcmc_tpu_torch.parallel",
        description="One rank of the multi-process layer (see the module "
                    "docstring).")
    common.add_argument("--init", help="rendezvous: host:port, tcp://... or "
                        "file://... (default: torchrun's environment)")
    common.add_argument("--world", type=int, help="number of ranks")
    common.add_argument("--rank", type=int, help="this process's rank")
    common.add_argument("--backend", choices=("gloo", "nccl"))
    common.add_argument("--device", help="this rank's device (default "
                        "cuda:<local rank>)")
    modes = {}
    p = modes["likelihood"] = argparse.ArgumentParser(prog="likelihood")
    p.add_argument("--taxa", type=int, default=8)
    p.add_argument("--categories", type=int, default=2)
    p.add_argument("--patterns", type=int, default=64)
    p.add_argument("--mesh", type=_mesh_arg, default=(1, 2))
    p.add_argument("--seed", type=int, default=0)
    p = modes["swap"] = argparse.ArgumentParser(prog="swap")
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--mesh", type=_mesh_arg, default=(2, 1))
    p.add_argument("--seed", type=int, default=0)
    p = modes["dryrun"] = argparse.ArgumentParser(prog="dryrun")
    p.add_argument("--taxa", type=int, default=1441)
    p.add_argument("--patterns", type=int, default=128)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--mesh", type=_mesh_arg, default=(2, 1))
    p.add_argument("--swap-every", type=int, default=12)
    p.add_argument("--delta", type=float, default=0.002)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    return common, modes


def main(argv=None) -> int:
    from beast_mcmc_tpu_torch.parallel import distributed

    argv = sys.argv[1:] if argv is None else list(argv)
    common, modes = _parsers()
    cuts = [i for i, a in enumerate(argv) if a in MODES] + [len(argv)]
    if len(cuts) == 1:
        common.error(f"give one or more modes of {MODES}")
    top = common.parse_args(argv[:cuts[0]])
    runs = [(argv[a], modes[argv[a]].parse_args(argv[a + 1:b]))
            for a, b in zip(cuts, cuts[1:])]
    dev = distributed.initialize(top.init, top.world, top.rank,
                                 backend=top.backend, device=top.device)
    try:
        for mode, args in runs:
            rec = {"likelihood": likelihood, "swap": swap,
                   "dryrun": dryrun}[mode](args, dev)
            print("RESULT " + json.dumps(rec), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

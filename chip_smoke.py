#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit: `python3 chip_smoke.py`. The peel kernels build into build/
at first use. Phases, each of which fails the run (non-zero exit, no
result line):

  1. build the four kernels (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and time both: the resident peel
     (S = 4, by levels) at the benchmark2 shape, on a caterpillar tree of
     62 taxa (61 levels of one node) and at a ragged pattern count, timed
     in turns with the deep peel on the benchmark2 inputs; the
     level-scheduled deep peel (S = 4) at the Makona shape, at the
     benchmark1 three-partition launch (K = 3), at the small forced shape,
     on a caterpillar tree and at a ragged pattern count; the v1 streaming
     peel at S = 4, 20 and 61, and the matrix-product peel (by levels) at the
     protein (S = 20) and codon (S = 61) shapes, a ragged small one and a
     caterpillar of 128 taxa, partials included, timed in turns with the v1
     streaming peel on the same inputs; hold the card's log posterior
     against the CPU's on a small analysis;
  3. the f64 GTR+Gamma4 chain at the benchmark2 shape (62 taxa, 5,565
     patterns) through the resident kernel, with the full-evaluation
     self-check (< 0.1);
  4. the same model at the Makona shape (1,610 taxa, 2,048 patterns)
     through the deep streaming kernel, with the same check;
  5. the f64 HKY x 3 codon-partition chain at the benchmark1 shape (1,441
     taxa, 3 x 593 patterns): one deep streaming launch a step for all
     three partitions, with the same check;
  6. the f64 LG+Gamma4 protein chain (`protein_analysis`: 128 taxa, 1,024
     patterns, 20 states) and the f64 GY94 codon chain (`codon_analysis`:
     64 taxa, 512 patterns, 61 states): one matrix-product launch a step,
     with the same check;
  6b. the gradients through each kernel route (ops/peeling.py's level
     adjoint over the kernel's forward with its partials) against the
     node-by-node plain peel's on the card, in f64, with each kernel's
     partials against its plain version's: the resident route at
     benchmark2, the deep one at Makona and at benchmark1's three
     partitions, the matrix-product one at the protein and codon shapes,
     the v1 streaming one on a benchmark1 partition; timed (the forward
     without and with the partials, and the backward);
  6c. the GTR+Gamma4 chain at the benchmark2 and Makona shapes with HMC on
     the node heights (NodeHeightHmcOperator) and on (clock.rate, pop.size)
     added to its operators: each HMC operator alone first (2 n_leapfrog + 1
     launches a proposal, wall and device time a proposal), then the mixed
     chain, with its launches, each HMC operator's acceptance and the same
     full-evaluation check;
  6d. the samplers, from the states the chains of phases 3 to 6 reached:
     P7a, the benchmark2 chain with NUTS on (clock.rate, pop.size), the
     slice sampler on pop.size and AVMVN on (gtr.rates, alpha) added (its
     statistics by make_mcmc_step's post_update); P7b, the benchmark1 chain
     with reflective HMC on the three kappas (lower bound 0) and MVN on
     (clock.rate, pop.size); P7c, the protein chain with Zig-Zag and BPS on
     (clock.rate, pop.size), their bounds from the gradients of a warm-up;
     P7d, NUTS alone at Makona. Each operator that evaluates the posterior
     in its proposal runs alone first, each step's launches held exactly to
     what it reports (NUTS n_lf + 1 and the chain's evaluation, reflective
     HMC 2 n_leapfrog + 1, a PDMP events + 1); then the mixed chain with the
     same full-evaluation check. P7e: the sphere, Stiefel and simplex HMC
     operators and elliptical slice on toy targets on the card, each
     constraint held to its tolerance;
  7. the remaining entry points: tree_site_logliks at the benchmark2 and
     Makona shapes (one resident and one deep launch), a 20-state and an
     8-state likelihood by tree_loglikelihood_pmats (one matrix-product and
     one v1 streaming launch), a few real amino-acid sequences from
     Alignment to tree_loglikelihood against the CPU, and the benchmark1
     likelihood partition by partition by peel_loglikelihood_stream (the v1
     streaming kernel) against the chain's route (one deep launch).
  8. chain batches and MC3 (`chain_paths`): P8a, the benchmark2 chain as a
     batch of 8 chains (inference/mcmc.py::make_multichain_step), P8b
     Makona with 4, P8d protein with 4, each one kernel launch a step for
     the whole batch and the full-evaluation check on every chain; P8c, MC3
     (inference/mc3.py) on 4 chains at benchmark1, each chain its own
     operator draw, one launch a step for 4 chains and 3 partitions, the
     swap acceptance inside [0.05, 0.95]; P8e, one benchmark2 chain through
     the component cache (inference/component_cache.py), a launch exactly
     on each step whose operator refreshes the likelihood. Phase 2 also
     holds each chain-axis kernel (peel_resident at B = 8, peel_stream at
     B = 4 and at B = 4 x K = 3, peel_mxu at B = 4, the chains' trees from
     their own seeds) against its plain chain-axis version and B single
     launches, and times the one launch against the B.
  9. the Makona-1610 joint analysis (`joint_path`), the north-star model of
     examples/makona_joint.xml, built at full size by
     apps/makona.py::build_makona_joint: 1,610 dated taxa, the document's
     18,996 sites simulated under GTR+Gamma4 and the relaxed clock and
     compressed to patterns, a skygrid of 50 cells, 56 locations under an
     asymmetric CTMC with 3,080 rates and 3,080 BSSVS indicators, f64, the
     component-cached posterior and the document's 14 operators. peel_stream
     is held against its plain version on the joint's inputs; the chain's
     peel_stream launches must equal its steps whose operator refreshes
     treeLikelihood (the 56-state trait peels by the plain level peel and
     launches nothing); the full-evaluation check; a profiler window.

`python3 chip_smoke.py --tiles` instead builds the v1 streaming kernel and
times it at every pattern-tile width its planner could pick (32, 16, 8, 4
patterns a block, where shared memory allows), with its largest deviation
from the plain version; `*` marks the width the planner picks. This is the
measurement behind the planner's rule of narrowing the tile while the grid
would leave more than half of the SMs idle. At the shapes with 16 states or
more it then times the matrix-product kernel at 1 to 8 teams a block, where
shared memory allows. It times the deep kernel at the Makona
and the benchmark1 three-partition shapes at every pattern tile (pw
patterns a slot) and 4, 8, 16 and 32 warps a block, and last the resident
kernel at the benchmark2 shape at 8 and 4 patterns a slot, 4 to 32 warps
and 1 to 8 pattern tiles a block.

It prints each phase's seconds, the card's name and power limit, one
{"kernels": [...]} line, and last {"ok": true, "device": {...}}. It imports nothing of JAX and
nothing of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# per site, relative to max(|site logL|, 1): padded patterns have logL 0
F64_REL_TOL = 1e-10
F32_ABS_TOL = 5e-5  # per site, absolute (as tests/test_pallas_stream.py)
F32_ABS_TOL_WIDE = 1e-4  # S >= 16: the j-sum runs in another order
F32_POST_TOL = 1e-5  # rescaled partials lie in [0, 1]
GRAD_REL_TOL = 1e-10  # each gradient's max |diff| over its max |entry|, f64
POST_ABS_TOL = 1e-13  # the gradient's residual, kernel against plain, f64
FULL_EVAL_TOL = 0.1  # MarkovChain.java:55
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# data sheet: float64 on the FP64 tensor cores (full precision), float32
# outside the tensor cores (TF32 would lose precision)
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}

B2 = (62, 5565)
MAKONA = (1610, 2048)
SMALL = (12, 130)
B1 = (1441, 593)  # taxa, patterns per codon partition
CATERPILLAR = (500, 4, 4, 203)  # taxa, categories, states, patterns
RAGGED_DEEP = (1610, 4, 4, 1001)
B2_PEEL = (62, 4, 4, 5632)  # the benchmark2 chain's peel, patterns padded
RAGGED_B2 = (62, 4, 4, 1001)
DEEP_TILE_SHAPES = [(1610, 1, 4, 2048), (1441, 3, 1, 640)]  # taxa, K, C, P
# f32 deep checks draw tips with 85% of entries 1: site logL stays under
# 300 in magnitude, where one f32 step is 3e-5; at the chains' ~1,500 it is
# 1.2e-4, beyond the 5e-5 the check allows, whatever the kernel does
F32_CUT = 0.15
AMINO = (128, 4, 20, 1024)  # taxa, categories, states, patterns
CODON = (64, 1, 61, 512)
RAGGED = (20, 4, 61, 70)
CATERPILLAR_MXU = (128, 4, 20, 1024)
TILE_SHAPES = [CODON, AMINO, RAGGED, (300, 2, 16, 2048),
               (128, 4, 20, 8192), (1441, 1, 4, 640), (1610, 4, 4, 2048),
               (62, 4, 4, 5632)]
B2_STEPS, B2_CHECK = 1000, 100
MAK_STEPS, MAK_CHECK = 200, 50
B1_STEPS, B1_CHECK = 300, 50
PC_STEPS, PC_CHECK = 300, 50  # the protein and the codon chain
KERNELS = ("peel_resident", "peel_stream", "peel_stream_ring", "peel_mxu")
# the HMC chains: both operators take HMC_LEAPFROG steps from HMC_STEP (the
# Robbins-Monro adaptation moves it); weights beside the 48 of build_analysis
HMC_LEAPFROG, HMC_STEP = 5, 1e-3
HMC_WEIGHTS = (10.0, 5.0)  # NodeHeightHmcOperator, HmcOperator
HMC_ALONE = 8  # proposals of each HMC operator alone: launches and times
HMC_B2_STEPS, HMC_B2_CHECK = 200, 40
HMC_MAK_STEPS, HMC_MAK_CHECK = 60, 15


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps):
    """Median milliseconds of `reps` calls, CUDA events around each."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(tensors_in, tensors_out, n_int, c, s, p, dtype_name, k=1):
    """Least time for the peel of k partitions: inputs read once and outputs
    written once over HBM bandwidth, against the peel's operations
    (bench.py's count, 4S^2 + 3S per node, category and pattern, plus the
    root) over the card's full-precision peak for the type."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors_in, *tensors_out))
    flops = k * (n_int * c * p * (4 * s * s + 3 * s) + 2 * c * s * p)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def _strict_clock_analysis(tips_np, weights_np, freqs, seed, dtype, device,
                           params0, derived, model, extra_ops):
    """The five-tuple of `build_analysis` for a one-partition analysis under
    a strict clock and a constant coalescent, aux["log_post_chains"] and
    aux["log_post_cached_chains"] (the chain-axis forms) included.
    `model(params, cached)` gives (eigensystem, category rates, category
    weights), from the derived entries of `params` when `cached`."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.mcmc import apply_derived
    from beast_mcmc_tpu_torch.inference.operators import (
        TREE_HEIGHTS, NarrowExchangeOperator, RootHeightScaleOperator,
        ScaleOperator, UniformNodeHeightOperator, UpDownOperator,
        WideExchangeOperator, WilsonBaldingOperator)
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik)
    from beast_mcmc_tpu_torch.models.priors import (
        lognormal_logpdf, one_on_x_logpdf)
    from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
    from beast_mcmc_tpu_torch.tree.topology import (
        make_tree_state, simulate_coalescent_tree)

    n_taxa = tips_np.shape[0]
    tips = torch.tensor(tips_np, dtype=dtype, device=device)
    weights = torch.tensor(weights_np, dtype=dtype, device=device)
    tree0 = make_tree_state(*simulate_coalescent_tree(
        np.random.default_rng(seed + 1), np.zeros(n_taxa), pop_size=0.5),
        dtype, device)

    def log_lik(params, tree, cached=False):
        eig, rates, cat_w = model(params, cached)
        return tree_loglikelihood(
            tips, weights, tree.parent, tree.children, tree.heights,
            tree.root, eig, freqs, rates, cat_w, params["clock.rate"])

    def log_prior(params, tree, chains=False):
        return (one_on_x_logpdf(params["pop.size"], chains)
                + lognormal_logpdf(params["clock.rate"], 0.0, 1.0, chains)
                + constant_coalescent_loglik(tree.heights, n_taxa,
                                             params["pop.size"]))

    def log_post(params, tree):
        return log_lik(params, tree) + log_prior(params, tree)

    def log_post_cached(params, tree):
        return log_lik(params, tree, cached=True) + log_prior(params, tree)

    # the same posteriors over a chain batch: [B] from one launch
    def log_post_chains(params, tree):
        return log_lik(params, tree) + log_prior(params, tree, True)

    def log_post_cached_chains(params, tree):
        return (log_lik(params, tree, cached=True)
                + log_prior(params, tree, True))

    params0 = {k: torch.tensor(v, dtype=dtype, device=device)
               for k, v in {**params0, "clock.rate": 1.0,
                            "pop.size": 0.5}.items()}
    operators = [
        *extra_ops,
        ScaleOperator(parameter="pop.size", weight=3.0),
        UpDownOperator(up=("clock.rate",), down=(TREE_HEIGHTS,), weight=3.0),
        UniformNodeHeightOperator(weight=15.0),
        RootHeightScaleOperator(weight=3.0),
        NarrowExchangeOperator(weight=15.0),
        WideExchangeOperator(weight=3.0),
        WilsonBaldingOperator(weight=3.0),
    ]
    aux = {"tips": tips, "weights": weights, "freqs": freqs,
           "log_lik": log_lik, "derived": derived,
           "log_post_cached": log_post_cached,
           "log_post_chains": log_post_chains,
           "log_post_cached_chains": log_post_cached_chains}
    return log_post, operators, apply_derived(derived, params0), tree0, aux


def _one_hot_tips(n_taxa, n_patterns, n_states, seed):
    """Random unambiguous tip partials [N, S, P] and pattern weights [P]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    states = rng.integers(0, n_states, size=(n_taxa, n_patterns))
    tips = (states[:, None, :] == np.arange(n_states)[None, :, None])
    weights = rng.integers(1, 10, size=n_patterns)
    return tips.astype(np.float64), weights.astype(np.float64)


def protein_analysis(n_taxa=128, n_patterns=1024, seed=0, dtype=None,
                     device="cuda"):
    """LG+Gamma4 on 20-state tips, strict clock, constant coalescent:
    (log_post, operators, params0, tree0, aux) as `build_analysis` returns
    them. The LG eigensystem is fixed (aux["eig"]); "site.rates" is derived
    from "alpha"."""
    import torch

    from beast_mcmc_tpu_torch.inference.operators import ScaleOperator
    from beast_mcmc_tpu_torch.models.data.aa_matrices import AA_MODELS
    from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates
    from beast_mcmc_tpu_torch.models.substitution import empirical_aa_eigen

    dtype = dtype or torch.float64
    freqs = torch.tensor(AA_MODELS["LG"]["frequencies"], dtype=dtype,
                         device=device)
    eig = empirical_aa_eigen("LG", freqs)

    def site_rates(params):
        return discrete_gamma_rates(params["alpha"], 4, dtype=dtype)

    def model(params, cached):
        rates, cat_w = params["site.rates"] if cached else site_rates(params)
        return eig, rates, cat_w

    out = _strict_clock_analysis(
        *_one_hot_tips(n_taxa, n_patterns, 20, seed), freqs, seed, dtype,
        device, {"alpha": 0.5}, {"site.rates": (site_rates, ("alpha",))},
        model, [ScaleOperator(parameter="alpha", weight=1.0)])
    out[4]["eig"] = eig
    return out


def codon_analysis(n_taxa=64, n_patterns=512, seed=0, dtype=None,
                   device="cuda"):
    """GY94 (kappa, omega, uniform codon frequencies) on 61-state tips, one
    rate category, strict clock, constant coalescent. "eig" is derived from
    ("kappa", "omega"), so the 61 x 61 eigh runs only when one of them
    moves."""
    import torch

    from beast_mcmc_tpu_torch.inference.operators import ScaleOperator
    from beast_mcmc_tpu_torch.models.sitemodel import single_rate
    from beast_mcmc_tpu_torch.models.substitution import gy94_eigen

    dtype = dtype or torch.float64
    freqs = torch.full((61,), 1.0 / 61, dtype=dtype, device=device)
    rates, cat_w = single_rate(dtype=dtype, device=device)

    def eigen(params):
        return gy94_eigen(params["kappa"], params["omega"], freqs)

    def model(params, cached):
        return (params["eig"] if cached else eigen(params)), rates, cat_w

    return _strict_clock_analysis(
        *_one_hot_tips(n_taxa, n_patterns, 61, seed), freqs, seed, dtype,
        device, {"kappa": 2.0, "omega": 0.5},
        {"eig": (eigen, ("kappa", "omega"))}, model,
        [ScaleOperator(parameter="kappa", weight=1.0),
         ScaleOperator(parameter="omega", weight=1.0)])


# phase 6d, the samplers: starting step sizes in log space (NUTS from the
# HMC step of phase 6c; the Robbins-Monro adaptation moves them), the
# expected candidate events of a PDMP proposal (its travel time follows from
# the bounds), and the constraint tolerances of the toy targets
P7_WARM = 20  # warm-up steps before each measured chain
P7_ALONE = 4  # proposals of each chain operator alone: launches and times
P7_STEPS = {"benchmark2": (200, 40), "benchmark1": (100, 25),
            "protein": (100, 25)}  # steps, full-evaluation steps
P7_TOY_STEPS = 500
NUTS_STEP, NUTS_DEPTH = 1e-3, 6
PDMP_EVENTS = 35.0
SPHERE_TOL, STIEFEL_TOL, SIMPLEX_TOL = 1e-12, 1e-10, 1e-12


def sampler_paths(paths, reset_counts, read_counts, device_ms, dev):
    """Phase 6d: the samplers of `inference/{nuts,pdmp,samplers,geodesic}.py`
    and the reflective HMC operator on the chains, and the constrained
    operators on toy targets.

    paths: {label: ((log_post, operators, params0, tree0, aux), (params,
    tree) to start from, the route's kernel)} for "benchmark2",
    "benchmark1", "protein" and "makona". Each operator that evaluates the
    posterior in its proposal first runs alone, P7_ALONE proposals, each
    step's launches held exactly to what the operator reports (NUTS n_lf + 1
    and the chain's evaluation, reflective HMC 2 n_leapfrog + 1, a PDMP
    events + 1); then the mixed chain with the full-evaluation check.
    Returns ({path: record}, {path: launches of its measured chain})."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.geodesic import (
        StiefelGeodesicHmcOperator)
    from beast_mcmc_tpu_torch.inference.hmc import (
        GeodesicHmcOperator, HmcOperator, ReflectiveHmcOperator,
        SimplexHmcOperator, value_grad)
    from beast_mcmc_tpu_torch.inference.mcmc import (
        full_evaluation_check, init_mcmc_state, make_mcmc_step,
        operator_report, run_chain)
    from beast_mcmc_tpu_torch.inference.nuts import NutsOperator
    from beast_mcmc_tpu_torch.inference.pdmp import (
        BouncyParticleOperator, ZigZagOperator)
    from beast_mcmc_tpu_torch.inference.samplers import (
        AvmvnOperator, EllipticalSliceOperator, MvnOperator, SliceOperator,
        make_post_update)
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state

    f64 = torch.float64
    rate_size = ("clock.rate", "pop.size")
    pdmp = (ZigZagOperator, BouncyParticleOperator)
    records, launches = {}, {}

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def step_launches(op):
        """A chain step's launches with op's proposal, from its report."""
        if isinstance(op, NutsOperator):
            return op.last_n_leapfrog + 2
        if isinstance(op, pdmp):
            return op.last_n_events + 1
        return 2 * op.n_leapfrog + 1

    def alone(label, op, seed):
        (_, _, _, _, aux), (p0, t0), kname = paths[label]
        name = type(op).__name__
        lpc = aux["log_post_cached"]
        step = make_mcmc_step(lpc, [op], derived=aux["derived"])
        st = init_mcmc_state(p0, t0, gen(seed), [op], lpc)
        rows = []
        for _ in range(P7_ALONE):
            sync()
            reset_counts()
            t0_ = time.perf_counter()
            st = step(st)
            sync()
            row = {"ms": 1e3 * (time.perf_counter() - t0_)}
            counts = read_counts()
            want = step_launches(op)
            row["launches_in_step"] = counts[kname]
            if isinstance(op, NutsOperator):
                row["n_leapfrog"] = op.last_n_leapfrog
            if isinstance(op, pdmp):
                row["events"] = op.last_n_events
            rows.append(row)
            if counts != {k: want * (k == kname) for k in counts}:
                raise AssertionError(f"{label} {name} alone: expected {want} "
                                     f"launches of {kname} in a step, got "
                                     f"{counts}")
        _, busy = device_ms(lambda: step(st), f"p7 {label} {name}", 1, 6)
        rec = {"proposals": rows, "device_ms_one_more": busy or
               "not measured", "accepted": int(st.op_accept[0])}
        if op.adaptable:
            rec["step_size_end"] = float(op.tuning(st.op_adapt[0]))
        log(f"[p7 {label}] {name} alone {json.dumps(rec)}")
        return rec

    def mixed(label, added, seed, metropolis):
        (log_post, ops, _, _, aux), (p0, t0), kname = paths[label]
        n_steps, n_check = P7_STEPS[label]
        lpc = aux["log_post_cached"]
        all_ops = [*ops, *added]
        step = make_mcmc_step(lpc, all_ops, derived=aux["derived"],
                              post_update=make_post_update(all_ops))
        st = init_mcmc_state(p0, t0, gen(seed), all_ops, lpc)
        st, _ = run_chain(step, st, P7_WARM)
        sync()
        drawn0 = (st.op_accept + st.op_reject).tolist()
        acc0 = st.op_accept.tolist()
        reset_counts()
        t0_ = time.perf_counter()
        st, _ = run_chain(step, st, n_steps)
        sync()
        secs = time.perf_counter() - t0_
        counts = read_counts()
        drawn = [a - b for a, b in zip((st.op_accept + st.op_reject).tolist(),
                                       drawn0)]
        acc = [a - b for a, b in zip(st.op_accept.tolist(), acc0)]
        k = len(ops)
        rec = {"steps": n_steps, "seconds": secs,
               "states_per_s": n_steps / secs, "launches": counts,
               "operators": {f"{type(op).__name__}": {
                   "weight": op.weight, "proposals": drawn[k + i],
                   "accepted": acc[k + i]} for i, op in enumerate(added)}}
        st, dev_max = full_evaluation_check(step, log_post, st, n_check,
                                            derived=aux["derived"])
        rec["full_eval_max_deviation"] = float(dev_max)
        log(f"[p7 {label}] chain {json.dumps(rec)}")
        log(operator_report(all_ops, st))
        if not (counts[kname] > n_steps
                and all(v == 0 for n, v in counts.items() if n != kname)):
            raise AssertionError(f"{label}: the chain did not go through "
                                 f"{kname} alone: {counts}")
        if not all(drawn[k + i] > 0 for i in range(len(added))):
            raise AssertionError(f"{label}: an added operator never ran")
        if not all(acc[k + i] > 0 for i, op in enumerate(added)
                   if isinstance(op, metropolis)):
            raise AssertionError(f"{label}: a Metropolis operator accepted "
                                 f"nothing")
        if not rec["full_eval_max_deviation"] < FULL_EVAL_TOL:
            raise AssertionError(f"{label}: full-evaluation deviation "
                                 f"{rec['full_eval_max_deviation']}")
        launches[label] = counts
        return rec

    # P7a: benchmark2, NUTS, slice and AVMVN with its post-update hook
    t_phase = time.perf_counter()
    nuts = NutsOperator(parameters=rate_size, max_depth=NUTS_DEPTH,
                        step_size=NUTS_STEP, weight=5.0)
    records["benchmark2"] = {
        "NutsOperator alone": alone("benchmark2", NutsOperator(
            parameters=rate_size, max_depth=NUTS_DEPTH, step_size=NUTS_STEP),
            11),
        "chain": mixed("benchmark2", [
            nuts, SliceOperator(parameter="pop.size", log_transform=True,
                                weight=3.0),
            AvmvnOperator(parameters=("gtr.rates", "alpha"), scale=0.05,
                          weight=3.0)], 12, (AvmvnOperator,))}
    records["benchmark2"]["seconds"] = time.perf_counter() - t_phase
    log(f"[p7 benchmark2] phase {records['benchmark2']['seconds']:.2f} s")

    # P7b: benchmark1, reflective HMC on the three kappas and MVN
    t_phase = time.perf_counter()
    refl = dict(parameters=("kappa",), lower=0.0, n_leapfrog=5,
                step_size=0.01)
    records["benchmark1"] = {
        "ReflectiveHmcOperator alone": alone(
            "benchmark1", ReflectiveHmcOperator(**refl), 13),
        "chain": mixed("benchmark1", [
            ReflectiveHmcOperator(**refl, weight=5.0),
            MvnOperator(parameters=rate_size, scale=0.05, weight=3.0)], 14,
            (ReflectiveHmcOperator, MvnOperator))}
    records["benchmark1"]["seconds"] = time.perf_counter() - t_phase
    log(f"[p7 benchmark1] phase {records['benchmark1']['seconds']:.2f} s")

    # P7c: protein, Zig-Zag and BPS. The bounds come from the gradients of
    # the potential seen over a warm-up of the plain chain: Zig-Zag's, twice
    # each coordinate's largest |dU/dy|; BPS's, thrice the largest |grad U|
    # (|v| of a 2-d standard normal velocity is under 3 in 99% of draws).
    # Each travel time makes PDMP_EVENTS candidate events expected.
    t_phase = time.perf_counter()
    (_, ops, _, _, aux), (p0, t0), kname = paths["protein"]
    lpc = aux["log_post_cached"]
    probe = HmcOperator(parameters=rate_size)
    probe.bind_log_posterior(lpc)
    base = make_mcmc_step(lpc, ops, derived=aux["derived"])
    st = init_mcmc_state(p0, t0, gen(15), ops, lpc)
    grads = []
    for _ in range(P7_WARM):
        st = base(st)
        grads.append(value_grad(probe.neg_log_density(st.params, st.tree),
                                probe._pack(st.params).detach()))
    grads = torch.stack(grads)
    zz_bound = (2.0 * grads.abs().max(0).values).tolist()
    bps_bound = 3.0 * float(torch.linalg.vector_norm(grads, dim=1).max())
    pdmp_kw = [dict(grad_bound=zz_bound,
                    travel_time=PDMP_EVENTS / sum(zz_bound)),
               dict(grad_bound=bps_bound,
                    travel_time=PDMP_EVENTS / (bps_bound + 1.0))]
    paths["protein"] = (paths["protein"][0], (st.params, st.tree), kname)
    rec = {"warmup_max_abs_grad": grads.abs().max(0).values.tolist(),
           "settings": {"ZigZagOperator": pdmp_kw[0],
                        "BouncyParticleOperator": pdmp_kw[1]}}
    for i, (cls, kw) in enumerate(zip(pdmp, pdmp_kw)):
        rec[f"{cls.__name__} alone"] = alone(
            "protein", cls(parameters=rate_size, **kw), 16 + i)
    rec["chain"] = mixed("protein", [
        cls(parameters=rate_size, weight=3.0, **kw)
        for cls, kw in zip(pdmp, pdmp_kw)], 18, ())
    records["protein"] = rec
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[p7 protein] phase {rec['seconds']:.2f} s")

    # P7d: Makona, NUTS alone
    t_phase = time.perf_counter()
    records["makona"] = {"NutsOperator alone": alone("makona", NutsOperator(
        parameters=rate_size, max_depth=NUTS_DEPTH, step_size=NUTS_STEP),
        19)}
    launches["makona"] = {
        k: sum(r["launches_in_step"] for r in
               records["makona"]["NutsOperator alone"]["proposals"])
        * (k == paths["makona"][2]) for k in read_counts()}
    records["makona"]["seconds"] = time.perf_counter() - t_phase
    log(f"[p7 makona] phase {records['makona']['seconds']:.2f} s")

    # P7e: the constrained operators and elliptical slice on toy targets
    t_phase = time.perf_counter()
    tree = make_tree_state(np.array([2, 2, -1]),
                           np.array([[-1, -1], [-1, -1], [0, 1]]),
                           np.array([0.0, 0.0, 1.0]), 2, f64, dev)
    rng = np.random.default_rng(20)
    t = lambda a: torch.tensor(a, dtype=f64, device=dev)  # noqa: E731
    mu = t([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.6, 0.0, 0.8]])
    c_mat = t(rng.normal(size=(5, 2)))
    alpha = t([2.0, 3.0, 4.0, 5.0])
    x_st = np.linalg.qr(rng.normal(size=(5, 2)))[0]
    eye2 = torch.eye(2, dtype=f64, device=dev)

    def stiefel(out):
        x = torch.stack([out["a"], out["b"]], -1)
        return float((x.transpose(1, 2) @ x - eye2).abs().max())

    toys = [
        ("sphere", GeodesicHmcOperator(parameter="x", block_dim=3,
                                       n_leapfrog=8, step_size=0.3),
         {"x": t([1.0, 0.0, 0.0] * 3)},
         lambda p, tr: 4.0 * torch.sum(p["x"].reshape(3, 3) * mu),
         lambda out: float((torch.linalg.vector_norm(
             out["x"].reshape(-1, 3, 3), dim=-1) - 1.0).abs().max()),
         SPHERE_TOL),
        ("stiefel", StiefelGeodesicHmcOperator(parameters=("a", "b"),
                                               step_size=0.1),
         {"a": t(x_st[:, 0]), "b": t(x_st[:, 1])},
         lambda p, tr: torch.sum(c_mat * torch.stack([p["a"], p["b"]], 1)),
         stiefel, STIEFEL_TOL),
        ("simplex", SimplexHmcOperator(parameter="x", step_size=0.3),
         {"x": t([0.25] * 4)},
         lambda p, tr: torch.sum((alpha - 1.0) * torch.log(p["x"])),
         lambda out: float((out["x"].sum(-1) - 1.0).abs().max())
         if bool((out["x"] > 0).all()) else float("inf"), SIMPLEX_TOL),
        ("elliptical slice", EllipticalSliceOperator(parameter="x"),
         {"x": t([0.0] * 3)},
         lambda p, tr: torch.sum(-0.5 * p["x"] ** 2
                                 - 2.0 * (p["x"] - 2.0) ** 2), None, None),
    ]
    rec = {}
    for i, (label, op, params, log_post, err_fn, tol) in enumerate(toys):
        step = make_mcmc_step(log_post, [op])
        st = init_mcmc_state(params, tree, gen(21 + i), [op], log_post)
        sync()
        t0_ = time.perf_counter()
        st, out = run_chain(step, st, P7_TOY_STEPS, 1, lambda s: {
            k: v.clone() for k, v in s.params.items()})
        sync()
        secs = time.perf_counter() - t0_
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        r = {"operator": type(op).__name__, "steps": P7_TOY_STEPS,
             "steps_per_s": P7_TOY_STEPS / secs, "finite": finite,
             "accepted": int(st.op_accept[0]),
             "mean": {k: v.mean(0).tolist() for k, v in out.items()}}
        if err_fn is not None:
            r.update({"constraint_max_err": err_fn(out), "tol": tol})
        rec[label] = r
        log(f"[p7 toy] {label} {json.dumps(r)}")
        if not finite or (err_fn is not None and not (
                r["constraint_max_err"] <= tol and r["accepted"] > 0)):
            raise AssertionError(f"toy {label}: {r}")
    records["toys"] = rec
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[p7 toys] phase {rec['seconds']:.2f} s")
    return records, launches


# phase 8, chain batches and MC3: chains, steps and full-evaluation steps
# of the make_multichain_step paths; MC3 at benchmark1; the component cache
P8_WARM = 20
P8_PATHS = {"benchmark2": (8, 200, 40), "makona": (4, 60, 15),
            "protein": (4, 100, 25)}
P8C_CHAINS, P8C_ROUNDS, P8C_SWAP_EVERY, P8C_WARM = 4, 20, 12, 24
P8E_STEPS = 200
SWAP_BAND = (0.05, 0.95)  # __graft_entry__.py:118-122


def chain_paths(paths, reset_counts, read_counts, device_ms, dev):
    """Phase 8: chain batches (inference/mcmc.py::make_multichain_step),
    MC3 (inference/mc3.py) and the component cache
    (inference/component_cache.py) on the card.

    paths: {label: ((log_post, operators, params0, tree0, aux), the route's
    kernel, the single chain's states/s measured in this run)} for
    "benchmark2", "makona", "protein" and "benchmark1". P8a, P8b, P8d: a
    batch of P8_PATHS[label] chains replicated from the analysis's start,
    one operator drawn a step for all chains, exactly one launch of the
    route's kernel a step, the full-evaluation check over every chain. P8c:
    MC3 at benchmark1, each chain its own operator draw and still one
    launch a step; the ladder's delta from the adjacent log-posterior gaps
    after a warm-up at temperature 1, so that (dT)(dL) ~ 1 as
    __graft_entry__.py:90-94 reasons; the swap acceptance inside
    SWAP_BAND. P8e: one benchmark2 chain through make_mcmc_step's component
    cache (likelihood, coalescent and two priors): its launches equal its
    steps whose operator refreshes the likelihood. Returns ({path: record},
    {path: launches})."""
    import bisect

    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.component_cache import (
        component_lp_fn, full_lp_fn, make_components, seed_components)
    from beast_mcmc_tpu_torch.inference.mc3 import (
        make_mc3_runner, replicate_state)
    from beast_mcmc_tpu_torch.inference.mcmc import (
        apply_derived, full_evaluation_check, init_mcmc_state,
        make_mcmc_step, make_multichain_step, operator_report, run_chain)
    from beast_mcmc_tpu_torch.inference.operators import TREE_HEIGHTS

    records, launches = {}, {}

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def only(kname, n):
        return lambda counts: counts == {k: n * (k == kname) for k in counts}

    def batch(label, seed):
        (_, ops, p0, t0, aux), kname, _ = paths[label]
        lpc = aux["log_post_cached"]
        st = init_mcmc_state(p0, t0, gen(seed), ops, lpc)
        return replicate_state(st, P8_PATHS.get(label, (P8C_CHAINS,))[0],
                               gen(seed + 1))

    for p_name, label, seed in (("P8a", "benchmark2", 80),
                                ("P8b", "makona", 81),
                                ("P8d", "protein", 83)):
        t_phase = time.perf_counter()
        (log_post, ops, _, _, aux), kname, single = paths[label]
        b_n, n_steps, n_check = P8_PATHS[label]
        mstep = make_multichain_step(aux["log_post_cached_chains"], ops,
                                     derived=aux["derived"])
        states = batch(label, seed)
        states, _ = run_chain(mstep, states, P8_WARM)
        sync()
        reset_counts()
        t0_ = time.perf_counter()
        states, _ = run_chain(mstep, states, n_steps)
        sync()
        secs = time.perf_counter() - t0_
        counts = read_counts()
        lps = states.log_posterior.tolist()
        rec = {"chains": b_n, "steps": n_steps, "seconds": secs,
               "aggregate_states_per_s": b_n * n_steps / secs,
               "single_chain_states_per_s": single, "launches": counts,
               "log_posterior": lps}
        if dev != "cpu":
            wall, busy = device_ms(lambda: run_chain(mstep, states, 20),
                                   f"{p_name} {label}", 20, 8)
            rec.update({"profiled_ms_per_step": wall,
                        "device_busy_ms_per_step": busy or "not measured",
                        "device_busy_share": (busy / wall if busy
                                              else "not measured")})
        states, dev_max = full_evaluation_check(
            mstep, aux["log_post_chains"], states, n_check,
            derived=aux["derived"])
        rec["full_eval_max_deviation"] = float(dev_max)
        rec["seconds_in_phase"] = time.perf_counter() - t_phase
        log(f"[{p_name} {label}] {json.dumps(rec)}")
        log(operator_report(ops, states))
        if not only(kname, n_steps)(counts):
            raise AssertionError(f"{p_name}: expected one {kname} launch a "
                                 f"step for all {b_n} chains, got {counts}")
        if not all(np.isfinite(lps)):
            raise AssertionError(f"{p_name}: a chain's posterior is not "
                                 f"finite: {lps}")
        if not rec["full_eval_max_deviation"] < FULL_EVAL_TOL:
            raise AssertionError(f"{p_name}: full-evaluation deviation "
                                 f"{rec['full_eval_max_deviation']}")
        records[p_name], launches[f"{label} {p_name}"] = rec, counts

    # P8c: MC3 at benchmark1
    t_phase = time.perf_counter()
    (_, ops, _, _, aux), kname, single = paths["benchmark1"]
    lp_chains = aux["log_post_chains"]
    states = batch("benchmark1", 82)
    warm = make_multichain_step(lp_chains, ops)
    states, _ = run_chain(warm, states, P8C_WARM)
    lp = states.log_posterior.tolist()
    gap = float(np.mean(np.abs(np.diff(lp))))
    delta = 1.0 / gap if gap > 0 else 1.0
    run, temps = make_mc3_runner(lp_chains, ops, P8C_CHAINS,
                                 swap_every=P8C_SWAP_EVERY, delta=delta)
    sync()
    reset_counts()
    t0_ = time.perf_counter()
    states, out = run(states, torch.Generator().manual_seed(84), P8C_ROUNDS,
                      collector=lambda c: {"lp": c.log_posterior})
    sync()
    secs = time.perf_counter() - t0_
    counts = read_counts()
    n_steps = P8C_ROUNDS * P8C_SWAP_EVERY
    swap_rate = float(out["swap_accepted"].double().mean())
    cold = out["lp"].tolist()
    rec = {"chains": P8C_CHAINS, "rounds": P8C_ROUNDS,
           "swap_every": P8C_SWAP_EVERY, "warm_up_gap": gap, "delta": delta,
           "temperatures": temps.tolist(), "seconds": secs,
           "aggregate_states_per_s": P8C_CHAINS * n_steps / secs,
           "single_chain_states_per_s": single, "launches": counts,
           "swap_acceptance": swap_rate,
           "swaps_accepted": out["swap_accepted"].tolist(),
           "cold_log_posterior_last": cold[-1],
           "seconds_in_phase": time.perf_counter() - t_phase}
    log(f"[P8c benchmark1] {json.dumps(rec)}")
    log(operator_report(ops, states))
    if not only(kname, n_steps)(counts):
        raise AssertionError(f"P8c: expected one {kname} launch a step for "
                             f"the {P8C_CHAINS} chains, got {counts}")
    if not SWAP_BAND[0] <= swap_rate <= SWAP_BAND[1]:
        raise AssertionError(f"P8c: swap acceptance {swap_rate} outside "
                             f"{SWAP_BAND} (delta {delta})")
    if not all(np.isfinite(cold)):
        raise AssertionError(f"P8c: the cold chain's posterior is not finite")
    records["P8c"], launches["benchmark1 P8c"] = rec, counts

    # P8e: the component cache on one benchmark2 chain
    t_phase = time.perf_counter()
    (log_post, ops, p0, t0, aux), kname, single = paths["benchmark2"]
    comps = make_components(aux["components"], p0, t0)
    # the tree operators (modifies_params == ()) and up/down on the heights
    tree_flags = [op.modifies_params == () or TREE_HEIGHTS in (
        *getattr(op, "up", ()), *getattr(op, "down", ())) for op in ops]
    step = make_mcmc_step(log_post, ops, derived=aux["derived"],
                          components=comps, op_tree_flags=tree_flags)
    state = init_mcmc_state(seed_components(p0, t0, comps), t0, gen(85), ops,
                            component_lp_fn(comps))
    lik = next(i for i, c in enumerate(comps) if c.name == "likelihood")
    cum = np.cumsum(torch.exp(step.log_probs).numpy()).tolist()
    sync()
    reset_counts()
    touching = 0
    t0_ = time.perf_counter()
    for _ in range(P8E_STEPS):  # the step's own draw, made here to count
        u = float(torch.rand((), generator=state.op_generator,
                             dtype=torch.float64))
        i = min(bisect.bisect_right(cum, u), len(cum) - 1)
        touching += lik in step.refreshed[i]
        state = step.given_op(state, i)
    sync()
    secs = time.perf_counter() - t0_
    counts = read_counts()
    fresh = full_lp_fn(comps)(apply_derived(aux["derived"], state.params),
                              state.tree)
    dev_sum = abs(float(fresh) - float(state.log_posterior))
    rec = {"steps": P8E_STEPS, "likelihood_steps": touching,
           "launches": counts, "seconds": secs,
           "states_per_s": P8E_STEPS / secs,
           "single_chain_states_per_s": single,
           "components": [{"name": c.name, "deps": sorted(c.deps),
                           "uses_tree": c.uses_tree} for c in comps],
           "tree_flags": tree_flags, "refreshed": step.refreshed,
           "carried_vs_full_deviation": dev_sum,
           "seconds_in_phase": time.perf_counter() - t_phase}
    log(f"[P8e benchmark2] {json.dumps(rec)}")
    if not only(kname, touching)(counts) or touching >= P8E_STEPS:
        raise AssertionError(f"P8e: expected {touching} {kname} launches of "
                             f"{P8E_STEPS} steps, got {counts}")
    if not dev_sum < FULL_EVAL_TOL:
        raise AssertionError(f"P8e: carried sum off the full posterior by "
                             f"{dev_sum}")
    records["P8e"], launches["benchmark2 P8e"] = rec, counts
    return records, launches


# phase 9, the Makona-1610 joint analysis: warm-up, measured and
# full-evaluation steps of its chain, and the steps of its profiler window
JOINT_WARM, JOINT_STEPS, JOINT_CHECK, JOINT_PROFILE = 20, 300, 50, 30
JOINT_SEED = 666  # the starting tree's (the JAX package's) and alignment's


def joint_path(analysis, reset_counts, read_counts, dev, n_steps=JOINT_STEPS,
               n_check=JOINT_CHECK, n_warm=JOINT_WARM):
    """Phase 9: the joint analysis's component-cached chain
    (apps/makona.py::build_makona_joint's five-tuple), through
    make_mcmc_step(components=, op_tree_flags=) and run_chain, as
    bench.py::measure_makona_joint steps it. After n_warm steps, n_steps
    are timed with the launch counts set to 0 just before them; peel_stream
    must have launched exactly on the steps whose operator refreshes
    treeLikelihood (each operator's steps from its accept and reject
    counts), and no other kernel at all (the trait peels by the plain level
    peel). Then the full-evaluation check over n_check steps. Returns
    (record, launches, step, state)."""
    import torch

    from beast_mcmc_tpu_torch.inference.mcmc import (
        full_evaluation_check, init_mcmc_state, make_mcmc_step,
        operator_report, run_chain)

    log_post, ops, p0, t0, aux = analysis
    names = [c.name for c in aux["components"]]
    step = make_mcmc_step(log_post, ops, components=aux["components"],
                          op_tree_flags=aux["op_tree_flags"])
    gen = torch.Generator(device=dev).manual_seed(9)
    state = init_mcmc_state(p0, t0, gen, ops, log_post)
    state, _ = run_chain(step, state, n_warm)

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    sync()
    before = (state.op_accept + state.op_reject).tolist()
    reset_counts()
    t_start = time.perf_counter()
    state, _ = run_chain(step, state, n_steps)
    sync()
    dt = time.perf_counter() - t_start
    counts = read_counts()
    per_op = [a - b for a, b in zip(
        (state.op_accept + state.op_reject).tolist(), before)]

    def steps_refreshing(name):
        i = names.index(name)
        return sum(n for n, idxs in zip(per_op, step.refreshed) if i in idxs)

    rec = {"steps": n_steps, "seconds": dt, "states_per_s": n_steps / dt,
           "log_posterior": float(state.log_posterior), "launches": counts,
           "tree_likelihood_steps": steps_refreshing("treeLikelihood"),
           "geo_likelihood_steps": steps_refreshing("geoLikelihood"),
           "steps_per_operator": per_op}
    log(f"[joint] {n_steps} steps in {dt:.3f} s = {rec['states_per_s']:.2f} "
        f"states/s; log posterior {rec['log_posterior']!r}; launches "
        f"{json.dumps(counts)}; steps refreshing treeLikelihood "
        f"{rec['tree_likelihood_steps']}, geoLikelihood "
        f"{rec['geo_likelihood_steps']}")
    log(operator_report(ops, state))
    expect = {k: rec["tree_likelihood_steps"] * (k == "peel_stream")
              for k in counts}
    if counts != expect:
        raise AssertionError(f"joint: expected launches {expect}, got "
                             f"{counts}")
    lp = rec["log_posterior"]
    if lp != lp or abs(lp) == float("inf"):
        raise AssertionError(f"joint: posterior not finite: {lp}")
    t_start = time.perf_counter()
    state, dev_max = full_evaluation_check(step, log_post, state, n_check)
    rec["full_evaluation_deviation"] = float(dev_max)
    log(f"[joint] full-evaluation max deviation over {n_check} steps: "
        f"{rec['full_evaluation_deviation']!r} (tolerance {FULL_EVAL_TOL}) "
        f"in {time.perf_counter() - t_start:.2f} s")
    if not rec["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError("joint: full-evaluation deviation "
                             f"{rec['full_evaluation_deviation']}")
    return rec, counts, step, state


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
    from beast_mcmc_tpu_torch.inference.mcmc import (
        full_evaluation_check, init_mcmc_state, make_mcmc_step,
        operator_report, run_chain)
    from beast_mcmc_tpu_torch.data import AMINO_ACIDS, Alignment, SitePatterns
    from beast_mcmc_tpu_torch.models.data.aa_matrices import AA_MODELS
    from beast_mcmc_tpu_torch.models.sitemodel import single_rate
    from beast_mcmc_tpu_torch.models.substitution import (
        empirical_aa_eigen, hky_eigen)
    from beast_mcmc_tpu_torch.models.treelikelihood import (
        branch_transition_matrices, tree_loglikelihood,
        tree_loglikelihood_pmats, tree_site_logliks)
    from beast_mcmc_tpu_torch.ops import (
        _build, cuda_mxu, cuda_peeling, cuda_stream, cuda_stream2)
    from beast_mcmc_tpu_torch.ops import peeling as plain
    from beast_mcmc_tpu_torch.ops.peeling import peel_order_from_heights
    from beast_mcmc_tpu_torch.tree.topology import (
        make_tree_state, simulate_coalescent_tree)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind}")

    # each wrapper's module counts the launches of its kernel
    counters = {"peel_resident": cuda_peeling, "peel_stream": cuda_stream2,
                "peel_stream_ring": cuda_stream, "peel_mxu": cuda_mxu}

    def reset_counts():
        for mod in counters.values():
            mod.launches = 0

    def read_counts():
        return {k: mod.launches for k, mod in counters.items()}

    def random_inputs(n_taxa, c, s, p, seed, dtype, cut=0.6, k=None,
                      caterpillar=False):
        """The same tuple for any state count, and its tree, made on the
        host from a seed: a coalescent tree (or a caterpillar: each internal
        node joins the previous one and the next tip), tips whose entries
        are 1 with probability 1 - `cut` and 0.1 otherwise,
        row-stochastic matrices; with `k`, k partitions on the tree (tips,
        matrices, freqs and weights gain a leading axis)."""
        rng = np.random.default_rng(seed)
        tree_np = simulate_coalescent_tree(rng, np.zeros(n_taxa), 1.0)
        if caterpillar:
            m = 2 * n_taxa - 1
            parent, children = np.full(m, -1), np.full((m, 2), -1)
            for i in range(1, n_taxa):
                children[n_taxa + i - 1] = (n_taxa + i - 2 if i > 1 else 0, i)
                parent[children[n_taxa + i - 1]] = n_taxa + i - 1
            tree_np = (parent, children,
                       np.r_[np.zeros(n_taxa), np.arange(1.0, n_taxa)], m - 1)
        tr = make_tree_state(*tree_np, dtype=torch.float64, device=dev)
        lead = () if k is None else (k,)
        tips = (rng.random((*lead, n_taxa, s, p)) > cut) * 0.9 + 0.1
        pm = rng.random((*lead, 2 * n_taxa - 1, c, s, s)) * 0.2 + 0.01
        pm = pm / pm.sum(-1, keepdims=True)
        order = peel_order_from_heights(tr.heights, n_taxa, tr.parent)
        f = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
        return (f(tips), tr.children, order, tr.root, f(pm),
                f(np.full((*lead, s), 1.0 / s)),
                f(np.full((*lead, c), 1.0 / c))), tr

    if "--tiles" in sys.argv[1:]:
        _build.build_all(["peel_stream_ring", "peel_mxu", "peel_stream",
                          "peel_resident"])
        for shape in TILE_SHAPES:
            for dtype in (torch.float64, torch.float32):
                (tips, ch, order, _, pm, fr, cw), _ = random_inputs(
                    *shape, 1, dtype)
                ids, pos = cuda_stream.stream_schedule(ch, order)
                pmo = pm[ids]
                ref = cuda_stream._stream_plain(tips, ids, pos, pmo,
                                                cw[:, None] * fr[None, :])
                n_taxa, c, s, p = shape
                picked = cuda_stream.stream_plan(p, c, s,
                                                 pm.element_size()).bp
                line = f"[tiles] {shape} {str(dtype)[6:]}"
                for bp in (32, 16, 8, 4):
                    try:
                        call = cuda_stream.prepare_stream(tips, ids, pos, pmo,
                                                          fr, cw, bp)
                    except ValueError:  # this width overflows shared memory
                        continue
                    got = call.launch()
                    err = max((g - r).abs().max().item()
                              for g, r in zip(got, ref))
                    line += (f" | bp {bp}{'*' if bp == picked else ''} "
                             f"err {err:.1e} ms {time_ms(call.launch, 10):.4f}")
                log(line)
                if s < cuda_peeling.MXU_MIN_STATES:
                    continue
                # the matrix-product kernel: teams a block, forced through
                # the planner's argument
                sched = cuda_stream.level_schedule(ch, n_taxa)
                picked = cuda_mxu.mxu_plan(n_taxa - 1, c, s,
                                           pm.element_size())
                line = f"[tiles] {shape} {str(dtype)[6:]} peel_mxu"
                for teams in range(1, 9):
                    try:
                        call = cuda_mxu.prepare_mxu(tips, ch, order, pm, fr,
                                                    cw, sched, teams)
                    except ValueError:  # overflows shared memory
                        continue
                    err = (call.launch()[0] - ref[0]).abs().max().item()
                    star = "*" if teams == picked.teams else ""
                    ms = time_ms(call.launch, 10)
                    line += (f" | teams {teams} tw {call.ints[5]}{star} err "
                             f"{err:.1e} ms {ms:.4f}")
                log(line)
        # the deep kernel: pw patterns a slot, warps a block; f32 on mostly
        # ambiguous tips (see F32_CUT)
        for n_taxa, k, c, p in DEEP_TILE_SHAPES:
            for dtype in (torch.float64, torch.float32):
                (tips, ch, _, _, pm, fr, cw), _ = random_inputs(
                    n_taxa, c, 4, p, 1, dtype,
                    F32_CUT if dtype == torch.float32 else 0.6, k)
                _, ids, pos, ls = cuda_stream.level_schedule(ch, n_taxa)
                pmo = pm[:, ids.long()].contiguous()
                ref = cuda_stream2._deep_plain(tips, ids, pos, ls, pmo,
                                               cw[:, :, None] * fr[:, None])
                picked = cuda_stream2.deep_plan(p, k, c, pm.element_size())
                line = f"[tiles] deep {(n_taxa, k, c, p)} {str(dtype)[6:]}"
                pw = 1 << ((32 // c).bit_length() - 1)
                while pw * c >= 2:
                    for w in (4, 8, 16, 32):
                        try:
                            call = cuda_stream2.prepare_deep(
                                tips, ids, pos, ls, pmo, fr, cw, pw, w)
                        except ValueError:  # overflows shared memory
                            continue
                        err = (call.launch() - ref).abs().max().item()
                        star = "*" if (pw, w) == picked[:2] else ""
                        line += (f" | pw {pw} w {w}{star} err {err:.1e} ms "
                                 f"{time_ms(call.launch, 10):.4f}")
                    pw //= 2
                log(line)
        # the resident kernel at the benchmark2 shape: patterns a slot,
        # warps and pattern tiles a block
        for dtype in (torch.float64, torch.float32):
            (tips, ch, _, _, pm, fr, cw), _ = random_inputs(*B2_PEEL, 1,
                                                            dtype)
            sched = cuda_stream.level_schedule(ch, B2_PEEL[0])
            _, ids, pos, ls = sched
            ref = cuda_peeling._resident_plain(tips, ids, pos, ls, pm,
                                               cw[:, None] * fr[None, :])
            picked = cuda_peeling.resident_plan(pm.shape[0], 4,
                                                pm.element_size())
            line = f"[tiles] resident {B2_PEEL} {str(dtype)[6:]}"
            for pw in (8, 4):
                for w in (4, 8, 16, 32):
                    for tl in (1, 2, 4, 8):
                        try:
                            call = cuda_peeling.prepare_resident(
                                tips, ch, None, pm, fr, cw, sched, pw, w, tl)
                        except ValueError:  # slots do not divide the tiles
                            continue
                        err = (call.launch() - ref).abs().max().item()
                        star = "*" if (pw, w, tl) == picked[:3] else ""
                        ms = time_ms(call.launch, 10)
                        line += (f" | pw {pw} w {w} tiles {tl}{star} err "
                                 f"{err:.1e} ms {ms:.4f}")
            log(line)
        return 0

    phases = {}  # seconds of each phase
    t_mark = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phases[name] = now - t_mark[0]
        t_mark[0] = now
        log(f"[phase] {name} {phases[name]:.2f} s")

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all(KERNELS)
    log(f"[build] {time.perf_counter() - t0:.2f} s wall, per source "
        f"{json.dumps({k: round(v, 2) for k, v in built.items()})}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- set-up: the analyses of the main path -------------------------
    t0 = time.perf_counter()
    analyses = {shape: build_analysis(*shape, model="gtr_gamma", device=dev,
                                      dtype=torch.float64)
                for shape in (B2, MAKONA, SMALL)}
    analyses[B1] = build_analysis(*B1, model="hky_codon3", device=dev,
                                  dtype=torch.float64)
    analyses[AMINO] = protein_analysis(AMINO[0], AMINO[3], 0, torch.float64,
                                       dev)
    analyses[CODON] = codon_analysis(CODON[0], CODON[3], 0, torch.float64, dev)
    torch.cuda.synchronize()
    log(f"[setup] analyses built in {time.perf_counter() - t0:.2f} s")
    mark("1 build and set-up")

    def peel_inputs(shape, dtype, partitions=False):
        """(tips, children, order, root, p_matrices, freqs, cat_w) of an
        analysis at its start; partition 0 of the benchmark1 one, or with
        `partitions` all three ([K, ...] tips, matrices, freqs, weights)."""
        _, _, p0, t0_, aux = analyses[shape]
        tips, freqs = aux["tips"], aux["freqs"]
        eig, rates = model_of(shape, partitions)
        pm = branch_transition_matrices(eig, t0_.parent, t0_.heights,
                                        p0["clock.rate"], rates)
        cw = model_of(shape, partitions, weights=True)
        if shape == B1:
            tips = tips if partitions else tips[0]
            freqs = freqs.expand(3, 4) if partitions else freqs
        order = peel_order_from_heights(t0_.heights, shape[0], t0_.parent)
        return (tips.to(dtype).contiguous(), t0_.children, order,
                t0_.root, pm.to(dtype).contiguous(), freqs.to(dtype),
                cw.to(dtype))

    def model_of(shape, partitions=False, weights=False):
        """(eigensystem, category rates) of an analysis at its start, or
        with `weights` its category weights; partition 0 of benchmark1, or
        with `partitions` all three."""
        _, _, p0, _, aux = analyses[shape]
        freqs = aux["freqs"]
        if shape == B1 and partitions:
            freqs = freqs.expand(3, 4)
            eig = hky_eigen(p0["kappa"], freqs)
            rates, cw = single_rate(dtype=torch.float64, device=dev)
            rates, cw = p0["mu"][:, None] * rates, cw.expand(3, 1)
        elif shape == B1:
            eig = hky_eigen(p0["kappa"][0], freqs)
            rates, cw = single_rate(dtype=torch.float64, device=dev)
            rates = p0["mu"][0] * rates
        elif shape == AMINO:
            eig = aux["eig"]
            rates, cw = p0["site.rates"]
        elif shape == CODON:
            eig = p0["eig"]
            rates, cw = single_rate(dtype=torch.float64, device=dev)
        else:
            eig = p0["eig"]
            rates, cw = p0["site.rates"]
        return cw if weights else (eig, rates)

    # -- phase 2: kernel vs plain on the card -------------------------
    checks = {k: [] for k in KERNELS}

    def deviation(got, ref):
        err = (got - ref).abs()
        return (err.max().item(),
                (err / ref.abs().clamp_min(1.0)).max().item(),
                bool(torch.isfinite(got).all()))

    def check(kname, label, inputs, reps, plain_reps):
        tips, ch, order, root, pm, fr, cw = inputs
        dtype = pm.dtype
        n_int = tips.shape[-3] - 1
        c, s, p = pm.shape[-3], pm.shape[-2], tips.shape[-1]
        k_parts = tips.shape[0] if tips.dim() == 4 else 1
        wcs = cw[..., None] * fr[..., None, :]
        rec = {"label": label, "shape": [tips.shape[-3], c, s, p],
               "dtype": str(dtype).replace("torch.", "")}
        if kname in ("peel_resident", "peel_mxu"):  # by levels
            sched = cuda_stream.level_schedule(ch, n_int + 1)
            lvl_order, lr_ids, lr_pos, ls = sched
            rec["levels"] = int((ls < n_int).sum())
        if kname == "peel_resident":
            call = cuda_peeling.prepare_resident(tips, ch, order, pm, fr, cw,
                                                 sched)
            plain_fn = lambda: (cuda_peeling._resident_plain(  # noqa: E731
                tips, lr_ids, lr_pos, ls, pm, wcs),)
            ins = [tips, pm, lr_ids, lr_pos, ls, fr, cw]
        elif kname == "peel_mxu":
            call = cuda_mxu.prepare_mxu(tips, ch, order, pm, fr, cw, sched)
            plain_fn = lambda: cuda_mxu._mxu_plain(  # noqa: E731
                tips, sched, pm, wcs)
            ins = [tips, pm, lvl_order.to(torch.int32), lr_ids, ls, fr, cw]
        elif kname == "peel_stream":  # one tree, or K partitions on it
            if tips.dim() == 3:
                tips, pm, fr, cw = tips[None], pm[None], fr[None], cw[None]
            _, lr_ids, lr_pos, ls = cuda_stream.level_schedule(ch, n_int + 1)
            pm_ord = pm[:, lr_ids.long()].contiguous()
            call = cuda_stream2.prepare_deep(tips, lr_ids, lr_pos, ls, pm_ord,
                                             fr, cw)
            wcs = cw[:, :, None] * fr[:, None, :]
            plain_fn = lambda: (cuda_stream2._deep_plain(  # noqa: E731
                tips, lr_ids, lr_pos, ls, pm_ord, wcs),)
            ins = [tips, pm_ord, lr_ids, lr_pos, ls, fr, cw]
            rec["shape"] = [tips.shape[0], *rec["shape"]]
            rec["levels"] = int((ls < n_int).sum())
        else:
            lr_ids, lr_pos = cuda_stream.stream_schedule(ch, order)
            pm_ord = pm[lr_ids]
            ins = [tips, pm_ord, lr_ids, lr_pos, fr, cw]
            call = cuda_stream.prepare_stream(tips, lr_ids, lr_pos, pm_ord,
                                              fr, cw)
            plain_fn = lambda: cuda_stream._stream_plain(  # noqa: E731
                tips, lr_ids, lr_pos, pm_ord, wcs)
            # children the ring serves from shared memory
            step = torch.arange(n_int, device=dev)[:, None]
            inner = lr_pos >= 0
            rec["internal_child_reads"] = int(inner.sum())
            rec["ring_share"] = (int((inner & (lr_pos >= step - 2)).sum())
                                 / rec["internal_child_reads"])
        got = call.launch()
        got = tuple(t.clone() for t in (got if isinstance(got, tuple)
                                        else (got,)))
        if kname == "peel_mxu":  # the kernel leaves the tips' rows to the
            got[1][:tips.shape[0]] = tips[:, None]  # wrapper, as here
        ref = plain_fn()
        torch.cuda.synchronize()
        max_abs, max_rel, finite = deviation(got[0], ref[0])
        if dtype == torch.float64:
            ok, tol = max_rel < F64_REL_TOL, f"rel<{F64_REL_TOL}"
        else:
            lim = F32_ABS_TOL if s < 16 else F32_ABS_TOL_WIDE
            ok, tol = max_abs < lim, f"abs<{lim}"
        rec.update({"max_abs_err": max_abs, "max_rel_err": max_rel,
                    "tol": tol})
        if len(got) == 2:  # the rescaled partials by peel position
            post_abs, _, post_finite = deviation(got[1], ref[1])
            lim = F64_REL_TOL if dtype == torch.float64 else F32_POST_TOL
            ok = ok and post_abs < lim and post_finite
            rec.update({"post_max_abs_err": post_abs,
                        "post_tol": f"abs<{lim}"})
        del ref
        rec["ms"] = time_ms(call.launch, reps)
        rec["plain_ms"] = time_ms(plain_fn, plain_reps)
        # int inputs counted as the int32 the kernel reads; the partials are
        # an output of peel_stream_ring, scratch of the others (the chains
        # call peel_mxu without them)
        b_ms, b_by, nbytes, flops = bound_ms(
            [t for t in ins if t.is_floating_point()]
            + [t.to(torch.int32) for t in ins if not t.is_floating_point()],
            got[:1] if kname == "peel_mxu" else got, n_int, c, s, p,
            rec["dtype"], k_parts)
        rec.update({"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "flops": flops})
        log(f"[kernel] {kname} {json.dumps(rec)}")
        if not (ok and finite):
            raise AssertionError(f"{kname} {label}: kernel disagrees with its "
                                 f"plain version ({tol}): {rec}")
        checks[kname].append(rec)
        return call, got

    f64, f32 = torch.float64, torch.float32
    b2_in = peel_inputs(B2, f64)
    res_call, res_got = check("peel_resident", "benchmark2 f64", b2_in, 50,
                              5)
    check("peel_resident", "benchmark2 f32", peel_inputs(B2, f32), 50, 5)
    for dtype in (f64, f32):
        name = str(dtype).replace("torch.", "")
        check("peel_resident", f"caterpillar {name}", random_inputs(
            *B2_PEEL, 35, dtype, caterpillar=True)[0], 20, 1)
        check("peel_resident", f"ragged {name}",
              random_inputs(*RAGGED_B2, 36, dtype)[0], 50, 5)
    # the deep kernel on the benchmark2 inputs: a yardstick for the resident
    # design (the route stays resident), timed in turns
    b2_deep_call, b2_deep_got = check("peel_stream", "benchmark2 yardstick "
                                      "f64", b2_in, 50, 5)
    _, rel, _ = deviation(res_got[0], b2_deep_got[0][0])
    turns = [time_ms(c.launch, 20)
             for c in (res_call, b2_deep_call, b2_deep_call, res_call)]
    log(f"[kernel] benchmark2 f64 peel_resident vs peel_stream: max rel "
        f"{rel:.3e}; ms in turns resident {turns[0]:.4f} deep {turns[1]:.4f} "
        f"deep {turns[2]:.4f} resident {turns[3]:.4f}")
    if not rel < F64_REL_TOL:
        raise AssertionError("the two S = 4 kernels disagree at benchmark2")
    del res_call, res_got, b2_deep_call, b2_deep_got, b2_in
    mak = peel_inputs(MAKONA, f64)
    # the deep kernel: f64 on the chains' own inputs, f32 on random ones
    # (F32_CUT); K = 3 is the launch of the benchmark1 chain
    deep_call, deep_got = check("peel_stream", "makona f64", mak, 20, 2)
    b1_all = peel_inputs(B1, f64, partitions=True)
    check("peel_stream", "benchmark1 three partitions f64", b1_all, 20, 2)
    check("peel_stream", "small forced stream f64", peel_inputs(SMALL, f64),
          50, 5)
    check("peel_stream", "small forced stream f32", peel_inputs(SMALL, f32),
          50, 5)
    check("peel_stream", "makona f32",
          random_inputs(MAKONA[0], 4, 4, MAKONA[1], 31, f32, F32_CUT)[0],
          20, 2)
    check("peel_stream", "benchmark1 three partitions f32",
          random_inputs(B1[0], 1, 4, 640, 32, f32, F32_CUT, 3)[0], 20, 2)
    for dtype in (f64, f32):
        name = str(dtype).replace("torch.", "")
        cut = F32_CUT if dtype == f32 else 0.6
        check("peel_stream", f"caterpillar {name}", random_inputs(
            *CATERPILLAR, 33, dtype, cut, caterpillar=True)[0], 10, 1)
        check("peel_stream", f"ragged {name}",
              random_inputs(*RAGGED_DEEP, 34, dtype, cut)[0], 10, 2)
    del b1_all
    b1_part = peel_inputs(B1, f64)

    check("peel_stream_ring", "benchmark1 partition f64", b1_part, 20, 2)
    ring_call, ring_got = check("peel_stream_ring", "makona f64", mak, 20, 2)
    # the two streaming kernels on the same Makona inputs, timed in turns
    _, rel, _ = deviation(ring_got[0], deep_got[0][0])
    turns = [time_ms(c.launch, 10)
             for c in (ring_call, deep_call, deep_call, ring_call)]
    log(f"[kernel] makona f64 peel_stream_ring vs peel_stream: max rel "
        f"{rel:.3e}; ms in turns ring {turns[0]:.4f} deep {turns[1]:.4f} "
        f"deep {turns[2]:.4f} ring {turns[3]:.4f}")
    if not rel < F64_REL_TOL:
        raise AssertionError("the two streaming kernels disagree at Makona")
    del ring_call, ring_got, deep_call, deep_got, mak
    for dtype in (f64, f32):
        name = str(dtype).replace("torch.", "")
        check("peel_stream_ring", f"amino acid {name}",
              random_inputs(*AMINO, 20, dtype)[0], 10, 2)
        check("peel_stream_ring", f"codon {name}",
              random_inputs(*CODON, 61, dtype)[0], 10, 2)
        small = peel_inputs(SMALL, dtype)  # padded to 256 patterns: cut back
        check("peel_stream_ring", f"small ragged {name}",
              (small[0][..., :SMALL[1]].contiguous(), *small[1:]), 50, 5)

    # the matrix-product peel at the shapes of the protein and the codon
    # chain, and against the v1 streaming peel on the same inputs, in turns.
    # float64 takes the chains' own inputs. float32 takes random ones, as the
    # v1 streaming peel's checks above do: the chains' site logL is near -800,
    # where the absolute tolerance is one or two float32 steps and the plain
    # version's own float32 log-scale sum is not that close to the truth.
    for dtype in (f64, f32):
        name = str(dtype).replace("torch.", "")
        for label, shape in (("protein", AMINO), ("codon", CODON)):
            inputs = (peel_inputs(shape, dtype) if dtype == f64
                      else random_inputs(*shape, shape[2], dtype)[0])
            mxu_call, mxu_got = check("peel_mxu", f"{label} {name}", inputs,
                                      20, 2)
            ring_call, ring_got = check("peel_stream_ring",
                                        f"{label} analysis {name}", inputs,
                                        20, 2)
            err, rel, _ = deviation(mxu_got[0], ring_got[0])
            turns = [time_ms(c.launch, 10)
                     for c in (mxu_call, ring_call, ring_call, mxu_call)]
            log(f"[kernel] {label} {name} peel_mxu vs peel_stream_ring: max "
                f"abs {err:.3e} rel {rel:.3e}; ms in turns mxu "
                f"{turns[0]:.4f} ring {turns[1]:.4f} ring {turns[2]:.4f} mxu "
                f"{turns[3]:.4f}")
            if not (rel < F64_REL_TOL if dtype == f64
                    else err < 2 * F32_ABS_TOL_WIDE):
                raise AssertionError(f"the two S >= 16 kernels disagree at "
                                     f"{label} {name}")
            del mxu_call, mxu_got, ring_call, ring_got, inputs
        check("peel_mxu", f"ragged {name}",
              random_inputs(*RAGGED, 7, dtype)[0], 20, 5)
        check("peel_mxu", f"caterpillar {name}", random_inputs(
            *CATERPILLAR_MXU, 8, dtype, caterpillar=True)[0], 10, 1)

    mark("2 kernel vs plain")

    # -- phase 2, chain axis: B chains' trees, each from its own seed, in
    # one launch against the plain chain-axis version and B single launches
    def chain_inputs(shape, b_n, seed, partitions=False):
        """The analysis's tips with B chains' trees drawn from seeds seed,
        seed + 1, ... and their branch matrices from the analysis's model:
        (tips, children [B, M, 2], parent [B, M], p_matrices [B, (K,) M, C,
        S, S], freqs [B, (K,) S], cat_w [B, (K,) C])."""
        tips, ch0, _, _, _, fr, cw = peel_inputs(shape, f64, partitions)
        eig, rates = model_of(shape, partitions)
        _, _, p0, _, _ = analyses[shape]
        trees = [make_tree_state(*simulate_coalescent_tree(
            np.random.default_rng(seed + b), np.zeros(shape[0]), 0.5),
            dtype=f64, device=dev) for b in range(b_n)]
        pms = [branch_transition_matrices(eig, t.parent, t.heights,
                                          p0["clock.rate"], rates)
               for t in trees]
        return (tips, torch.stack([t.children for t in trees]),
                torch.stack([t.parent for t in trees]),
                torch.stack(pms).contiguous(),
                fr.expand(b_n, *fr.shape).contiguous(),
                cw.expand(b_n, *cw.shape).contiguous())

    def chain_check(kname, label, shape, b_n, seed, reps, plain_reps,
                    partitions=False):
        tips, ch, par, pm, fr, cw = chain_inputs(shape, b_n, seed, partitions)
        n_tips = tips.shape[-3]
        n_int = n_tips - 1
        c, s, p = pm.shape[-3], pm.shape[-2], tips.shape[-1]
        sched = cuda_stream.level_schedule(ch, n_tips, par)
        lvl_order, ids, pos, ls = sched
        wcs = cw[..., None] * fr[..., None, :]
        k_parts = 1
        if kname == "peel_resident":
            call = cuda_peeling.prepare_resident(tips, ch, None, pm, fr, cw,
                                                 sched)
            singles = [cuda_peeling.prepare_resident(
                tips, ch[b], None, pm[b], fr[b], cw[b],
                tuple(t[b] for t in sched)) for b in range(b_n)]
            plain_fn = lambda: (cuda_peeling._resident_plain(  # noqa: E731
                tips, ids, pos, ls, pm, wcs),)
            ins = [tips, pm, ids, pos, ls, fr, cw]
        elif kname == "peel_mxu":
            call = cuda_mxu.prepare_mxu(tips, ch, None, pm, fr, cw, sched)
            singles = [cuda_mxu.prepare_mxu(
                tips, ch[b], None, pm[b], fr[b], cw[b],
                tuple(t[b] for t in sched)) for b in range(b_n)]
            plain_fn = lambda: cuda_mxu._mxu_plain(  # noqa: E731
                tips, sched, pm, wcs)
            ins = [tips, pm, lvl_order.to(torch.int32), ids, ls, fr, cw]
        else:  # peel_stream: one partition, or K on each chain's tree
            if not partitions:
                tips, pm, fr, cw = tips[None], pm[:, None], fr[:, None], \
                    cw[:, None]
                wcs = wcs[:, None]
            k_parts = tips.shape[0]
            pm_ord = cuda_stream2.chains_pm_ord(pm, ids)
            call = cuda_stream2.prepare_deep(tips, ids, pos, ls, pm_ord, fr,
                                             cw)
            singles = [cuda_stream2.prepare_deep(
                tips, ids[b], pos[b], ls[b], pm_ord[b], fr[b], cw[b])
                for b in range(b_n)]
            plain_fn = lambda: (cuda_stream2._deep_plain(  # noqa: E731
                tips, ids, pos, ls, pm_ord, wcs),)
            ins = [tips, pm_ord, ids, pos, ls, fr, cw]
        got = call.launch()
        got = tuple(t.clone() for t in (got if isinstance(got, tuple)
                                        else (got,)))
        if kname == "peel_mxu":  # the tips' rows are the wrapper's
            got[1][:, :n_tips] = tips[None, :, None]
        ref = plain_fn()
        one = torch.stack([
            (lambda o: o[0] if isinstance(o, tuple) else o)(c_.launch())
            for c_ in singles])
        torch.cuda.synchronize()
        max_abs, max_rel, finite = deviation(got[0], ref[0])
        _, rel_single, _ = deviation(got[0], one)
        ok = max_rel < F64_REL_TOL and rel_single < F64_REL_TOL and finite
        rec = {"label": label, "chains": b_n,
               "shape": [k_parts, n_tips, c, s, p], "dtype": "float64",
               "levels": [int((ls[b] < n_int).sum()) for b in range(b_n)],
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "max_rel_err_vs_single_launches": rel_single,
               "tol": f"rel<{F64_REL_TOL}"}
        if len(got) == 2:
            post_abs, _, post_finite = deviation(got[1], ref[1])
            ok = ok and post_abs < F64_REL_TOL and post_finite
            rec["post_max_abs_err"] = post_abs
        del ref, one
        rec["ms"] = time_ms(call.launch, reps)
        rec["single_launches_ms"] = time_ms(
            lambda: [c_.launch() for c_ in singles], reps)
        rec["ms_over_single_launches"] = rec["ms"] / rec["single_launches_ms"]
        rec["plain_ms"] = time_ms(plain_fn, plain_reps)
        b_ms, b_by, nbytes, flops = bound_ms(
            [t for t in ins if t.is_floating_point()]
            + [t.to(torch.int32) for t in ins if not t.is_floating_point()],
            got[:1], n_int, c, s, p, "float64", k_parts * b_n)
        rec.update({"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                    "flops": flops})
        log(f"[kernel] {kname} chain axis {json.dumps(rec)}")
        if not ok:
            raise AssertionError(f"{kname} {label}: the chain-axis launch "
                                 f"disagrees ({rec['tol']}): {rec}")
        checks[kname].append(rec)

    chain_check("peel_resident", "benchmark2 B=8 f64", B2, 8, 100, 20, 1)
    chain_check("peel_stream", "makona B=4 f64", MAKONA, 4, 110, 10, 1)
    chain_check("peel_stream", "benchmark1 K=3 B=4 f64", B1, 4, 120, 10, 1,
                partitions=True)
    chain_check("peel_mxu", "protein B=4 f64", AMINO, 4, 130, 10, 1)
    mark("2 chain axis")

    # the card's log posterior against the CPU's plain path, small input
    lp_s, _, p_s, t_s, _ = analyses[SMALL]
    lp_cpu, _, p_c, t_c, _ = build_analysis(*SMALL, model="gtr_gamma",
                                            device="cpu", dtype=torch.float64)
    a, b = float(lp_s(p_s, t_s)), float(lp_cpu(p_c, t_c))
    log(f"[logpost] card {a!r} cpu {b!r} rel {abs(a - b) / abs(b):.3e}")
    if not abs(a - b) <= 1e-10 * abs(b):
        raise AssertionError("card and CPU log posteriors disagree")

    mark("2 log posterior")

    # -- phase 6b: gradients through every kernel route ----------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from beast_mcmc_tpu_torch.ops.peeling import post_by_node

    def device_ms(fn, label, n=1, top=6):
        """(wall ms, device-busy ms) of fn() under the profiler, per one of
        its `n` repeats, device events only, with the `top` device kernels
        logged under `label`; busy None where the profiler saw no device
        time."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        log(f"[profile {label}] wall {1e3 * wall / n:.3f} ms, device busy "
            f"{busy / n:.3f} ms, {sum(e.count for e in kern) / n:.1f} device "
            f"events, each of {n}")
        for e in kern[:top]:
            log(f"[profile {label}]   {e.self_device_time_total / 1e3 / n:9.4f}"
                f" ms {e.count / n:7.1f}x  {e.key[:70]}")
        return 1e3 * wall / n, (busy / n if busy > 0 else None)

    grad_checks = {k: [] for k in KERNELS}

    def grad_check(kname, label, inputs):
        """The route's gradient of sum(g * site logL) with respect to the
        matrices, freqs and category weights against the node-by-node plain
        peel's on the same card; the route's partials against its plain
        version's; times and bounds."""
        tips, ch, order, root, pm, fr, cw = inputs
        k_parts = tips.shape[0] if tips.dim() == 4 else None
        n_tips = tips.shape[-3]
        n_int = n_tips - 1
        c, s, p = pm.shape[-3], pm.shape[-2], tips.shape[-1]
        lvl = cuda_stream.level_schedule(ch, n_tips)
        l_order, ids, pos, ls = lvl
        wcs = cw[..., None] * fr[..., None, :]
        g = torch.rand(tips.shape[:-3] + (p,), dtype=f64, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(7))
        if kname == "peel_resident":
            def entry(*x):
                return cuda_peeling.peel_site_loglik_cuda(tips, ch, order,
                                                          root, *x, lvl)
            site_k, pos_k = cuda_peeling._peel_resident_kernel(
                tips, ch, order, pm, fr, cw, lvl, want_post=True)
            _, pos_p = cuda_peeling._resident_plain(tips, ids, pos, ls, pm,
                                                    wcs, want_post=True)
            res_k = post_by_node(pos_k[None], tips[None], l_order)
            res_p = post_by_node(pos_p[None], tips[None], l_order)
            ins = [tips, pm, ids, pos, ls, fr, cw]
        elif kname == "peel_stream":
            def entry(*x):
                return cuda_stream2.peel_site_loglik_deep(tips, ch, None,
                                                          root, *x, lvl)
            t4, pm4, fr4, cw4 = ((tips, pm, fr, cw) if k_parts else
                                 (tips[None], pm[None], fr[None], cw[None]))
            pm_ord = pm4[:, ids.long()].contiguous()
            site_k, pos_k = cuda_stream2._peel_deep_kernel(
                t4, ids, pos, ls, pm_ord, fr4, cw4, want_post=True)
            _, pos_p = cuda_stream2._deep_plain(
                t4, ids, pos, ls, pm_ord, cw4[:, :, None] * fr4[:, None],
                want_post=True)
            res_k = post_by_node(pos_k, t4, l_order)
            res_p = post_by_node(pos_p, t4, l_order)
            ins = [tips, pm_ord, ids, pos, ls, fr, cw]
        elif kname == "peel_mxu":
            def entry(*x):
                return cuda_mxu.peel_site_loglik_mxu(tips, ch, order, root,
                                                     *x, lvl)
            site_k, res_k = cuda_mxu._peel_forward_mxu(tips, ch, order, pm,
                                                       fr, cw, True, lvl)
            _, res_p = cuda_mxu._mxu_plain(tips, lvl, pm, wcs)
            ins = [tips, pm, l_order.to(torch.int32), ids, ls, fr, cw]
        else:
            sched = cuda_stream.stream_schedule(ch, order)

            def entry(*x):
                return cuda_stream.peel_site_loglik_stream(tips, ch, order,
                                                           root, *x, sched)
            site_k, pos_k = cuda_stream._stream_forward(tips, ch, order, pm,
                                                        fr, cw, sched)
            _, pos_p = cuda_stream._stream_plain(tips, *sched, pm[sched[0]],
                                                 wcs)
            res_k = post_by_node(pos_k[None], tips[None], order)
            res_p = post_by_node(pos_p[None], tips[None], order)
            ins = [tips, pm[sched[0]], *sched, fr, cw]

        def plain_entry(pm_, fr_, cw_):  # the node-by-node peel, per tree
            if k_parts is None:
                return plain.peel_site_loglik(tips, ch, order, root, pm_, fr_,
                                              cw_)
            return torch.stack([plain.peel_site_loglik(
                tips[k], ch, order, root, pm_[k], fr_[k], cw_[k])
                for k in range(k_parts)])

        leaves = [t.detach().clone().requires_grad_(True) for t in (pm, fr, cw)]

        def grads(fn):
            return torch.autograd.grad(torch.sum(g * fn(*leaves)), leaves)

        reset_counts()
        got = grads(entry)
        torch.cuda.synchronize()
        launches_per_grad = read_counts()
        ref = grads(plain_entry)
        rel = {name: ((a - b).abs().max() / b.abs().max()).item()
               for name, a, b in zip(("p_matrices", "freqs", "cat_w"), got,
                                     ref)}
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        post_err = (res_k - res_p).abs().max().item()
        rec = {"label": label, "shape": [n_tips, c, s, p],
               "partitions": k_parts or 1, "grad_max_rel_err": rel,
               "grad_tol": f"rel<{GRAD_REL_TOL}", "post_max_abs_err": post_err,
               "post_tol": f"abs<{POST_ABS_TOL}",
               "launches_per_gradient": launches_per_grad}
        del ref, res_k, res_p
        rec["ms_forward"] = time_ms(lambda: entry(pm, fr, cw), 20)
        rec["ms_forward_residual"] = time_ms(lambda: entry(*leaves), 10)
        times = []
        for _ in range(11):
            total = torch.sum(g * entry(*leaves))
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.autograd.grad(total, leaves)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        rec["ms_backward"] = statistics.median(times[1:])
        total = torch.sum(g * entry(*leaves))
        torch.cuda.synchronize()
        _, rec["device_ms_backward"] = device_ms(
            lambda: torch.autograd.grad(total, leaves),
            f"backward {kname} {label}")
        # the bound of the forward, and of the forward with its partials
        # [n_int, C, S, P] (a partition) counted as an output
        ints = [t.to(torch.int32) for t in ins if not t.is_floating_point()]
        floats = [t for t in ins if t.is_floating_point()]
        b_ms, b_by, _, _ = bound_ms(floats + ints, [site_k], n_int, c, s, p,
                                    "float64", k_parts or 1)
        post_out = torch.empty((k_parts or 1, n_int, c, s, p), dtype=f64,
                               device="meta")  # counted, never written
        bp_ms, bp_by, _, _ = bound_ms(floats + ints, [site_k, post_out],
                                      n_int, c, s, p, "float64", k_parts or 1)
        rec.update({"bound_ms": b_ms, "bound_by": b_by,
                    "bound_post_ms": bp_ms, "bound_post_by": bp_by})
        log(f"[grad] {kname} {json.dumps(rec)}")
        ok = (finite and all(v <= GRAD_REL_TOL for v in rel.values())
              and post_err <= POST_ABS_TOL
              and launches_per_grad == {k: int(k == kname) for k in KERNELS})
        if not ok:
            raise AssertionError(f"{kname} {label}: the gradient through the "
                                 f"kernel disagrees with the plain peel's, or "
                                 f"its partials do: {rec}")
        grad_checks[kname].append(rec)

    grad_check("peel_resident", "benchmark2 f64", peel_inputs(B2, f64))
    grad_check("peel_stream", "makona f64", peel_inputs(MAKONA, f64))
    grad_check("peel_stream", "benchmark1 three partitions f64",
               peel_inputs(B1, f64, partitions=True))
    grad_check("peel_mxu", "protein float64", peel_inputs(AMINO, f64))
    grad_check("peel_mxu", "codon float64", peel_inputs(CODON, f64))
    grad_check("peel_stream_ring", "benchmark1 partition f64",
               peel_inputs(B1, f64))

    mark("6b gradients")

    # -- phases 3 to 5: the chains -------------------------------------
    def chain(label, shape, n_steps, n_check, per_step, seed):
        """Run the chain of one analysis; `per_step` is the launches each
        kernel must count for one step."""
        log_post, ops, p0, tr0, aux = analyses[shape]
        lpc = aux["log_post_cached"]
        step = make_mcmc_step(lpc, ops, derived=aux["derived"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_mcmc_state(p0, tr0, gen, ops, lpc)
        state, _ = run_chain(step, state, 20)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, _ = run_chain(step, state, n_steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        lp = float(state.log_posterior)
        log(f"[chain {label}] {n_steps} steps in {dt:.3f} s = "
            f"{n_steps / dt:.2f} states/s; log posterior {lp!r}; "
            f"launches {json.dumps(counts)}")
        log(operator_report(ops, state))
        expect = {k: n_steps * per_step.get(k, 0) for k in KERNELS}
        if counts != expect:
            raise AssertionError(f"expected launches {expect}, got {counts}")
        if lp != lp or lp == float("inf") or lp == -float("inf"):
            raise AssertionError(f"posterior not finite: {lp}")
        t0 = time.perf_counter()
        state, dev_max = full_evaluation_check(step, log_post, state, n_check,
                                               derived=aux["derived"])
        dev_max = float(dev_max)
        log(f"[chain {label}] full-evaluation max deviation over {n_check} "
            f"steps: {dev_max!r} (tolerance {FULL_EVAL_TOL}) in "
            f"{time.perf_counter() - t0:.2f} s")
        if not dev_max < FULL_EVAL_TOL:
            raise AssertionError(f"full-evaluation deviation {dev_max}")
        return counts, n_steps / dt, step, state

    b2_counts, b2_rate, b2_step, b2_state = chain(
        "benchmark2", B2, B2_STEPS, B2_CHECK, {"peel_resident": 1}, 0)
    mak_counts, mak_rate, mak_step, mak_state = chain(
        "makona", MAKONA, MAK_STEPS, MAK_CHECK, {"peel_stream": 1}, 1)
    b1_counts, b1_rate, b1_step, b1_state = chain(
        "benchmark1", B1, B1_STEPS, B1_CHECK, {"peel_stream": 1}, 2)
    aa_counts, aa_rate, aa_step, aa_state = chain(
        "protein", AMINO, PC_STEPS, PC_CHECK, {"peel_mxu": 1}, 3)
    cod_counts, cod_rate, cod_step, cod_state = chain(
        "codon", CODON, PC_STEPS, PC_CHECK, {"peel_mxu": 1}, 4)

    # where the time of a step goes: a profiler window over the chain
    def where_time_goes(label, step, state, n_steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = run_chain(step, state, n_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (kernels, copies): an operator's own
        # entry would count its kernels' time a second time
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kern) / 1e6
        if busy <= 0:
            log(f"[profile {label}] device time not measured by the profiler")
            return
        sorts = sum(e.count for e in prof.key_averages()
                    if e.key == "aten::sort")
        log(f"[profile {label}] {n_steps} steps, wall {wall:.4f} s "
            f"(profiled), device busy {busy:.4f} s = "
            f"{100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%, "
            f"{sum(e.count for e in kern) / n_steps:.1f} device events/step, "
            f"{sorts / n_steps:.2f} sorts/step")
        for e in kern[:8]:
            log(f"[profile {label}]   {e.self_device_time_total / 1e3:9.3f} ms"
                f"  {e.count:6d}x  {e.key[:70]}")
        # the host side: the operators and launches with most own CPU time
        host = sorted((e for e in prof.key_averages()
                       if e.device_type != DeviceType.CUDA),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in host[:5]:
            log(f"[profile {label}]   host {e.self_cpu_time_total / 1e3:9.3f}"
                f" ms  {e.count:6d}x  {e.key[:70]}")

    where_time_goes("benchmark2", b2_step, b2_state, 200)
    where_time_goes("makona", mak_step, mak_state, 50)
    where_time_goes("benchmark1", b1_step, b1_state, 50)
    where_time_goes("protein", aa_step, aa_state, 50)
    where_time_goes("codon", cod_step, cod_state, 50)
    mark("3 to 6 chains and profiles")

    # -- phase 6c: HMC on the node heights and on (clock.rate, pop.size) --
    from beast_mcmc_tpu_torch.inference.hmc import (
        HmcOperator, NodeHeightHmcOperator)

    def hmc_chain(label, shape, n_steps, n_check, kname, seed):
        """build_analysis's chain with both HMC operators added: each HMC
        operator alone first (launches, wall and device time a proposal),
        then the mixed chain (launches, acceptance, full evaluation)."""
        log_post, ops, p0, tr0, aux = analyses[shape]
        lpc = aux["log_post_cached"]
        hmc = [NodeHeightHmcOperator(weight=HMC_WEIGHTS[0],
                                     n_leapfrog=HMC_LEAPFROG,
                                     step_size=HMC_STEP),
               HmcOperator(parameters=("clock.rate", "pop.size"),
                           weight=HMC_WEIGHTS[1], n_leapfrog=HMC_LEAPFROG,
                           step_size=HMC_STEP)]
        rec = {"label": label, "n_leapfrog": HMC_LEAPFROG,
               "step_size_start": HMC_STEP, "weights": list(HMC_WEIGHTS),
               "other_weights": sum(op.weight for op in ops)}
        for op in hmc:
            name = type(op).__name__
            alone = make_mcmc_step(lpc, [op], derived=aux["derived"])
            st = init_mcmc_state(p0, tr0, torch.Generator(
                device=dev).manual_seed(seed), [op], lpc)
            st, _ = run_chain(alone, st, 2)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            st, _ = run_chain(alone, st, HMC_ALONE)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / HMC_ALONE
            counts = read_counts()
            _, busy = device_ms(lambda: run_chain(alone, st, 2),
                                f"hmc {label} {name}", 2, 10)
            # st's statistics count every proposal made from it: warm-up,
            # measured and profiled
            rec[name] = {"ms_per_proposal": wall,
                         "device_ms_per_proposal": busy or "not measured",
                         "launches": counts, "proposals": HMC_ALONE,
                         "accepted_of_all": int(st.op_accept[0]),
                         "proposed_in_all": int(st.op_accept[0]
                                                + st.op_reject[0])}
            expect = {k: HMC_ALONE * (2 * op.n_leapfrog + 1) * (k == kname)
                      for k in KERNELS}
            if counts != expect:
                raise AssertionError(f"{label} {name}: expected launches "
                                     f"{expect}, got {counts}")
        all_ops = [*ops, *hmc]
        step = make_mcmc_step(lpc, all_ops, derived=aux["derived"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_mcmc_state(p0, tr0, gen, all_ops, lpc)
        state, _ = run_chain(step, state, 20)  # warm-up
        torch.cuda.synchronize()
        drawn0 = (state.op_accept + state.op_reject).tolist()
        reset_counts()
        t0 = time.perf_counter()
        state, _ = run_chain(step, state, n_steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        drawn = [a - b for a, b in zip(
            (state.op_accept + state.op_reject).tolist(), drawn0)]
        n_hmc = drawn[-2:]
        acc = state.op_accept.tolist()[-2:]
        tot = [a + r for a, r in zip(acc, state.op_reject.tolist()[-2:])]
        expect = {k: (n_steps + sum(2 * op.n_leapfrog * n
                                    for op, n in zip(hmc, n_hmc)))
                  * (k == kname) for k in KERNELS}
        rec.update({"steps": n_steps, "seconds": dt,
                    "states_per_s": n_steps / dt, "launches": counts,
                    "hmc_proposals": n_hmc,
                    "acceptance": [a / max(t, 1) for a, t in zip(acc, tot)],
                    "step_size_end": [float(op.tuning(state.op_adapt[i]))
                                      for i, op in zip((-2, -1), hmc)]})
        state, dev_max = full_evaluation_check(step, log_post, state, n_check,
                                               derived=aux["derived"])
        rec["full_eval_max_deviation"] = float(dev_max)
        log(f"[hmc {label}] {json.dumps(rec)}")
        log(operator_report(all_ops, state))
        if counts != expect:
            raise AssertionError(f"{label}: expected launches {expect} "
                                 f"(2 n_leapfrog + 1 an HMC proposal), got "
                                 f"{counts}")
        if not all(a > 0 for a in acc):
            raise AssertionError(f"{label}: an HMC operator accepted nothing")
        if not rec["full_eval_max_deviation"] < FULL_EVAL_TOL:
            raise AssertionError(f"{label}: full-evaluation deviation "
                                 f"{rec['full_eval_max_deviation']}")
        return counts, rec

    b2_hmc_counts, b2_hmc = hmc_chain("benchmark2", B2, HMC_B2_STEPS,
                                      HMC_B2_CHECK, "peel_resident", 5)
    mak_hmc_counts, mak_hmc = hmc_chain("makona", MAKONA, HMC_MAK_STEPS,
                                        HMC_MAK_CHECK, "peel_stream", 6)

    mark("6c HMC")

    # -- phase 6d: NUTS, the PDMPs, slice, AVMVN and the constrained HMC --
    t0 = time.perf_counter()
    p7, p7_launches = sampler_paths({
        "benchmark2": (analyses[B2], (b2_state.params, b2_state.tree),
                       "peel_resident"),
        "benchmark1": (analyses[B1], (b1_state.params, b1_state.tree),
                       "peel_stream"),
        "protein": (analyses[AMINO], (aa_state.params, aa_state.tree),
                    "peel_mxu"),
        "makona": (analyses[MAKONA], (mak_state.params, mak_state.tree),
                   "peel_stream")}, reset_counts, read_counts, device_ms, dev)
    log(f"[p7] phase 6d in {time.perf_counter() - t0:.2f} s")

    mark("6d samplers")

    # -- phase 7: the remaining entry points ---------------------------
    # per-site log-likelihoods go through the same dispatcher as the chains
    for label, shape, kname in (("benchmark2", B2, "peel_resident"),
                                ("makona", MAKONA, "peel_stream")):
        _, _, p0, tr, aux = analyses[shape]
        rates, cw = p0["site.rates"]
        reset_counts()
        got = tree_site_logliks(aux["tips"], tr.parent, tr.children,
                                tr.heights, tr.root, p0["eig"], aux["freqs"],
                                rates, cw, p0["clock.rate"])
        counts = read_counts()
        _, rel, finite = deviation(
            got, plain.peel_site_loglik(*peel_inputs(shape, f64)))
        log(f"[entry] tree_site_logliks {label}: max rel {rel:.3e} against "
            f"the plain peel; launches {json.dumps(counts)}")
        if counts != {k: int(k == kname) for k in KERNELS}:
            raise AssertionError(f"tree_site_logliks at {label} did not go "
                                 f"through {kname} once")
        if not (finite and rel < F64_REL_TOL):
            raise AssertionError("tree_site_logliks disagrees with the plain "
                                 "peel")
    # likelihoods from caller-built matrices: the dispatcher sends S = 20 to
    # the matrix-product kernel and S = 8 to the v1 streaming kernel
    for shape, kname in ((AMINO, "peel_mxu"), ((40, 2, 8, 300),
                                               "peel_stream_ring")):
        reset_counts()
        (tips, ch, order, root, pm, fr, cw), tr = random_inputs(*shape, 20,
                                                                f64)
        w = torch.ones(shape[3], dtype=f64, device=dev)
        got = float(tree_loglikelihood_pmats(tips, w, ch, tr.heights, root,
                                             tr.parent, pm, fr, cw))
        ref = float(plain.peel_loglikelihood(tips, ch, order, root, pm, fr,
                                             cw, w))
        log(f"[entry] tree_loglikelihood_pmats S={shape[2]} card {got!r} "
            f"plain {ref!r} launches {json.dumps(read_counts())}")
        if read_counts() != {k: int(k == kname) for k in KERNELS}:
            raise AssertionError(f"S = {shape[2]} did not go through {kname} "
                                 f"once")
        if not abs(got - ref) <= F64_REL_TOL * abs(ref):
            raise AssertionError("tree_loglikelihood_pmats disagrees with "
                                 "the plain peel")
    # real sequences: amino-acid strings (an ambiguity code and a gap among
    # them) from the alignment to the likelihood, on the card and on the CPU
    pats = SitePatterns.from_alignment(Alignment.from_sequences(
        ["a", "b", "c", "d", "e"],
        ["ACDEFGHIKLMNPQRSTVWYAC", "ACDEWGHIKLMNPQRSTVWYAC",
         "ACDEYGHLKLMNPQRSTVWXAC", "ACDEFGHIKIMNPQ-STVWYAC",
         "GCDEFGHIKLMNPQRSTVFYAC"], AMINO_ACIDS))
    tree_np = simulate_coalescent_tree(np.random.default_rng(5), np.zeros(5),
                                       0.2)
    reset_counts()
    vals = {}
    for where in (dev, "cpu"):
        tr = make_tree_state(*tree_np, dtype=f64, device=where)
        fr = torch.tensor(AA_MODELS["WAG"]["frequencies"], dtype=f64,
                          device=where)
        rates, cw = single_rate(dtype=f64, device=where)
        vals[where] = float(tree_loglikelihood(
            torch.tensor(pats.tip_partials().transpose(0, 2, 1), dtype=f64,
                         device=where).contiguous(),
            torch.tensor(pats.weights, dtype=f64, device=where), tr.parent,
            tr.children, tr.heights, tr.root, empirical_aa_eigen("WAG", fr),
            fr, rates, cw, 1.0))
    log(f"[entry] WAG on 5 sequences, {pats.n_patterns} patterns of "
        f"{pats.n_sites} sites: card {vals[dev]!r} cpu {vals['cpu']!r} "
        f"launches {json.dumps(read_counts())}")
    if read_counts() != {k: int(k == "peel_mxu") for k in KERNELS}:
        raise AssertionError("the sequences did not go through peel_mxu once")
    if not (abs(vals[dev] - vals["cpu"]) <= F64_REL_TOL * abs(vals["cpu"])
            and vals["cpu"] < 0):
        raise AssertionError("card and CPU disagree on the sequences")
    reset_counts()
    # the benchmark1 likelihood at the chain's last state: the chain's route
    # (one deep launch) against the streaming entry point, by partition
    _, _, _, _, aux = analyses[B1]
    prm, tr = b1_state.params, b1_state.tree
    via_chain = float(aux["log_lik"](prm, tr))
    order = peel_order_from_heights(tr.heights, B1[0], tr.parent)
    rates, cw = single_rate(dtype=f64, device=dev)
    via_ring = 0.0
    for k in range(3):
        pm = branch_transition_matrices(
            hky_eigen(prm["kappa"][k], aux["freqs"]), tr.parent, tr.heights,
            prm["clock.rate"], prm["mu"][k] * rates)
        via_ring += float(cuda_stream.peel_loglikelihood_stream(
            aux["tips"][k], tr.children, order, tr.root, pm, aux["freqs"], cw,
            aux["weights"][k]))
    ring_counts = read_counts()
    log(f"[entry] benchmark1 log likelihood: chain's route {via_chain!r}, "
        f"peel_loglikelihood_stream {via_ring!r}; launches "
        f"{json.dumps(ring_counts)}")
    if ring_counts != {"peel_resident": 0, "peel_stream": 1,
                       "peel_stream_ring": 3, "peel_mxu": 0}:
        raise AssertionError(f"unexpected launches {ring_counts}")
    if not abs(via_chain - via_ring) <= F64_REL_TOL * abs(via_chain):
        raise AssertionError("the two routes disagree at benchmark1")

    mark("7 entry points")

    # -- phase 8: chain batches, MC3 and the component cache -----------
    p8, p8_launches = chain_paths({
        "benchmark2": (analyses[B2], "peel_resident", b2_rate),
        "makona": (analyses[MAKONA], "peel_stream", mak_rate),
        "benchmark1": (analyses[B1], "peel_stream", b1_rate),
        "protein": (analyses[AMINO], "peel_mxu", aa_rate)},
        reset_counts, read_counts, device_ms, dev)
    mark("8 chain batches")

    # -- phase 9: the Makona-1610 joint analysis -----------------------
    from beast_mcmc_tpu_torch.apps.benchmarks import (
        clock_rates, gtr_site_model)
    from beast_mcmc_tpu_torch.apps.makona import build_makona_joint

    t0 = time.perf_counter()
    joint = build_makona_joint(seed=JOINT_SEED, device=dev)
    torch.cuda.synchronize()
    _, _, j_p0, j_t0, j_aux = joint
    n_taxa = j_aux["tips"].shape[0]
    j_rec = {"build_seconds": time.perf_counter() - t0,
             "taxa": n_taxa, "sites": j_aux["config"]["n_sites"],
             "patterns": j_aux["n_patterns"],
             "patterns_padded": j_aux["tips"].shape[-1],
             "locations": j_aux["geo_tips"].shape[1],
             "rates": int(j_p0["geo.rates"].numel())}
    log(f"[joint] built in {j_rec['build_seconds']:.2f} s: {json.dumps(j_rec)}")
    # peel_stream against its plain version on the joint's own inputs:
    # dated tips, relaxed-clock branch lengths, the simulated patterns
    eig, freqs, rates, cw = gtr_site_model(j_p0, 4)
    pm = branch_transition_matrices(eig, j_t0.parent, j_t0.heights,
                                    clock_rates(j_p0), rates)
    check("peel_stream", "makona joint f64", (
        j_aux["tips"], j_t0.children,
        peel_order_from_heights(j_t0.heights, n_taxa, j_t0.parent),
        j_t0.root, pm.contiguous(), freqs, cw), 20, 2)
    del pm
    j_chain, j_launches, j_step, j_state = joint_path(
        joint, reset_counts, read_counts, dev)
    j_rec.update(j_chain)
    where_time_goes("makona joint", j_step, j_state, JOINT_PROFILE)
    mark("9 makona joint")

    # -- phase 10: summary --------------------------------------------
    def entry(kname, source, replaces, launches, label):
        rec = next(r for r in checks[kname] if r["label"] == label)
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "checks": checks[kname], "gradients": grad_checks[kname]}

    log(f"[summary] states/s: benchmark2 {b2_rate:.2f}, makona "
        f"{mak_rate:.2f}, benchmark1 {b1_rate:.2f}, protein {aa_rate:.2f}, "
        f"codon {cod_rate:.2f}; with HMC benchmark2 "
        f"{b2_hmc['states_per_s']:.2f}, makona {mak_hmc['states_per_s']:.2f}; "
        f"on {smi_line}")
    def per_proposal(rec, key, less=0):
        return [r[key] - less for r in rec["proposals"]]

    nuts_b2 = p7["benchmark2"]["NutsOperator alone"]
    nuts_mak = p7["makona"]["NutsOperator alone"]
    zz, bps = (p7["protein"][f"{name} alone"]
               for name in ("ZigZagOperator", "BouncyParticleOperator"))
    log(f"[summary p7] states/s: benchmark2 with NUTS, slice and AVMVN "
        f"{p7['benchmark2']['chain']['states_per_s']:.2f}, benchmark1 with "
        f"reflective HMC and MVN "
        f"{p7['benchmark1']['chain']['states_per_s']:.2f}, protein with "
        f"Zig-Zag and BPS {p7['protein']['chain']['states_per_s']:.2f}; NUTS "
        f"n_lf a proposal benchmark2 {per_proposal(nuts_b2, 'n_leapfrog')} "
        f"makona {per_proposal(nuts_mak, 'n_leapfrog')}, launches a proposal "
        f"(n_lf + 1) benchmark2 "
        f"{per_proposal(nuts_b2, 'launches_in_step', 1)} makona "
        f"{per_proposal(nuts_mak, 'launches_in_step', 1)}; PDMP events a "
        f"proposal Zig-Zag {per_proposal(zz, 'events')} BPS "
        f"{per_proposal(bps, 'events')}; on {smi_line}")
    log(f"[summary p8] aggregate states/s: benchmark2 B=8 "
        f"{p8['P8a']['aggregate_states_per_s']:.2f} (one chain "
        f"{b2_rate:.2f}), makona B=4 "
        f"{p8['P8b']['aggregate_states_per_s']:.2f} ({mak_rate:.2f}), "
        f"protein B=4 {p8['P8d']['aggregate_states_per_s']:.2f} "
        f"({aa_rate:.2f}), MC3 benchmark1 B=4 "
        f"{p8['P8c']['aggregate_states_per_s']:.2f} ({b1_rate:.2f}), swap "
        f"acceptance {p8['P8c']['swap_acceptance']:.3f} at delta "
        f"{p8['P8c']['delta']:.6g}; components at benchmark2 "
        f"{p8['P8e']['likelihood_steps']} launches in "
        f"{p8['P8e']['steps']} steps; on {smi_line}")
    log(f"[summary p9] makona joint: {j_rec['taxa']} taxa, "
        f"{j_rec['patterns']} patterns ({j_rec['patterns_padded']} padded), "
        f"{j_rec['locations']} locations, {j_rec['rates']} rates; "
        f"{j_rec['states_per_s']:.2f} states/s; peel_stream launches "
        f"{j_launches['peel_stream']} = steps refreshing treeLikelihood "
        f"{j_rec['tree_likelihood_steps']} of {j_rec['steps']}; "
        f"full-evaluation deviation {j_rec['full_evaluation_deviation']!r}; "
        f"on {smi_line}")
    log(f"[phases] {json.dumps(phases)}")
    log(smi_line)
    print(json.dumps({"kernels": [
        entry("peel_resident", "beast_mcmc_tpu_torch/csrc/peel_resident.cu",
              "beast_mcmc_tpu/ops/pallas_peeling.py:52",
              b2_counts["peel_resident"], "benchmark2 f64"),
        entry("peel_stream", "beast_mcmc_tpu_torch/csrc/peel_stream.cu",
              "beast_mcmc_tpu/ops/pallas_stream2.py:64",
              mak_counts["peel_stream"], "makona f64"),
        entry("peel_stream_ring",
              "beast_mcmc_tpu_torch/csrc/peel_stream_ring.cu",
              "beast_mcmc_tpu/ops/pallas_stream.py:62",
              ring_counts["peel_stream_ring"],
              "benchmark1 partition f64"),
        entry("peel_mxu", "beast_mcmc_tpu_torch/csrc/peel_mxu.cu",
              "beast_mcmc_tpu/ops/pallas_mxu.py:67",
              aa_counts["peel_mxu"], "protein float64"),
    ], "launches_per_path": {"benchmark2": b2_counts, "makona": mak_counts,
                             "benchmark1": b1_counts, "protein": aa_counts,
                             "codon": cod_counts,
                             "benchmark2 with HMC": b2_hmc_counts,
                             "makona with HMC": mak_hmc_counts,
                             "benchmark2 P7a": p7_launches["benchmark2"],
                             "benchmark1 P7b": p7_launches["benchmark1"],
                             "protein P7c": p7_launches["protein"],
                             "makona P7d": p7_launches["makona"],
                             "stream entry points": ring_counts,
                             **p8_launches,
                             "makona joint": j_launches}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
  7. the remaining entry points: tree_site_logliks at the benchmark2 and
     Makona shapes (one resident and one deep launch), a 20-state and an
     8-state likelihood by tree_loglikelihood_pmats (one matrix-product and
     one v1 streaming launch), a few real amino-acid sequences from
     Alignment to tree_loglikelihood against the CPU, and the benchmark1
     likelihood partition by partition by peel_loglikelihood_stream (the v1
     streaming kernel) against the chain's route (one deep launch).

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

It prints the card's name and power limit, one {"kernels": [...]} line,
and last {"ok": true, "device": {...}}. It imports nothing of JAX and
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
    a strict clock and a constant coalescent. `model(params, cached)` gives
    (eigensystem, category rates, category weights), from the derived
    entries of `params` when `cached`."""
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

    def log_prior(params, tree):
        return (one_on_x_logpdf(params["pop.size"])
                + lognormal_logpdf(params["clock.rate"], 0.0, 1.0)
                + constant_coalescent_loglik(tree.heights, n_taxa,
                                             params["pop.size"]))

    def log_post(params, tree):
        return log_lik(params, tree) + log_prior(params, tree)

    def log_post_cached(params, tree):
        return log_lik(params, tree, cached=True) + log_prior(params, tree)

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
           "log_post_cached": log_post_cached}
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

    def peel_inputs(shape, dtype, partitions=False):
        """(tips, children, order, root, p_matrices, freqs, cat_w) of an
        analysis at its start; partition 0 of the benchmark1 one, or with
        `partitions` all three ([K, ...] tips, matrices, freqs, weights)."""
        _, _, p0, t0_, aux = analyses[shape]
        tips, freqs = aux["tips"], aux["freqs"]
        if shape == B1 and partitions:
            freqs = freqs.expand(3, 4)
            eig = hky_eigen(p0["kappa"], freqs)
            rates, cw = single_rate(dtype=torch.float64, device=dev)
            rates, cw = p0["mu"][:, None] * rates, cw.expand(3, 1)
        elif shape == B1:
            tips = tips[0]
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
        pm = branch_transition_matrices(eig, t0_.parent, t0_.heights,
                                        p0["clock.rate"], rates)
        order = peel_order_from_heights(t0_.heights, shape[0], t0_.parent)
        return (tips.to(dtype).contiguous(), t0_.children, order,
                t0_.root, pm.to(dtype).contiguous(), freqs.to(dtype),
                cw.to(dtype))

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

    # the card's log posterior against the CPU's plain path, small input
    lp_s, _, p_s, t_s, _ = analyses[SMALL]
    lp_cpu, _, p_c, t_c, _ = build_analysis(*SMALL, model="gtr_gamma",
                                            device="cpu", dtype=torch.float64)
    a, b = float(lp_s(p_s, t_s)), float(lp_cpu(p_c, t_c))
    log(f"[logpost] card {a!r} cpu {b!r} rel {abs(a - b) / abs(b):.3e}")
    if not abs(a - b) <= 1e-10 * abs(b):
        raise AssertionError("card and CPU log posteriors disagree")

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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    where_time_goes("benchmark2", b2_step, b2_state, 200)
    where_time_goes("makona", mak_step, mak_state, 50)
    where_time_goes("benchmark1", b1_step, b1_state, 50)
    where_time_goes("protein", aa_step, aa_state, 50)
    where_time_goes("codon", cod_step, cod_state, 50)

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

    # -- phase 8: summary ---------------------------------------------
    def entry(kname, source, replaces, launches, label):
        rec = next(r for r in checks[kname] if r["label"] == label)
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "checks": checks[kname]}

    log(f"[summary] states/s: benchmark2 {b2_rate:.2f}, makona "
        f"{mak_rate:.2f}, benchmark1 {b1_rate:.2f}, protein {aa_rate:.2f}, "
        f"codon {cod_rate:.2f}, on {smi_line}")
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
                             "stream entry points": ring_counts}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

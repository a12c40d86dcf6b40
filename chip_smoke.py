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
     peel (by levels) at S = 2, 4, 8, 20 and 61 (one benchmark1 partition,
     Makona, the small ragged shape, caterpillars at S = 4 and 20, the
     GY94+Gamma4 inputs of phase 11), partials included, timed in turns
     with the deep peel at Makona, and the matrix-product peel (by levels)
     at the protein (S = 20) and codon (S = 61) shapes, a ragged small one
     and a caterpillar of 128 taxa, partials included, timed in turns with
     the v1 streaming peel on the same inputs; hold the card's log
     posterior against the CPU's on a small analysis;
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
     B = 4 and at B = 4 x K = 3, peel_mxu at B = 4, peel_stream_ring at B
     = 4 at the GY94+Gamma4 and benchmark1-partition shapes, the chains'
     trees from their own seeds) against its plain chain-axis version and B
     single launches, and times the one launch against the B.
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
     The chain writes what the document's <log> and <logTree> ask for
     (apps/makona.py::run_joint_logged): makona_joint.log every
     JOINT_LOG_EVERY steps (the five columns) and makona_joint.trees every
     JOINT_TREE_EVERY, each node annotated with a joint draw of its
     location, into build/smoke/; the tree file is read back with the
     port's parse_newick (1,610 tips, a location of the 56 on every node,
     the tips' their data) and the host ms of an annotated draw reported.
  10. chain batches and MC3 with the operators that bind the posterior
     (`chain_gradient_checks`, `bound_chain_paths`). P10g: each chain-axis
     route's gradient (B chains' trees from their own seeds: resident at
     benchmark2 x 8, deep at Makona x 4 and benchmark1 K = 3 x 4,
     matrix-product at protein x 4) against the same level adjoint over the
     route's plain chain-axis forward and against each chain's
     single-chain kernel gradient, its partials against the plain ones,
     one launch a gradient, the backward timed beside B single backwards;
     log_post_chains' gradient in every chain's heights and rates against
     each chain's log_post's. P10a benchmark2 x 8 with node-height HMC and
     HMC on (clock.rate, pop.size), P10b Makona x 4 with node-height HMC
     and NUTS, P10c protein x 4 with Zig-Zag and BPS, P10d MC3 at
     benchmark1 on 4 chains with reflective HMC on the kappas and slice on
     pop.size: each bound operator alone over the batch (its report + 1
     launches a step), then the mixed batch, its launches the steps plus
     every bound proposal's own (the single chain's count for the whole
     batch), aggregate states/s beside one chain's with the same operators,
     a profiler window, the full-evaluation check on every chain, and
     P10d's swap acceptance inside [0.05, 0.95].
  11. the GY94+Gamma4 codon chain at benchmark1's size (`codon_analysis`
     with four categories: 1,441 taxa, 593 codon patterns, 61 states, f64,
     uniform codon frequencies, strict clock, constant coalescent), which
     peel_route sends to the v1 streaming kernel (asserted)
     (`codon_gamma_path`): one chain, G4_STEPS steps after 20, exactly one
     peel_stream_ring launch a step, a profiler window and the
     full-evaluation check; the same model as a batch of G4_CHAINS chains
     (make_multichain_step), one launch a batch step for all of them, the
     check on every chain, aggregate states/s beside one chain's; and the
     route's gradient for the G4_CHAINS chains (`chain_gradient_checks`)
     against the same level adjoint over the plain chain-axis forward and
     each chain's single-tree gradient, one launch a gradient.
  12. the importer route at the Makona shape (`spec_document`,
     `spec_path`): a BEAUti-style document in the importer's vocabulary
     (the 1,610 dated taxa of examples/makona_joint.xml, its 18,996 sites
     simulated as in phase 9, GTR+Gamma4, the discretised lognormal
     clock, a skygrid of 50 cells, ctmcScale, logNormal and gamma priors,
     <log logEvery="10">) run through `python -m beast_mcmc_tpu_torch
     run` (__main__.main): SPEC_STEPS steps straight, half of them with
     -save_state, the other half with -load_state, and an unknown
     command; each run's peel_stream launches exactly its steps plus its
     full evaluations (start, load check); 30 log rows under the
     builder's columns, 30 trees of 1,610 tips read back; the checkpoint
     reloaded within 0.1; the resumed run's final log posterior against
     the straight run's; the built analysis's full-evaluation check over
     SPEC_CHECK steps and a profiler window.
  13. the CLI's MC3 and the post-processing tools on phase 12's files
     (`mc3_path`, `tools_path`): `run doc -mc3_chains MC3_CHAINS -mc3_swap
     MC3_SWAP` for SPEC_STEPS steps, exactly one peel_stream launch a
     batch step and the start's evaluation, nothing else; the cold
     chain's log of SPEC_STEPS / MC3_SWAP rows; the built analysis's batch
     (config/builder.py::Analysis.log_posterior_chains) run for one swap
     round, its carried log posteriors against a fresh evaluation within
     0.1, a profiler window of MC3_PROFILE batch steps, and the chain-axis
     posterior at four parameter draws against four single-chain
     posteriors to MC3_REL_TOL, with their exact launches; aggregate
     states/s and swap acceptance printed, not gated. Then loganalyser on
     the straight log, logcombiner of the halves' logs (its rows those of
     the two at or past the burn-in), treeannotator's MCC tree of the
     straight run's trees read back with every tip, treestat on them, and
     seqgen down the last of them at the document's width on the card;
     each tool exits 0, its host seconds printed.
  14. every MCMC operator of the JAX package (`operators_path`): phase
     12's document built with the new operators in spec.extra_operators
     (the subtree leap, tip leap and jump, FNPR, NNI, fixed-height SPR,
     the node- and tip-height moves, and the transformed, MVN, subset and
     uniform moves, a compound weighted delta, a joint and a team
     operator on its parameters): 14a one chain of A14_STEPS steps taking
     each new operator in turn, exactly one peel_stream launch a step and
     one a full evaluation, the carried posterior within 0.1 of a fresh
     one at every step, the final and A14_TREES sampled trees valid on the
     host, each operator's acceptance, states/s and a profiler window;
     14b B14_PAR Gibbs prune-and-regraft and B14_SWAP Gibbs subtree-swap
     proposals, each scoring its candidates as chunks of trees, one
     peel_stream launch a chunk (exactly one for the current tree and
     ceil(candidates / chunk) an enumeration, and the step's own), sampled
     candidates' scores against single-tree evaluations and the carried
     posterior against a fresh one to P14_REL_TOL; 14c a batch of
     C14_CHAINS chains taking every new operator and the two Gibbs moves
     in turn, one launch a batch step plus the Gibbs proposals' own, every
     chain's carried posterior within 0.1; 14d the operators with no
     target there on small posteriors on the card (a star tree, a normal
     hierarchy's conjugate Gibbs draws, the rate-bit exchange on a BSSVS
     analysis), and the 36 densities of models/priors.py, gamma_quantile
     and gammainc_fixed on the card against the CPU to P14_DENSITY_TOL.
  15. the XML interpreter route at the Makona shape (`interpreter_path`,
     `functions_path`, `testxml_path`): on phase 12's taxa and alignment,
     15a a document outside the importer's vocabulary (GTR+Gamma4, a
     random local clock over every node with a Poisson prior on its
     indicator sum, a time-aware GMRF skyride, a coalescentSimulator start
     tree) through `python -m beast_mcmc_tpu_torch run` (the importer's
     refusal printed, the interpreter's route taken) for P15_STEPS_A
     states after the interpreter's 100-step full-evaluation check, its
     peel_stream launches exactly as predicted from _run_mcmc (the start,
     two a checked step, one a step, one a log row's posterior), its log
     and trees read back, a profiler window of P15_PROFILE steps; 15b
     HKY+Gamma4 with a local clock on a clade of P15_CLADE taxa and a
     stepwise skyline of P15_GROUPS groups through XmlAnalysis.run, the
     same checks; 15c every function that models/clock.py, epoch.py,
     coalescent.py and speciation.py gained on the card against the CPU
     at 3,219 nodes to P15_REL_TOL (P15_ODE_TOL for the SIR ODE); 15d
     `run -testxml` on the conjugate normal document of
     tests/test_distribution_likelihood_xml.py, exit 0 and its
     expectation line.
  16. the north-star document through the XML interpreter
     (`north_star_path`, `p16_functions_path`): 16a
     `python -m beast_mcmc_tpu_torch run examples/makona_joint.xml -scale
     P16_SCALE` at full width (1,610 taxa, 18,996 sites simulated by its
     <beagleSequenceSimulator>, 56 locations), P16_STATES states with a
     log row and a location-annotated tree each, peel_stream launches
     exactly as predicted from _run_mcmc, the log's columns and every
     tree's annotations read back; 16b apps/benchmarks.py::
     measure_makona_joint (bench.py's, in float64: P16_WARM warm-up and
     P16_STEPS timed steps of the component-cached chain, the carried
     posterior against a fresh one), its peel_stream launches equal to
     the steps that refresh treeLikelihood, the document's pattern count,
     the host ms of an annotated tree sample, a profiler window of
     P16_PROFILE steps; 16c the document with a
     <gmrfGridBlockUpdateOperator> on its skygrid added (written into
     build/smoke and built as 16b builds the document, its alignment
     16b's): P16_BLOCK_PROPOSALS block-update proposals timed with
     CUDA events, their acceptance, then the full-evaluation check of the
     whole operator mix; 16d the GMRF block update and elliptical slice
     proposals (their draws given), the stochastic Dollo likelihood, the
     SVS connectivity prior at 56 states and config/xml_ext.py's
     densities, clocks, views and matrix parameters at the Makona tree,
     on the card against the CPU to P16_REL_TOL.

`python3 chip_smoke.py --tiles` instead builds the kernels and times the
v1 streaming kernel at the plans its planner could pick, with its largest
deviation from the plain version (`*` marks the planner's): below 16 states
patterns a slot (32 to 2, where a slot's lanes allow) by 4, 8 and 16 warps
a block; from 16 states 1 to 8 teams a block. At the shapes with 16 states
or more it then times the matrix-product kernel at 1 to 8 teams a block,
where shared memory allows. It times the deep kernel at the Makona
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
# steps of a plain chain's profiler window: the profiler's host-side parse
# of a window grows with its operators (tens of seconds for 20 steps at
# Makona width), so a window is kept short
PROFILE_STEPS = 8
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
# the GY94+Gamma4 codon chain at benchmark1's size, the v1 streaming
# kernel's main path (phase 11): taxa, categories, states, patterns
CODON_G4 = (1441, 4, 61, 593)
RING_SHAPES = [("S=2", (400, 1, 2, 1000), 38), ("S=8", (40, 2, 8, 300), 39),
               ("caterpillar", (500, 4, 4, 203), 40),
               ("caterpillar S=20", (128, 4, 20, 256), 41)]
G4_STEPS, G4_CHECK = 200, 50  # phase 11, one chain
G4_CHAINS, G4_BATCH_STEPS, G4_BATCH_CHECK = 4, 60, 20  # phase 11, a batch
TILE_SHAPES = [CODON, AMINO, RAGGED, (300, 2, 16, 2048),
               (128, 4, 20, 8192), (1441, 1, 4, 640), (1610, 4, 4, 2048),
               (62, 4, 4, 5632), (40, 2, 8, 300), CODON_G4]
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
                   device="cuda", n_categories=1, alpha=0.5):
    """GY94 (kappa, omega, uniform codon frequencies) on 61-state tips,
    strict clock, constant coalescent. "eig" is derived from ("kappa",
    "omega"), so the 61 x 61 eigh runs only when one of them moves. One
    rate category, or with `n_categories` > 1 discrete Gamma rates
    (GY94+Gamma): "site.rates" derived from "alpha" (starting at `alpha`),
    with a ScaleOperator on alpha beside those on kappa and omega."""
    import torch

    from beast_mcmc_tpu_torch.inference.operators import ScaleOperator
    from beast_mcmc_tpu_torch.models.sitemodel import (
        discrete_gamma_rates, single_rate)
    from beast_mcmc_tpu_torch.models.substitution import gy94_eigen

    dtype = dtype or torch.float64
    freqs = torch.full((61,), 1.0 / 61, dtype=dtype, device=device)
    one_rate = single_rate(dtype=dtype, device=device)

    def eigen(params):
        return gy94_eigen(params["kappa"], params["omega"], freqs)

    def site_rates(params):
        return discrete_gamma_rates(params["alpha"], n_categories,
                                    dtype=dtype)

    def model(params, cached):
        eig = params["eig"] if cached else eigen(params)
        if n_categories == 1:
            return (eig, *one_rate)
        return (eig, *(params["site.rates"] if cached
                       else site_rates(params)))

    params0 = {"kappa": 2.0, "omega": 0.5}
    derived = {"eig": (eigen, ("kappa", "omega"))}
    ops = [ScaleOperator(parameter="kappa", weight=1.0),
           ScaleOperator(parameter="omega", weight=1.0)]
    if n_categories > 1:
        params0["alpha"] = alpha
        derived["site.rates"] = (site_rates, ("alpha",))
        ops.append(ScaleOperator(parameter="alpha", weight=1.0))
    return _strict_clock_analysis(
        *_one_hot_tips(n_taxa, n_patterns, 61, seed), freqs, seed, dtype,
        device, params0, derived, model, ops)


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
        SimplexHmcOperator, batch_of_one, value_grad)
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
        one = batch_of_one((st.params, st.tree))
        grads.append(value_grad(probe.neg_log_density(
            probe.one_chain_posterior(), *one), probe._pack(one[0]).detach()))
    grads = torch.cat(grads)
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
            wall, busy = device_ms(
                lambda: run_chain(mstep, states, PROFILE_STEPS),
                f"{p_name} {label}", PROFILE_STEPS, 8)
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
JOINT_WARM, JOINT_STEPS, JOINT_CHECK, JOINT_PROFILE = 20, 300, 50, 10
JOINT_SEED = 666  # the starting tree's (the JAX package's) and alignment's
# the joint's log rows and annotated trees: the document's logEvery of 1,000
# and 10,000 are for its 200 million steps, scaled here to 300
JOINT_LOG_EVERY, JOINT_TREE_EVERY = 10, 50
SMOKE_OUT = os.path.join(ROOT, "build", "smoke")  # git-ignored


def check_joint_trees(path, cfg):
    """Read a joint tree file back: each tree through the port's
    parse_newick (all of the document's taxa), a location="..." of the
    document's states on every node, and each tip whose location is known
    annotated with it. Returns the number of trees."""
    import re

    from beast_mcmc_tpu_torch.tree.topology import parse_newick

    n_taxa, codes = len(cfg["taxa"]), set(cfg["location_codes"])
    by_upper = {c.upper(): c for c in codes}  # the data type maps upper case
    lines = [ln for ln in open(path) if ln.startswith("tree STATE_")]
    for ln in lines:
        newick = ln.split("[&R]", 1)[1].strip()
        _, _, _, _, names = parse_newick(newick)
        if len(names) != n_taxa:
            raise AssertionError(f"joint trees: {len(names)} tips")
        labels = re.findall(r'\[&location="([^"]*)"\]', newick)
        if len(labels) != 2 * n_taxa - 1 or not set(labels) <= codes:
            raise AssertionError(f"joint trees: {len(labels)} annotations, "
                                 f"unknown {sorted(set(labels) - codes)}")
        for num, loc in re.findall(r'[(,](\d+)\[&location="([^"]*)"\]',
                                   newick):
            data = by_upper.get(cfg["locations"][int(num) - 1].strip().upper())
            if data is not None and loc != data:
                raise AssertionError(f"joint trees: tip {num} is {loc}, its "
                                     f"data {data}")
    return len(lines)


def joint_path(analysis, reset_counts, read_counts, dev, n_steps=JOINT_STEPS,
               n_check=JOINT_CHECK, n_warm=JOINT_WARM, out_dir=SMOKE_OUT):
    """Phase 9: the joint analysis's component-cached chain
    (apps/makona.py::build_makona_joint's five-tuple), through
    make_mcmc_step(components=, op_tree_flags=) and run_chain, as
    bench.py::measure_makona_joint steps it. After n_warm steps, n_steps
    are timed with the launch counts set to 0 just before them, through
    apps/makona.py::run_joint_logged, which writes makona_joint.log and
    makona_joint.trees into out_dir; peel_stream must have launched
    exactly on the steps whose operator refreshes treeLikelihood (each
    operator's steps from its accept and reject counts), and no other
    kernel at all (the trait and the annotation peel by the plain level
    peel). The tree file is read back (check_joint_trees). Then the
    full-evaluation check over n_check steps. Returns (record, launches,
    step, state)."""
    import torch

    from beast_mcmc_tpu_torch.apps.makona import run_joint_logged
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
    cfg = aux["config"]
    os.makedirs(out_dir, exist_ok=True)
    files = [os.path.join(out_dir, f"makona_joint.{ext}")
             for ext in ("log", "trees")]
    reset_counts()
    t_start = time.perf_counter()
    state, info = run_joint_logged(
        step, state, n_steps, aux["geo_tips"], cfg["taxa"],
        cfg["location_codes"], *files, JOINT_LOG_EVERY, JOINT_TREE_EVERY,
        JOINT_SEED)
    sync()
    dt = time.perf_counter() - t_start
    counts = read_counts()
    per_op = [a - b for a, b in zip(
        (state.op_accept + state.op_reject).tolist(), before)]
    n_rows = sum(1 for ln in open(files[0]) if ln[:1].isdigit())
    n_trees = check_joint_trees(files[1], cfg)
    if (n_rows, n_trees) != (n_steps // JOINT_LOG_EVERY,
                             n_steps // JOINT_TREE_EVERY):
        raise AssertionError(f"joint: {n_rows} log rows, {n_trees} trees")

    def steps_refreshing(name):
        i = names.index(name)
        return sum(n for n, idxs in zip(per_op, step.refreshed) if i in idxs)

    rec = {"steps": n_steps, "seconds": dt, "states_per_s": n_steps / dt,
           "log_posterior": float(state.log_posterior), "launches": counts,
           "tree_likelihood_steps": steps_refreshing("treeLikelihood"),
           "geo_likelihood_steps": steps_refreshing("geoLikelihood"),
           "steps_per_operator": per_op, "log_rows": n_rows,
           "trees": n_trees, "tree_sample_ms": info["sample_ms"],
           "files": files}
    log(f"[joint] {n_steps} steps in {dt:.3f} s = {rec['states_per_s']:.2f} "
        f"states/s; log posterior {rec['log_posterior']!r}; launches "
        f"{json.dumps(counts)}; steps refreshing treeLikelihood "
        f"{rec['tree_likelihood_steps']}, geoLikelihood "
        f"{rec['geo_likelihood_steps']}; wrote {n_rows} log rows and "
        f"{n_trees} annotated trees (read back); host ms of an annotated "
        f"tree sample {[round(x, 3) for x in info['sample_ms']]}")
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


# phase 12, the importer route at the Makona shape: the straight run's steps
# (half of them before the checkpoint, half after), the built analysis's
# full-evaluation check and profiler window, the CLI's seed
SPEC_STEPS, SPEC_CHECK, SPEC_PROFILE, SPEC_SEED = 300, 50, PROFILE_STEPS, 7
SPEC_LOG_EVERY = 10
SPEC_TAXA, SPEC_SITES = 1610, 18996  # examples/makona_joint.xml's


def makona_data(n_taxa=SPEC_TAXA, n_sites=SPEC_SITES, seed=JOINT_SEED,
                device="cuda"):
    """The first n_taxa dated taxa of examples/makona_joint.xml and n_sites
    nucleotides of each, simulated with apps/makona.py::simulate_sites on
    `device` down a coalescent tree from `seed` (at the full size and the
    default seed, phase 9's tree and alignment): {"cfg", "taxa", "dates",
    "rows" (uint8 [taxa, sites] of ACGT), "sites", "patterns" (the
    distinct columns)}."""
    import numpy as np

    from beast_mcmc_tpu_torch.apps.makona import (
        read_makona_xml, simulate_sites, tip_heights)
    from beast_mcmc_tpu_torch.apps.seqgen import compress_patterns
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    cfg = read_makona_xml()
    taxa, dates = cfg["taxa"][:n_taxa], cfg["dates"][:n_taxa]
    tree = simulate_coalescent_tree(np.random.default_rng(seed),
                                    tip_heights(dates), cfg["pop_size"])
    states = simulate_sites(cfg, tree, seed, device, n_sites)
    return {"cfg": cfg, "taxa": taxa, "dates": dates,
            "rows": np.frombuffer(b"ACGT", np.uint8)[states.cpu().numpy()],
            "sites": int(states.shape[1]),
            "patterns": int(compress_patterns(states)[0].shape[1])}


def taxa_alignment_xml(data):
    """The <taxa> block (forward dates in years) and the <alignment> of
    makona_data's rows, as lines."""
    from xml.sax.saxutils import quoteattr

    out = ['  <taxa id="taxa">']
    out += [f'    <taxon id={quoteattr(t)}><date value="{float(d)!r}" '
            'direction="forwards" units="years"/></taxon>'
            for t, d in zip(data["taxa"], data["dates"])]
    out += ["  </taxa>", '  <alignment id="alignment" dataType="nucleotide">']
    out += [f"    <sequence><taxon idref={quoteattr(t)}/>"
            f"{row.tobytes().decode()}</sequence>"
            for t, row in zip(data["taxa"], data["rows"])]
    out.append("  </alignment>")
    return out


def spec_document(path, n_taxa=SPEC_TAXA, n_sites=SPEC_SITES,
                  seed=JOINT_SEED, device="cuda"):
    """Write a BEAUti-style document in the importer's vocabulary
    (config/xml_import.py) at `path`: the first n_taxa dated taxa of
    examples/makona_joint.xml's <taxa> block; n_sites nucleotides of each
    simulated with apps/makona.py::simulate_sites on `device` down a
    coalescent tree from `seed` (at the full size and the default seed,
    phase 9's tree and alignment); gtrModel with gammaShape over 4
    categories, discretizedBranchRates with a lognormal,
    gmrfSkyGridLikelihood with 50 cells, ctmcScale, logNormal, gamma and
    exponential priors, the operators that make the model's parameters
    estimated, <log logEvery="10">. Returns {"taxa", "sites", "patterns"}
    (the distinct columns)."""
    data = makona_data(n_taxa, n_sites, seed, device)
    cfg, taxa, n_patterns = data["cfg"], data["taxa"], data["patterns"]
    init = cfg["model"]["init"]
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += taxa_alignment_xml(data)
    freqs = " ".join(repr(float(f)) for f in init["frequencies"])
    gtr = "\n".join(
        f'    <rate{r}><parameter id="gtr.{r.lower()}" '
        f'value="{float(init["gtr." + r.lower()])!r}" lower="0.0"/>'
        f"</rate{r}>" for r in ("AC", "AG", "AT", "CG", "GT"))
    n_grid = int(init["skygrid.numGridPoints"])
    out.append(f"""  <patterns id="patterns" from="1" strip="false">
    <alignment idref="alignment"/>
  </patterns>
  <gmrfSkyGridLikelihood id="skygrid">
    <populationSizes>
      <parameter id="skygrid.logPopSize" dimension="{n_grid + 1}" value="1.0"/>
    </populationSizes>
    <precisionParameter>
      <parameter id="skygrid.precision" value="{init['skygrid.precision']!r}" lower="0.0"/>
    </precisionParameter>
    <numGridPoints><parameter value="{n_grid}"/></numGridPoints>
    <cutOff><parameter value="{float(init['skygrid.cutOff'])!r}"/></cutOff>
  </gmrfSkyGridLikelihood>
  <discretizedBranchRates id="branchRates">
    <distribution>
      <logNormalDistributionModel meanInRealSpace="true">
        <mean><parameter id="ucld.mean" value="{init['ucld.mean']!r}" lower="0.0"/></mean>
        <stdev><parameter id="ucld.stdev" value="{init['ucld.stdev']!r}" lower="0.0"/></stdev>
      </logNormalDistributionModel>
    </distribution>
    <rateCategories><parameter id="branchRates.categories"/></rateCategories>
  </discretizedBranchRates>
  <gtrModel id="gtr">
    <frequencies>
      <frequencyModel dataType="nucleotide">
        <frequencies><parameter id="frequencies" value="{freqs}"/></frequencies>
      </frequencyModel>
    </frequencies>
{gtr}
  </gtrModel>
  <siteModel id="siteModel">
    <substitutionModel><gtrModel idref="gtr"/></substitutionModel>
    <gammaShape gammaCategories="{cfg['model']['gamma_categories']}">
      <parameter id="siteModel.alpha" value="{init['siteModel.alpha']!r}" lower="0.0"/>
    </gammaShape>
  </siteModel>
  <treeDataLikelihood id="treeLikelihood" useAmbiguities="false">
    <patterns idref="patterns"/>
    <siteModel idref="siteModel"/>
    <discretizedBranchRates idref="branchRates"/>
  </treeDataLikelihood>
  <operators id="operators">
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="ucld.mean"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="ucld.stdev"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="siteModel.alpha"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="gtr.ag"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="skygrid.precision"/></scaleOperator>
  </operators>
  <mcmc id="mcmc" chainLength="{SPEC_STEPS}" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        <ctmcScalePrior><ctmcScale><parameter idref="ucld.mean"/></ctmcScale></ctmcScalePrior>
        <exponentialPrior mean="0.3333"><parameter idref="ucld.stdev"/></exponentialPrior>
        <exponentialPrior mean="0.5"><parameter idref="siteModel.alpha"/></exponentialPrior>
        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="gtr.ag"/></logNormalPrior>
        <gammaPrior shape="0.001" scale="1000.0"><parameter idref="skygrid.precision"/></gammaPrior>
        <gmrfSkyGridLikelihood idref="skygrid"/>
      </prior>
      <likelihood id="likelihood">
        <treeDataLikelihood idref="treeLikelihood"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="{SPEC_LOG_EVERY}" fileName="makona_spec.log">
      <posterior idref="posterior"/>
      <parameter idref="ucld.mean"/>
      <parameter idref="siteModel.alpha"/>
    </log>
    <logTree logEvery="{SPEC_LOG_EVERY}" nexusFormat="true" fileName="makona_spec.trees"/>
  </mcmc>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return {"taxa": len(taxa), "sites": data["sites"],
            "patterns": int(n_patterns)}


def spec_path(doc, out_dir, reset_counts, read_counts, device_ms, dev,
              n_steps=SPEC_STEPS, n_check=SPEC_CHECK,
              n_profile=SPEC_PROFILE):
    """Phase 12: the importer route, `python -m beast_mcmc_tpu_torch run
    doc` through __main__.main, as a user runs it. n_steps straight
    (-log, -trees, -save_state), then half of them with -save_state and
    the other half from that checkpoint with -load_state, each run's
    launch counts set to 0 just before it and read just after: peel_stream
    exactly its steps plus its full evaluations (one at the start, one to
    check a loaded checkpoint), nothing else; an unknown command returns 2
    and launches nothing. The straight log holds n_steps / logEvery rows
    under the builder's columns and its tree file as many trees of every
    taxon (read back with parse_newick); the resumed run's final log
    posterior is set beside the straight run's (from their checkpoints'
    manifests). Then the built analysis (config/builder.py::build of the
    imported spec): the checkpoint reloaded within 0.1 (the deviation
    recorded), the full-evaluation check over n_check steps and a profiler
    window of n_profile steps (device_ms) from the reloaded state, with
    their launches. Returns
    (record, launches)."""
    import contextlib
    import io
    import re

    import torch

    from beast_mcmc_tpu_torch.__main__ import main as cli
    from beast_mcmc_tpu_torch.config.builder import build
    from beast_mcmc_tpu_torch.config.xml_import import parse_beast_xml_file
    from beast_mcmc_tpu_torch.inference.checkpoint import load_checkpoint
    from beast_mcmc_tpu_torch.inference.mcmc import (
        full_evaluation_check, init_mcmc_state, make_mcmc_step, run_chain)
    from beast_mcmc_tpu_torch.tree.topology import parse_newick

    os.makedirs(out_dir, exist_ok=True)
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    half = n_steps // 2
    rec, launches = {}, {}

    def run(label, argv, expect, want_rc=0):
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {k: expect * (k == "peel_stream") for k in counts}
        if rc != want_rc or counts != want:
            raise AssertionError(f"P12 {label}: rc {rc}, launches {counts}, "
                                 f"expected {want}\n{buf.getvalue()}")
        rate = re.findall(r"([0-9.]+) states/sec", buf.getvalue())
        rec[label] = {"rc": rc, "cli_seconds": wall, "launches": counts,
                      "states_per_s": float(rate[-1]) if rate else None}
        launches[f"P12 {label}"] = counts
        log(f"[P12] {label}: rc {rc} in {wall:.2f} s, launches "
            f"{json.dumps(counts)}, {rec[label]['states_per_s']} states/s")

    base = ["run", doc, "-seed", str(SPEC_SEED), "-device", str(dev),
            "-overwrite"]
    run("straight", base + ["-chain_length", str(n_steps), "-log",
                            path("straight.log"), "-trees",
                            path("straight.trees"), "-save_state",
                            path("straight.ckpt")], n_steps + 1)
    run("first half", base + ["-chain_length", str(half), "-log",
                              path("first.log"), "-trees",
                              path("first.trees"), "-save_state",
                              path("half.ckpt")], half + 1)
    run("resumed", base + ["-chain_length", str(n_steps - half), "-log",
                           path("resumed.log"), "-trees",
                           path("resumed.trees"), "-load_state",
                           path("half.ckpt"), "-save_state",
                           path("resumed.ckpt")], n_steps - half + 2)
    run("unknown command", ["frobnicate"], 0, want_rc=2)

    spec = parse_beast_xml_file(doc)
    spec.mcmc.seed = SPEC_SEED
    analysis = build(spec, device=dev)
    cols = ["posterior", "treeModel.rootHeight"] + [
        k for k, v in analysis.params0.items() if v.dim() == 0]
    lines = open(path("straight.log")).read().splitlines()
    header = next(ln for ln in lines if ln.startswith("state"))
    n_rows = sum(1 for ln in lines if ln[:1].isdigit())
    want_rows = n_steps // spec.mcmc.log_every
    if header.split("\t") != ["state"] + cols or n_rows != want_rows:
        raise AssertionError(f"P12 log: {n_rows} rows under {header!r}")
    trees = [ln.split("[&R]", 1)[1].strip()
             for ln in open(path("straight.trees"))
             if ln.startswith("tree STATE_")]
    for newick in trees:
        if len(parse_newick(newick)[4]) != analysis.n_taxa:
            raise AssertionError("P12 trees: a tree lacks taxa")
    if len(trees) != want_rows:
        raise AssertionError(f"P12 trees: {len(trees)}")
    finals = [json.load(open(path(f"{n}.ckpt.manifest.json")))
              for n in ("straight", "resumed")]
    rec.update({"taxa": analysis.n_taxa, "log_rows": n_rows,
                "log_columns": cols, "trees": len(trees),
                "final_log_posterior": {
                    "straight": finals[0]["log_posterior"],
                    "resumed": finals[1]["log_posterior"]},
                "resumed_equals_straight": (finals[0]["log_posterior"]
                                            == finals[1]["log_posterior"])})
    log(f"[P12] log {n_rows} rows, columns {cols}; {len(trees)} trees of "
        f"{analysis.n_taxa} taxa read back; final log posterior straight "
        f"{finals[0]['log_posterior']!r}, resumed "
        f"{finals[1]['log_posterior']!r} (equal: "
        f"{rec['resumed_equals_straight']})")

    reset_counts()
    step = make_mcmc_step(analysis.log_posterior, analysis.operators)
    gen = torch.Generator(device=dev).manual_seed(SPEC_SEED)
    state = init_mcmc_state(analysis.params0, analysis.tree0, gen,
                            analysis.operators, analysis.log_posterior)
    state = load_checkpoint(path("half.ckpt"), state)
    rec["reload_deviation"] = abs(
        float(analysis.log_posterior(state.params, state.tree))
        - float(state.log_posterior))
    if not rec["reload_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P12 reload {rec['reload_deviation']}")
    state, dev_max = full_evaluation_check(step, analysis.log_posterior,
                                           state, n_check)
    rec["full_evaluation_deviation"] = float(dev_max)
    wall, busy = device_ms(lambda: run_chain(step, state, n_profile),
                           "p12 importer chain", n_profile)
    rec["profile_ms_per_step"] = wall
    rec["device_busy_share"] = None if busy is None else busy / wall
    counts = read_counts()
    # the start, the reload check, each checked step and its fresh
    # evaluation, the profiled steps
    want = 2 + 2 * n_check + n_profile
    launches["P12 built analysis"] = counts
    log(f"[P12] built analysis: reload deviation "
        f"{rec['reload_deviation']!r}, full-evaluation deviation over "
        f"{n_check} steps {rec['full_evaluation_deviation']!r} (tolerance "
        f"{FULL_EVAL_TOL}), {wall:.3f} ms a step under the profiler, busy "
        f"share {rec['device_busy_share']}, launches {json.dumps(counts)}")
    if counts != {k: want * (k == "peel_stream") for k in counts}:
        raise AssertionError(f"P12 built analysis: launches {counts}, "
                             f"expected {want} peel_stream")
    if not rec["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError("P12 full-evaluation deviation "
                             f"{rec['full_evaluation_deviation']}")
    return rec, launches


# phase 13, the CLI's MC3 at the Makona shape: chains, steps between swaps
# (SPEC_STEPS / MC3_SWAP logged rounds), the built batch's steps before its
# full-evaluation check and in its profiler window, the seed of the four
# parameter draws and their relative tolerance against single chains
MC3_CHAINS, MC3_SWAP, MC3_CHECK, MC3_PROFILE = 4, 50, 50, PROFILE_STEPS
MC3_DRAW_SEED, MC3_REL_TOL = 13, 1e-10
# the sub-tools on phase 12's files: logcombiner's burn-in in states,
# treeannotator's as a fraction, and seqgen's partition (GTR+Gamma4 at a
# clock rate near the document's ucld.mean) and seed
TOOLS_BURNIN_STATES, TOOLS_BURNIN_FRACTION = 50, 0.1
SEQGEN_PARTITION, SEQGEN_SEED = "model=GTR,alpha=0.5,ncat=4,rate=0.001", 17


def mc3_path(doc, out_dir, reset_counts, read_counts, device_ms, dev,
             n_steps=SPEC_STEPS, swap=MC3_SWAP, n_chains=MC3_CHAINS,
             n_check=MC3_CHECK, n_profile=MC3_PROFILE):
    """Phase 13a: `python -m beast_mcmc_tpu_torch run doc -mc3_chains
    n_chains -mc3_swap swap` through __main__.main, its launch counts set
    to 0 just before and read just after: peel_stream exactly once a batch
    step and once for the start, nothing else; the cold chain's log of
    n_steps // swap rows under phase 12's columns. Then the built
    analysis's batch, counted likewise: the start, one swap round of
    n_check steps (inference/mc3.py), the carried [B] log posteriors
    against log_posterior_chains within FULL_EVAL_TOL, a profiler window
    of n_profile batch steps at the ladder's temperatures (device_ms), and
    log_posterior_chains at n_chains parameter draws (from MC3_DRAW_SEED;
    the relaxed clock's categories permuted, the rest scaled) on the
    chains' trees against n_chains single-chain log_posterior calls to
    MC3_REL_TOL relative. Returns (record, launches)."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.__main__ import main as cli
    from beast_mcmc_tpu_torch.config.builder import build
    from beast_mcmc_tpu_torch.config.xml_import import parse_beast_xml_file
    from beast_mcmc_tpu_torch.inference.mc3 import (
        chain_state, make_mc3_runner, replicate_state)
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_multichain_step, run_chain)

    rec, launches = {}, {}
    log_f = os.path.join(out_dir, "mc3.log")
    n_rounds = n_steps // swap

    def expect(label, counts, n):
        launches[f"P13 {label}"] = counts
        if counts != {k: n * (k == "peel_stream") for k in counts}:
            raise AssertionError(f"P13 {label}: launches {counts}, expected "
                                 f"{n} peel_stream")

    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["run", doc, "-seed", str(SPEC_SEED), "-device", str(dev),
                  "-overwrite", "-chain_length", str(n_steps), "-log", log_f,
                  "-mc3_chains", str(n_chains), "-mc3_swap", str(swap)])
    wall = time.perf_counter() - t0
    counts = read_counts()
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"P13 MC3 CLI: rc {rc}\n{out}")
    expect("mc3 cli", counts, 1 + n_rounds * swap)
    rec["cli"] = {
        "rc": rc, "cli_seconds": wall, "launches": counts,
        "aggregate_states_per_s": float(
            re.findall(r"([0-9.]+) states/sec", out)[-1]),
        "swap_acceptance": float(
            re.search(r"swap acceptance ([0-9.]+)", out).group(1)),
        "temperatures": re.search(r"temperatures (\[[^\]]*\])",
                                  out).group(1)}
    log(f"[P13] mc3 CLI: rc {rc} in {wall:.2f} s, launches "
        f"{json.dumps(counts)}, {rec['cli']['aggregate_states_per_s']} "
        f"aggregate states/s, temperatures {rec['cli']['temperatures']}, "
        f"swap acceptance {rec['cli']['swap_acceptance']}")

    spec = parse_beast_xml_file(doc)
    spec.mcmc.seed = SPEC_SEED
    analysis = build(spec, device=dev)
    cols = ["posterior", "treeModel.rootHeight"] + [
        k for k, v in analysis.params0.items() if v.dim() == 0]
    lines = open(log_f).read().splitlines()
    header = next(ln for ln in lines if ln.startswith("state"))
    rows = [ln.split("\t") for ln in lines if ln[:1].isdigit()]
    if (header.split("\t") != ["state"] + cols or len(rows) != n_rounds
            or [int(r[0]) for r in rows] != [swap * (i + 1)
                                             for i in range(n_rounds)]):
        raise AssertionError(f"P13 log: {len(rows)} rows under {header!r}")
    rec["log_rows"] = len(rows)

    reset_counts()
    ops = analysis.operators
    run, temps = make_mc3_runner(analysis.log_posterior_chains, ops,
                                 n_chains, swap_every=n_check)
    state0 = init_mcmc_state(
        analysis.params0, analysis.tree0,
        torch.Generator(device=dev).manual_seed(SPEC_SEED), ops,
        analysis.log_posterior)
    states = replicate_state(state0, n_chains, torch.Generator(
        device=dev).manual_seed(SPEC_SEED + 1))
    states, _ = run(states, torch.Generator().manual_seed(SPEC_SEED + 2), 1)
    fresh = analysis.log_posterior_chains(states.params, states.tree)
    rec["full_evaluation_deviation"] = float(
        (fresh - states.log_posterior).abs().max())
    mstep = make_multichain_step(analysis.log_posterior_chains, ops)
    temps_dev = temps.to(dev)
    wall_ms, busy = device_ms(
        lambda: run_chain(lambda s, t: mstep(s, temps_dev), states,
                          n_profile), "p13 mc3 batch", n_profile)
    rec["profile_ms_per_batch_step"] = wall_ms
    rec["device_busy_share"] = None if busy is None else busy / wall_ms

    rng = np.random.default_rng(MC3_DRAW_SEED)
    draws = {}
    for k, v in analysis.params0.items():
        v = v.cpu().numpy()
        if v.dtype.kind == "i":
            x = np.stack([rng.permutation(v) for _ in range(n_chains)])
        else:
            x = v * np.exp(rng.normal(0.0, 0.05, (n_chains,) + v.shape))
        draws[k] = torch.as_tensor(x, device=dev)
    batch = analysis.log_posterior_chains(draws, states.tree)
    singles = torch.stack([analysis.log_posterior(
        {k: v[b] for k, v in draws.items()}, chain_state(states, b).tree)
        for b in range(n_chains)])
    rec["draws_max_rel_err"] = float(((batch - singles).abs()
                                      / singles.abs()).max())
    rec["draws_log_posterior"] = batch.tolist()
    expect("mc3 built batch", read_counts(),
           1 + n_check + 1 + n_profile + 1 + n_chains)
    log(f"[P13] built batch of {n_chains}: full-evaluation deviation after "
        f"{n_check} steps {rec['full_evaluation_deviation']!r} (tolerance "
        f"{FULL_EVAL_TOL}), {wall_ms:.3f} ms a batch step under the "
        f"profiler, busy share {rec['device_busy_share']}; "
        f"{n_chains} draws: chain-axis posterior {rec['draws_log_posterior']}"
        f" against single chains, max relative error "
        f"{rec['draws_max_rel_err']!r} (tolerance {MC3_REL_TOL}); launches "
        f"{json.dumps(launches['P13 mc3 built batch'])}")
    if not rec["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError("P13 full-evaluation deviation "
                             f"{rec['full_evaluation_deviation']}")
    if not rec["draws_max_rel_err"] <= MC3_REL_TOL:
        raise AssertionError(f"P13 draws: {rec['draws_max_rel_err']}")
    return rec, launches


# phase 14, every MCMC operator: 14a's steps (each new operator in turn)
# and profiler window; 14b's Gibbs proposals and the candidates sampled from
# each to check; 14c's chains, steps and profiler window; 14d's steps on
# each small posterior; the seed and the relative tolerances
A14_STEPS, A14_TREES, A14_PROFILE, A14_MIN_DRAWN = 198, 10, 20, 5
B14_PAR, B14_SWAP, B14_SAMPLED = 3, 2, 4
C14_CHAINS, C14_STEPS, C14_PROFILE = 4, 40, 18
D14_STEPS = 50
P14_SEED, P14_REL_TOL, P14_DENSITY_TOL = 21, 1e-10, 1e-12


def new_operators(tips, n_taxa, n_cells):
    """[(label, operator)]: the new operators of phase 14a on phase 12's
    analysis (its parameter names); `tips` three dated tips for the tip
    moves."""
    import numpy as np

    from beast_mcmc_tpu_torch.inference import operators as O
    from beast_mcmc_tpu_torch.inference import tree_operators as T
    from beast_mcmc_tpu_torch.utils.transforms import LogTransform

    def parameter_ops():
        return (O.MvnRandomWalkOperator(parameter="skygrid.logPopSizes",
                                        chol=0.05 * np.eye(n_cells)),
                O.SubsetRandomWalkOperator(parameter="skygrid.logPopSizes",
                                           indices=tuple(range(0, n_cells,
                                                               5)),
                                           window=0.2),
                O.CompoundWeightedDeltaOperator(
                    parameters=("treeLikelihood.alpha", "ucld.stdev"),
                    parameter_weights=(1.0, 1.0), delta=0.02))

    mvn, subset, compound = parameter_ops()
    return [
        ("subtree leap", T.SubtreeLeapOperator(size=0.05)),
        ("tip leap", T.TipLeapOperator(size=0.05, n_tips=n_taxa)),
        ("subtree jump", T.SubtreeJumpOperator(size=0.05)),
        ("FNPR", T.FNPROperator()),
        ("NNI", T.NNIOperator()),
        ("fixed-height SPR", T.FixedHeightSPROperator()),
        ("scale node height", T.ScaleNodeHeightOperator()),
        ("random-walk node height", T.RandomWalkNodeHeightOperator(
            window=0.01)),
        ("tip height random walk", T.TipHeightRandomWalkOperator(
            tip=tips[0], window=0.01)),
        ("tip height uniform", T.TipHeightUniformOperator(tip=tips[1])),
        ("tip height scale", T.TipHeightScaleOperator(tip=tips[2])),
        ("transformed random walk ucld.mean",
         O.TransformedRandomWalkOperator(parameter="ucld.mean",
                                         transform=LogTransform(),
                                         window=0.1)),
        ("mvn random walk skygrid", mvn),
        ("subset random walk skygrid", subset),
        ("uniform ucld.stdev", O.UniformRealOperator(
            parameter="ucld.stdev", lower=0.0, upper=2.0)),
        ("compound weighted delta", compound),
        ("joint", O.JointOperator(sub_operators=[
            O.TransformedRandomWalkOperator(parameter="ucld.mean",
                                            transform=LogTransform(),
                                            window=0.1),
            O.UniformRealOperator(parameter="ucld.stdev", lower=0.0,
                                  upper=2.0)])),
        ("team", O.TeamOperator(sub_operators=list(parameter_ops()),
                                n_pick=2)),
    ]


def valid_tree_np(parent, children, heights, root, n_taxa):
    """Whether host arrays are one binary tree over n_taxa tips: one root,
    each child listed by its parent, each parent above its children (so
    no cycle: every node reaches the root)."""
    m = parent.shape[0]
    if m != 2 * n_taxa - 1 or int((parent < 0).sum()) != 1 \
            or parent[root] >= 0:
        return False
    for x in range(m):
        if x != root and (x not in children[parent[x]]
                          or not heights[parent[x]] > heights[x]):
            return False
    return bool((children[:n_taxa] < 0).all()
                and (children[n_taxa:] >= 0).all())


def density_cases():
    """[(name, args)]: each of the 36 densities of models/priors.py beyond
    the main path's at numpy inputs from P14_SEED (x first)."""
    import numpy as np

    rng = np.random.default_rng(P14_SEED)
    pos, unit = rng.uniform(0.1, 4.0, 64), rng.uniform(0.02, 0.98, 64)
    real, ints = rng.normal(0.0, 2.0, 64), rng.integers(0, 9, 64) * 1.0
    a = rng.normal(size=(4, 4))
    spd = a @ a.T + 4 * np.eye(4)
    corr = spd / np.sqrt(np.outer(np.diag(spd), np.diag(spd)))
    return [
        ("inverse_gamma_logpdf", (pos, 2.5, 1.3)),
        ("laplace_logpdf", (real, 0.3, 1.7)),
        ("beta_logpdf", (unit, 2.0, 3.5)),
        ("normal_gamma_precision_logpdf", (real, 0.2, 3.0)),
        ("multivariate_normal_logpdf", (real[:4], real[4:8], spd)),
        ("bayesian_bridge_logpdf", (real, 0.7, 0.25)),
        ("lkj_logpdf", (corr, 2.5)),
        ("wishart_logpdf", (spd, 6.0, spd + np.eye(4))),
        ("inverse_wishart_logpdf", (spd, 6.0, spd + np.eye(4))),
        ("half_t_logpdf", (pos, 1.5, 3.0)),
        ("chi_square_logpdf", (pos, 3.0)),
        ("t_logpdf", (real, 4.0, 0.5, 1.3)),
        ("cauchy_logpdf", (real, 0.2, 0.8)),
        ("logistic_logpdf", (real, 0.5, 1.2)),
        ("weibull_logpdf", (pos, 1.7, 2.2)),
        ("gumbel2_logpdf", (pos, 2.0, 1.5)),
        ("half_normal_logpdf", (pos, 1.4)),
        ("pareto_logpdf", (pos + 1.0, 0.9, 2.5)),
        ("inverse_gaussian_logpdf", (pos, 1.2, 2.0)),
        ("truncated_normal_logpdf", (pos - 0.5, 0.4, 1.1, -0.5, 3.6)),
        ("reflected_normal_logpdf", (pos - 0.1, 1.0, 0.9, 0.0, 4.0)),
        ("negative_binomial_logpmf", (ints, 4.5, 0.6)),
        ("geometric_logpmf", (ints, 0.3)),
        ("binomial_logpmf", (ints, 10.0, 0.35)),
        ("discrete_uniform_logpmf", (ints, 0.0, 9.0)),
        ("multivariate_gamma_logpdf", (pos[:4], np.array([0.5, 1.5, 2.0,
                                                          4.0]),
                                       np.array([2.0, 0.5, 1.0, 3.0]))),
        ("ar1_normal_logpdf", (real, 1.3, 0.6)),
        ("normal_kde_logpdf", (real[:8], real[8:])),
        ("log_transformed_normal_kde_logpdf", (pos[:8], pos[8:])),
        ("logit_transformed_normal_kde_logpdf", (unit[:8], unit[8:])),
        ("marginalized_alpha_stable_logpdf", (real, 1.3, 0.7)),
        ("multivariate_t_logpdf", (real[:4], real[4:8], spd, 5.0)),
        ("multivariate_lognormal_logpdf", (pos[:4], real[4:8], spd)),
        ("kumaraswamy_logpdf", (unit, 2.0, 3.0)),
        ("point_mass_mixture_logpmf", (np.array([1.0, 2.0]),
                                       np.array([0.2, 0.5, 0.3]),
                                       np.array([[0.0, 1.0], [1.0, 2.0],
                                                 [1.0, 2.0]]))),
        ("frechet_logpdf", (pos, 2.5, 1.5)),
    ]


def operators_path(doc, reset_counts, read_counts, device_ms, dev,
                   n_steps=A14_STEPS, n_profile=A14_PROFILE,
                   n_chains=C14_CHAINS, c_steps=C14_STEPS,
                   c_profile=C14_PROFILE, d_steps=D14_STEPS,
                   n_par=B14_PAR, n_swap=B14_SWAP, bssvs_shape=(40, 400)):
    """Phase 14 (see the module docstring) on `doc`, phase 12's document,
    its spec built with config/builder.py::build and the new operators of
    `new_operators` and the two Gibbs moves in spec.extra_operators; each
    part's launch counts set to 0 just before it and read just after.
    Returns (record, launches)."""
    import math

    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.config import spec as S
    from beast_mcmc_tpu_torch.config.builder import build
    from beast_mcmc_tpu_torch.config.xml_import import parse_beast_xml_file
    from beast_mcmc_tpu_torch.data import alignment as al
    from beast_mcmc_tpu_torch.data import datatype as dt
    from beast_mcmc_tpu_torch.inference import operators as O
    from beast_mcmc_tpu_torch.inference import tree_operators as T
    from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_mcmc_step, make_multichain_step)
    from beast_mcmc_tpu_torch.models import priors as P
    from beast_mcmc_tpu_torch.ops import special
    from beast_mcmc_tpu_torch.tree.topology import TreeState, make_tree_state

    rec, launches = {}, {}
    f64 = torch.float64

    def expect(label, want):
        counts = read_counts()
        launches[f"P14 {label}"] = counts
        if counts != {k: want * (k == "peel_stream") for k in counts}:
            raise AssertionError(f"P14 {label}: launches {counts}, expected "
                                 f"{want} peel_stream")
        return counts

    def host_tree(tree):
        return tuple(getattr(tree, f).cpu().numpy()
                     for f in ("parent", "children", "heights", "root"))

    spec = parse_beast_xml_file(doc)
    spec.mcmc.seed = SPEC_SEED
    taxa = spec.partitions[0].patterns.taxa
    dated = sorted(range(len(taxa)),
                   key=lambda i: -spec.tree.tip_heights.get(taxa[i], 0.0))
    new = new_operators(dated[:3], len(taxa), 50)
    gibbs = [T.GibbsPruneAndRegraftOperator(), T.GibbsSubtreeSwapOperator()]
    spec.extra_operators = [op for _, op in new] + gibbs
    analysis = build(spec, device=dev)
    for g in gibbs:
        g.log_posterior_chains = analysis.log_posterior_chains
    ops = analysis.operators
    index = {id(op): k for k, op in enumerate(ops)}
    new_idx = [index[id(op)] for _, op in new]
    gibbs_idx = [index[id(g)] for g in gibbs]
    n_taxa = analysis.n_taxa
    lp = analysis.log_posterior

    # 14a: one chain, each new operator in turn
    step = make_mcmc_step(lp, ops)
    reset_counts()
    t0 = time.perf_counter()
    state = init_mcmc_state(analysis.params0, analysis.tree0,
                            torch.Generator(device=dev).manual_seed(P14_SEED),
                            ops, lp)
    max_dev = torch.zeros((), dtype=f64, device=dev)
    sampled = []
    for k in range(n_steps):
        state = step.given_op(state, new_idx[k % len(new_idx)])
        fresh = lp(state.params, state.tree)
        max_dev = torch.maximum(max_dev, (fresh - state.log_posterior).abs())
        state = state.replace(log_posterior=fresh)
        if (k + 1) % (n_steps // A14_TREES) == 0:
            sampled.append(host_tree(state.tree))
    if dev != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sampled.append(host_tree(state.tree))
    bad = [k for k, t in enumerate(sampled)
           if not valid_tree_np(*t, n_taxa)]
    acc = state.op_accept.tolist()
    rej = state.op_reject.tolist()
    a = {"steps": n_steps, "operators": len(new_idx),
         "seconds_with_checks": wall, "max_deviation": float(max_dev),
         "trees_checked": len(sampled), "acceptance": {
             label: {"drawn": acc[i] + rej[i],
                     "acceptance": acc[i] / max(acc[i] + rej[i], 1)}
             for (label, _), i in zip(new, new_idx)}}
    k = [0]

    def cycle(st, _t=1.0):
        k[0] += 1
        return step.given_op(st, new_idx[k[0] % len(new_idx)])

    from beast_mcmc_tpu_torch.inference.mcmc import run_chain

    wall_ms, busy = device_ms(lambda: run_chain(cycle, state, n_profile),
                              "p14a new operators", n_profile)
    a.update({"profile_ms_per_step": wall_ms,
              "states_per_s": 1e3 / wall_ms,
              "device_busy_share": None if busy is None else busy / wall_ms})
    expect("14a one chain", 1 + 2 * n_steps + n_profile)
    rec["14a"] = a
    log(f"[P14a] {n_steps} steps of {len(new_idx)} new operators in turn at "
        f"{n_taxa} taxa: max deviation {a['max_deviation']!r} (tolerance "
        f"{FULL_EVAL_TOL}), {a['trees_checked']} trees valid on the host: "
        f"{not bad}, {a['states_per_s']:.2f} states/s, busy share "
        f"{a['device_busy_share']}; launches "
        f"{json.dumps(launches['P14 14a one chain'])}")
    for label, r in a["acceptance"].items():
        log(f"[P14a]   {label:36s} drawn {r['drawn']:3d} acceptance "
            f"{r['acceptance']:.3f}")
    if bad or not a["max_deviation"] <= FULL_EVAL_TOL or min(
            r["drawn"] for r in a["acceptance"].values()) < min(
                A14_MIN_DRAWN, n_steps // len(new_idx)):
        raise AssertionError(f"P14a: invalid trees {bad}, deviation "
                             f"{a['max_deviation']}, {a['acceptance']}")

    # 14b: the Gibbs moves, each proposal through step.given_op
    b_rec = []
    for label, oi, op in ([("prune-regraft", gibbs_idx[0], gibbs[0])] * n_par
                          + [("subtree swap", gibbs_idx[1], gibbs[1])]
                          * n_swap):
        before = state
        n_acc = int(state.op_accept[oi])
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state = step.given_op(state, oi)
        if dev != "cpu":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        chunk = op.chunk(dev)
        want = 1 + sum(-(-n // chunk) for n in op.last_candidates)
        if op.last_calls != want:
            raise AssertionError(f"P14b {label}: {op.last_calls} posterior "
                                 f"calls, expected {want}")
        counts = expect(f"14b {label} {len(b_rec)}", want + 1)
        r = {"operator": label, "candidates": list(op.last_candidates),
             "chunk": chunk, "launches": counts["peel_stream"], "ms": ms,
             "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                if dev != "cpu" else None),
             "accepted": int(state.op_accept[oi]) > n_acc}
        # candidates sampled over the enumerations, each scored alone
        pairs = [(e, j) for e, scores in enumerate(op.last_scores)
                 for j in torch.isfinite(scores[0]).nonzero()[:, 0].tolist()]
        rng = np.random.default_rng(P14_SEED + len(b_rec))
        errs = []
        for n in rng.choice(len(pairs), min(len(pairs), B14_SAMPLED),
                            replace=False):
            e, j = pairs[n]
            one = lp(before.params, op.candidate_tree(e, 0, j))
            errs.append(float((one - op.last_scores[e][0, j]).abs()
                              / one.abs()))
        fresh = lp(state.params, state.tree)
        r["sampled_max_rel_err"] = max(errs)
        r["sampled"] = len(errs)
        r["carried_rel_err"] = float((fresh - state.log_posterior).abs()
                                     / fresh.abs())
        b_rec.append(r)
        log(f"[P14b] {label}: candidates {r['candidates']}, chunk {chunk}, "
            f"launches {r['launches']} (= 1 current + sum ceil(candidates / "
            f"chunk) + 1 step), {ms:.1f} ms, peak memory "
            f"{r['peak_memory_gb']} GB, accepted {r['accepted']}; "
            f"{len(errs)} sampled candidates' scores vs single-tree "
            f"evaluations max rel {r['sampled_max_rel_err']!r}, carried vs "
            f"fresh rel {r['carried_rel_err']!r} (tolerance {P14_REL_TOL})")
        if len(errs) != min(len(pairs), B14_SAMPLED) or max(
                r["sampled_max_rel_err"], r["carried_rel_err"]) > P14_REL_TOL:
            raise AssertionError(f"P14b {label}: {r}")
        if not valid_tree_np(*host_tree(state.tree), n_taxa):
            raise AssertionError(f"P14b {label}: invalid tree")
    rec["14b"] = b_rec

    # 14c: a batch, every new operator and the Gibbs moves in turn
    states = replicate_state(state, n_chains, torch.Generator(
        device=dev).manual_seed(P14_SEED + 1))
    mstep = make_multichain_step(analysis.log_posterior_chains, ops)
    order = new_idx + gibbs_idx
    reset_counts()
    calls0 = sum(g.total_calls for g in gibbs)
    max_dev = torch.zeros((), dtype=f64, device=dev)
    for k in range(c_steps):
        states = mstep.given_op(states, order[k % len(order)])
        fresh = analysis.log_posterior_chains(states.params, states.tree)
        max_dev = torch.maximum(max_dev,
                                (fresh - states.log_posterior).abs().max())
        states = states.replace(log_posterior=fresh)
    gibbs_calls = sum(g.total_calls for g in gibbs) - calls0
    expect("14c batch", 2 * c_steps + gibbs_calls)
    kc = [0]

    def batch_cycle(st, _t=1.0):
        kc[0] += 1
        return mstep.given_op(st, new_idx[kc[0] % len(new_idx)])

    reset_counts()
    wall_ms, busy = device_ms(lambda: run_chain(batch_cycle, states,
                                                c_profile),
                              "p14c batch of new operators", c_profile)
    expect("14c batch profile", c_profile)
    c = {"chains": n_chains, "steps": c_steps,
         "gibbs_posterior_calls": gibbs_calls,
         "max_deviation": float(max_dev),
         "profile_ms_per_batch_step": wall_ms,
         "aggregate_states_per_s": n_chains * 1e3 / wall_ms,
         "device_busy_share": None if busy is None else busy / wall_ms}
    rec["14c"] = c
    log(f"[P14c] {n_chains} chains x {c_steps} steps (every new operator "
        f"and both Gibbs moves in turn): launches one a batch step and one "
        f"a check plus the Gibbs proposals' {gibbs_calls}; max deviation "
        f"{c['max_deviation']!r} over every chain; aggregate "
        f"{c['aggregate_states_per_s']:.2f} states/s against one chain's "
        f"{a['states_per_s']:.2f} (14a), busy share {c['device_busy_share']}")
    if not c["max_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P14c deviation {c['max_deviation']}")
    for k in range(0, n_chains):
        if not valid_tree_np(*host_tree(TreeState(*(
                getattr(states.tree, f)[k] for f in
                ("parent", "children", "heights", "root")))), n_taxa):
            raise AssertionError(f"P14c chain {k}: invalid tree")

    # 14d: the operators with no target above, on small posteriors
    d = {}

    def run_small(label, log_post, operators, params, tree):
        stp = make_mcmc_step(log_post, operators)
        st = init_mcmc_state(params, tree, torch.Generator(
            device=dev).manual_seed(P14_SEED), operators, log_post)
        for k in range(d_steps):
            st = stp.given_op(st, k % len(operators))
        lp_end = float(st.log_posterior)
        acc, rej = st.op_accept.tolist(), st.op_reject.tolist()
        d[label] = {"log_posterior": lp_end, "acceptance": [
            x / max(x + y, 1) for x, y in zip(acc, rej)]}
        log(f"[P14d] {label}: {d_steps} steps, log posterior {lp_end!r}, "
            f"acceptance {d[label]['acceptance']}")
        if not math.isfinite(lp_end):
            raise AssertionError(f"P14d {label}: {lp_end}")

    n_star = 8  # a caterpillar whose internal nodes share one height
    ch = np.full((2 * n_star - 1, 2), -1)
    for i in range(1, n_star):
        ch[n_star + i - 1] = (n_star + i - 2 if i > 1 else 0, i)
    par = np.full(2 * n_star - 1, -1)
    for x in range(n_star, 2 * n_star - 1):
        par[ch[x]] = x
    star = make_tree_state(par, ch, np.r_[np.zeros(n_star),
                                          np.full(n_star - 1, 1.0)],
                           2 * n_star - 2, f64, dev)
    run_small("star root height scale", lambda p, t: P.lognormal_logpdf(
        t.heights[t.root], 0.0, 0.5),
        [O.StarRootHeightScaleOperator(n_taxa=n_star)], {}, star)
    data = torch.tensor(np.random.default_rng(P14_SEED).normal(2.0, 0.5, 20),
                        dtype=f64, device=dev)

    def normal_model(p, t):
        return (P.normal_gamma_precision_logpdf(data, p["mu"], p["tau"])
                + P.gamma_logpdf(p["tau"], 2.0, 1.0)
                + P.normal_logpdf(p["mu"], 0.0, 10.0))

    kw = {"data_parameter": "data", "mean_parameter": "mu",
          "precision_parameter": "tau"}
    run_small("conjugate normal-gamma Gibbs", normal_model,
                   [O.NormalGammaPrecisionGibbsOperator(prior_shape=2.0,
                                                        prior_rate=1.0, **kw),
                    O.NormalNormalMeanGibbsOperator(prior_precision=0.01,
                                                    **kw)],
                   {"data": data, "mu": torch.zeros((), dtype=f64,
                                                    device=dev),
                    "tau": torch.ones((), dtype=f64, device=dev)}, star)
    if d["conjugate normal-gamma Gibbs"]["acceptance"] != [1.0, 1.0]:
        raise AssertionError(f"P14d conjugate Gibbs {d}")
    n_b, n_sites = bssvs_shape
    rng = np.random.default_rng(P14_SEED)
    letters = np.array(list("ABCD"))
    names = [f"t{i}" for i in range(n_b)]
    pats = al.SitePatterns.from_alignment(al.Alignment.from_sequences(
        names, ["".join(letters[rng.integers(0, 4, n_sites)])
                for _ in names], dt.general_datatype(list("ABCD"))))
    bspec = S.AnalysisSpec(
        partitions=[S.Partition(
            patterns=pats,
            substitution=S.GeneralReversible(n_states=4, bssvs=True))],
        tree=S.TreeSpec(seed=P14_SEED),
        clock=S.StrictClock(rate=S.Param(1.0, prior=S.CTMCScalePrior())),
        tree_prior=S.ConstantCoalescent())
    exchange = O.RateBitExchangeOperator(bit_parameter="p1.indicators",
                                         rate_parameter="p1.rates")
    bspec.extra_operators = [exchange]
    banalysis = build(bspec, device=dev)
    bops = banalysis.operators
    k_x = next(k for k, op in enumerate(bops) if op is exchange)
    bops = [bops[k_x]] + [op for k, op in enumerate(bops) if k != k_x]
    run_small("rate-bit exchange on BSSVS", banalysis.log_posterior,
              bops[:1] + [op for op in bops[1:]
                          if type(op).__name__ == "BitFlipOperator"],
              banalysis.params0, banalysis.tree0)

    worst = {}
    for name, args in density_cases():
        def on(device):
            return getattr(P, name)(*[
                torch.tensor(x, dtype=f64, device=device)
                if isinstance(x, np.ndarray) else x for x in args])
        got, ref = float(on(dev)), float(on("cpu"))
        worst[name] = abs(got - ref) / abs(ref) if ref != got else 0.0
    p_q = np.random.default_rng(P14_SEED).uniform(0.01, 0.99, 64)
    shape = np.exp(np.random.default_rng(P14_SEED + 1).uniform(-3.0, 4.0,
                                                                 64))
    for name, fn, args in (
            ("gamma_quantile", special.gamma_quantile, (p_q, shape)),
            ("gammainc_fixed", special.gammainc_fixed, (shape, shape * p_q
                                                        * 2))):
        got = fn(*[torch.tensor(x, device=dev) for x in args]).cpu()
        ref = fn(*[torch.tensor(x) for x in args])
        worst[name] = float(((got - ref).abs() / ref.abs()).max())
    d["densities_max_rel_err"] = max(worst.values())
    d["densities"] = len(worst)
    rec["14d"] = d
    log(f"[P14d] {len(worst)} functions (36 densities, gamma_quantile, "
        f"gammainc_fixed) on the card against the CPU: max relative "
        f"difference {d['densities_max_rel_err']!r} (tolerance "
        f"{P14_DENSITY_TOL}); worst {max(worst, key=worst.get)}")
    if not d["densities_max_rel_err"] <= P14_DENSITY_TOL:
        raise AssertionError(f"P14d densities: {worst}")
    return rec, launches


def tools_path(out_dir, n_taxa, dev, n_sites=SPEC_SITES,
               burnin_states=TOOLS_BURNIN_STATES):
    """Phase 13b: the sub-tools through __main__.main on phase 12's files
    in out_dir, each required to return 0, its host seconds recorded:
    loganalyser on straight.log (every column reported); logcombiner of
    first.log and resumed.log past burnin_states (its rows those of the
    two at or past it); treeannotator's MCC tree of straight.trees
    (read back by parse_newick with all n_taxa tips); treestat on
    straight.trees (a row a tree); seqgen down the last tree of
    straight.trees, n_sites columns under SEQGEN_PARTITION on `dev` (its
    FASTA read back: n_taxa rows of n_sites, the pattern count recorded).
    Returns the record."""
    import contextlib
    import io

    from beast_mcmc_tpu_torch.__main__ import main as cli
    from beast_mcmc_tpu_torch.apps.treeannotator import read_trees_file
    from beast_mcmc_tpu_torch.data.alignment import SitePatterns
    from beast_mcmc_tpu_torch.data.io import read_fasta
    from beast_mcmc_tpu_torch.tree.topology import parse_newick, to_newick

    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    rec = {}

    def tool(name, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli([name] + argv)
        secs = time.perf_counter() - t0
        rec[name] = {"rc": rc, "host_seconds": secs}
        log(f"[P13b] {name}: rc {rc} in {secs:.2f} s")
        if rc != 0:
            raise AssertionError(f"P13b {name}: rc {rc}\n{buf.getvalue()}")
        return buf.getvalue()

    def rows(f, burnin=0):
        return [ln for ln in open(f) if ln[:1].isdigit()
                and int(ln.split("\t")[0]) >= burnin]

    report = tool("loganalyser", [path("straight.log")])
    header = next(ln for ln in open(path("straight.log"))
                  if ln.startswith("state")).split("\t")[1:]
    missing = [c.strip() for c in header if c.strip() not in report]
    if missing:
        raise AssertionError(f"P13b loganalyser: {missing} not reported")

    tool("logcombiner", ["-burnin", str(burnin_states),
                         path("first.log"), path("resumed.log"),
                         path("combined.log")])
    want = sum(len(rows(path(f), burnin_states))
               for f in ("first.log", "resumed.log"))
    rec["logcombiner"]["rows"] = len(rows(path("combined.log")))
    if rec["logcombiner"]["rows"] != want:
        raise AssertionError(f"P13b logcombiner: {rec['logcombiner']['rows']}"
                             f" rows, expected {want}")

    tool("treeannotator", ["-burnin", str(TOOLS_BURNIN_FRACTION),
                           path("straight.trees"), path("mcc.tree")])
    tips = parse_newick(open(path("mcc.tree")).read())[4]
    trees = read_trees_file(path("straight.trees"))
    rec["treeannotator"]["tips"] = len(tips)
    if len(tips) != n_taxa or set(tips) != set(trees[0].taxa):
        raise AssertionError(f"P13b treeannotator: {len(tips)} tips")

    tool("treestat", [path("straight.trees"), "-output",
                      path("treestat.txt")])
    rec["treestat"]["rows"] = sum(1 for ln in open(path("treestat.txt"))
                                  if ln[:1].isdigit())
    if rec["treestat"]["rows"] != len(trees):
        raise AssertionError(f"P13b treestat: {rec['treestat']['rows']} rows")

    last = trees[-1]
    with open(path("last.nwk"), "w") as f:
        f.write(to_newick(last.parent, last.children, last.heights,
                          last.root, last.taxa) + "\n")
    tool("seqgen", ["-tree", path("last.nwk"), "-partition",
                    f"length={n_sites},{SEQGEN_PARTITION}", "-seed",
                    str(SEQGEN_SEED), "-output", path("seqgen.fasta"),
                    "-device", str(dev)])
    aln = read_fasta(open(path("seqgen.fasta")).read())
    rec["seqgen"]["shape"] = list(aln.states.shape)
    rec["seqgen"]["patterns"] = SitePatterns.from_alignment(aln).n_patterns
    if rec["seqgen"]["shape"] != [n_taxa, n_sites]:
        raise AssertionError(f"P13b seqgen: {rec['seqgen']['shape']}")
    log(f"[P13b] seqgen wrote {n_taxa} x {n_sites}: "
        f"{rec['seqgen']['patterns']} patterns")
    return rec


# phase 15, the XML interpreter route at the Makona shape: 15a's steps
# (the CLI's full-evaluation check is the interpreter's default of 100
# steps), 15b's steps and full-evaluation steps, the profiler windows, the
# log interval, the seed, 15b's local-clock clade and skyline groups, the
# -testxml document's chain scale, and 15c's tolerances (card against the
# CPU, relative to the output's largest magnitude; the SIR ODE's loop
# accumulates)
P15_STEPS_A, P15_CHECK_A = 300, 100
P15_STEPS_B, P15_CHECK_B = 200, 50
P15_PROFILE, P15_LOG_EVERY, P15_SEED = PROFILE_STEPS, 10, 7
P15_CLADE, P15_GROUPS = 100, 10
P15_TESTXML_SCALE = 0.02
P15_REL_TOL, P15_ODE_TOL = 1e-12, 1e-10


def interpreter_document(path, kind, data, n_steps):
    """Write a document outside the importer's vocabulary at `path` on
    makona_data's taxa and alignment, with a coalescentSimulator start
    tree (the interpreter draws it from its numpy stream) and n_steps
    states, <log logEvery="P15_LOG_EVERY"> of the posterior (the one
    column that evaluates the tree likelihood) and scalar parameters, and
    a tree log. kind "rlc" (15a): gtrModel with Gamma4, a
    randomLocalClockModel over every node (rates, rateIndicator,
    clockRate), a sumStatistic of the indicators under a poissonPrior, a
    time-aware gmrfSkyrideLikelihood whose precision has a gammaPrior;
    scale, bit-flip, random-walk, subtree-slide, narrow-exchange,
    Wilson-Balding and uniform node-height operators. kind "skyline" (15b):
    HKYModel with Gamma4, a localClockModel with one clade of the first
    P15_CLADE taxa and the trunk, a stepwise generalizedSkyLineLikelihood
    of P15_GROUPS groups; its operators with an integer delta exchange on
    the group sizes. Returns the file's name of its log."""
    from xml.sax.saxutils import quoteattr

    cfg = data["cfg"]
    init = cfg["model"]["init"]
    pop = float(cfg["pop_size"])
    freqs = " ".join(repr(float(f)) for f in init["frequencies"])
    alpha = float(init["siteModel.alpha"])
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += taxa_alignment_xml(data)
    name = f"makona_{kind}"
    common = f"""  <patterns id="patterns" from="1"><alignment idref="alignment"/></patterns>
  <constantSize id="initialDemo" units="years">
    <populationSize><parameter id="initialDemo.popSize" value="{pop!r}"/></populationSize>
  </constantSize>
  <coalescentSimulator id="startingTree">
    <taxa idref="taxa"/><constantSize idref="initialDemo"/>
  </coalescentSimulator>
  <treeModel id="treeModel">
    <coalescentTree idref="startingTree"/>
    <rootHeight><parameter id="treeModel.rootHeight"/></rootHeight>
    <nodeHeights internalNodes="true"><parameter id="treeModel.internalNodeHeights"/></nodeHeights>
  </treeModel>"""
    tree_ops = """    <subtreeSlide size="1.0" gaussian="true" weight="15"><treeModel idref="treeModel"/></subtreeSlide>
    <narrowExchange weight="15"><treeModel idref="treeModel"/></narrowExchange>
    <wilsonBalding weight="3"><treeModel idref="treeModel"/></wilsonBalding>
    <uniformOperator weight="30"><parameter idref="treeModel.internalNodeHeights"/></uniformOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="treeModel.rootHeight"/></scaleOperator>"""
    site = f"""    <gammaShape gammaCategories="4"><parameter id="alpha" value="{alpha!r}" lower="0.0"/></gammaShape>"""
    if kind == "rlc":
        rates = "\n".join(
            f'    <rate{r}><parameter id="gtr.{r.lower()}" '
            f'value="{float(init["gtr." + r.lower()])!r}" lower="0.0"/>'
            f"</rate{r}>" for r in ("AC", "AG", "AT", "CG", "GT"))
        model = f"""  <gtrModel id="subst">
    <frequencies><frequencyModel dataType="nucleotide">
      <frequencies><parameter id="frequencies" value="{freqs}"/></frequencies>
    </frequencyModel></frequencies>
{rates}
  </gtrModel>
  <randomLocalClockModel id="clock">
    <treeModel idref="treeModel"/>
    <rates><parameter id="rlc.rates"/></rates>
    <rateIndicator><parameter id="rlc.indicators"/></rateIndicator>
    <clockRate><parameter id="clock.rate" value="{float(init['ucld.mean'])!r}" lower="0.0"/></clockRate>
  </randomLocalClockModel>
  <sumStatistic id="rlc.changes"><parameter idref="rlc.indicators"/></sumStatistic>
  <gmrfSkyrideLikelihood id="treePrior" timeAwareSmoothing="true">
    <populationSizes><parameter id="skyride.logPopSize" value="{float(__import__('math').log(pop))!r}"/></populationSizes>
    <precisionParameter><parameter id="skyride.precision" value="1.0" lower="0.0"/></precisionParameter>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </gmrfSkyrideLikelihood>"""
        clock_ref = '<randomLocalClockModel idref="clock"/>'
        ops = """    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="clock.rate"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="10"><parameter idref="rlc.rates"/></scaleOperator>
    <bitFlipOperator weight="10"><parameter idref="rlc.indicators"/></bitFlipOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="gtr.ag"/></scaleOperator>
    <randomWalkOperator windowSize="0.5" weight="10"><parameter idref="skyride.logPopSize"/></randomWalkOperator>
    <scaleOperator scaleFactor="0.75" weight="2"><parameter idref="skyride.precision"/></scaleOperator>"""
        priors = """        <poissonPrior mean="0.6931471805599453"><statistic idref="rlc.changes"/></poissonPrior>
        <gammaPrior shape="0.5" scale="2.0"><parameter idref="rlc.rates"/></gammaPrior>
        <gammaPrior shape="0.001" scale="1000.0"><parameter idref="skyride.precision"/></gammaPrior>
        <gmrfSkyrideLikelihood idref="treePrior"/>"""
        logged = """      <parameter idref="clock.rate"/>
      <sumStatistic idref="rlc.changes"/>
      <parameter idref="skyride.precision"/>"""
    else:
        clade = "".join(f"<taxon idref={quoteattr(t)}/>"
                        for t in data["taxa"][:P15_CLADE])
        pops = " ".join([repr(pop)] * P15_GROUPS)
        model = f"""  <taxa id="clade">{clade}</taxa>
  <HKYModel id="subst">
    <frequencies><frequencyModel dataType="nucleotide">
      <frequencies><parameter id="frequencies" value="{freqs}"/></frequencies>
    </frequencyModel></frequencies>
    <kappa><parameter id="kappa" value="4.0" lower="0.0"/></kappa>
  </HKYModel>
  <localClockModel id="clock">
    <treeModel idref="treeModel"/>
    <rate><parameter id="clock.rate" value="{float(init['ucld.mean'])!r}" lower="0.0"/></rate>
    <clade includeStem="false"><taxa idref="clade"/>
      <parameter id="clade.rate" value="{float(init['ucld.mean'])!r}" lower="0.0"/></clade>
  </localClockModel>
  <generalizedSkyLineLikelihood id="treePrior" linear="false">
    <populationSizes><parameter id="skyline.popSize" value="{pops}" lower="0.0"/></populationSizes>
    <groupSizes><parameter id="skyline.groupSize" dimension="{P15_GROUPS}"/></groupSizes>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </generalizedSkyLineLikelihood>"""
        clock_ref = '<localClockModel idref="clock"/>'
        ops = """    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="clock.rate"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="clade.rate"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="kappa"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="10"><parameter idref="skyline.popSize"/></scaleOperator>
    <deltaExchange delta="1" integer="true" weight="5"><parameter idref="skyline.groupSize"/></deltaExchange>"""
        priors = """        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="kappa"/></logNormalPrior>
        <oneOnXPrior><parameter idref="skyline.popSize"/></oneOnXPrior>
        <generalizedSkyLineLikelihood idref="treePrior"/>"""
        logged = """      <parameter idref="clock.rate"/>
      <parameter idref="clade.rate"/>
      <parameter idref="kappa"/>"""
    out.append(f"""{common}
{model}
  <siteModel id="siteModel">
    <substitutionModel><{'gtrModel' if kind == 'rlc' else 'HKYModel'} idref="subst"/></substitutionModel>
{site}
  </siteModel>
  <treeLikelihood id="treeLikelihood" useAmbiguities="false">
    <patterns idref="patterns"/><treeModel idref="treeModel"/>
    <siteModel idref="siteModel"/>{clock_ref}
  </treeLikelihood>
  <operators id="operators">
{ops}
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="alpha"/></scaleOperator>
{tree_ops}
  </operators>
  <mcmc id="mcmc" chainLength="{n_steps}" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        <exponentialPrior mean="0.5"><parameter idref="alpha"/></exponentialPrior>
{priors}
      </prior>
      <likelihood id="likelihood"><treeLikelihood idref="treeLikelihood"/></likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="{P15_LOG_EVERY}" fileName="{name}.log">
      <posterior idref="posterior"/>
      <parameter idref="alpha"/>
{logged}
      <parameter idref="treeModel.rootHeight"/>
    </log>
    <logTree logEvery="{P15_LOG_EVERY}" fileName="{name}.trees">
      <treeModel idref="treeModel"/>
    </logTree>
  </mcmc>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return f"{name}.log"


def _interp_files_check(label, out_dir, log_name, n_steps, n_taxa):
    """The run's log (n_steps / P15_LOG_EVERY rows, finite) and tree file
    (as many trees of every taxon) read back; (rows, trees)."""
    import math

    from beast_mcmc_tpu_torch.tree.topology import parse_newick

    lines = open(os.path.join(out_dir, log_name)).read().splitlines()
    rows = [ln.split("\t") for ln in lines if ln[:1].isdigit()]
    want = n_steps // P15_LOG_EVERY
    if (len(rows) != want or lines[0].split("\t")[:2] != ["state", "posterior"]
            or not all(math.isfinite(float(v)) for r in rows for v in r)):
        raise AssertionError(f"P15 {label} log: {len(rows)} rows of {want}")
    trees = [ln.split("[&R]", 1)[1].strip() for ln in open(os.path.join(
        out_dir, log_name.replace(".log", ".trees")))
        if ln.startswith("tree STATE_")]
    if len(trees) != want or any(len(parse_newick(t)[4]) != n_taxa
                                 for t in trees):
        raise AssertionError(f"P15 {label} trees: {len(trees)}")
    return len(rows), len(trees)


def interpreter_path(out_dir, reset_counts, read_counts, device_ms, dev,
                     n_taxa=SPEC_TAXA, n_sites=SPEC_SITES,
                     steps_a=P15_STEPS_A, steps_b=P15_STEPS_B,
                     check_b=P15_CHECK_B,
                     n_profile=P15_PROFILE):
    """Phases 15a and 15b (see the module docstring) at n_taxa x n_sites.
    The peel launches of each run are predicted from _run_mcmc's
    evaluations: the start, two a checked step (the step's own and the
    fresh one), one a step, and one a log row for the posterior column;
    all of them peel_stream at the Makona shape. Returns (record,
    launches)."""
    import contextlib
    import io
    import re

    from beast_mcmc_tpu_torch.__main__ import main as cli
    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.inference.mcmc import run_chain

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    docs = {k: os.path.join(out_dir, f"makona_{k}.xml")
            for k in ("rlc", "skyline")}
    logs = {"rlc": interpreter_document(docs["rlc"], "rlc", data, steps_a),
            "skyline": interpreter_document(docs["skyline"], "skyline",
                                            data, steps_b)}
    rec = {"taxa": len(data["taxa"]), "sites": data["sites"],
           "patterns": data["patterns"],
           "documents_seconds": time.perf_counter() - t0}
    launches = {}
    kname = "peel_stream"

    def expect(counts, n, label):
        want = {k: n * (k == kname) for k in counts}
        launches[f"P15 {label}"] = counts
        if counts != want:
            raise AssertionError(f"P15 {label}: launches {counts}, "
                                 f"expected {want}")

    def profile(ax, label):
        """A profiler window of n_profile steps from the document's start
        state: one launch to start, one a step."""
        reset_counts()
        chain = ax.prepare_chain()
        wall, busy = device_ms(lambda: run_chain(
            chain["step"], chain["state"], n_profile), label, n_profile)
        expect(read_counts(), 1 + n_profile, label)
        return {"profile_ms_per_step": wall,
                "device_busy_share": None if busy is None else busy / wall,
                "device_events_per_step": device_ms.events}

    # 15a: the CLI, as a user runs it; the importer refuses the document
    reset_counts()
    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(out_dir)
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(["run", docs["rlc"], "-seed", str(P15_SEED), "-device",
                      str(dev)])
    finally:
        os.chdir(cwd)
    cli_s = time.perf_counter() - t1
    a = {"rc": rc, "cli_seconds": cli_s}
    text = out.getvalue() + err.getvalue()
    m = re.search(r"(\d+) states in ([0-9.]+)s = ([0-9.]+) states/sec; "
                  r"full-evaluation deviation (\S+)", text)
    if rc != 0 or "running through the interpreter registry]" not in text \
            or m is None:
        raise AssertionError(f"P15a: rc {rc}\n{text[-3000:]}")
    a.update({"steps": int(m.group(1)), "chain_seconds": float(m.group(2)),
              "states_per_s": float(m.group(3)),
              "full_evaluation_deviation": float(m.group(4))})
    rows = steps_a // P15_LOG_EVERY
    a["predicted_launches"] = 1 + 2 * P15_CHECK_A + steps_a + rows
    expect(read_counts(), a["predicted_launches"], "15a CLI")
    a["log_rows"], a["trees"] = _interp_files_check(
        "15a", out_dir, logs["rlc"], steps_a, rec["taxa"])
    if not a["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P15a deviation {a}")
    ax = XmlAnalysis(docs["rlc"], seed=P15_SEED, device=dev,
                     workdir=out_dir)
    a.update(profile(ax, "p15a interpreter chain"))
    rec["15a"] = a
    log(f"[P15a] CLI rc {rc} in {cli_s:.2f} s: {a['steps']} states in "
        f"{a['chain_seconds']:.2f} s = {a['states_per_s']} states/s, "
        f"full-evaluation deviation {a['full_evaluation_deviation']!r} "
        f"(tolerance {FULL_EVAL_TOL}), peel_stream launches "
        f"{a['predicted_launches']} as predicted, {a['log_rows']} log rows "
        f"and {a['trees']} trees read back; profile "
        f"{a['profile_ms_per_step']:.3f} ms a step, busy share "
        f"{a['device_busy_share']}, {a['device_events_per_step']} device "
        f"events a step")

    # 15b: XmlAnalysis.run, as run_testxml runs it
    reset_counts()
    ax = XmlAnalysis(docs["skyline"], seed=P15_SEED, device=dev,
                     workdir=out_dir)
    t1 = time.perf_counter()
    ax.run(full_eval_steps=check_b)
    b = {"run_seconds": time.perf_counter() - t1, **ax.runs[0]}
    b["states_per_s"] = b["steps"] / b["seconds"]
    rows = steps_b // P15_LOG_EVERY
    b["predicted_launches"] = 1 + 2 * check_b + steps_b + rows
    expect(read_counts(), b["predicted_launches"], "15b run")
    b["log_rows"], b["trees"] = _interp_files_check(
        "15b", out_dir, logs["skyline"], steps_b, rec["taxa"])
    if not b["full_eval_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P15b deviation {b}")
    b.update(profile(ax, "p15b interpreter chain"))
    rec["15b"] = b
    log(f"[P15b] XmlAnalysis.run in {b['run_seconds']:.2f} s: {b['steps']} "
        f"states in {b['seconds']:.2f} s = {b['states_per_s']:.2f} "
        f"states/s, full-evaluation deviation "
        f"{b['full_eval_deviation']!r}, peel_stream launches "
        f"{b['predicted_launches']} as predicted, {b['log_rows']} log rows "
        f"and {b['trees']} trees read back; profile "
        f"{b['profile_ms_per_step']:.3f} ms a step, busy share "
        f"{b['device_busy_share']}, {b['device_events_per_step']} device "
        f"events a step")
    return rec, launches


def p15_function_cases(parent, children, heights, root, n_taxa, seed):
    """{label: fn(A) -> tensor}: every function that models/{clock,epoch,
    coalescent,speciation}.py gained with the interpreter route, on the
    tree (parent, heights) of n_taxa taxa and inputs drawn with numpy from
    `seed`; A(x) makes a tensor of x on the device under test."""
    import numpy as np

    from beast_mcmc_tpu_torch.models import clock, coalescent as coal
    from beast_mcmc_tpu_torch.models import epoch, speciation as spec
    from beast_mcmc_tpu_torch.models import substitution as subst

    m = parent.shape[0]
    n_ev = n_taxa - 1
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.5, 2.0, m)
    ind = (rng.uniform(size=m) < 0.05).astype(np.float64)
    log_rates = rng.normal(0.0, 0.3, m)
    q = rng.uniform(0.05, 0.95, m)
    log_pops = rng.normal(0.0, 0.4, n_ev)
    groups = np.full(10, n_ev // 10)
    groups[: n_ev - groups.sum()] += 1
    tipset = np.zeros(m, bool)
    tipset[rng.choice(n_taxa, min(100, n_taxa // 2), replace=False)] = True
    ebsp_pops = rng.uniform(0.3, 1.2, n_ev)
    ebsp_ind = (rng.uniform(size=n_ev - 1) < 0.1).astype(np.float64)
    root_h = float(heights.max())
    cuts = np.linspace(root_h / 20, root_h, 20)
    gamma20 = rng.normal(0.0, 0.3, 21)
    qmat = rng.uniform(0.1, 1.0, (4, 4))
    np.fill_diagonal(qmat, 0.0)
    np.fill_diagonal(qmat, -qmat.sum(1))
    freqs = np.array([0.3, 0.2, 0.25, 0.25])
    h = heights
    P = parent

    def hky(A, kappa):
        return subst.hky_eigen(A(kappa), A(freqs))

    return {
        "strict_clock_rates": lambda A: clock.strict_clock_rates(A(1.7), m),
        "continuous_quantile_rates": lambda A: clock
        .continuous_quantile_rates(A(q), A(1.2), A(0.4)),
        "arbitrary_rates": lambda A: clock.arbitrary_rates(A(rates)),
        "rate_epoch_rates": lambda A: clock.rate_epoch_rates(
            A(h), A(P), A(np.array([0.3, 0.8]) * root_h),
            A(np.array([1.0, 2.0, 0.5]))),
        "_doubling_steps": lambda A: A(np.asarray(
            [clock._doubling_steps(k) for k in (2, 3, m)])),
        "ancestor_or_self_mask": lambda A: clock.ancestor_or_self_mask(
            A(P), int(root)).double(),
        "local_clock_rates": lambda A: clock.local_clock_rates(
            A(np.arange(m) % 3), A(np.array([0.5, 1.0, 2.0]))),
        "random_local_clock_rates": lambda A: clock.random_local_clock_rates(
            A(P), A(h), A(ind), A(rates)),
        "random_local_clock_rates multipliers": lambda A: clock
        .random_local_clock_rates(A(P), A(h), A(ind), A(rates),
                                  mean_rate=A(0.7),
                                  rates_are_multipliers=True),
        "branch_rate_increments": lambda A: clock.branch_rate_increments(
            A(P), A(h), A(log_rates), True)[0],
        "autocorrelated_rates_log_density": lambda A: clock
        .autocorrelated_rates_log_density(A(P), A(h), A(log_rates), A(3.0)),
        "shrinkage_local_clock_log_density": lambda A: clock
        .shrinkage_local_clock_log_density(A(P), A(h), A(log_rates), A(0.4),
                                           A(0.5)),
        "lognormal_mixture_cdf": lambda A: clock.lognormal_mixture_cdf(
            A(rates), A(np.array([0.3, 0.7])), A(np.array([0.8, 1.5])),
            A(np.array([0.3, 0.6]))),
        "mixture_model_rates": lambda A: clock.mixture_model_rates(
            A(q), A(np.array([0.3, 0.7])), A(np.array([0.8, 1.5])),
            A(np.array([0.3, 0.6]))),
        "latent_state_branch_rates": lambda A: clock
        .latent_state_branch_rates(A(rates), A(q * 0.5)),
        "two_state_occupancy_log_density": lambda A: clock
        .two_state_occupancy_log_density(A(rates), A(q * 0.5), A(0.8),
                                         A(1.3)),
        "epoch_overlaps": lambda A: epoch.epoch_overlaps(
            A(P), A(h), A(np.array([0.2, 0.6]) * root_h)),
        "epoch_branch_matrices": lambda A: epoch.epoch_branch_matrices(
            [hky(A, 2.0), A(qmat), hky(A, 6.0)],
            A(np.array([0.2, 0.6]) * root_h), A(P), A(h), A(rates * 1e-3),
            A(np.array([0.3, 0.8, 1.2, 1.7]))),
        "ancestor_closure": lambda A: epoch.ancestor_closure(
            A(P), A(0.0).dtype),
        "clade_branch_matrices": lambda A: epoch.clade_branch_matrices(
            hky(A, 2.0), [(A(tipset[:n_taxa]), hky(A, 8.0), A(0.4))],
            A(P), A(h), A(root), A(rates * 1e-3),
            A(np.array([0.3, 0.8, 1.2, 1.7]))),
        "logistic_growth_loglik": lambda A: coal.logistic_growth_loglik(
            A(h), n_taxa, A(0.6), A(2.0 / root_h), A(0.6 * root_h)),
        "expansion_loglik": lambda A: coal.expansion_loglik(
            A(h), n_taxa, A(0.6), A(0.2), A(3.0 / root_h)),
        "piecewise_exponential_loglik": lambda A: coal
        .piecewise_exponential_loglik(A(h), n_taxa,
                                      A(np.array([0.6, 0.3, 0.9])),
                                      A(np.array([1.5])),
                                      A(np.array([0.2, 0.3]) * root_h)),
        "cataclysm_loglik": lambda A: coal.cataclysm_loglik(
            A(h), n_taxa, A(0.5), A(1.2), A(4.0), A(0.3 * root_h)),
        "bayesian_skyline_loglik": lambda A: coal.bayesian_skyline_loglik(
            A(h), n_taxa, A(rng_pops(10)), A(groups)),
        "bayesian_skyline_linear_loglik": lambda A: coal
        .bayesian_skyline_linear_loglik(A(h), n_taxa, A(rng_pops(11)),
                                        A(groups)),
        "gmrf_skyride_loglik": lambda A: coal.gmrf_skyride_loglik(
            A(h), n_taxa, A(log_pops)),
        "skyride_coalescent_midpoints": lambda A: coal
        .skyride_coalescent_midpoints(A(h), n_taxa),
        "gmrf_skyride_time_aware_prior": lambda A: coal
        .gmrf_skyride_time_aware_prior(A(h), n_taxa, A(log_pops), A(2.5)),
        "gmrf_skyride_uniform_prior": lambda A: coal
        .gmrf_skyride_uniform_prior(A(log_pops), A(2.5)),
        "grouped_skyride_loglik": lambda A: coal.grouped_skyride_loglik(
            A(h), n_taxa, A(np.log(rng_pops(10))), A(groups)),
        "grouped_skyride_gmrf_prior": lambda A: coal
        .grouped_skyride_gmrf_prior(A(h), n_taxa, A(np.log(rng_pops(10))),
                                    A(groups), A(1.5), lam=A(0.6)),
        "sir_trajectories": lambda A: coal.sir_trajectories(
            A(2.5), A(4.0), A(0.01), A(np.linspace(0.0, root_h, 256)))[1],
        "sir_coalescent_loglik": lambda A: coal.sir_coalescent_loglik(
            A(h), n_taxa, A(2.5), A(4.0 / root_h), A(0.01), A(5000.0),
            root_h),
        "multilocus_skygrid_loglik": lambda A: coal.multilocus_skygrid_loglik(
            [A(h), A(h)], [n_taxa, n_taxa], A(gamma20), A(cuts),
            [1.0, 0.5]),
        "_ebsp_pop_at": lambda A: coal._ebsp_pop_at(
            A(h), coal.ebsp_knots(A(h[n_taxa:]), True), A(ebsp_pops),
            A(np.r_[True, ebsp_ind > 0.5])),
        "ebsp_knots": lambda A: coal.ebsp_knots(A(h[n_taxa:]), False),
        "ebsp_coalescent_loglik": lambda A: coal.ebsp_coalescent_loglik(
            [A(h)], [n_taxa], [1.0], A(ebsp_pops), A(ebsp_ind), True),
        "smooth_skygrid_loglik": lambda A: coal.smooth_skygrid_loglik(
            A(h), n_taxa, A(gamma20), A(cuts), A(50.0 / root_h)),
        "coalescent_loglik_integral": lambda A: coal
        .coalescent_loglik_integral(
            A(h), n_taxa, lambda t: 0.2 * t - 0.5,
            coal.quad_interval_integral(lambda t: 0.2 * t - 0.5, 12)),
        "quad_interval_integral": lambda A: coal.quad_interval_integral(
            lambda t: 0.3 * t + 0.1 * t * t, 16)(A(h[:-1]), A(h[1:])),
        "const_exponential_loglik": lambda A: coal.const_exponential_loglik(
            A(h), n_taxa, A(0.6), A(0.1), A(4.0 / root_h)),
        "exp_constant_loglik": lambda A: coal.exp_constant_loglik(
            A(h), n_taxa, A(0.6), A(2.0 / root_h), A(0.2 * root_h)),
        "const_logistic_loglik": lambda A: coal.const_logistic_loglik(
            A(h), n_taxa, A(0.6), A(0.1), A(3.0 / root_h), A(0.4)),
        "linear_growth_loglik": lambda A: coal.linear_growth_loglik(
            A(h), n_taxa, A(2.0)),
        "power_law_growth_loglik": lambda A: coal.power_law_growth_loglik(
            A(h), n_taxa, A(0.5), A(1.5)),
        "flexible_growth_loglik": lambda A: coal.flexible_growth_loglik(
            A(h), n_taxa, A(0.5), A(2.0), A(1.5)),
        "multi_epoch_exponential_loglik": lambda A: coal
        .multi_epoch_exponential_loglik(A(h), n_taxa, A(0.6),
                                        A(np.array([2.0, 0.0, 1.0]) / root_h),
                                        A(np.array([0.1, 0.3]) * root_h)),
        "exponential_sawtooth_loglik": lambda A: coal
        .exponential_sawtooth_loglik(A(h), n_taxa, A(0.6), A(2.0 / root_h),
                                     A(0.15 * root_h), A(0.2)),
        "exponential_logistic_loglik": lambda A: coal
        .exponential_logistic_loglik(A(h), n_taxa, A(0.6), A(3.0 / root_h),
                                     A(0.5 * root_h), A(0.5 / root_h),
                                     A(0.25 * root_h)),
        "_bdss_c1": lambda A: spec._bdss_c1(A(2.0), A(0.5), A(0.3)),
        "_bdss_c2": lambda A: spec._bdss_c2(A(2.0), A(0.5), A(0.1), A(0.3)),
        "bdss_log_q": lambda A: spec.bdss_log_q(A(2.0), A(0.5), A(0.1),
                                                A(0.3), A(h / root_h)),
        "bdss_p0": lambda A: spec.bdss_p0(A(2.0), A(0.5), A(0.1), A(0.3),
                                          A(h / root_h)),
        "serial_birth_death_loglik": lambda A: spec.serial_birth_death_loglik(
            A(h / root_h), n_taxa, A(2.0), A(0.5), A(0.3), A(1.2)),
        "episodic_serial_birth_death_loglik": lambda A: spec
        .episodic_serial_birth_death_loglik(
            A(h / root_h), n_taxa, A(1.2), A(np.array([2.0, 1.5, 3.0])),
            A(np.array([0.5, 0.7, 0.2])), A(np.array([0.3, 0.4, 0.2])),
            treatment_probs=A(np.array([0.9, 1.0, 0.5])), rho_present=A(0.3),
            grid_end=A(1.0), num_intervals=3),
        "mrca_node": lambda A: spec.mrca_node(A(P), A(h), A(tipset)),
        "calibrated_speciation_loglik": lambda A: spec
        .calibrated_speciation_loglik(
            A(-3.5), A(P), A(h),
            [(A(tipset), lambda x: -0.5 * (x - 0.4 * root_h) ** 2)]),
    }


def rng_pops(k):
    """k population sizes for the skyline cases, from a fixed seed."""
    import numpy as np

    return np.random.default_rng(1000 + k).uniform(0.3, 1.2, k)


def functions_path(dev, n_taxa=SPEC_TAXA, seed=P15_SEED):
    """Phase 15c: every case of p15_function_cases at the Makona shape (a
    coalescent tree of the first n_taxa dated taxa of
    examples/makona_joint.xml) on the card and on the CPU, each output's
    largest deviation over its largest magnitude held to P15_REL_TOL
    (P15_ODE_TOL for the SIR functions). Returns the record."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.apps.makona import read_makona_xml, tip_heights
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    cfg = read_makona_xml()
    tree = simulate_coalescent_tree(
        np.random.default_rng(JOINT_SEED),
        tip_heights(cfg["dates"][:n_taxa]), cfg["pop_size"])
    parent, children, heights, root = tree
    cases = p15_function_cases(parent.astype(np.int64), children, heights,
                               root, n_taxa, seed)

    def maker(d):
        def A(x):
            x = np.asarray(x)
            return torch.as_tensor(x.astype(np.float64) if x.dtype.kind == "f"
                                   else x, device=d)
        return A

    t0 = time.perf_counter()
    worst = {}
    for label, fn in cases.items():
        got = fn(maker(dev)).detach().cpu().double()
        want = fn(maker("cpu")).detach().double()
        if not bool(torch.isfinite(want).all()):
            raise AssertionError(f"P15c {label}: not finite on the CPU")
        scale = max(float(want.abs().max()), 1e-300)
        worst[label] = float((got - want).abs().max()) / scale
        tol = P15_ODE_TOL if label.startswith("sir") else P15_REL_TOL
        if not worst[label] <= tol:
            raise AssertionError(f"P15c {label}: {worst[label]!r} > {tol}")
    top = max(worst, key=worst.get)
    rec = {"functions": len(worst), "nodes": 2 * n_taxa - 1,
           "max_rel_err": worst[top], "worst": top,
           "seconds": time.perf_counter() - t0, "rel_err": worst}
    log(f"[P15c] {len(worst)} functions at {2 * n_taxa - 1} nodes on the "
        f"card against the CPU in {rec['seconds']:.2f} s: largest deviation "
        f"{worst[top]!r} ({top}; tolerance {P15_REL_TOL}, "
        f"{P15_ODE_TOL} for the SIR ODE)")
    return rec


# the conjugate normal model of tests/test_distribution_likelihood_xml.py:
# y = (1, 2, 3) ~ N(m, 1) with m ~ N(0, 10); E[m | y] = 6 / 3.01 = 1.9934
CONJUGATE_XML = """<?xml version="1.0" standalone="yes"?>
<beast>
  <taxa id="taxa">
    <taxon id="a"/><taxon id="b"/><taxon id="c"/><taxon id="d"/>
  </taxa>
  <alignment id="alignment" dataType="nucleotide">
    <sequence><taxon idref="a"/>ACGTACGT</sequence>
    <sequence><taxon idref="b"/>ACGTACGA</sequence>
    <sequence><taxon idref="c"/>ACGAACGT</sequence>
    <sequence><taxon idref="d"/>AGGTACGT</sequence>
  </alignment>
  <patterns id="patterns" from="1"><alignment idref="alignment"/></patterns>
  <constantSize id="constant" units="substitutions">
    <populationSize><parameter id="constant.popSize" value="0.08"/></populationSize>
  </constantSize>
  <coalescentTree id="startingTree" rootHeight="0.08">
    <taxa idref="taxa"/><constantSize idref="constant"/>
  </coalescentTree>
  <treeModel id="treeModel">
    <coalescentTree idref="startingTree"/>
    <rootHeight><parameter id="treeModel.rootHeight"/></rootHeight>
    <nodeHeights internalNodes="true">
      <parameter id="treeModel.internalNodeHeights"/>
    </nodeHeights>
  </treeModel>
  <coalescentLikelihood id="coalescent">
    <model><constantSize idref="constant"/></model>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </coalescentLikelihood>
  <HKYModel id="hky">
    <frequencies>
      <frequencyModel dataType="nucleotide">
        <frequencies><parameter id="frequencies" value="0.25 0.25 0.25 0.25"/></frequencies>
      </frequencyModel>
    </frequencies>
    <kappa><parameter id="kappa" value="2.0" lower="0.0"/></kappa>
  </HKYModel>
  <siteModel id="siteModel">
    <substitutionModel><HKYModel idref="hky"/></substitutionModel>
  </siteModel>
  <treeLikelihood id="treeLikelihood" useAmbiguities="false">
    <patterns idref="patterns"/>
    <treeModel idref="treeModel"/>
    <siteModel idref="siteModel"/>
  </treeLikelihood>
  <distributionLikelihood id="metaLik">
    <distribution>
      <normalDistributionModel>
        <mean><parameter id="m" value="0.0"/></mean>
        <stdev><parameter id="m.sd" value="1.0"/></stdev>
      </normalDistributionModel>
    </distribution>
    <data>
      <parameter id="y" value="1.0 2.0 3.0"/>
    </data>
  </distributionLikelihood>
  <operators id="operators">
    <subtreeSlide size="0.008" gaussian="true" weight="5">
      <treeModel idref="treeModel"/>
    </subtreeSlide>
    <scaleOperator scaleFactor="0.75" weight="2">
      <parameter idref="treeModel.rootHeight"/>
    </scaleOperator>
    <uniformOperator weight="10">
      <parameter idref="treeModel.internalNodeHeights"/>
    </uniformOperator>
    <randomWalkOperator windowSize="0.8" weight="20">
      <parameter idref="m"/>
    </randomWalkOperator>
  </operators>
  <mcmc id="mcmc" chainLength="60000" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        <normalPrior mean="0.0" stdev="10.0">
          <parameter idref="m"/>
        </normalPrior>
        <coalescentLikelihood idref="coalescent"/>
      </prior>
      <likelihood id="likelihood">
        <treeLikelihood idref="treeLikelihood"/>
        <distributionLikelihood idref="metaLik"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log id="fileLog" logEvery="20" fileName="distlik.log" overwrite="true">
      <posterior idref="posterior"/>
      <parameter idref="m"/>
    </log>
  </mcmc>
  <traceAnalysis fileName="distlik.log" burnIn="500">
    <expectation name="m" value="1.9934"/>
  </traceAnalysis>
</beast>
"""


def testxml_path(out_dir, reset_counts, read_counts, dev,
                 scale=P15_TESTXML_SCALE):
    """Phase 15d: `python -m beast_mcmc_tpu_torch run -testxml doc.xml
    -scale scale` on CONJUGATE_XML, written into out_dir and run from
    there: exit 0 and the expectation line. Returns (record, launches)."""
    import contextlib
    import io
    import re

    from beast_mcmc_tpu_torch.__main__ import main as cli

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "conjugate.xml")
    with open(path, "w") as f:
        f.write(CONJUGATE_XML)
    reset_counts()
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(out_dir)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli(["run", path, "-testxml", "-scale", str(scale), "-seed",
                      "13", "-device", str(dev)])
    finally:
        os.chdir(cwd)
    rec = {"rc": rc, "seconds": time.perf_counter() - t0,
           "launches": read_counts()}
    m = re.search(r"E\[m\] = (\S+) \(expected 1\.9934, SE (\S+)\) OK",
                  out.getvalue())
    if rc != 0 or m is None or "all embedded checks passed" not in \
            out.getvalue():
        raise AssertionError(f"P15d: rc {rc}\n{out.getvalue()[-2000:]}")
    rec.update({"mean": float(m.group(1)), "se": float(m.group(2))})
    log(f"[P15d] -testxml rc {rc} in {rec['seconds']:.2f} s: {m.group(0)}; "
        f"launches {json.dumps(rec['launches'])}")
    return rec, {"P15 15d testxml": rec["launches"]}


# phase 16, the north-star document through the XML interpreter: 16a's
# -scale (the document's 200 million states scaled to P16_STATES, a log
# row and an annotated tree each state), 16b's warm-up and timed steps (as
# bench.py::measure_makona_joint) and profiler window, 16c's block-update
# proposals, its weight, the steps of its full-evaluation check and its
# profiler window (proposals), and 16d's seed and tolerance (card against
# the CPU, relative to the output's largest magnitude)
P16_STATES = 200
P16_SCALE = P16_STATES / 200_000_000
P16_WARM, P16_STEPS, P16_PROFILE = 16, 192, PROFILE_STEPS
P16_BLOCK_PROPOSALS, P16_BLOCK_WEIGHT, P16_BLOCK_CHECK = 40, 4, 40
P16_BLOCK_PROFILE = 2
P16_SEED, P16_REL_TOL = 16, 1e-12
NORTH_STAR_XML = os.path.join(ROOT, "examples", "makona_joint.xml")


def block_update_document(doc, path, weight=P16_BLOCK_WEIGHT):
    """Write `doc` at `path` with a <gmrfGridBlockUpdateOperator> on its
    skygrid (id "skygrid") added to its <operators>."""
    text = open(doc).read()
    anchor = '<operators id="operators">'
    if anchor not in text:
        raise AssertionError(f"P16c: no {anchor} in {doc}")
    op = (f'\n    <gmrfGridBlockUpdateOperator scaleFactor="2.0" '
          f'weight="{weight}">\n      <gmrfSkyGridLikelihood '
          f'idref="skygrid"/>\n    </gmrfGridBlockUpdateOperator>')
    with open(path, "w") as f:
        f.write(text.replace(anchor, anchor + op, 1))
    return path


def north_star_path(out_dir, reset_counts, read_counts, device_ms, dev,
                    doc=NORTH_STAR_XML, scale=P16_SCALE, n_warm=P16_WARM,
                    n_steps=P16_STEPS, n_profile=P16_PROFILE,
                    n_block=P16_BLOCK_PROPOSALS, block_check=P16_BLOCK_CHECK):
    """Phases 16a to 16c (see the module docstring) on `doc`. The CLI's
    peel launches are predicted from _run_mcmc's evaluations: the start,
    two a checked step of its 100-step check, one a step, one a log row's
    posterior (the annotation's trait peel is the plain level peel).
    Returns (record, launches)."""
    import contextlib
    import io
    import re

    import torch

    from beast_mcmc_tpu_torch.__main__ import main as cli
    from beast_mcmc_tpu_torch.apps.benchmarks import (
        measure_makona_joint, xml_joint_chain)
    from beast_mcmc_tpu_torch.apps.makona import read_makona_xml
    from beast_mcmc_tpu_torch.inference.gibbs import GmrfBlockUpdateOperator
    from beast_mcmc_tpu_torch.inference.mcmc import (
        full_evaluation_check, run_chain)

    os.makedirs(out_dir, exist_ok=True)
    kname = "peel_stream"
    launches = {}
    cfg = read_makona_xml(doc)

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def expect(counts, n, label):
        want = {k: n * (k == kname) for k in counts}
        launches[f"P16 {label}"] = counts
        if counts != want:
            raise AssertionError(f"P16 {label}: launches {counts}, "
                                 f"expected {want}")

    # 16a: the CLI, as a user runs it on the document
    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(out_dir)
    reset_counts()
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(["run", doc, "-scale", repr(scale), "-device", str(dev)])
    finally:
        os.chdir(cwd)
    a = {"rc": rc, "cli_seconds": time.perf_counter() - t1}
    text = out.getvalue() + err.getvalue()
    m = re.search(r"(\d+) states in ([0-9.]+)s = ([0-9.]+) states/sec; "
                  r"full-evaluation deviation (\S+)", text)
    if rc != 0 or "running through the interpreter registry]" not in text \
            or m is None:
        raise AssertionError(f"P16a: rc {rc}\n{text[-3000:]}")
    a.update({"steps": int(m.group(1)), "chain_seconds": float(m.group(2)),
              "states_per_s": float(m.group(3)),
              "full_evaluation_deviation": float(m.group(4))})
    a["predicted_launches"] = 1 + 2 * 100 + 2 * a["steps"]
    expect(read_counts(), a["predicted_launches"], "16a CLI")
    lines = open(os.path.join(out_dir, "makona_joint.log")).read().splitlines()
    rows = [ln.split("\t") for ln in lines if ln[:1].isdigit()]
    want_cols = ["state", "posterior", "ucld.mean", "siteModel.alpha",
                 "nonZeroRates", "treeModel.rootHeight"]
    if lines[0].split("\t") != want_cols or len(rows) != a["steps"]:
        raise AssertionError(f"P16a log: {lines[0]!r}, {len(rows)} rows")
    a["log_rows"] = len(rows)
    a["trees"] = check_joint_trees(os.path.join(out_dir,
                                                "makona_joint.trees"), cfg)
    if a["trees"] != a["steps"] or not a["full_evaluation_deviation"] <= \
            FULL_EVAL_TOL:
        raise AssertionError(f"P16a: {a}")
    log(f"[P16a] CLI rc {rc} in {a['cli_seconds']:.2f} s: {a['steps']} "
        f"states in {a['chain_seconds']:.2f} s = {a['states_per_s']} "
        f"states/s, full-evaluation deviation "
        f"{a['full_evaluation_deviation']!r}, peel_stream launches "
        f"{a['predicted_launches']} as predicted, {a['log_rows']} log rows "
        f"of the document's columns and {a['trees']} location-annotated "
        f"trees read back")

    # 16b: bench.py::measure_makona_joint on the document, in float64
    b = {}
    t1 = time.perf_counter()
    rate = measure_makona_joint(doc, n_steps, dev, n_warm, record=b,
                                counts=(reset_counts, read_counts))
    b["seconds_in_phase"] = time.perf_counter() - t1
    ax, step = b["analysis"], b["step"]
    names = [c.name for c in b["components"]]
    i_lik = names.index("treeLikelihood")
    b["tree_likelihood_steps"] = sum(
        n for n, idxs in zip(b["steps_per_operator"], step.refreshed)
        if i_lik in idxs)
    expect(b["launches"], b["tree_likelihood_steps"], "16b timed steps")
    pats = ax.build(ax._ids["patterns"])
    rec = {"taxa": len(cfg["taxa"]), "sites": int(pats.n_sites),
           "patterns": int(pats.n_patterns),
           "patterns_padded": int(ax._treelik_parts["treeLikelihood"]
                                  ["tips"].shape[-1]),
           "locations": len(cfg["location_codes"])}
    # the host ms of one annotated tree sample: the draw of every node's
    # location, as <logTree> makes it
    ann = ax._ancestral_liks["geoLikelihood"]
    gen = torch.Generator(device=dev).manual_seed(P16_SEED)
    state = b["state"]
    sample_ms = []
    for _ in range(5):
        sync()
        t1 = time.perf_counter()
        loc = ann["states_fn"](state.params, state.tree, gen)
        sync()
        sample_ms.append(1e3 * (time.perf_counter() - t1))
    if loc.shape[0] != 2 * rec["taxa"] - 1 or int(loc.min()) < 0:
        raise AssertionError(f"P16b annotation: {loc.shape}")
    reset_counts()
    wall, busy = device_ms(lambda: run_chain(step, state, n_profile),
                           "p16b north-star chain", n_profile)
    b_rec = {"states_per_s": rate, "steps": n_steps, "warm_up": n_warm,
             "seconds": b["seconds"], "deviation": b["deviation"],
             "log_posterior": b["log_posterior"],
             "tree_likelihood_steps": b["tree_likelihood_steps"],
             "steps_per_operator": b["steps_per_operator"],
             "launches": b["launches"], "tree_sample_ms": sample_ms,
             "profile_ms_per_step": wall,
             "device_busy_share": None if busy is None else busy / wall,
             "device_events_per_step": device_ms.events,
             "seconds_in_phase": b["seconds_in_phase"]}
    log(f"[P16b] measure_makona_joint: {rec['patterns']} patterns "
        f"({rec['patterns_padded']} padded) of {rec['sites']} sites, "
        f"{rate:.2f} states/s over {n_steps} steps after {n_warm}; "
        f"peel_stream launches {b['launches'][kname]} = steps refreshing "
        f"treeLikelihood {b['tree_likelihood_steps']}; carried against "
        f"fresh {b['deviation']!r}; host ms of an annotated tree sample "
        f"{[round(x, 3) for x in sample_ms]}; profile {wall:.3f} ms a "
        f"step, busy share {b_rec['device_busy_share']}, "
        f"{device_ms.events} device events a step")

    # 16c: the same document with the skygrid's block update added to its
    # operators, written by the script and run through the interpreter as
    # 16b runs the document (xml_joint_chain); the copy simulates 16b's
    # alignment, from the same seed
    n_patterns = rec["patterns"]
    del b, ax, step, state
    copy = block_update_document(doc, os.path.join(out_dir,
                                                    "makona_block.xml"))
    t1 = time.perf_counter()
    chain = xml_joint_chain(copy, dev)
    build_s = time.perf_counter() - t1
    ops, step, state = chain["operators"], chain["step"], chain["state"]
    log_post = chain["log_post"]
    copy_patterns = chain["analysis"].build(
        chain["analysis"]._ids["patterns"]).n_patterns
    blk = [i for i, op in enumerate(ops)
           if isinstance(op, GmrfBlockUpdateOperator)]
    if len(blk) != 1 or copy_patterns != n_patterns:
        raise AssertionError(f"P16c: block updates at {blk}, "
                             f"{copy_patterns} patterns")
    i_blk = blk[0]
    del chain
    state, _ = run_chain(step, state, n_warm)
    sync()
    acc0 = int(state.op_accept[i_blk])
    ms = []
    for _ in range(n_block):
        if dev == "cpu":
            t1 = time.perf_counter()
            state = step.given_op(state, i_blk)
            ms.append(1e3 * (time.perf_counter() - t1))
            continue
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        state = step.given_op(state, i_blk)
        ev1.record()
        torch.cuda.synchronize()
        ms.append(ev0.elapsed_time(ev1))
    accepted = int(state.op_accept[i_blk]) - acc0
    # where a proposal's time goes: a profiler window of a few more
    box = [state]

    def block_proposals():
        for _ in range(P16_BLOCK_PROFILE):
            box[0] = step.given_op(box[0], i_blk)

    wall_c, busy_c = device_ms(block_proposals, "p16c block update",
                               P16_BLOCK_PROFILE)
    state = box[0]
    state, dev_max = full_evaluation_check(step, log_post, state,
                                           block_check)
    c_rec = {"proposals": n_block, "accepted": accepted, "document": copy,
             "acceptance": accepted / n_block,
             "ms_per_proposal": statistics.median(ms), "ms": ms,
             "field": ops[i_blk].field,
             "cells": len(ops[i_blk].cut_points) + 1,
             "full_evaluation_deviation": float(dev_max),
             "check_steps": block_check, "build_seconds": build_s,
             "profile_ms_per_proposal": wall_c,
             "device_busy_share": None if busy_c is None else busy_c / wall_c,
             "device_events_per_proposal": device_ms.events}
    if not c_rec["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P16c deviation {c_rec}")
    log(f"[P16c] {os.path.basename(copy)} built in {build_s:.2f} s "
        f"({copy_patterns} patterns); gmrfGridBlockUpdateOperator on "
        f"{c_rec['field']} ({c_rec['cells']} cells): {accepted} of "
        f"{n_block} proposals "
        f"accepted ({c_rec['acceptance']:.3f}), median "
        f"{c_rec['ms_per_proposal']:.3f} ms a proposal "
        f"({'CUDA events' if dev != 'cpu' else 'host clock'}), "
        f"profile {wall_c:.3f} ms a proposal, busy share "
        f"{c_rec['device_busy_share']}, {device_ms.events} device events a "
        f"proposal; full-evaluation deviation over {block_check} steps of "
        f"the whole mix {c_rec['full_evaluation_deviation']!r}")
    rec.update({"16a": a, "16b": b_rec, "16c": c_rec})
    return rec, launches


P16_FUNCTIONS_XML = """  <constantSize id="initialDemo" units="years">
    <populationSize><parameter id="initialDemo.popSize" value="2.0"/></populationSize>
  </constantSize>
  <coalescentSimulator id="startingTree">
    <taxa idref="taxa"/><constantSize idref="initialDemo"/>
  </coalescentSimulator>
  <treeModel id="treeModel"><coalescentTree idref="startingTree"/></treeModel>
  <gmrfSkyGridLikelihood id="skygrid">
    <populationSizes><parameter id="sg.logPop" value="{pops}"/></populationSizes>
    <precisionParameter><parameter id="sg.prec" value="0.8"/></precisionParameter>
    <numGridPoints><parameter value="49"/></numGridPoints>
    <cutOff><parameter value="2.0"/></cutOff>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </gmrfSkyGridLikelihood>
  <ACLikelihood id="ac" distribution="logNormal">
    <treeModel idref="treeModel"/>
    <rates><parameter id="ac.rates" value="1.0"/></rates>
    <rootRate><parameter id="ac.root" value="1.1"/></rootRate>
    <variance><parameter id="ac.var" value="0.3"/></variance>
  </ACLikelihood>
  <exponentialBranchLengthsPrior id="ebl"><treeModel idref="treeModel"/></exponentialBranchLengthsPrior>
  <gridBasedBranchRateModel id="grid">
    <treeModel idref="treeModel"/>
    <levelSpecificRates><parameter id="grid.rates" value="1.0 0.5 2.0 1.5"/></levelSpecificRates>
    <gridPoints><parameter id="grid.points" value="0.3 0.8 1.5"/></gridPoints>
  </gridBasedBranchRateModel>
  <coalescentIntervals id="ci"><treeModel idref="treeModel"/></coalescentIntervals>
  <LKJCorrelationPrior id="lkj" shapeParameter="2.0" dimension="6">
    <data><parameter id="lkj.x" value="{lkj}"/></data>
  </LKJCorrelationPrior>
  <LKJCorrelationPrior id="lkjc" shapeParameter="1.5" cholesky="false">
    <data><parameter id="lkjc.x" value="{lkjc}"/></data>
  </LKJCorrelationPrior>
  <sphericalBetaPrior id="sb" shapeParameter="2.5" dimension="3">
    <data><parameter id="sb.x" value="{sb}"/></data>
  </sphericalBetaPrior>
  <halfTPrior id="ht" scale="2.0" df="3"><parameter id="ht.x" value="{pos}"/></halfTPrior>
  <halfNormalPrior id="hn" mean="0.0" stdev="1.5"><parameter idref="ht.x"/></halfNormalPrior>
  <binomialLikelihood id="bin">
    <proportion><parameter id="bin.p" value="0.3"/></proportion>
    <trials><parameter id="bin.n" value="56"/></trials>
    <counts><parameter id="bin.k" value="{counts}"/></counts>
  </binomialLikelihood>
  <empiricalDistributionLikelihood id="emp">
    <grid>
      <logLikelihood><parameter value="-3.0 -1.0 -0.5 -1.2 -4.0"/></logLikelihood>
      <value><parameter value="0.5 1.5 2.0 3.0 6.0"/></value>
    </grid>
    <data><parameter idref="ht.x"/></data>
  </empiricalDistributionLikelihood>
  <matrixParameter id="ouQ">
    <parameter id="ou.q1" value="1.0 0.2"/><parameter id="ou.q2" value="0.2 0.8"/>
  </matrixParameter>
  <multivariateOUModel id="mvou">
    <positiveDefiniteSubstitutionModel><matrixParameter idref="ouQ"/></positiveDefiniteSubstitutionModel>
    <data><parameter id="ou.data" value="{ou}"/></data>
    <times><parameter value="{times}"/></times>
    <design><parameter value="{design}"/></design>
    <diagonalMatrix id="ouG"><parameter id="ou.g" value="1.0 1.5"/></diagonalMatrix>
  </multivariateOUModel>
  <transformedVectorSumTransform id="vs" incrementTransformType="log">
    <parameter id="vs.inc" value="{inc}"/>
  </transformedVectorSumTransform>
  <compoundSymmetricMatrix id="csm" asCorrelation="true" isCholesky="true">
    <diagonal><parameter id="csm.d" value="1.0 2.0 0.5 1.5"/></diagonal>
    <offDiagonal><parameter id="csm.o" value="{csm}"/></offDiagonal>
  </compoundSymmetricMatrix>
"""


def p16_functions_document(path, n_taxa=SPEC_TAXA, seed=P16_SEED):
    """Write 16d's document at `path`: the first n_taxa dated taxa of
    examples/makona_joint.xml, a coalescentSimulator start tree, and
    config/xml_ext.py's densities, clocks, views and matrix parameters
    with values drawn from `seed`."""
    import numpy as np

    from beast_mcmc_tpu_torch.apps.makona import read_makona_xml

    rng = np.random.default_rng(seed)

    def vals(x):
        return " ".join(repr(float(v)) for v in np.ravel(x))

    n_points = 40
    body = P16_FUNCTIONS_XML.format(
        pops=vals(rng.normal(0.5, 0.4, 50)),
        lkj=vals(rng.uniform(-0.3, 0.3, 15)),
        lkjc=vals(rng.uniform(-0.2, 0.2, 6)),
        sb=vals(rng.uniform(-0.3, 0.3, 30)),
        pos=vals(rng.gamma(2.0, 1.0, 200)),
        counts=vals(rng.integers(0, 56, 100)),
        ou=vals(rng.normal(0.0, 0.5, 2 * n_points)),
        times=vals(np.repeat(np.arange(n_points), 2)),
        design=vals(np.tile([1, 2], n_points)),
        inc=vals(rng.normal(0.0, 0.2, 60)),
        csm=vals(rng.uniform(-0.3, 0.3, 6)))
    cfg = read_makona_xml()
    data = {"taxa": cfg["taxa"][:n_taxa], "dates": cfg["dates"][:n_taxa],
            "rows": []}
    lines = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    lines += taxa_alignment_xml(data)[:-2]  # the taxa, no alignment
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + body + "</beast>\n")
    return path


def p16_function_cases(ax):
    """{label: fn() -> tensor} of 16d on an XmlAnalysis of
    p16_functions_document: each density, clock, view and matrix at the
    document's initial state, the stochastic Dollo likelihood at its tree,
    the SVS connectivity prior at 56 states, and the GMRF block update's
    and the elliptical slice sampler's proposals with their draws given
    (inference/gibbs.py's draw helpers replaced for the call)."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.config import xml_geo
    from beast_mcmc_tpu_torch.config.interpreter import _StateShim
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state
    from beast_mcmc_tpu_torch.config.xml_hmc import matrix_param_of
    from beast_mcmc_tpu_torch.inference import gibbs
    from beast_mcmc_tpu_torch.models.dollo import stochastic_dollo_loglik

    ax.build(ax._ids["treeModel"])
    built = {k: ax.build(ax._ids[k]) for k in (
        "skygrid", "ac", "ebl", "grid", "ci", "lkj", "lkjc", "sb", "ht",
        "hn", "bin", "emp", "mvou", "vs")}
    csm = matrix_param_of(ax, ax._ids["csm"])
    p0, t0 = initial_eval_state(ax)
    p0 = ax.inject_derived(p0)
    n = (t0.parent.shape[0] + 1) // 2
    rng = np.random.default_rng(P16_SEED)
    dev, dt = t0.heights.device, t0.heights.dtype

    def t(x, dtype=dt):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    presence = t(rng.uniform(size=(n, 64)) < 0.3, torch.int8)
    indicators = t((rng.uniform(size=56 * 55) < 0.9).astype(float))

    class _Svs:
        dtype = torch.float64
        _svs_models = {"m": ("r", "ind", 56, 56 * 55)}

    def injected(fn, uniforms, normals):
        saved = (gibbs._uniform, gibbs._uniforms, gibbs._normal)
        us, ns = list(uniforms), list(normals)

        def take(seq):
            return seq.pop(0) if len(seq) > 1 else seq[0]

        gibbs._uniforms = lambda gen, like, shape=(): torch.full(
            tuple(shape), take(us), dtype=like.dtype, device=like.device)
        gibbs._uniform = lambda gen, like: gibbs._uniforms(gen, like)
        gibbs._normal = lambda gen, like, shape=(): t(take(ns)).reshape(
            shape)
        try:
            return fn()
        finally:
            gibbs._uniform, gibbs._uniforms, gibbs._normal = saved

    block = gibbs.GmrfBlockUpdateOperator(
        field="sg.logPop", precision="sg.prec", n_taxa=n,
        cut_points=tuple(np.linspace(2.0 / 49, 2.0, 49)))

    def gmrf():
        p, _, h = injected(lambda: block.propose(p0, t0, None, t(2.0)),
                           [0.3, 0.6], [rng_gmrf])
        return torch.cat([p["sg.logPop"], p["sg.prec"].reshape(1),
                          h.reshape(1)])

    rng_gmrf = np.random.default_rng(P16_SEED + 1).normal(size=50)
    mean, prec = np.array([0.5, -0.5]), np.array([[2.0, 0.5], [0.5, 1.0]])
    prec_t = t(prec)
    ess = gibbs.EllipticalSliceOperator(
        parameter="x", prior_mean=mean,
        prior_chol=np.linalg.cholesky(np.linalg.inv(prec)),
        prior_logpdf=lambda v, mu: -0.5 * torch.einsum(
            "...i,ij,...j->...", v - mu, prec_t, v - mu))
    ess.bind_log_posterior(lambda p, tr: (
        -0.5 * (p["x"] - t(mean)) @ prec_t @ (p["x"] - t(mean))
        - 0.5 * torch.sum((p["x"] - t([1.0, 0.4])) ** 2) / 0.05))

    def ess_draw():
        p, _, _ = injected(lambda: ess.propose({"x": t([0.2, 0.1])}, t0,
                                               None, None),
                           [0.999, 0.45, 0.97], [[1.3, -0.7]])
        return p["x"]

    s0 = _StateShim(p0, t0)
    return {
        **{k: (lambda k=k: built[k].fn(p0, t0)) for k in (
            "skygrid", "ebl", "lkj", "lkjc", "sb", "ht", "hn", "bin", "emp",
            "mvou")},
        "ac density": lambda: built["ac"].density(p0, t0),
        "ac rates": lambda: built["ac"].rates(p0, t0),
        "grid rates": lambda: built["grid"].rates(p0, t0),
        "coalescent intervals": lambda: built["ci"](s0),
        "vector sum": lambda: built["vs"].fn(p0),
        "compound symmetric matrix": lambda: csm.fn(p0),
        "stochastic dollo": lambda: stochastic_dollo_loglik(
            presence, t0.parent, t0.children, t0.heights, 0.7,
            gain_rate=0.3, branch_rates=1.2),
        "svs connectivity 56": lambda: xml_geo.svs_connectivity_prior(
            _Svs(), "m").fn({"ind": indicators}, None),
        "gmrf block update": gmrf,
        "elliptical slice": ess_draw,
    }


def p16_functions_path(out_dir, dev, n_taxa=SPEC_TAXA):
    """Phase 16d: p16_function_cases on the card and on the CPU (an
    XmlAnalysis of p16_functions_document on each), each output's largest
    deviation over its largest magnitude held to P16_REL_TOL. Returns the
    record."""
    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis

    path = p16_functions_document(os.path.join(out_dir,
                                               "p16_functions.xml"), n_taxa)
    t0 = time.perf_counter()
    got = {k: fn().detach().cpu().double() for k, fn in p16_function_cases(
        XmlAnalysis(path, device=dev)).items()}
    want = {k: fn().detach().double() for k, fn in p16_function_cases(
        XmlAnalysis(path, device="cpu")).items()}
    worst = {}
    for label, w in want.items():
        g = got[label]
        fin = torch.isfinite(w)
        if not bool(torch.equal(fin, torch.isfinite(g))) or not bool(
                torch.equal(g[~fin], w[~fin])):
            raise AssertionError(f"P16d {label}: non-finite entries differ")
        scale = max(float(w[fin].abs().max()) if bool(fin.any()) else 0.0,
                    1e-300)
        worst[label] = (float((g[fin] - w[fin]).abs().max()) / scale
                        if bool(fin.any()) else 0.0)
        if not worst[label] <= P16_REL_TOL:
            raise AssertionError(f"P16d {label}: {worst[label]!r} > "
                                 f"{P16_REL_TOL}")
    top = max(worst, key=worst.get)
    rec = {"functions": len(worst), "nodes": 2 * n_taxa - 1,
           "max_rel_err": worst[top], "worst": top, "rel_err": worst,
           "seconds": time.perf_counter() - t0}
    log(f"[P16d] {len(worst)} functions of items 6 to 9 at "
        f"{rec['nodes']} nodes on the card against the CPU in "
        f"{rec['seconds']:.2f} s: largest deviation {worst[top]!r} ({top}; "
        f"tolerance {P16_REL_TOL})")
    return rec


def chain_gradient_checks(peel_cases, post_cases, chain_inputs, analyses,
                          reset_counts, read_counts, dev):
    """Phase 10g: the chain-axis gradients. peel_cases: [(kernel, label,
    chain_inputs's arguments)]: B chains' trees from their own seeds (phase
    2's chain axis), each route's chain-axis gradient (one forward with
    every chain's partials, one level adjoint) against the same adjoint
    over the route's plain chain-axis forward, and against each chain's
    single-chain kernel gradient (its own tree), GRAD_REL_TOL; the partials
    against the plain ones, POST_ABS_TOL; one launch a gradient; the
    backward's CUDA-event ms beside B single backwards'. post_cases:
    [(label, analysis shape, B, seed, kernel)]: log_post_chains' gradient
    in every chain's heights, clock.rate and pop.size against each chain's
    log_post's. Returns the records."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, map_tensors)
    from beast_mcmc_tpu_torch.ops import (
        cuda_mxu, cuda_peeling, cuda_stream, cuda_stream2)
    from beast_mcmc_tpu_torch.ops import peeling as plain
    from beast_mcmc_tpu_torch.ops.peeling import peel_with_adjoint
    from beast_mcmc_tpu_torch.tree.topology import (
        TreeState, make_tree_state, simulate_coalescent_tree)

    f64 = torch.float64

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def rel_err(got, ref):
        return max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(got, ref))

    def event_ms(fn, reps):
        """Median CUDA-event ms of fn() (a backward) over reps calls, each
        prepared by fn.prepare(); "not measured" off the card."""
        if dev == "cpu":
            return "not measured"
        times = []
        for _ in range(reps + 1):
            arg = fn.prepare()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(arg)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[1:])

    p10_grads = []

    def chain_grad_check(kname, label, shape, b_n, seed, partitions=False):
        tips, ch, par, pm, fr, cw = chain_inputs(shape, b_n, seed, partitions)
        n_tips = tips.shape[-3]
        sched = cuda_stream.level_schedule(ch, n_tips, par)
        lvl_order, ids, pos, ls = sched
        one = [tuple(t[b] for t in sched) for b in range(b_n)]
        g = torch.rand(pm.shape[:-4] + (tips.shape[-1],), dtype=f64,
                       device=dev,
                       generator=torch.Generator(device=dev).manual_seed(9))
        k = (lambda x: x) if partitions else (lambda x: x[:, None])
        t4 = tips if partitions else tips[None]

        def wcs_of(fr_, cw_):
            return cw_[..., None] * fr_[..., None, :]

        if kname == "peel_resident":
            def entry(*x):
                return cuda_peeling.peel_site_loglik_auto(
                    tips, ch, lvl_order, None, *x, sched)

            def single(b, *x):
                return cuda_peeling.peel_site_loglik_cuda(
                    tips, ch[b], None, None, *x, one[b])

            def plain_fwd(pm_, fr_, cw_, want_post):  # True: autograd
                site, pp = cuda_peeling._resident_plain(
                    tips, ids, pos, ls, pm_[:, 0], wcs_of(fr_, cw_)[:, 0],
                    want_post=True)
                return site[:, None], plain.post_by_node(
                    pp[:, None], tips[None], lvl_order)

            _, post_k = cuda_peeling._peel_resident_kernel(
                tips, ch, None, pm, fr, cw, sched, want_post=True)
            _, post_p = cuda_peeling._resident_plain(
                tips, ids, pos, ls, pm, wcs_of(fr, cw), want_post=True)
        elif kname == "peel_stream":
            def entry(*x):
                return cuda_stream2.peel_deep_chains(tips, ch, *x, sched)

            def single(b, *x):
                return cuda_stream2.peel_site_loglik_deep(
                    tips, ch[b], None, None, *x, one[b])

            def plain_fwd(pm_, fr_, cw_, want_post):  # True: autograd
                site, pp = cuda_stream2._deep_plain(
                    t4, ids, pos, ls, cuda_stream2.chains_pm_ord(pm_, ids),
                    wcs_of(fr_, cw_), want_post=True)
                return site, plain.post_by_node(pp, t4, lvl_order)

            pm_ord = cuda_stream2.chains_pm_ord(k(pm), ids)
            _, post_k = cuda_stream2._peel_deep_kernel(
                t4, ids, pos, ls, pm_ord, k(fr), k(cw), want_post=True)
            _, post_p = cuda_stream2._deep_plain(
                t4, ids, pos, ls, pm_ord, wcs_of(k(fr), k(cw)),
                want_post=True)
        elif kname == "peel_stream_ring":
            def entry(*x):
                return cuda_stream.peel_stream_chains(tips, ch, *x, sched)

            def single(b, *x):
                return cuda_stream.peel_site_loglik_stream(
                    tips, ch[b], None, None, *x, one[b])

            def plain_fwd(pm_, fr_, cw_, want_post):  # True: autograd
                site, pp = cuda_stream._stream_plain(
                    tips, sched, pm_[:, 0], wcs_of(fr_, cw_)[:, 0])
                return site[:, None], plain.post_by_node(
                    pp[:, None], tips[None], lvl_order)

            _, post_k = cuda_stream._stream_chains(tips, sched, pm, fr, cw,
                                                   True)
            _, post_p = cuda_stream._stream_plain(tips, sched, pm,
                                                  wcs_of(fr, cw))
        else:
            def entry(*x):
                return cuda_peeling.peel_site_loglik_auto(
                    tips, ch, lvl_order, None, *x, sched)

            def single(b, *x):
                return cuda_mxu.peel_site_loglik_mxu(
                    tips, ch[b], None, None, *x, one[b])

            def plain_fwd(pm_, fr_, cw_, want_post):  # True: autograd
                site, post = cuda_mxu._mxu_plain(tips, sched, pm_[:, 0],
                                                 wcs_of(fr_, cw_)[:, 0])
                return site[:, None], post[:, None]

            _, post_k = cuda_mxu._peel_mxu_kernel(tips, ch, None, pm, fr, cw,
                                                  sched)
            _, post_p = cuda_mxu._mxu_plain(tips, sched, pm, wcs_of(fr, cw))
            post_k, post_p = post_k[:, n_tips:], post_p[:, n_tips:]

        def plain_entry(*x):
            out = peel_with_adjoint(plain_fwd, sched, *(k(t) for t in x))
            return out if partitions else out[:, 0]

        leaves = [t.detach().clone().requires_grad_(True) for t in (pm, fr, cw)]

        def grads(fn):
            return torch.autograd.grad(torch.sum(g * fn(*leaves)), leaves)

        reset_counts()
        got = grads(entry)
        sync()
        per_grad = read_counts()
        ref_plain = grads(plain_entry)
        # each chain's single gradient fills its own rows of the leaves
        ref_single = [torch.zeros_like(x) for x in leaves]
        for b in range(b_n):
            ref_single = [r + d for r, d in zip(ref_single, torch.autograd.grad(
                torch.sum(g[b] * single(b, *(t[b] for t in leaves))),
                leaves))]
        post_err = (post_k - post_p).abs().max().item()
        rec = {"label": label, "chains": b_n, "shape": [
            tips.shape[0] if partitions else 1, n_tips, *pm.shape[-3:-1],
            tips.shape[-1]],
            "grad_max_rel_err_vs_plain": rel_err(got, ref_plain),
            "grad_max_rel_err_vs_single": rel_err(got, ref_single),
            "grad_tol": f"rel<{GRAD_REL_TOL}", "post_max_abs_err": post_err,
            "post_tol": f"abs<{POST_ABS_TOL}",
            "launches_per_gradient": per_grad,
            "finite": all(bool(torch.isfinite(a).all()) for a in got)}
        del ref_plain, ref_single, post_k, post_p

        class Chain:
            @staticmethod
            def prepare():
                return torch.sum(g * entry(*leaves))

            def __call__(self, total):
                torch.autograd.grad(total, leaves)

        class Singles:
            @staticmethod
            def prepare():
                return [torch.sum(g[b] * single(b, *(t[b] for t in leaves)))
                        for b in range(b_n)]

            def __call__(self, totals):
                for total in totals:
                    torch.autograd.grad(total, leaves)

        rec["ms_backward"] = event_ms(Chain(), 5)
        rec["ms_single_backwards"] = event_ms(Singles(), 5)
        if dev != "cpu":
            rec["backward_over_single_backwards"] = (
                rec["ms_backward"] / rec["ms_single_backwards"])
        log(f"[P10g] {kname} {json.dumps(rec)}")
        ok = (rec["finite"] and post_err <= POST_ABS_TOL
              and rec["grad_max_rel_err_vs_plain"] <= GRAD_REL_TOL
              and rec["grad_max_rel_err_vs_single"] <= GRAD_REL_TOL
              and per_grad == {n: int(n == kname) for n in KERNELS})
        if not ok:
            raise AssertionError(f"P10g {kname} {label}: the chain-axis "
                                 f"gradient disagrees: {rec}")
        p10_grads.append(rec)

    def posterior_grad_check(label, shape, b_n, seed, kname):
        """log_post_chains' gradient in every chain's heights, clock.rate
        and pop.size (each chain its own tree and rates) against each
        chain's log_post's, through the single-chain kernel path."""
        _, _, p0, _, aux = analyses[shape]
        n_taxa = aux["tips"].shape[-3]
        trees = [make_tree_state(*simulate_coalescent_tree(
            np.random.default_rng(seed + b), np.zeros(n_taxa), 0.5),
            dtype=f64, device=dev) for b in range(b_n)]
        tree = TreeState(*(torch.stack([getattr(t, f) for t in trees])
                           for f in ("parent", "children", "heights",
                                     "root")))
        st = init_mcmc_state(p0, trees[0], torch.Generator(
            device=dev).manual_seed(seed), [])
        params = replicate_state(st, b_n, torch.Generator(
            device=dev).manual_seed(seed)).params
        scale = 1.0 + 0.05 * torch.arange(b_n, dtype=f64, device=dev)
        names = ("clock.rate", "pop.size")
        leaves = [tree.heights.clone().requires_grad_(True)] + [
            (params[n] * scale).requires_grad_(True) for n in names]

        def chain_lp(h, *xs):
            return aux["log_post_cached_chains"](
                {**params, **dict(zip(names, xs))}, tree.replace(heights=h))

        reset_counts()
        got = torch.autograd.grad(chain_lp(*leaves).sum(), leaves)
        sync()
        per_grad = read_counts()
        ref = []
        for b in range(b_n):
            lb = [x[b].detach().clone().requires_grad_(True) for x in leaves]
            pb = map_tensors(lambda v: v[b], params)
            lp_b = aux["log_post_cached"](
                {**pb, **dict(zip(names, lb[1:]))},
                trees[b].replace(heights=lb[0]))
            ref.append(torch.autograd.grad(lp_b, lb))
        ref = [torch.stack(t) for t in zip(*ref)]
        rec = {"label": label, "chains": b_n,
               "grad_max_rel_err_vs_single": rel_err(got, ref),
               "grad_tol": f"rel<{GRAD_REL_TOL}",
               "launches_per_gradient": per_grad}
        log(f"[P10g] log_post_chains {json.dumps(rec)}")
        if not (rec["grad_max_rel_err_vs_single"] <= GRAD_REL_TOL
                and per_grad == {n: int(n == kname) for n in KERNELS}):
            raise AssertionError(f"P10g log_post_chains {label}: {rec}")
        p10_grads.append(rec)

    for kname, label, args in peel_cases:
        chain_grad_check(kname, label, *args)
    for case in post_cases:
        posterior_grad_check(*case)
    return p10_grads


def codon_gamma_path(analysis, kname, reset_counts, read_counts, device_ms,
                     dev):
    """Phase 11: the GY94+Gamma4 codon chain (`codon_analysis` with four
    categories) through its route's kernel, `kname`. One chain: G4_STEPS
    steps after 20, exactly one launch a step, a profiler window, the
    full-evaluation check over G4_CHECK steps. A batch of G4_CHAINS chains
    replicated from the start (make_multichain_step): exactly one launch a
    batch step for all chains, aggregate states/s beside one chain's, a
    profiler window, the full-evaluation check on every chain. Returns
    ({path: record}, {path: launches})."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
    from beast_mcmc_tpu_torch.inference.mcmc import (
        apply_derived, full_evaluation_check, init_mcmc_state,
        make_mcmc_step, make_multichain_step, operator_report, run_chain)

    log_post, ops, p0, t0, aux = analysis
    lpc = aux["log_post_cached"]
    records, launches = {}, {}

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def run(label, step, state, n_steps, n_check, lp_full, b_n):
        t_phase = time.perf_counter()
        state, _ = run_chain(step, state, 20 if b_n == 1 else 10)
        sync()
        reset_counts()
        t0_ = time.perf_counter()
        state, _ = run_chain(step, state, n_steps)
        sync()
        secs = time.perf_counter() - t0_
        counts = read_counts()
        lps = state.log_posterior.reshape(-1).tolist()
        rec = {"chains": b_n, "steps": n_steps, "seconds": secs,
               "aggregate_states_per_s": b_n * n_steps / secs,
               "launches": counts, "log_posterior": lps}
        if dev != "cpu":
            wall, busy = device_ms(
                lambda: run_chain(step, state, PROFILE_STEPS),
                f"P11 {label}", PROFILE_STEPS, 8)
            rec.update({"profiled_ms_per_step": wall,
                        "device_busy_ms_per_step": busy or "not measured",
                        "device_busy_share": (busy / wall if busy
                                              else "not measured")})
        state, dev_max = full_evaluation_check(step, lp_full, state, n_check,
                                               derived=aux["derived"])
        rec["full_eval_max_deviation"] = float(dev_max)
        rec["seconds_in_phase"] = time.perf_counter() - t_phase
        log(f"[P11 {label}] {json.dumps(rec)}")
        log(operator_report(ops, state))
        if counts != {k: n_steps * (k == kname) for k in counts}:
            raise AssertionError(f"P11 {label}: expected one {kname} launch "
                                 f"a step, got {counts}")
        if not all(np.isfinite(lps)):
            raise AssertionError(f"P11 {label}: posterior not finite: {lps}")
        if not rec["full_eval_max_deviation"] < FULL_EVAL_TOL:
            raise AssertionError(f"P11 {label}: full-evaluation deviation "
                                 f"{rec['full_eval_max_deviation']}")
        records[label], launches[f"codon+gamma4 {label}"] = rec, counts

    step = make_mcmc_step(lpc, ops, derived=aux["derived"])
    run("one chain", step, init_mcmc_state(p0, t0, gen(110), ops, lpc),
        G4_STEPS, G4_CHECK, log_post, 1)
    lp_chains = aux["log_post_cached_chains"]
    mstep = make_multichain_step(lp_chains, ops, derived=aux["derived"])
    states = replicate_state(init_mcmc_state(p0, t0, gen(111), ops, lpc),
                             G4_CHAINS, gen(112))
    # the batch's derived entries and posterior from the batch's own code
    # path: the replicated single chain's category rates (a 0-d alpha's
    # product) differ from the batch's by ~1e-14, which random one-hot
    # codons at this size turn into ~0.5 of log posterior
    params = apply_derived(aux["derived"], states.params)
    states = states.replace(params=params,
                            log_posterior=lp_chains(params, states.tree))
    run(f"B={G4_CHAINS}", mstep, states, G4_BATCH_STEPS, G4_BATCH_CHECK,
        aux["log_post_chains"], G4_CHAINS)
    return records, launches


# phase 10, chain batches and MC3 with the operators that bind the
# posterior: chains, warm-up, measured and full-evaluation steps of each
# path, the steps of its single chain with the same operators, and the
# proposals of each bound operator alone over the batch
P10_PATHS = {"benchmark2": (8, 10, 100, 10), "makona": (4, 5, 40, 6),
             "protein": (4, 5, 40, 8)}
P10D_CHAINS, P10D_ROUNDS, P10D_SWAP_EVERY, P10D_WARM = 4, 20, 8, 16
P10_ALONE = 2


def bound_chain_paths(paths, reset_counts, read_counts, device_ms, dev):
    """Phase 10: chain batches (make_multichain_step) and MC3 with the
    operators that evaluate the posterior inside their proposal, each
    bound to the chain-axis posterior and proposing over its chains at
    once (`propose_chains`).

    paths: {label: ((log_post, operators, params0, tree0, aux), the route's
    kernel, the operators to add)} for "benchmark2" (P10a),
    "makona" (P10b), "protein" (P10c) and "benchmark1" (P10d, MC3). Every
    bound operator's proposal is watched: its launches must be what it
    reports (2 n_leapfrog for HMC, NUTS's largest n_lf + 1, a PDMP's
    largest event count, the slice samplers' evaluations), and a path's
    launches must be its steps plus its proposals', all of the route's
    kernel: the single chain's count for the whole batch. Each bound
    operator alone over the batch first (P10_ALONE proposals), then the
    mixed batch: aggregate states/s beside one chain's with the same
    operators, start and operator sequence (its draws seeded as the
    batch's; MC3's chains draw their own), a profiler window, the
    full-evaluation check over
    every chain. MC3 (P10d): delta from the adjacent log-posterior gaps
    after a warm-up at temperature 1, as P8c; the swap acceptance inside
    SWAP_BAND. Returns ({path: record}, {path: launches})."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.mc3 import (
        make_mc3_runner, replicate_state)
    from beast_mcmc_tpu_torch.inference.mcmc import (
        full_evaluation_check, init_mcmc_state, make_mcmc_step,
        make_multichain_step, operator_report, run_chain)
    from beast_mcmc_tpu_torch.inference.nuts import NutsOperator
    from beast_mcmc_tpu_torch.inference.pdmp import (
        BouncyParticleOperator, ZigZagOperator)
    from beast_mcmc_tpu_torch.inference.samplers import (
        EllipticalSliceOperator, SliceOperator)

    records, launches = {}, {}

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def reported(op):
        """The launches a bound operator's last batch proposal reports."""
        if isinstance(op, NutsOperator):
            return max(op.last_n_leapfrog) + 1
        if isinstance(op, (ZigZagOperator, BouncyParticleOperator)):
            return max(op.last_n_events)
        if isinstance(op, (SliceOperator, EllipticalSliceOperator)):
            return op.last_n_evaluations
        return 2 * op.n_leapfrog

    def watch(ops, kname, seen):
        """Wrap each bound operator's propose_chains: its launches against
        its report, appended to `seen` as (name, launches, reported)."""
        def wrap(op):
            inner = type(op).propose_chains.__get__(op)

            def propose_chains(*a):
                before = read_counts()[kname]
                out = inner(*a)
                seen.append((type(op).__name__,
                             read_counts()[kname] - before, reported(op)))
                return out
            op.propose_chains = propose_chains

        for op in ops:
            if hasattr(op, "bind_log_posterior"):
                wrap(op)

    def held(label, kname, counts, n_steps, seen):
        """The path's launches against its steps and proposals."""
        bad = [x for x in seen if x[1] != x[2]]
        want = n_steps + sum(x[1] for x in seen)
        if bad or counts != {k: want * (k == kname) for k in counts}:
            raise AssertionError(
                f"{label}: launches {counts}, expected {want} of {kname} "
                f"({n_steps} steps and the proposals' own); proposals off "
                f"their reports: {bad}")
        return want

    def batch(analysis, b_n, seed, ops):
        _, _, p0, t0, aux = analysis
        lpc = aux["log_post_cached"]
        st = init_mcmc_state(p0, t0, gen(seed), ops, lpc)
        return replicate_state(st, b_n, gen(seed + 1))

    def alone(label, analysis, kname, op, b_n, seed):
        """op alone over the batch: each proposal's launches its report,
        plus one evaluation a step."""
        aux = analysis[4]
        seen = []
        watch([op], kname, seen)
        mstep = make_multichain_step(aux["log_post_cached_chains"], [op],
                                     derived=aux["derived"])
        states = batch(analysis, b_n, seed, [op])
        rows = []
        for _ in range(P10_ALONE):
            sync()
            reset_counts()
            t0_ = time.perf_counter()
            states = mstep(states)
            sync()
            rows.append({"ms": 1e3 * (time.perf_counter() - t0_),
                         "launches": read_counts()[kname],
                         "reported": seen[-1][2]})
            if rows[-1]["launches"] != rows[-1]["reported"] + 1:
                raise AssertionError(f"{label} {type(op).__name__} alone: "
                                     f"{rows[-1]}, expected its report + 1")
        del op.propose_chains  # the class's again
        return rows

    def one_chain(analysis, ops, n_warm, n_steps, seed):
        """(states/s, each operator's draws) of one chain with the same
        operators, start and operator draws as the batch of `batch(...,
        seed - 1, ...)`: its CPU operator-draw generator is seeded as the
        batch's, so that both draw the same operator sequence."""
        _, _, p0, t0, aux = analysis
        lpc = aux["log_post_cached"]
        step = make_mcmc_step(lpc, ops, derived=aux["derived"])
        st = init_mcmc_state(p0, t0, gen(seed), ops, lpc)
        st, _ = run_chain(step, st, n_warm)
        sync()
        drawn0 = st.op_accept + st.op_reject
        t0_ = time.perf_counter()
        st, _ = run_chain(step, st, n_steps)
        sync()
        rate = n_steps / (time.perf_counter() - t0_)
        return rate, (st.op_accept + st.op_reject - drawn0).tolist()

    def drawn_of(states, before):
        """Each operator's draws by chain 0 since `before`."""
        return (states.op_accept[0] + states.op_reject[0] - before).tolist()

    for p_name, label, seed in (("P10a", "benchmark2", 100),
                                ("P10b", "makona", 110),
                                ("P10c", "protein", 120)):
        t_phase = time.perf_counter()
        analysis, kname, added = paths[label]
        _, base_ops, _, _, aux = analysis
        b_n, n_warm, n_steps, n_check = P10_PATHS[label]
        ops = [*base_ops, *added]
        rec = {"chains": b_n, "steps": n_steps, "added": [
            {"operator": type(op).__name__, "weight": op.weight}
            for op in added]}
        for i, op in enumerate(added):
            rec[f"{type(op).__name__} alone"] = alone(
                label, analysis, kname, op, b_n, seed + 2 + i)
        single, single_drawn = one_chain(analysis, ops, n_warm, n_steps,
                                         seed + 1)
        seen = []
        watch(added, kname, seen)
        mstep = make_multichain_step(aux["log_post_cached_chains"], ops,
                                     derived=aux["derived"])
        states = batch(analysis, b_n, seed, ops)
        states, _ = run_chain(mstep, states, n_warm)
        sync()
        seen.clear()
        drawn0 = states.op_accept[0] + states.op_reject[0]
        reset_counts()
        t0_ = time.perf_counter()
        states, _ = run_chain(mstep, states, n_steps)
        sync()
        secs = time.perf_counter() - t0_
        counts = read_counts()
        want = held(p_name, kname, counts, n_steps, seen)
        lps = states.log_posterior.tolist()
        rec.update({"seconds": secs,
                    "aggregate_states_per_s": b_n * n_steps / secs,
                    "single_chain_states_per_s": single,
                    "drawn": drawn_of(states, drawn0),
                    "single_chain_drawn": single_drawn,
                    "launches": counts, "launches_expected": want,
                    "launches_per_step": counts[kname] / n_steps,
                    "bound_proposals": [list(x) for x in seen],
                    "log_posterior": lps})
        if dev != "cpu":
            wall, busy = device_ms(lambda: run_chain(mstep, states, 5),
                                   f"{p_name} {label}", 5, 8)
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
        for op in added:
            del op.propose_chains
        if not all(np.isfinite(lps)):
            raise AssertionError(f"{p_name}: a chain's posterior is not "
                                 f"finite: {lps}")
        if not rec["full_eval_max_deviation"] < FULL_EVAL_TOL:
            raise AssertionError(f"{p_name}: full-evaluation deviation "
                                 f"{rec['full_eval_max_deviation']}")
        if not any(x[0] == type(op).__name__ for op in added for x in seen):
            raise AssertionError(f"{p_name}: no bound operator was drawn")
        records[p_name], launches[f"{label} {p_name}"] = rec, counts

    # P10d: MC3 at benchmark1 with reflective HMC and slice
    t_phase = time.perf_counter()
    analysis, kname, added = paths["benchmark1"]
    _, base_ops, _, _, aux = analysis
    ops = [*base_ops, *added]
    lp_chains = aux["log_post_chains"]
    n_steps = P10D_ROUNDS * P10D_SWAP_EVERY
    single, single_drawn = one_chain(analysis, ops, P10D_WARM, n_steps, 132)
    states = batch(analysis, P10D_CHAINS, 131, ops)
    warm = make_multichain_step(lp_chains, ops)
    states, _ = run_chain(warm, states, P10D_WARM)
    lp = states.log_posterior.tolist()
    gap = float(np.mean(np.abs(np.diff(lp))))
    delta = 1.0 / gap if gap > 0 else 1.0
    run, temps = make_mc3_runner(lp_chains, ops, P10D_CHAINS,
                                 swap_every=P10D_SWAP_EVERY, delta=delta)
    seen = []
    watch(added, kname, seen)
    sync()
    reset_counts()
    t0_ = time.perf_counter()
    states, out = run(states, torch.Generator().manual_seed(132), P10D_ROUNDS,
                      collector=lambda c: {"lp": c.log_posterior})
    sync()
    secs = time.perf_counter() - t0_
    counts = read_counts()
    want = held("P10d", kname, counts, n_steps, seen)
    swap_rate = float(out["swap_accepted"].double().mean())
    cold = out["lp"].tolist()
    rec = {"chains": P10D_CHAINS, "rounds": P10D_ROUNDS,
           "swap_every": P10D_SWAP_EVERY, "warm_up_gap": gap, "delta": delta,
           "temperatures": temps.tolist(), "seconds": secs,
           "added": [{"operator": type(op).__name__, "weight": op.weight}
                     for op in added],
           "aggregate_states_per_s": P10D_CHAINS * n_steps / secs,
           "single_chain_states_per_s": single,
           "single_chain_drawn": single_drawn, "launches": counts,
           "launches_expected": want,
           "launches_per_step": counts[kname] / n_steps,
           "bound_proposals": [list(x) for x in seen],
           "swap_acceptance": swap_rate,
           "swaps_accepted": out["swap_accepted"].tolist(),
           "cold_log_posterior_last": cold[-1]}
    if dev != "cpu":
        wall, busy = device_ms(lambda: run(
            states, torch.Generator().manual_seed(133), 1),
            "P10d benchmark1", P10D_SWAP_EVERY, 8)
        rec.update({"profiled_ms_per_step": wall,
                    "device_busy_ms_per_step": busy or "not measured",
                    "device_busy_share": (busy / wall if busy
                                          else "not measured")})
    for op in added:
        del op.propose_chains
    # every chain at its own temperature, its carried posterior against a
    # fresh one after each step
    tstep = make_multichain_step(lp_chains, ops, adaptation=False)
    _, dev_max = full_evaluation_check(tstep, lp_chains, states, 6,
                                       temperature=temps.to(dev))
    rec["full_eval_max_deviation"] = float(dev_max)
    rec["seconds_in_phase"] = time.perf_counter() - t_phase
    log(f"[P10d benchmark1] {json.dumps(rec)}")
    log(operator_report(ops, states))
    if not SWAP_BAND[0] <= swap_rate <= SWAP_BAND[1]:
        raise AssertionError(f"P10d: swap acceptance {swap_rate} outside "
                             f"{SWAP_BAND} (delta {delta})")
    if not all(np.isfinite(cold)):
        raise AssertionError("P10d: the cold chain's posterior is not finite")
    if not rec["full_eval_max_deviation"] < FULL_EVAL_TOL:
        raise AssertionError(f"P10d: full-evaluation deviation "
                             f"{rec['full_eval_max_deviation']}")
    records["P10d"], launches["benchmark1 P10d"] = rec, counts
    return records, launches


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
    from beast_mcmc_tpu_torch.ops.peeling import (
        one_chain, peel_order_from_heights)
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
                n_taxa, c, s, p = shape
                sched = cuda_stream.level_schedule(ch, n_taxa)
                ref = tuple(t[0] for t in cuda_stream._stream_plain(
                    tips, one_chain(sched), pm[None],
                    (cw[:, None] * fr[None, :])[None]))
                picked = tuple(cuda_stream.stream_plan(
                    p, c, s, pm.element_size())[:4])
                line = f"[tiles] {shape} {str(dtype)[6:]}"
                # below 16 states patterns a slot and warps a block, from 16
                # teams a block (the warps left to each)
                choices = ([{"pw": pw, "warps": w} for pw in (32, 16, 8, 4, 2)
                            for w in (4, 8, 16)]
                           if s < cuda_stream.MMA_MIN_STATES else
                           [{"teams": t} for t in range(1, 9)])
                for kw in choices:
                    try:
                        call = cuda_stream.prepare_stream(tips, sched, pm, fr,
                                                          cw, **kw)
                    except ValueError:  # outside the envelope
                        continue
                    site, post = call.launch()
                    err = max((site - ref[0]).abs().max().item(),
                              (cuda_stream2.deep_positions(post, p)
                               - ref[1]).abs().max().item())
                    plan = tuple(call.ints[4:8])  # pw, warps, nodes, g
                    line += (f" | {plan}{'*' if plan == picked else ''} "
                             f"err {err:.1e} ms {time_ms(call.launch, 5):.4f}")
                log(line)
                if s < cuda_peeling.MXU_MIN_STATES:
                    continue
                # the matrix-product kernel: teams a block, forced through
                # the planner's argument
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
    analyses[CODON_G4] = codon_analysis(CODON_G4[0], CODON_G4[3], 0,
                                        torch.float64, dev,
                                        n_categories=CODON_G4[1])
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
        else:  # peel_stream_ring, by levels; one tree is B = 1
            sched = cuda_stream.level_schedule(ch, n_int + 1)
            _, lr_ids, lr_pos, ls = sched
            ins = [tips, pm, lr_ids, lr_pos, ls, fr, cw]
            call = cuda_stream.prepare_stream(tips, sched, pm, fr, cw)
            plain_fn = lambda: tuple(  # noqa: E731
                t[0] for t in cuda_stream._stream_plain(
                    tips, one_chain(sched), pm[None], wcs[None]))
            rec["levels"] = int((ls < n_int).sum())
            rec["plan"] = call.ints[4:8]  # pw, warps, slots or teams, g
        got = call.launch()
        got = tuple(t.clone() for t in (got if isinstance(got, tuple)
                                        else (got,)))
        if kname == "peel_mxu":  # the kernel leaves the tips' rows to the
            got[1][:tips.shape[0]] = tips[:, None]  # wrapper, as here
        if kname == "peel_stream_ring":  # tile-major: by level position
            got = (got[0], cuda_stream2.deep_positions(got[1], p))
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
    check("peel_stream_ring", "benchmark1 partition f32", random_inputs(
        B1[0], 1, 4, B1[1], 37, f32, F32_CUT)[0], 20, 2)
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
        cut = F32_CUT if dtype == f32 else 0.6
        for label, shape, seed in RING_SHAPES:
            check("peel_stream_ring", f"{label} {name}", random_inputs(
                *shape, seed, dtype, cut, caterpillar="caterpillar" in label
            )[0], 10, 1)
    check("peel_stream_ring", "codon+gamma4 f64", peel_inputs(CODON_G4, f64),
          5, 1)

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
        elif kname == "peel_stream_ring":
            call = cuda_stream.prepare_stream(tips, sched, pm, fr, cw)
            singles = [cuda_stream.prepare_stream(
                tips, tuple(t[b] for t in sched), pm[b], fr[b], cw[b])
                for b in range(b_n)]
            plain_fn = lambda: cuda_stream._stream_plain(  # noqa: E731
                tips, sched, pm, wcs)
            ins = [tips, pm, ids, pos, ls, fr, cw]
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
        if kname == "peel_stream_ring":  # tile-major: by level position
            got = (got[0], cuda_stream2.deep_positions(got[1], p))
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
    chain_check("peel_stream_ring", "codon+gamma4 B=4 f64", CODON_G4,
                G4_CHAINS, 150, 3, 1)
    chain_check("peel_stream_ring", "benchmark1 partition B=4 f64", B1, 4,
                160, 10, 1)
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
        device_ms.events = sum(e.count for e in kern) / n
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
            def entry(*x):
                return cuda_stream.peel_site_loglik_stream(tips, ch, order,
                                                           root, *x, lvl)
            site_k, pos_k = cuda_stream._stream_forward(tips, ch, order, pm,
                                                        fr, cw, lvl)
            _, pos_p = cuda_stream._stream_plain(tips, one_chain(lvl),
                                                 pm[None], wcs[None])
            res_k = post_by_node(pos_k[None], tips[None], l_order)
            res_p = post_by_node(pos_p, tips[None], l_order)
            ins = [tips, pm, ids, pos, ls, fr, cw]

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
        averages = prof.key_averages()  # parsed once: seconds a window
        kern = sorted((e for e in averages
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kern) / 1e6
        if busy <= 0:
            log(f"[profile {label}] device time not measured by the profiler")
            return
        sorts = sum(e.count for e in averages if e.key == "aten::sort")
        log(f"[profile {label}] {n_steps} steps, wall {wall:.4f} s "
            f"(profiled), device busy {busy:.4f} s = "
            f"{100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%, "
            f"{sum(e.count for e in kern) / n_steps:.1f} device events/step, "
            f"{sorts / n_steps:.2f} sorts/step")
        for e in kern[:8]:
            log(f"[profile {label}]   {e.self_device_time_total / 1e3:9.3f} ms"
                f"  {e.count:6d}x  {e.key[:70]}")
        # the host side: the operators and launches with most own CPU time
        host = sorted((e for e in averages
                       if e.device_type != DeviceType.CUDA),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in host[:5]:
            log(f"[profile {label}]   host {e.self_cpu_time_total / 1e3:9.3f}"
                f" ms  {e.count:6d}x  {e.key[:70]}")

    where_time_goes("benchmark2", b2_step, b2_state, 4 * PROFILE_STEPS)
    for label, step_, state_ in (("makona", mak_step, mak_state),
                                 ("benchmark1", b1_step, b1_state),
                                 ("protein", aa_step, aa_state),
                                 ("codon", cod_step, cod_state)):
        where_time_goes(label, step_, state_, 2 * PROFILE_STEPS)
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
            _, busy = device_ms(lambda: run_chain(alone, st, 1),
                                f"hmc {label} {name}", 1, 10)
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

    # -- phase 10g: chain-axis gradients -------------------------------
    p10_grads = chain_gradient_checks(
        [("peel_resident", "benchmark2 B=8 f64", (B2, 8, 100)),
         ("peel_stream", "makona B=4 f64", (MAKONA, 4, 110)),
         ("peel_stream", "benchmark1 K=3 B=4 f64", (B1, 4, 120, True)),
         ("peel_mxu", "protein B=4 f64", (AMINO, 4, 130))],
        [("benchmark2 B=8", B2, 8, 140, "peel_resident"),
         ("makona B=4", MAKONA, 4, 141, "peel_stream"),
         ("benchmark1 B=4", B1, 4, 142, "peel_stream"),
         ("protein B=4", AMINO, 4, 143, "peel_mxu")],
        chain_inputs, analyses, reset_counts, read_counts, dev)
    mark("10g chain gradients")

    # -- phase 10: chain batches and MC3 with the bound operators -------
    from beast_mcmc_tpu_torch.inference.nuts import NutsOperator
    from beast_mcmc_tpu_torch.inference.pdmp import (
        BouncyParticleOperator, ZigZagOperator)
    from beast_mcmc_tpu_torch.inference.hmc import ReflectiveHmcOperator
    from beast_mcmc_tpu_torch.inference.samplers import SliceOperator

    rate_size = ("clock.rate", "pop.size")

    def hmc_pair():
        return [NodeHeightHmcOperator(weight=HMC_WEIGHTS[0],
                                      n_leapfrog=HMC_LEAPFROG,
                                      step_size=HMC_STEP),
                HmcOperator(parameters=rate_size, weight=HMC_WEIGHTS[1],
                            n_leapfrog=HMC_LEAPFROG, step_size=HMC_STEP)]

    pdmp_kw = p7["protein"]["settings"]
    p10, p10_launches = bound_chain_paths({
        "benchmark2": (analyses[B2], "peel_resident", hmc_pair()),
        "makona": (analyses[MAKONA], "peel_stream", [
            NodeHeightHmcOperator(weight=HMC_WEIGHTS[0],
                                  n_leapfrog=HMC_LEAPFROG,
                                  step_size=HMC_STEP),
            NutsOperator(parameters=rate_size, weight=HMC_WEIGHTS[1],
                         max_depth=NUTS_DEPTH, step_size=NUTS_STEP)]),
        "protein": (analyses[AMINO], "peel_mxu", [
            ZigZagOperator(parameters=rate_size, weight=3.0,
                           **pdmp_kw["ZigZagOperator"]),
            BouncyParticleOperator(parameters=rate_size, weight=3.0,
                                   **pdmp_kw["BouncyParticleOperator"])]),
        "benchmark1": (analyses[B1], "peel_stream", [
            ReflectiveHmcOperator(parameters=("kappa",), lower=0.0,
                                  n_leapfrog=HMC_LEAPFROG, step_size=0.01,
                                  weight=5.0),
            SliceOperator(parameter="pop.size", log_transform=True,
                          weight=3.0)])},
        reset_counts, read_counts, device_ms, dev)
    mark("10 bound chain batches")

    # -- phase 11: the GY94+Gamma4 codon chain at 1,441 taxa -----------
    g4_route = cuda_peeling.peel_route(2 * CODON_G4[0] - 1, CODON_G4[1],
                                       CODON_G4[2], 8)
    log(f"[P11] route of {CODON_G4} (taxa, categories, states, patterns): "
        f"{g4_route}")
    if g4_route != "stream":
        raise AssertionError(f"the codon+gamma4 chain goes to {g4_route}")
    p11, p11_launches = codon_gamma_path(
        analyses[CODON_G4], "peel_stream_ring", reset_counts, read_counts,
        device_ms, dev)
    p11_grads = chain_gradient_checks(
        [("peel_stream_ring", f"codon+gamma4 B={G4_CHAINS} f64",
          (CODON_G4, G4_CHAINS, 170))],
        [], chain_inputs, analyses, reset_counts, read_counts, dev)
    mark("11 codon+gamma4")

    # -- phase 12: the importer route at the Makona shape ---------------
    doc = os.path.join(SMOKE_OUT, "makona_spec.xml")
    os.makedirs(SMOKE_OUT, exist_ok=True)
    t0 = time.perf_counter()
    p12_doc = spec_document(doc, device=dev)
    log(f"[P12] wrote {doc} in {time.perf_counter() - t0:.2f} s: "
        f"{json.dumps(p12_doc)}")
    p12, p12_launches = spec_path(doc, SMOKE_OUT, reset_counts, read_counts,
                                  device_ms, dev)
    p12.update(p12_doc)
    mark("12 importer route")

    # -- phase 13: the CLI's MC3 and the sub-tools on phase 12's files --
    p13, p13_launches = mc3_path(doc, SMOKE_OUT, reset_counts, read_counts,
                                 device_ms, dev)
    p13["tools"] = tools_path(SMOKE_OUT, p12["taxa"], dev)
    mark("13 mc3 and tools")

    # -- phase 14: every MCMC operator, the Gibbs moves at the Makona shape --
    p14, p14_launches = operators_path(doc, reset_counts, read_counts,
                                       device_ms, dev)
    mark("14 operators")

    # -- phase 15: the XML interpreter route at the Makona shape ----------
    p15, p15_launches = interpreter_path(SMOKE_OUT, reset_counts,
                                         read_counts, device_ms, dev)
    p15["15c"] = functions_path(dev)
    p15["15d"], p15d_launches = testxml_path(SMOKE_OUT, reset_counts,
                                             read_counts, dev)
    p15_launches.update(p15d_launches)
    mark("15 interpreter route")

    # -- phase 16: the north-star document through the interpreter ------
    p16, p16_launches = north_star_path(SMOKE_OUT, reset_counts,
                                        read_counts, device_ms, dev)
    p16["16d"] = p16_functions_path(SMOKE_OUT, dev)
    mark("16 north-star document")

    # -- summary ------------------------------------------------------
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
    log(f"[summary p10] aggregate states/s with the bound operators: "
        + ", ".join(f"{k} B={r['chains']} "
                    f"{r['aggregate_states_per_s']:.2f} (one chain "
                    f"{r['single_chain_states_per_s']:.2f}, launches a step "
                    f"{r['launches_per_step']:.3f}, deviation "
                    f"{r['full_eval_max_deviation']!r})"
                    for k, r in p10.items())
        + f"; MC3 swap acceptance {p10['P10d']['swap_acceptance']:.3f}; "
        f"chain backward over B single backwards " + ", ".join(
            f"{r['label']} {r['backward_over_single_backwards']:.3f}"
            for r in p10_grads if "ms_backward" in r) + f"; on {smi_line}")
    g4_one, g4_b = p11["one chain"], p11[f"B={G4_CHAINS}"]
    log(f"[summary p11] codon+gamma4 {CODON_G4}: one chain "
        f"{g4_one['aggregate_states_per_s']:.2f} states/s, device busy "
        f"{g4_one.get('device_busy_share')}, deviation "
        f"{g4_one['full_eval_max_deviation']!r}; B={G4_CHAINS} "
        f"{g4_b['aggregate_states_per_s']:.2f} aggregate states/s "
        f"({g4_b['aggregate_states_per_s'] / g4_one['aggregate_states_per_s']:.2f}x "
        f"one chain), deviation {g4_b['full_eval_max_deviation']!r}; "
        f"gradient vs plain " + ", ".join(
            f"{r['label']} {r.get('grad_max_rel_err_vs_plain')!r} vs single "
            f"{r['grad_max_rel_err_vs_single']!r} launches "
            f"{r['launches_per_gradient']}" for r in p11_grads)
        + f"; on {smi_line}")
    log(f"[summary p9 logs] makona joint: {j_rec['log_rows']} log rows, "
        f"{j_rec['trees']} annotated trees read back; host ms of an "
        f"annotated tree sample {j_rec['tree_sample_ms']}; on {smi_line}")
    straight = p12["straight"]
    log(f"[summary p12] importer route {p12['taxa']} taxa x {p12['sites']} "
        f"sites ({p12['patterns']} patterns): straight run "
        f"{straight['states_per_s']} states/s ({straight['cli_seconds']:.2f} "
        f"s of CLI), peel_stream launches "
        f"{straight['launches']['peel_stream']} in {SPEC_STEPS} steps; "
        f"resumed final log posterior equals the straight one: "
        f"{p12['resumed_equals_straight']} "
        f"({json.dumps(p12['final_log_posterior'])}); reload deviation "
        f"{p12['reload_deviation']!r}; full-evaluation deviation "
        f"{p12['full_evaluation_deviation']!r}; device busy share "
        f"{p12['device_busy_share']}; on {smi_line}")
    tools = p13["tools"]
    log(f"[summary p13] MC3 CLI {MC3_CHAINS} chains at {p12['taxa']} taxa x "
        f"{p12['sites']} sites: {p13['cli']['aggregate_states_per_s']} "
        f"aggregate states/s (one chain, phase 12: "
        f"{straight['states_per_s']}), swap acceptance "
        f"{p13['cli']['swap_acceptance']}, peel_stream launches "
        f"{p13['cli']['launches']['peel_stream']} in {SPEC_STEPS} batch "
        f"steps, {p13['log_rows']} log rows; built batch deviation "
        f"{p13['full_evaluation_deviation']!r}, busy share "
        f"{p13['device_busy_share']}, draws vs single chains "
        f"{p13['draws_max_rel_err']!r}; tools host s "
        + ", ".join(f"{k} {v['host_seconds']:.2f}" for k, v in tools.items())
        + f"; seqgen {tools['seqgen']['patterns']} patterns; on {smi_line}")
    p14a, p14c = p14["14a"], p14["14c"]
    log(f"[summary p14] {p14a['operators']} new operators at "
        f"{p12['taxa']} taxa: {p14a['states_per_s']:.2f} states/s, busy share "
        f"{p14a['device_busy_share']}, deviation {p14a['max_deviation']!r}; "
        f"Gibbs proposals " + ", ".join(
            f"{r['operator']} {r['candidates']} candidates chunk "
            f"{r['chunk']} launches {r['launches']} {r['ms']:.1f} ms peak "
            f"{r['peak_memory_gb']:.2f} GB" for r in p14["14b"])
        + f"; {p14c['chains']} chains {p14c['aggregate_states_per_s']:.2f} "
        f"aggregate states/s, deviation {p14c['max_deviation']!r}; "
        f"densities on the card vs the CPU "
        f"{p14['14d']['densities_max_rel_err']!r}; on {smi_line}")
    p15a, p15b = p15["15a"], p15["15b"]
    log(f"[summary p15] interpreter route {p15['taxa']} taxa x "
        f"{p15['sites']} sites ({p15['patterns']} patterns): 15a CLI "
        f"random local clock + skyride {p15a['states_per_s']} states/s "
        f"({p15a['cli_seconds']:.2f} s of CLI), busy share "
        f"{p15a['device_busy_share']}, {p15a['device_events_per_step']} "
        f"device events a step, peel_stream launches "
        f"{p15a['predicted_launches']} (predicted), deviation "
        f"{p15a['full_evaluation_deviation']!r}; 15b local clock + skyline "
        f"{p15b['states_per_s']:.2f} states/s, busy share "
        f"{p15b['device_busy_share']}, {p15b['device_events_per_step']} "
        f"device events a step, peel_stream launches "
        f"{p15b['predicted_launches']} (predicted), deviation "
        f"{p15b['full_eval_deviation']!r}; 15c {p15['15c']['functions']} "
        f"functions, largest deviation {p15['15c']['max_rel_err']!r} "
        f"({p15['15c']['worst']}); 15d -testxml E[m] "
        f"{p15['15d']['mean']!r} (SE {p15['15d']['se']!r}, expected "
        f"1.9934); phase {phases['15 interpreter route']:.2f} s; on "
        f"{smi_line}")
    p16a, p16b, p16c = p16["16a"], p16["16b"], p16["16c"]
    log(f"[summary p16] north-star document {p16['taxa']} taxa x "
        f"{p16['sites']} sites, {p16['patterns']} patterns "
        f"({p16['patterns_padded']} padded), {p16['locations']} locations: "
        f"16a CLI {p16a['steps']} states {p16a['states_per_s']} states/s "
        f"({p16a['cli_seconds']:.2f} s of CLI, {p16a['chain_seconds']:.2f} s "
        f"of chain), peel_stream launches {p16a['predicted_launches']} "
        f"(predicted), {p16a['trees']} annotated trees; 16b "
        f"measure_makona_joint {p16b['states_per_s']:.2f} states/s (phase "
        f"9's fixed reader {j_rec['states_per_s']:.2f}), peel_stream "
        f"launches {p16b['launches']['peel_stream']} = treeLikelihood "
        f"steps {p16b['tree_likelihood_steps']}, deviation "
        f"{p16b['deviation']!r}, busy share {p16b['device_busy_share']}, "
        f"{p16b['device_events_per_step']} device events a step, host ms "
        f"of an annotated tree {[round(x, 3) for x in p16b['tree_sample_ms']]}"
        f"; 16c copy built in {p16c['build_seconds']:.2f} s, block update "
        f"acceptance {p16c['acceptance']:.3f}, {p16c['ms_per_proposal']:.3f}"
        f" ms a proposal ({p16c['device_events_per_proposal']} device "
        f"events, busy share {p16c['device_busy_share']}), deviation "
        f"{p16c['full_evaluation_deviation']!r}; 16d "
        f"{p16['16d']['functions']} functions, largest deviation "
        f"{p16['16d']['max_rel_err']!r} ({p16['16d']['worst']}); phase "
        f"{phases['16 north-star document']:.2f} s; on {smi_line}")
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
              p11_launches["codon+gamma4 one chain"]["peel_stream_ring"],
              "codon+gamma4 f64"),
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
                             "makona joint": j_launches,
                             **p10_launches, **p11_launches,
                             **p12_launches, **p13_launches,
                             **p14_launches, **p15_launches,
                             **p16_launches}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

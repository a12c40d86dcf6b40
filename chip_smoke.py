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
  17. marginal likelihoods and particles (`mle_path`, `particles_path`,
     `oracles_path`, `p17_functions_path`): 17a `python -m
     beast_mcmc_tpu_torch run doc.xml -testxml -scale P17_SCALE -seed
     P17_SEED` on a document of phase 15's taxa and alignment (HKY+Gamma4,
     strict clock, constant coalescent, a coalescentSimulator start tree):
     a pilot <mcmc> logging kappa, clock.rate and popSize, a
     <marginalLikelihoodEstimator> of P17_PATH_STEPS rungs of P17_CHAIN
     states from the posterior to logTransformedNormalReferencePriors
     fitted to the pilot log and the coalescent, and an <assertEqual> over
     its generalized stepping-stone analysis, which fails and after the
     pilot warns and is skipped; its peel_stream launches exactly as
     predicted (the pilot, then per rung one re-evaluation, its steps and
     its log rows), mle.log's rungs at the beta-quantile thetas, the GSS
     report against this script's own recomputation from mle.log, each
     rung's carried posterior within 0.1 of a fresh one, and a profiler
     window of P17_PROFILE rung steps; 17b P17_PARTICLES particles of phase
     12's document, started from seeds through the builder and saved,
     then `run doc -particles DIR -chain_length P17_PARTICLE_STEPS`:
     exactly one peel_stream launch a batch step for the particles and one
     for the template, each output reloaded within 0.1 with its step
     advanced, the batch's aggregate states/s through inference/smc.py;
     17c the conjugate normal model's analytic log m by path sampling,
     stepping stones, the harmonic mean and generalized stepping stones
     (inference/marginal_likelihood.py) within the JAX tests' tolerances,
     and by an XML document's GSS whose tree terms cancel (peel_resident,
     exact launches); 17d the new deterministic functions (the path's
     ends and rung targets, the reference priors, the Gibbs operators and
     the Bayesian bridge at given draws, the analytic gradient of
     config/xml_assert.py, insert_taxon) on the card against the CPU to
     P17_REL_TOL.
  18. continuous phylogeography (`rrw_path`, `p18_functions_path`): 18a
     `python -m beast_mcmc_tpu_torch run makona_rrw.xml` on phase 15's
     taxa and alignment (HKY+Gamma4, strict clock, constant coalescent, a
     coalescentSimulator start tree) with a 2-D location on each taxon (a
     Brownian motion down makona_data's tree from West Africa, about 5% of
     tips NA NA) under BEAUti's relaxed-random-walk vocabulary (a
     multivariateDiffusionModel with a Wishart prior and a
     precisionGibbsOperator, arbitraryBranchRates under a gamma prior, a
     traitDataLikelihood with a conjugate root prior), P18_STEPS states
     after the CLI's 100-step check: peel_stream launches exactly as
     predicted from _run_mcmc, the deviation, states/s, the log's
     great-circle diffusion rate and root location read back, the trait
     likelihood's ms by CUDA events and a profiler window of P18_PROFILE
     steps; 18b models/continuous.py's, factor.py's and liability.py's
     functions at 1,610 taxa and the trait likelihood's gradient in its
     precision and branch rates, on the card against the CPU to
     P18_REL_TOL.

  19. gradients, HMC and the phylogeographic GLM (`hmc_path`,
     `glm_path`, `p19_functions_path`): 19a `python -m
     beast_mcmc_tpu_torch run makona_hmc.xml -testxml` on phase 15's
     taxa and alignment (HKY+Gamma4, strict clock, constant coalescent, a
     coalescentSimulator start tree) with a <hamiltonianMonteCarloOperator>
     of P19_LEAPFROG leapfrogs over a <nodeHeightProxyParameter> (a
     <jointGradient> of <nodeHeightGradient> and <coalescentGradient>), a
     <NoUTurnOperator> over the clock rate and the population size and
     scale and tree moves, P19_STEPS states after the CLI's 100-step
     check; the document's <assertEqual> holds the <jointGradient>'s
     analytic report to the CPU's (computed first, from the same
     document) to P19_TESTXML_TOL of its largest entry (on the simulated
     start tree a mismatch only warns "(skipped)": such a warning fails
     the phase). Its peel_stream
     launches are predicted exactly: the report's evaluations, the
     chain's, and each bound proposal's own, counted as drawn by
     `BoundLaunches` (2 nSteps an HMC proposal, n_lf + 1 a NUTS one),
     which also times each proposal (CUDA events); then the deviation,
     states/s and a profiler window of P19_PROFILE steps; 19b the
     north-star document with its BSSVS origin model replaced by a
     <glmSubstitutionModel> over the same 56 locations (`glm_document`:
     four seeded predictors, BSSVS indicators, HMC on the coefficients
     with a <jointGradient> of <glmSubstitutionModelGradient> and the
     prior's <gradient>) through `run -scale P19_GLM_SCALE`
     (P19_GLM_STATES states): the same launch prediction, each coefficient
     proposal's ms, the allocator's peak, the log and the
     location-annotated trees read back; 19c the first-order surrogate,
     the GLM gradient element's (surrogate) and the exact coefficient
     gradients, the GLM, log-rate, lumpable and mixture generators,
     basta_loglikelihood at 1,610 taxa x P19_BASTA_DEMES demes (with its
     ms) and the skyline, speciation and increments gradients, on the
     card against the CPU to P19_REL_TOL.

  20. phylogenetic factor analysis and the HMC skygrid (`factor_path`,
     `skygrid_path`, `p20_functions_path`): 20a `python -m
     beast_mcmc_tpu_torch run makona_factors.xml` on phase 15's taxa and
     alignment (HKY+Gamma4, strict clock, constant coalescent) with
     P20_TRAITS traits a taxon simulated from P20_FACTORS factors by a
     Brownian motion (`factor_traits`, about P20_MISSING NA) under a
     <traitDataLikelihood> of an <integratedFactorModel>, HMC on the
     loadings (<integratedFactorAnalysisLoadingsGradient>), Bayesian-bridge
     row priors (<matrixShrinkageLikelihood>) with the multiplicative-gamma
     <normalGammaPrecisionGibbsOperator>, <integratedFactorsGibbsOperator>
     drawing the 1,610 x P20_FACTORS tip factors, and the
     <factorProportionStatistic> logged, P20_STEPS states after the CLI's
     100-step check: peel_stream launches predicted as drawn
     (`BoundLaunches`) and held exactly, the deviation, states/s, each
     loadings HMC proposal's ms and a tip-factor draw's (CUDA events), a
     profiler window of P20_PROFILE steps, the log read back; 20b `run
     makona_skygrid.xml -testxml`: the same taxa and alignment with a
     <multiLocusNPCoalescentLikelihood> on the north-star skygrid's 50
     cells and a <randomField> of a <gaussianMarkovRandomField> (gamma
     prior on its precision), HMC over the field with a <jointGradient> of
     both gradients, whose report an <assertEqual> holds to the CPU's to
     P20_TESTXML_TOL of its largest entry (a "(skipped)" warning fails,
     as in 19a), launches exact; 20c the sampled
     factor route at 1,610 x P20_TRAITS x P20_FACTORS (the
     latentFactorModel density, the loadings and scale conditionals, the
     tip-factor draw's mean, timed, the multiplicative-gamma rates), each
     GP kernel's field, the GP prediction and conditional derivative, the
     NP coalescent and its gradient, and the small densities on the card
     against the CPU to P20_REL_TOL.

  21. the model families outside the XML vocabulary (`p21_paths`) on
     `p21_data`, the Makona taxa, start tree and 2,048 padded patterns:
     21a (`covarion_path`) an HKY covarion chain with two hidden classes
     (S = 8: covarion_q, eigen_from_q_reversible), sequence-error tips of
     a sampled error rate (expand_tip_partials_hidden), the constrained
     NNI and SPR inside the start tree's constraints tree (clades of fewer
     than P21_MIN_CLADE tips collapsed) with node heights under a constant
     coalescent, P21_STEPS steps of exactly one peel_stream_ring launch,
     the launch at the start held per site against the node-by-node plain
     peel, every constraint clade kept in every step, the deviation, a
     profiler window, then branch_expected_jumps and
     sample_branch_histories over all 3,218 branches card against CPU;
     21b (`arg_path`) an ARG of P21_ARG_EVENTS reassortments with the
     patterns split in two segments, each partition's level route (one
     peel_stream launch) against the plain peel, and P21_ARG_STEPS steps
     of the height and flip moves under arg_coalescent_loglik, two
     launches a step exactly; 21c (`thorney_path`, `empirical_path`) a
     Thorney chain at P21_THORNEY_TIPS tips of a constrained tree
     (build_constrained_tree of its constraints Newick) under the Poisson
     branch-length likelihood, P21_THORNEY_STEPS steps and no launch, and
     an empirical-tree chain over 21a's start tree and 31 of its steps'
     under GTR+Gamma4, P21_EMP_STEPS steps of one peel_stream launch;
     21d (`p21_functions_path`) the msc, alloppnet, transmission,
     case-to-case, clustering, MDS, antigenic, Hawkes, geo, regression and
     hypermutation functions at the issue's sizes on the card against the
     CPU to P21_REL_TOL; and fault C7's check (`c7_path`): a <gradient>
     report over kappa, the frequencies and the clock rate, Hessian
     diagonal included, on the card against the CPU to P21_C7_TOL.

  22. the multi-process layer (`parallel_path`): P22_RANKS ranks of `python
     -m beast_mcmc_tpu_torch.parallel` on the one card with
     backend="gloo" (NCCL takes one rank a GPU), started once: 22a the
     pattern-sharded likelihood (parallel/distributed.py::
     sharded_pattern_loglik) of random inputs at P22_LIK, Makona's width,
     on a P22_LIK_MESH mesh, each rank one peel_stream launch on its
     shard, held per site against the node-by-node plain peel, the
     reduced total equal on both ranks bit for bit and within
     P22_TOTAL_TOL of this process's unsharded total; 22b the counterpart
     of __graft_entry__.py::dryrun_multichip at P22_DRY, a tempered
     ensemble of 4 GTR+Gamma4 chains in float64 (swap every 12 steps, delta
     0.002, 10 rounds) with the likelihood of each rank's pattern shard
     all-reduced and the priors added once, on a 2 x 1 mesh (two chains a
     rank, swaps across ranks, each chain shard its own streams) and a 1 x
     2 mesh (all chains on each rank, half the patterns, the ranks' states
     equal bit for bit): swap acceptance inside SWAP_BAND, exactly one
     peel_stream launch a batch step and one a check on each rank, the
     full-evaluation deviation, each rank's shard (128 and 64 patterns)
     held per site against the node-by-node plain peel; meanwhile 22c, in this process, a world of
     one rank on backend="nccl" takes 22a's total over a 1 x 1 mesh, equal
     to the unsharded one. A rank that fails or outlives P22_TIMEOUT fails
     the run.

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
import math
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
PROFILE_STEPS = 4  # 8 before phase 20's third depth cut
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
# the depths here, of P7_*, P10_PATHS, P15_STEPS_*, P16_*, P18_STEPS and
# P19_STEPS were cut to make room for phases 19 and 20 in
# the script's time (the earlier values beside them: before phase 19, then
# before phase 20)
HMC_ALONE = 2  # proposals of each HMC operator alone: launches, times (8, 4)
HMC_B2_STEPS, HMC_B2_CHECK = 50, 10  # 200, 40
HMC_MAK_STEPS, HMC_MAK_CHECK = 8, 2  # 60, 15; 16, 4


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
P7_ALONE = 2  # proposals of each chain operator alone: launches, times (4)
P7_STEPS = {"benchmark2": (50, 12), "benchmark1": (50, 12),  # 200, 40; 100, 20
            "protein": (50, 12)}  # steps, full-evaluation steps (100, 25)
P7_TOY_STEPS = 50  # 500; 200; 100 before phase 22's cut
NUTS_STEP, NUTS_DEPTH = 1e-3, 6
PDMP_EVENTS = 20.0  # 35 before phase 22's cut
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
P8_PATHS = {"benchmark2": (8, 100, 40), "makona": (4, 60, 15),
            "protein": (4, 50, 25)}  # steps 200, 60, 100 before phase 20
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
SPEC_STEPS, SPEC_CHECK, SPEC_PROFILE, SPEC_SEED = 200, 50, PROFILE_STEPS, 7
# (SPEC_STEPS 300 before phase 20's third depth cut)
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
P15_STEPS_A, P15_CHECK_A = 150, 100  # 300
P15_STEPS_B, P15_CHECK_B = 100, 50  # 200
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
P16_STATES = 50  # 200; 100
P16_SCALE = P16_STATES / 200_000_000
P16_WARM, P16_STEPS, P16_PROFILE = 16, 48, PROFILE_STEPS  # 192; 96
P16_BLOCK_PROPOSALS, P16_BLOCK_WEIGHT, P16_BLOCK_CHECK = 20, 4, 40  # 40
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


# phase 17, marginal likelihoods and particles: 17a's pilot chain (its
# logEvery and the CLI's 100-step full-evaluation check), the estimator's
# path steps, rung length and logEvery, the CLI's -scale and -seed, its
# profiler window; 17b's particles, their start steps and the CLI's
# -chain_length; 17c's ladders (rungs and states a rung, as the JAX tests'
# but shorter, and each estimator's tolerance of those tests), the XML
# oracle's pilot, rungs and states a rung; 17d's tolerance
P17_PILOT, P17_PILOT_LOG, P17_CHECK = 100, 10, 100
P17_PATH_STEPS, P17_CHAIN, P17_LOG_EVERY = 8, 64, 8
P17_SCALE, P17_SEED, P17_PROFILE = 1.0, 17, 8  # a rung's window
P17_PARTICLES, P17_START_STEPS, P17_PARTICLE_STEPS = 4, 5, 50
P17_PS_RUNGS, P17_GSS_RUNGS, P17_PS_CHAIN, P17_GSS_CHAIN = 24, 12, 600, 400
P17_ORACLE_LOG = 2
P17_PS_TOL, P17_SS_TOL, P17_HM_TOL, P17_GSS_TOL = 0.25, 0.15, 2.0, 0.15
P17_XML_PILOT, P17_XML_RUNGS, P17_XML_CHAIN, P17_XML_CHECK = 300, 8, 160, 10
# (rungs of 300 before phase 20's third depth cut; the pilot fits the
# reference prior: at 200 states it left the GSS 0.118 from log m)
P17_REL_TOL = 1e-12
GSS_COLUMNS = ('<thetaColumn name="pathLikelihood.theta"/>'
               '<sourceColumn name="pathLikelihood.source"/>'
               '<destinationColumn name="pathLikelihood.destination"/>')


def mle_document(path, data, pilot=P17_PILOT, path_steps=P17_PATH_STEPS,
                 chain=P17_CHAIN, log_every=P17_LOG_EVERY):
    """Write a marginal-likelihood document at `path` on makona_data's
    taxa and alignment: HKY+Gamma4 (alpha fixed), a strict clock, a
    constant coalescent and a coalescentSimulator start tree, proper
    priors on kappa, clock.rate and popSize; a pilot <mcmc> of `pilot`
    states that logs the three every P17_PILOT_LOG; a
    <marginalLikelihoodEstimator> of `path_steps` rungs of `chain` states
    from the posterior to logTransformedNormalReferencePriors on the three,
    fitted to the pilot log, and the coalescent (the tree's prior given
    popSize: a normalised working distribution of every sampled value),
    logging every `log_every` to mle.log; then an <assertEqual> over its
    generalizedSteppingStoneSamplingAnalysis (expected 0.0: it fails, and
    after the pilot warns and is skipped, its report in the warning)."""
    import math

    cfg = data["cfg"]
    init = cfg["model"]["init"]
    pop = float(cfg["pop_size"])
    rate = float(init["ucld.mean"])
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += taxa_alignment_xml(data)
    refs = "\n".join(
        f"""          <logTransformedNormalReferencePrior fileName="pilot.log" parameterColumn="{p}" burnin="0">
            <parameter idref="{p}"/></logTransformedNormalReferencePrior>"""
        for p in ("kappa", "clock.rate", "popSize"))
    out.append(_seq_models_xml(data, _COALESCENT_XML, "treeLikelihood"))
    out.append(f"""  <operators id="operators">
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="kappa"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="clock.rate"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="popSize"/></scaleOperator>
    <subtreeSlide size="1.0" gaussian="true" weight="15"><treeModel idref="treeModel"/></subtreeSlide>
    <narrowExchange weight="15"><treeModel idref="treeModel"/></narrowExchange>
    <wilsonBalding weight="3"><treeModel idref="treeModel"/></wilsonBalding>
    <uniformOperator weight="30"><parameter idref="treeModel.internalNodeHeights"/></uniformOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="treeModel.rootHeight"/></scaleOperator>
  </operators>
  <mcmc id="mcmc" chainLength="{pilot}" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="kappa"/></logNormalPrior>
        <logNormalPrior mean="{math.log(rate)!r}" stdev="1.0"><parameter idref="clock.rate"/></logNormalPrior>
        <logNormalPrior mean="{math.log(pop)!r}" stdev="1.0"><parameter idref="popSize"/></logNormalPrior>
        <coalescentLikelihood idref="coalescent"/>
      </prior>
      <likelihood id="likelihood"><treeLikelihood idref="treeLikelihood"/></likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="{P17_PILOT_LOG}" fileName="pilot.log">
      <parameter idref="kappa"/><parameter idref="clock.rate"/><parameter idref="popSize"/>
    </log>
  </mcmc>
  <marginalLikelihoodEstimator chainLength="{chain}" pathSteps="{path_steps}">
    <samplers><mcmc idref="mcmc"/></samplers>
    <pathLikelihood id="pathLikelihood">
      <source><posterior idref="posterior"/></source>
      <destination>
        <workingPrior>
{refs}
        </workingPrior>
        <coalescentLikelihood idref="coalescent"/>
      </destination>
    </pathLikelihood>
    <log logEvery="{log_every}" fileName="mle.log"/>
  </marginalLikelihoodEstimator>
  <assertEqual tolerance="1e-9">
    <message>GSS log marginal likelihood</message>
    <actual regex="= (\\S+)"><generalizedSteppingStoneSamplingAnalysis id="gss" fileName="mle.log">{GSS_COLUMNS}</generalizedSteppingStoneSamplingAnalysis></actual>
    <expected>0.0</expected>
  </assertEqual>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))


def gss_of_log(path, alpha=0.3):
    """The generalized stepping-stone estimate of an MLE log, computed here
    from the file alone: (theta values, rows per theta, log m)."""
    import numpy as np

    lines = [ln.split("\t") for ln in open(path).read().splitlines()]
    rows = np.array(lines[1:], float)
    theta, src, dst = rows[:, 1], rows[:, 2], rows[:, 3]
    betas = np.unique(theta)  # ascending
    total = 0.0
    for k in range(len(betas) - 1):
        x = (betas[k + 1] - betas[k]) * (src - dst)[theta == betas[k]]
        total += x.max() + np.log(np.mean(np.exp(x - x.max())))
    return betas, [int((theta == b).sum()) for b in betas], float(total)


def _cli_in(out_dir, args):
    """__main__.main(args) run from out_dir: (rc, stdout and stderr, the
    warnings it raised, seconds)."""
    import contextlib
    import io
    import warnings

    from beast_mcmc_tpu_torch.__main__ import main as cli

    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(out_dir)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rc = cli(args)
    finally:
        os.chdir(cwd)
    return (rc, out.getvalue() + err.getvalue(),
            [str(w.message) for w in caught], time.perf_counter() - t0)


def mle_path(out_dir, reset_counts, read_counts, device_ms, dev,
             n_taxa=SPEC_TAXA, n_sites=SPEC_SITES, pilot=P17_PILOT,
             path_steps=P17_PATH_STEPS, chain=P17_CHAIN,
             log_every=P17_LOG_EVERY, n_profile=P17_PROFILE):
    """Phase 17a (see the module docstring) at n_taxa x n_sites. The peel
    launches are predicted from the interpreter: the pilot's start, two a
    checked step of the CLI's 100-step check and one a step (its log holds
    no likelihood column), then per rung one re-evaluation (the start for
    the first), one a step and one a log row's source; all of them
    peel_stream at the Makona shape. Returns (record, launches)."""
    import math
    import re

    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.config.xml_assert import (
        initial_eval_state, report_of)
    from beast_mcmc_tpu_torch.config.xml_mle import estimator_parts
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_mcmc_step, run_chain)

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    doc = os.path.join(out_dir, "makona_mle.xml")
    mle_document(doc, data, pilot, path_steps, chain, log_every)
    rec = {"taxa": len(data["taxa"]), "sites": data["sites"],
           "patterns": data["patterns"],
           "document_seconds": time.perf_counter() - t0}
    launches = {}

    def expect(counts, n, label):
        want = {k: n * (k == "peel_stream") for k in counts}
        launches[f"P17 {label}"] = counts
        if counts != want:
            raise AssertionError(f"P17 {label}: launches {counts}, "
                                 f"expected {want}")

    reset_counts()
    rc, text, warned, cli_s = _cli_in(out_dir, [
        "run", doc, "-testxml", "-scale", repr(P17_SCALE), "-seed",
        str(P17_SEED), "-device", str(dev)])
    runs = re.findall(r"(\d+) states in ([0-9.]+)s = ([0-9.]+) states/sec; "
                      r"full-evaluation deviation (\S+)", text)
    if rc != 0 or len(runs) != 2 or "all embedded checks passed" not in text:
        raise AssertionError(f"P17a: rc {rc}\n{text[-3000:]}")
    rows = chain // log_every
    a = {"rc": rc, "cli_seconds": cli_s,
         "pilot_states_per_s": float(runs[0][2]),
         "ladder_states": int(runs[1][0]),
         "ladder_seconds": float(runs[1][1]),
         "ladder_states_per_s": float(runs[1][2]),
         "pilot_deviation": float(runs[0][3]),
         "rung_deviation": float(runs[1][3]),
         "predicted_launches": (1 + 2 * P17_CHECK + pilot)
         + path_steps * (1 + chain + rows)}
    expect(read_counts(), a["predicted_launches"], "17a CLI")
    if a["ladder_states"] != path_steps * chain or not (
            a["rung_deviation"] <= FULL_EVAL_TOL
            and a["pilot_deviation"] <= FULL_EVAL_TOL):
        raise AssertionError(f"P17a ladder: {a}")
    # the log: the ladder's theta values, rows per rung, the estimate
    betas, per_rung, gss = gss_of_log(os.path.join(out_dir, "mle.log"))
    want_b = np.linspace(1.0, 0.0, path_steps) ** (1.0 / 0.3)
    if not (np.array_equal(betas[::-1], want_b)
            and per_rung == [rows] * path_steps):
        raise AssertionError(f"P17a mle.log: thetas {betas}, rows {per_rung}")
    # the assertion warned and was skipped, its report in the warning
    m = [re.search(r"\(skipped\): assert GSS log marginal likelihood: "
                   r"'(\S+)' != '0.0'", w) for w in warned]
    m = [x for x in m if x]
    if len(m) != 1:
        raise AssertionError(f"P17a: assertEqual warnings {warned}")
    a["gss_warned"] = float(m[0].group(1))
    a["gss_recomputed"] = gss
    if not (math.isfinite(gss)
            and abs(a["gss_warned"] - gss) <= P17_REL_TOL * abs(gss)):
        raise AssertionError(f"P17a GSS: report {a['gss_warned']!r}, "
                             f"recomputed {gss!r}")

    # a rung's profile on the same document (parsed again), from its start
    ax = XmlAnalysis(doc, seed=P17_SEED, device=dev, workdir=out_dir)
    ax.build(ax._ids["treeModel"])
    a["gss_report"] = float(report_of(ax, ax._ids["gss"]).split("= ")[1])
    if abs(a["gss_report"] - gss) > P17_REL_TOL * abs(gss):
        raise AssertionError(f"P17a GSS report {a['gss_report']!r}")
    parts = estimator_parts(ax, ax.root.find("marginalLikelihoodEstimator"))
    b = float(parts["betas"][path_steps // 2])

    def lp(params, tree):
        return b * parts["source"](params, tree) + (1.0 - b) * parts[
            "destination"](params, tree)

    reset_counts()
    step = make_mcmc_step(lp, parts["operators"])
    state = init_mcmc_state(*initial_eval_state(ax),
                            torch.Generator(device=dev).manual_seed(P17_SEED),
                            parts["operators"], lp)
    wall, busy = device_ms(lambda: run_chain(step, state, n_profile),
                           "p17a rung", n_profile)
    expect(read_counts(), 1 + n_profile, "17a rung profile")
    a.update({"profile_theta": b, "profile_ms_per_step": wall,
              "device_busy_share": None if busy is None else busy / wall,
              "device_events_per_step": device_ms.events})
    rec["17a"] = a
    log(f"[P17a] CLI rc {rc} in {cli_s:.2f} s: pilot "
        f"{a['pilot_states_per_s']} states/s, ladder {path_steps} x {chain} "
        f"states in {a['ladder_seconds']} s = {a['ladder_states_per_s']} "
        f"states/s, largest rung carried-vs-fresh deviation "
        f"{a['rung_deviation']!r}, peel_stream launches "
        f"{a['predicted_launches']} as predicted; mle.log {path_steps} rungs "
        f"of {rows} rows at the beta-quantile thetas; GSS {gss!r} (report "
        f"{a['gss_report']!r}, warned {a['gss_warned']!r}); rung profile at "
        f"theta {b:.4g}: {wall:.3f} ms a step, busy share "
        f"{a['device_busy_share']}, {a['device_events_per_step']} device "
        f"events a step")
    return rec, launches


def particles_path(doc, out_dir, reset_counts, read_counts, dev,
                   k=P17_PARTICLES, start_steps=P17_START_STEPS,
                   n_steps=P17_PARTICLE_STEPS):
    """Phase 17b: k particles of the importer document `doc`, started from
    seeds 1 to k and advanced start_steps each through the builder (one
    launch to start, one a step), saved with save_checkpoint; then `run
    doc -particles DIR -chain_length n_steps`: JAX's printed line, one
    peel_stream launch for the template state and exactly one a batch step
    (the chain-axis deep peel of the k particles); k files in DIR.out, each
    reloaded with its step advanced by n_steps and its posterior within 0.1
    of a fresh one; the same batch advanced through inference/smc.py for
    aggregate states/s. Returns (record, launches)."""
    import shutil

    import torch

    from beast_mcmc_tpu_torch.config.builder import build
    from beast_mcmc_tpu_torch.config.xml_import import parse_beast_xml
    from beast_mcmc_tpu_torch.inference import smc
    from beast_mcmc_tpu_torch.inference.checkpoint import (
        load_checkpoint, save_checkpoint)
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_mcmc_step, make_multichain_step, run_chain)

    launches = {}

    def expect(counts, n, label):
        want = {key: n * (key == "peel_stream") for key in counts}
        launches[f"P17 {label}"] = counts
        if counts != want:
            raise AssertionError(f"P17 {label}: launches {counts}, "
                                 f"expected {want}")

    def sync():
        if str(dev) != "cpu":
            torch.cuda.synchronize()

    folder = os.path.join(out_dir, "particles")
    for d in (folder, folder + ".out"):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    analysis = build(parse_beast_xml(open(doc).read()), device=dev)
    step = make_mcmc_step(analysis.log_posterior, analysis.operators)
    rec = {"particles": k, "build_seconds": time.perf_counter() - t0}
    reset_counts()
    for i in range(1, k + 1):
        st = init_mcmc_state(analysis.params0, analysis.tree0,
                             torch.Generator(device=dev).manual_seed(i),
                             analysis.operators, analysis.log_posterior)
        st, _ = run_chain(step, st, start_steps)
        save_checkpoint(os.path.join(folder, f"particle_start{i}"), st)
    expect(read_counts(), k * (1 + start_steps), "17b starts")

    reset_counts()
    rc, text, _, cli_s = _cli_in(out_dir, [
        "run", doc, "-particles", folder, "-chain_length", str(n_steps),
        "-device", str(dev)])
    line = f"advanced {k} particles by {n_steps} states -> {folder}.out"
    if rc != 0 or line not in text:
        raise AssertionError(f"P17b: rc {rc}\n{text[-3000:]}")
    expect(read_counts(), 1 + n_steps, "17b CLI")
    files = sorted(f for f in os.listdir(folder + ".out")
                   if f.endswith(".npz"))
    if files != [f"particle{i:04d}.npz" for i in range(k)]:
        raise AssertionError(f"P17b: files {files}")
    template = init_mcmc_state(analysis.params0, analysis.tree0,
                               torch.Generator(device=dev),
                               analysis.operators)
    devs = []
    for f in files:
        st = load_checkpoint(os.path.join(folder + ".out", f), template)
        fresh = float(analysis.log_posterior(st.params, st.tree))
        devs.append(abs(fresh - float(st.log_posterior)))
        if st.step != start_steps + n_steps:
            raise AssertionError(f"P17b {f}: step {st.step}")
    if not max(devs) <= FULL_EVAL_TOL:
        raise AssertionError(f"P17b reload deviations {devs}")

    # the same batch through inference/smc.py, timed
    particles = smc.load_particles(folder, template)
    mstep = make_multichain_step(analysis.log_posterior_chains,
                                 analysis.operators)
    reset_counts()
    sync()
    t1 = time.perf_counter()
    smc.run_particles(mstep, particles, n_steps)
    sync()
    seconds = time.perf_counter() - t1
    expect(read_counts(), n_steps, "17b batch")
    rec.update({"rc": rc, "cli_seconds": cli_s, "reload_deviations": devs,
                "batch_seconds": seconds,
                "aggregate_states_per_s": k * n_steps / seconds})
    log(f"[P17b] {k} particles of {os.path.basename(doc)} ({start_steps} "
        f"steps each from seeds 1-{k}); CLI rc {rc} in {cli_s:.2f} s, "
        f"'{line}', peel_stream launches 1 + {n_steps}; reload deviations "
        f"{[float(f'{x:.3g}') for x in devs]} (tolerance {FULL_EVAL_TOL}), "
        f"steps {start_steps + n_steps}; the batch through inference/smc.py "
        f"{rec['aggregate_states_per_s']:.2f} aggregate states/s "
        f"({n_steps} steps in {seconds:.2f} s)")
    return rec, launches


P17_ORACLE_DATA = (1.0, 2.0, 3.0)  # CONJUGATE_XML's y, m ~ N(0, 10^2)


def oracle_document(path, pilot=P17_XML_PILOT, rungs=P17_XML_RUNGS,
                    chain=P17_XML_CHAIN):
    """Write CONJUGATE_XML's model (a 4-taxon tree likelihood and
    coalescent, and y ~ N(m, 1) with m ~ N(0, 10^2)) with a pilot of
    `pilot` states that logs m, and a <marginalLikelihoodEstimator> of
    `rungs` rungs of `chain` states from the posterior to a
    normalReferencePrior on m plus the tree likelihood and the coalescent:
    the tree terms are in both ends of the path and cancel from the
    estimator, so its estimate is the normal model's log m
    (`oracle_log_m`), and every evaluation of either end peels the tree
    (peel_resident on the card)."""
    xml = (CONJUGATE_XML
           .replace('<mcmc id="mcmc" chainLength="60000"',
                    f'<mcmc id="mcmc" chainLength="{pilot}"')
           .replace('logEvery="20" fileName="distlik.log"',
                    'logEvery="4" fileName="pilot.log"')
           .replace('<posterior idref="posterior"/>\n      <parameter',
                    '<parameter')
           .replace('weight="5">\n      <treeModel', 'weight="1">\n      '
                    '<treeModel')
           .replace('<uniformOperator weight="10">',
                    '<uniformOperator weight="1">'))
    xml = xml[:xml.index("  <traceAnalysis")] + f"""  <marginalLikelihoodEstimator chainLength="{chain}" pathSteps="{rungs}">
    <samplers><mcmc idref="mcmc"/></samplers>
    <pathLikelihood id="pathLikelihood">
      <source><posterior idref="posterior"/></source>
      <destination>
        <workingPrior>
          <normalReferencePrior fileName="pilot.log" parameterColumn="m" burnin="100">
            <parameter idref="m"/></normalReferencePrior>
        </workingPrior>
        <treeLikelihood idref="treeLikelihood"/>
        <coalescentLikelihood idref="coalescent"/>
      </destination>
    </pathLikelihood>
    <log logEvery="4" fileName="mle.log"/>
  </marginalLikelihoodEstimator>
  <generalizedSteppingStoneSamplingAnalysis id="gss" fileName="mle.log">{GSS_COLUMNS}</generalizedSteppingStoneSamplingAnalysis>
</beast>
"""
    with open(path, "w") as f:
        f.write(xml)


def oracle_log_m(y=P17_ORACLE_DATA, s=1.0, t=10.0):
    """The analytic log marginal likelihood of y_i ~ N(m, s^2), m ~ N(0,
    t^2): y ~ N(0, s^2 I + t^2 1 1^T)."""
    import numpy as np

    y = np.asarray(y, float)
    n = y.size
    cov = s ** 2 * np.eye(n) + t ** 2 * np.ones((n, n))
    return float(-0.5 * (n * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1]
                         + y @ np.linalg.solve(cov, y)))


def normal_model(dev):
    """tests/test_marginal_likelihood.py's and tests/test_avmvn_gss.py's
    conjugate model on `dev`: (log_lik, log_prior, log_ref, analytic log m,
    a 3-taxon tree). Twelve draws x ~ N(1.5, 1) (numpy seed 0), x_i ~ N(mu,
    1), mu ~ N(0, 2^2); the reference N(posterior mean, (1.6 posterior
    sd)^2)."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.models.priors import normal_logpdf
    from beast_mcmc_tpu_torch.tree.topology import (
        make_tree_state, simulate_coalescent_tree)

    x_np = np.random.default_rng(0).normal(1.5, 1.0, size=12)
    x = torch.tensor(x_np, device=dev)
    prec_post = x_np.size + 1 / 4.0
    mu_post = float(np.sum(x_np) / prec_post)
    sd_ref = 1.6 / np.sqrt(prec_post)
    tree = make_tree_state(*simulate_coalescent_tree(
        np.random.default_rng(0), np.zeros(3), 1.0), torch.float64, dev)
    return (lambda p, t: torch.sum(normal_logpdf(x, p["mu"], 1.0)),
            lambda p, t: normal_logpdf(p["mu"], 0.0, 2.0),
            lambda p, t: normal_logpdf(p["mu"], mu_post, sd_ref),
            oracle_log_m(x_np, 1.0, 2.0), tree)


def oracles_path(out_dir, reset_counts, read_counts, dev,
                 ps_chain=P17_PS_CHAIN, gss_chain=P17_GSS_CHAIN,
                 xml_pilot=P17_XML_PILOT,
                 xml_chain=P17_XML_CHAIN, kname="peel_resident"):
    """Phase 17c: the conjugate normal model's analytic log m recovered on
    `dev` by sample_power_posteriors (P17_PS_RUNGS rungs; path sampling,
    stepping stones, the harmonic mean of the first rung; ps_chain states
    a rung) and sample_gss_ratios (P17_GSS_RUNGS rungs of gss_chain), a
    sample every P17_ORACLE_LOG states, each within the tolerance of the
    JAX package's own test (whose chains are 4,000 states a rung); then
    oracle_document through XmlAnalysis.run, its GSS report within
    P17_GSS_TOL of oracle_log_m, its tree likelihood's launches exactly
    the pilot's (start, two a checked step, one a step) and per rung two
    at the start and two a step and a log row (both ends peel), all of
    them `kname` (peel_resident at its 4 taxa). Returns (record,
    launches)."""
    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.config.xml_assert import report_of
    from beast_mcmc_tpu_torch.inference import marginal_likelihood as ml
    from beast_mcmc_tpu_torch.inference.operators import RandomWalkOperator

    log_lik, log_prior, log_ref, analytic, tree = normal_model(dev)
    ops = [RandomWalkOperator(parameter="mu", window=1.0)]
    mu0 = {"mu": torch.tensor(0.5, dtype=torch.float64, device=dev)}
    t0 = time.perf_counter()
    betas = ml.beta_quantile_schedule(P17_PS_RUNGS)
    lls = ml.sample_power_posteriors(
        log_lik, log_prior, ops, mu0, tree, betas, ps_chain, P17_ORACLE_LOG,
        torch.Generator(device=dev).manual_seed(0))
    est = {"ps": ml.path_sampling_logml(lls, betas),
           "ss": ml.stepping_stone_logml(lls, betas),
           "hm": ml.harmonic_mean_logml(lls[0])}
    betas = ml.beta_quantile_schedule(P17_GSS_RUNGS)
    est["gss"] = ml.generalized_stepping_stone_logml(ml.sample_gss_ratios(
        log_lik, log_prior, log_ref, ops, mu0, tree, betas, gss_chain,
        P17_ORACLE_LOG,
        torch.Generator(device=dev).manual_seed(1)), betas)
    ladder_s = time.perf_counter() - t0
    tols = {"ps": P17_PS_TOL, "ss": P17_SS_TOL, "hm": P17_HM_TOL,
            "gss": P17_GSS_TOL}
    for key, v in est.items():
        if not abs(v - analytic) < tols[key]:
            raise AssertionError(f"P17c {key}: {v!r} against {analytic!r}")

    path = os.path.join(out_dir, "oracle_mle.xml")
    oracle_document(path, xml_pilot, P17_XML_RUNGS, xml_chain)
    reset_counts()
    t1 = time.perf_counter()
    ax = XmlAnalysis(path, seed=P17_SEED, device=dev, workdir=out_dir)
    ax.run(full_eval_steps=P17_XML_CHECK)
    xml_s = time.perf_counter() - t1
    xml_est = float(report_of(ax, ax._ids["gss"]).split("= ")[1])
    xml_oracle = oracle_log_m()
    rows = xml_chain // 4
    counts = read_counts()
    want = (1 + 2 * P17_XML_CHECK + xml_pilot) + P17_XML_RUNGS * (
        2 + 2 * xml_chain + 2 * rows)
    launches = {"P17 17c XML": counts}
    if counts != {key: want * (key == kname) for key in counts}:
        raise AssertionError(f"P17c XML launches {counts}, expected {want} "
                             f"{kname}")
    if not abs(xml_est - xml_oracle) < P17_GSS_TOL:
        raise AssertionError(f"P17c XML GSS {xml_est!r} against "
                             f"{xml_oracle!r}")
    rec = {"analytic": analytic, **est, "ladder_seconds": ladder_s,
           "xml_gss": xml_est, "xml_analytic": xml_oracle,
           "xml_seconds": xml_s, "xml_launches": want,
           "xml_deviation": ax.runs[-1]["full_eval_deviation"]}
    log(f"[P17c] conjugate normal log m {analytic!r}: path sampling "
        f"{est['ps']!r}, stepping stones {est['ss']!r}, harmonic mean "
        f"{est['hm']!r} ({P17_PS_RUNGS} rungs of {ps_chain}), GSS "
        f"{est['gss']!r} ({P17_GSS_RUNGS} rungs of {gss_chain}), "
        f"{ladder_s:.2f} s; the XML document's GSS {xml_est!r} against "
        f"{xml_oracle!r} in {xml_s:.2f} s, {kname} launches {want} as "
        f"predicted, rung deviation {rec['xml_deviation']!r}")
    return rec, launches


def p17_function_cases(ax, dev):
    """{label: fn() -> tensor}: 17d's deterministic functions on the
    analysis `ax` of oracle_document (on `dev`): each end of its path and
    the rung target at each theta at the start state and a moved one; each
    working prior's density at three values; the five Gibbs operators of
    inference/gibbs.py (their new values and log Hastings, +inf for a Gibbs
    move) and the Bayesian bridge given their draws; the
    analytic gradient of the tree likelihood and coalescent in kappa and
    popSize, and in the node heights; insert_taxon on the tree."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.config.xml_assert import (
        analytic_gradient, initial_eval_state)
    from beast_mcmc_tpu_torch.config.xml_mle import estimator_parts
    from beast_mcmc_tpu_torch.inference import bridge_gibbs, gibbs, smc
    from beast_mcmc_tpu_torch.tree.topology import (
        make_tree_state, simulate_coalescent_tree)

    f64 = torch.float64

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f64, device=dev)

    ax.build(ax._ids["treeModel"])
    parts = estimator_parts(ax, ax.root.find("marginalLikelihoodEstimator"))
    p0, t0 = initial_eval_state(ax)
    moved = {**p0, "m": p0["m"] + 0.7, "kappa": p0["kappa"] * 1.3}

    def ends(p):
        src, dst = parts["source"](p, t0), parts["destination"](p, t0)
        return torch.stack([src, dst] + [b * src + (1 - b) * dst
                                         for b in parts["betas"]])

    refs = [ax.build(ax.deref(d)) for d in ax.root.find(
        "marginalLikelihoodEstimator/pathLikelihood/destination/"
        "workingPrior")]

    def ref_densities():
        return torch.stack([r.fn({**p0, "m": t(v)}, t0) for r in refs
                            for v in (-1.0, 0.5, 2.5)])

    # the Gibbs operators, their draws injected
    n, d = 6, 2
    rng = np.random.default_rng(P17_SEED)
    tr = make_tree_state(*simulate_coalescent_tree(
        rng, np.zeros(n), 1.0), f64, dev)
    lam = t([[1.5, 0.4], [0.4, 0.8]])
    w = rng.uniform(-0.3, 0.3, (n, n))
    np.fill_diagonal(w, 0.0)
    gp = {"mu": t(0.4), "tau": t(1.3), "x": t(rng.normal(0.5, 1.0, 5)),
          "t": t(rng.normal(size=(2 * n - 1) * d)), "c1": t([1.0, 0.1]),
          "c2": t([0.1, 1.0]), "z": t(rng.uniform(-0.3, 0.5, (n, d))),
          "beta": t(rng.normal(0.0, 0.5, 5)), "g": t(0.7),
          "l": t(rng.uniform(0.5, 2.0, 5))}
    normals = [t(rng.normal(size=s)) for s in ((), (d,), (d, d), (4, d))]
    gammas = [t(3.1), t(rng.uniform(2.0, 6.0, d)), t(2.7)]
    gibbs_ops = [
        (gibbs.NormalNormalMeanGibbs(mean_param="mu", data_params=("x",),
                                     precision_of=lambda p: p["tau"]),
         [normals[0]], [], [0]),
        (gibbs.NormalGammaPrecisionGibbs(precision_param="tau",
                                         data_params=("x",),
                                         mean_of=lambda p: p["mu"]),
         [], [gammas[0]], [0]),
        (gibbs.InternalTraitGibbsOperator(trait_param="t", dim=d, n_tips=n,
                                          prec_of=lambda p: lam),
         [normals[1]], [], [2]),
        (gibbs.PrecisionWishartGibbsOperator(
            trait_param="t", dim=d, col_params=("c1", "c2"), prior_df=3.0,
            prior_scale=np.array([[1.0, 0.2], [0.2, 2.0]])),
         [normals[2]], [gammas[1]], [0]),
        (gibbs.LatentLiabilityGibbsOperator(
            trait_param="z", dim=d, n_tips=n, cond_weights=w,
            cond_scale=np.linspace(0.5, 1.5, n), mu0=np.array([0.2, -0.1]),
            lo=np.full((n, d), -3.0), hi=np.full((n, d), 3.0),
            prec_of=lambda p: lam, max_attempts=4),
         [normals[3]], [], [3]),
    ]

    def injected(op, ns, gs, ints):
        saved = (gibbs._normal, gibbs._gamma, gibbs._randint)
        qn, qg, qi = list(ns), list(gs), list(ints)
        gibbs._normal = lambda gen, like, shape=(): qn.pop(0).reshape(shape)
        gibbs._gamma = lambda gen, a, like, size=(): qg.pop(0).reshape(size)
        gibbs._randint = lambda gen, lo, hi, like: torch.tensor(
            [qi.pop(0)], device=like.device)
        try:
            out, _, logh = op.propose(gp, tr, None, None)
        finally:
            gibbs._normal, gibbs._gamma, gibbs._randint = saved
        return torch.cat([out[k].reshape(-1) for k in
                          op.modified_params()] + [logh.reshape(1)])

    def bridge():
        saved = (bridge_gibbs._gamma, bridge_gibbs._seeds)
        bridge_gibbs._gamma = lambda gen, a, like, size=(): gammas[2].expand(
            size)
        bridge_gibbs._seeds = lambda gen, k, like: torch.full(
            (k,), 424242, device=like.device)
        try:
            out, _, _ = bridge_gibbs.BayesianBridgeGibbsOperator(
                coefficient="beta", global_scale="g",
                local_scale="l").propose(gp, tr, None, None)
        finally:
            bridge_gibbs._gamma, bridge_gibbs._seeds = saved
        return torch.cat([out["g"].reshape(1), out["l"]])

    def gradient(names, height_tid):
        spec = type("Spec", (), {
            "likelihoods": [ax.build(ax._ids["treeLikelihood"]),
                            ax.build(ax._ids["coalescent"])],
            "target_names": staticmethod(lambda: names),
            "height_tid": height_tid})
        return analytic_gradient(ax, spec)[2]

    def inserted():
        node, h = smc.distance_based_attachment(
            t0, np.array([0.3, 0.1, 0.5, 0.4]), 0.0)
        tree = smc.insert_taxon(t0, node, 0.0, h)
        return torch.cat([tree.parent.to(f64), tree.children.reshape(-1).to(
            f64), tree.heights, tree.root.reshape(1).to(f64)])

    cases = {"path ends and rung targets": lambda: ends(p0),
             "path ends and rung targets, moved": lambda: ends(moved),
             "working prior densities": ref_densities,
             "bayesian bridge": bridge,
             "gradient in kappa, popSize": lambda: gradient(
                 ["kappa", "constant.popSize"], None),
             "gradient in node heights": lambda: gradient([], "treeModel"),
             "insert_taxon": inserted}
    for op, ns, gs, ints in gibbs_ops:
        cases[type(op).__name__] = (lambda op=op, ns=ns, gs=gs, ints=ints:
                                    injected(op, ns, gs, ints))
    return cases


def p17_functions_path(out_dir, dev):
    """Phase 17d: p17_function_cases on the card and on the CPU (an
    XmlAnalysis of 17c's oracle_document on each, its pilot log read from
    out_dir), each output's largest deviation over its largest magnitude
    held to P17_REL_TOL. Returns the record."""
    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis

    path = os.path.join(out_dir, "oracle_mle.xml")
    t0 = time.perf_counter()
    got = {k: fn().detach().cpu().double() for k, fn in p17_function_cases(
        XmlAnalysis(path, device=dev, workdir=out_dir), dev).items()}
    want = {k: fn().detach().double() for k, fn in p17_function_cases(
        XmlAnalysis(path, device="cpu", workdir=out_dir), "cpu").items()}
    worst = {}
    for label, w in want.items():
        g = got[label]
        fin = torch.isfinite(w)
        if g.shape != w.shape or not bool(fin.any()) or not bool(
                torch.equal(g[~fin], w[~fin])):
            raise AssertionError(f"P17d {label}: {g} against {w}")
        worst[label] = float((g[fin] - w[fin]).abs().max()) / max(
            float(w[fin].abs().max()), 1e-300)
        if not worst[label] <= P17_REL_TOL:
            raise AssertionError(f"P17d {label}: {worst[label]!r} > "
                                 f"{P17_REL_TOL}")
    top = max(worst, key=worst.get)
    rec = {"functions": len(worst), "max_rel_err": worst[top], "worst": top,
           "rel_err": worst, "seconds": time.perf_counter() - t0}
    log(f"[P17d] {len(worst)} functions on the card against the CPU in "
        f"{rec['seconds']:.2f} s: largest deviation {worst[top]!r} ({top}; "
        f"tolerance {P17_REL_TOL})")
    return rec


P18_STEPS, P18_CHECK, P18_LOG_EVERY = 50, 100, 10  # 200; 100
P18_PROFILE, P18_SEED, P18_TRAIT_SEED = PROFILE_STEPS, 18, 1818
P18_MISSING, P18_SIGMA = 0.05, 2.0  # NA share of tips; degrees a sqrt(year)
P18_CENTRE = (8.5, -11.5)  # latitude, longitude: West Africa
P18_TRAIT_REPS, P18_REL_TOL = 20, 1e-12


def rrw_locations(data, seed=P18_TRAIT_SEED):
    """[taxa, 2] (latitude, longitude) of makona_data's taxa: a Brownian
    motion of P18_SIGMA degrees a square-root year from P18_CENTRE down
    makona_data's own tree (its tips' heights, its population size, its
    seed), drawn with numpy from `seed`; about P18_MISSING of the tips
    NaN in both dimensions (written NA NA). Returns (locations, the tree's
    length in years)."""
    import numpy as np

    from beast_mcmc_tpu_torch.apps.makona import tip_heights
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    parent, children, heights, root = simulate_coalescent_tree(
        np.random.default_rng(JOINT_SEED), tip_heights(data["dates"]),
        data["cfg"]["pop_size"])
    rng = np.random.default_rng(seed)
    n = len(data["taxa"])
    loc = np.zeros((parent.shape[0], 2))
    loc[root] = P18_CENTRE
    for node in np.argsort(-heights):  # parents before children
        if parent[node] >= 0:
            t = heights[parent[node]] - heights[node]
            loc[node] = loc[parent[node]] + rng.normal(
                0.0, P18_SIGMA * np.sqrt(t), 2)
    loc = loc[:n]
    loc[rng.uniform(size=n) < P18_MISSING] = np.nan
    length = float(np.sum(heights[parent[parent >= 0]]
                          - heights[parent >= 0]))
    return loc, length


def rrw_document(path, data, n_steps=P18_STEPS, log_every=P18_LOG_EVERY):
    """Write the continuous-phylogeography document of phase 18a at `path`
    on makona_data's taxa and alignment, in the vocabulary BEAUti writes:
    HKY+Gamma4, a strict clock and a constant coalescent for the sequences
    (a coalescentSimulator start tree), a 2-D location on each taxon
    (`rrw_locations`) under a <multivariateDiffusionModel> on a 2 x 2
    <matrixParameter> precision (starting at the one that generated the
    locations) with a <multivariateWishartPrior> (df 2, identity scale), an <arbitraryBranchRates> relaxed random walk (one
    rate a branch) under a gamma distributionLikelihood, and a
    <traitDataLikelihood> (integrateInternalTraits, useTreeLength,
    scaleByTime, a <conjugateRootPrior>); the tree operators, scale
    operators on the sequence parameters and the branch rates, a
    <precisionGibbsOperator>; <log logEvery> of the posterior, a
    great-circle <continuousDiffusionStatistic> and a root <traitLogger>.
    Returns the log's file name."""
    import math

    cfg = data["cfg"]
    init = cfg["model"]["init"]
    pop = float(cfg["pop_size"])
    rate = float(init["ucld.mean"])
    loc, length = rrw_locations(data)
    # scaleByTime with useTreeLength measures time in tree lengths: the
    # precision that generated the locations, in those units
    prec0 = 1.0 / (P18_SIGMA ** 2 * length)
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    taxa = taxa_alignment_xml(data)
    for i in range(len(data["taxa"])):
        attr = " ".join("NA" if math.isnan(v) else repr(float(v))
                        for v in loc[i])
        taxa[1 + i] = taxa[1 + i].replace(
            "</taxon>", f'<attr name="location">{attr}</attr></taxon>')
    out += taxa
    name = "makona_rrw"
    out.append(_seq_models_xml(data, _COALESCENT_XML, "treeLikelihood"))
    out.append(f"""  <matrixParameter id="location.precision">
    <parameter id="location.precision.col1" value="{prec0!r} 0.0"/>
    <parameter id="location.precision.col2" value="0.0 {prec0!r}"/>
  </matrixParameter>
  <multivariateDiffusionModel id="location.diffusionModel">
    <precisionMatrix><matrixParameter idref="location.precision"/></precisionMatrix>
  </multivariateDiffusionModel>
  <multivariateWishartPrior id="location.precisionPrior" df="2">
    <scaleMatrix><matrixParameter>
      <parameter value="1.0 0.0"/><parameter value="0.0 1.0"/>
    </matrixParameter></scaleMatrix>
    <data><matrixParameter idref="location.precision"/></data>
  </multivariateWishartPrior>
  <arbitraryBranchRates id="location.diffusion.branchRates">
    <treeModel idref="treeModel"/>
    <rates><parameter id="location.diffusion.rates" value="1.0" lower="0.0"/></rates>
  </arbitraryBranchRates>
  <distributionLikelihood id="location.diffusion.prior">
    <data><parameter idref="location.diffusion.rates"/></data>
    <distribution><gammaDistributionModel>
      <shape><parameter value="0.5"/></shape><scale><parameter value="2.0"/></scale>
    </gammaDistributionModel></distribution>
  </distributionLikelihood>
  <traitDataLikelihood id="location.traitLikelihood" traitName="location"
      useTreeLength="true" scaleByTime="true" integrateInternalTraits="true">
    <multivariateDiffusionModel idref="location.diffusionModel"/>
    <treeModel idref="treeModel"/>
    <traitParameter><parameter id="leaf.location"/></traitParameter>
    <conjugateRootPrior>
      <meanParameter><parameter value="{P18_CENTRE[0]!r} {P18_CENTRE[1]!r}"/></meanParameter>
      <priorSampleSize><parameter value="0.000001"/></priorSampleSize>
    </conjugateRootPrior>
    <arbitraryBranchRates idref="location.diffusion.branchRates"/>
  </traitDataLikelihood>
  <continuousDiffusionStatistic id="location.diffusionRate" greatCircleDistance="true">
    <traitDataLikelihood idref="location.traitLikelihood"/>
  </continuousDiffusionStatistic>
  <traitLogger id="location.root" traitName="location" nodes="root">
    <traitDataLikelihood idref="location.traitLikelihood"/>
  </traitLogger>
  <operators id="operators">
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="kappa"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="clock.rate"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="popSize"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="30"><parameter idref="location.diffusion.rates"/></scaleOperator>
    <precisionGibbsOperator weight="2">
      <traitDataLikelihood idref="location.traitLikelihood"/>
      <multivariateWishartPrior idref="location.precisionPrior"/>
    </precisionGibbsOperator>
    <subtreeSlide size="1.0" gaussian="true" weight="15"><treeModel idref="treeModel"/></subtreeSlide>
    <narrowExchange weight="15"><treeModel idref="treeModel"/></narrowExchange>
    <wilsonBalding weight="3"><treeModel idref="treeModel"/></wilsonBalding>
    <uniformOperator weight="30"><parameter idref="treeModel.internalNodeHeights"/></uniformOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="treeModel.rootHeight"/></scaleOperator>
  </operators>
  <mcmc id="mcmc" chainLength="{n_steps}" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="kappa"/></logNormalPrior>
        <logNormalPrior mean="{math.log(rate)!r}" stdev="1.0"><parameter idref="clock.rate"/></logNormalPrior>
        <logNormalPrior mean="{math.log(pop)!r}" stdev="1.0"><parameter idref="popSize"/></logNormalPrior>
        <coalescentLikelihood idref="coalescent"/>
        <multivariateWishartPrior idref="location.precisionPrior"/>
        <distributionLikelihood idref="location.diffusion.prior"/>
      </prior>
      <likelihood id="likelihood">
        <treeLikelihood idref="treeLikelihood"/>
        <traitDataLikelihood idref="location.traitLikelihood"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="{log_every}" fileName="{name}.log">
      <posterior idref="posterior"/>
      <continuousDiffusionStatistic idref="location.diffusionRate"/>
      <traitLogger idref="location.root"/>
    </log>
  </mcmc>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return f"{name}.log"


def _event_ms(fn, n, dev):
    """ms a call of fn over n calls after one warm-up: CUDA events on the
    card, the host clock elsewhere."""
    import torch

    fn()
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def rrw_path(out_dir, reset_counts, read_counts, device_ms, dev,
             n_taxa=SPEC_TAXA, n_sites=SPEC_SITES, n_steps=P18_STEPS,
             log_every=P18_LOG_EVERY,
             n_profile=P18_PROFILE, trait_reps=P18_TRAIT_REPS):
    """Phase 18a (see the module docstring) at n_taxa x n_sites: `run
    doc.xml` through the CLI, its peel_stream launches predicted from
    _run_mcmc (the start, two a checked step of the CLI's P18_CHECK, one
    a step, one a log row's posterior); the deviation, states/s, the log
    read back (its diffusion rate finite and positive, the root's
    location finite); the trait likelihood's ms at the start state (CUDA
    events); a profiler window of n_profile steps. Returns (record,
    launches)."""
    import math
    import re

    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.inference.mcmc import run_chain

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    doc = os.path.join(out_dir, "makona_rrw.xml")
    log_name = rrw_document(doc, data, n_steps, log_every)
    rec = {"taxa": len(data["taxa"]), "sites": data["sites"],
           "patterns": data["patterns"],
           "document_seconds": time.perf_counter() - t0}
    launches = {}

    def expect(counts, n, label):
        want = {k: n * (k == "peel_stream") for k in counts}
        launches[f"P18 {label}"] = counts
        if counts != want:
            raise AssertionError(f"P18 {label}: launches {counts}, "
                                 f"expected {want}")

    reset_counts()
    rc, text, _, cli_s = _cli_in(out_dir, [
        "run", doc, "-seed", str(P18_SEED), "-device", str(dev)])
    m = re.search(r"(\d+) states in ([0-9.]+)s = ([0-9.]+) states/sec; "
                  r"full-evaluation deviation (\S+)", text)
    if rc != 0 or m is None:
        raise AssertionError(f"P18a: rc {rc}\n{text[-3000:]}")
    rows = n_steps // log_every
    a = {"rc": rc, "cli_seconds": cli_s, "steps": int(m.group(1)),
         "chain_seconds": float(m.group(2)),
         "states_per_s": float(m.group(3)),
         "full_evaluation_deviation": float(m.group(4).rstrip(";,")),
         "predicted_launches": 1 + 2 * P18_CHECK + n_steps + rows}
    expect(read_counts(), a["predicted_launches"], "18a CLI")
    if not (a["steps"] == n_steps
            and a["full_evaluation_deviation"] <= FULL_EVAL_TOL):
        raise AssertionError(f"P18a chain: {a}")
    lines = open(os.path.join(out_dir, log_name)).read().splitlines()
    header = lines[0].split("\t")
    body = [[float(v) for v in ln.split("\t")] for ln in lines[1:]]
    loc_cols = [i for i, h in enumerate(header)
                if h.startswith("location.") and h.count(".") == 2]
    rate_col = header.index("location.diffusionRate")
    if (len(body) != rows or len(loc_cols) != 2
            or not all(math.isfinite(v) for r in body for v in r)
            or not all(r[rate_col] > 0 for r in body)):
        raise AssertionError(f"P18a log: {header} {body[:2]}")
    a["log_rows"] = len(body)
    a["diffusion_rate_km_per_year"] = [body[0][rate_col], body[-1][rate_col]]
    a["root_location"] = [body[-1][i] for i in loc_cols]

    # the trait likelihood alone at the start state, and a chain window
    ax = XmlAnalysis(doc, seed=P18_SEED, device=dev, workdir=out_dir)
    chain = ax.prepare_chain()
    trait = ax.build(ax._ids["location.traitLikelihood"])
    st = chain["state"]
    with torch.no_grad():
        a["trait_ms"] = _event_ms(lambda: trait.fn(st.params, st.tree),
                                  trait_reps, dev)
        a["trait_loglik"] = float(trait.fn(st.params, st.tree))
    if not math.isfinite(a["trait_loglik"]):
        raise AssertionError(f"P18a trait likelihood {a['trait_loglik']}")
    reset_counts()
    chain = ax.prepare_chain()
    wall, busy = device_ms(lambda: run_chain(
        chain["step"], chain["state"], n_profile), "p18a rrw chain",
        n_profile)
    expect(read_counts(), 1 + n_profile, "18a profile")
    a.update({"profile_ms_per_step": wall,
              "device_busy_share": None if busy is None else busy / wall,
              "device_events_per_step": device_ms.events})
    rec["18a"] = a
    log(f"[P18a] CLI rc {rc} in {cli_s:.2f} s: {a['steps']} states in "
        f"{a['chain_seconds']:.2f} s = {a['states_per_s']} states/s, "
        f"full-evaluation deviation {a['full_evaluation_deviation']!r} "
        f"(tolerance {FULL_EVAL_TOL}), peel_stream launches "
        f"{a['predicted_launches']} as predicted, {a['log_rows']} log rows "
        f"(diffusion rate {a['diffusion_rate_km_per_year']} km a year, "
        f"root {a['root_location']}); trait likelihood "
        f"{a['trait_loglik']!r} in {a['trait_ms']:.3f} ms; profile "
        f"{a['profile_ms_per_step']:.3f} ms a step, busy share "
        f"{a['device_busy_share']}, {a['device_events_per_step']} device "
        f"events a step")
    return rec, launches


def p18_function_cases(doc, out_dir, dev):
    """{label: fn() -> tensor}: 18b's functions on `dev` at the tree of
    phase 18a's document (its interpreter's start tree): every function of
    models/continuous.py (Brownian, drift, OU, missing dims, the affine
    channels and the node conditionals), models/factor.py (the potentials,
    the integrated factor likelihood, the propagation with delta tips) and
    models/liability.py on inputs drawn with numpy from P18_SEED, and the
    gradient of the document's trait likelihood in its precision and
    branch rates (torch.autograd) at the start state."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state
    from beast_mcmc_tpu_torch.models import continuous as C
    from beast_mcmc_tpu_torch.models import factor as F
    from beast_mcmc_tpu_torch.models import liability as L

    f64 = torch.float64
    ax = XmlAnalysis(doc, seed=P18_SEED, device=dev, workdir=out_dir)
    trait = ax.build(ax._ids["location.traitLikelihood"])
    params0, tree = initial_eval_state(ax)
    n = (tree.parent.shape[0] + 1) // 2
    m, d = 2 * n - 1, 2
    rng = np.random.default_rng(P18_SEED)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f64, device=dev)

    a = rng.normal(size=(d, d))
    prec = t(a @ a.T + d * np.eye(d))
    y = t(rng.normal(size=(n, d)))
    miss = torch.as_tensor(rng.uniform(size=(n, d)) < 0.05, device=dev)
    scal, drift = t(rng.uniform(0.5, 2.0, m)), t(rng.normal(size=(m, d)))
    mean0 = t(rng.normal(size=d))
    tr = (tree.parent, tree.children, tree.heights, tree.root)
    bl = C._branch_times(tree.parent, tree.heights)
    lam_inv = torch.linalg.inv(prec)
    q = torch.eye(d, dtype=f64, device=dev).expand(m, d, d) + 0.05 * t(
        rng.normal(size=(m, d, d)))
    r = drift * bl[:, None]
    sig = bl[:, None, None] * lam_inv + 1e-3 * torch.eye(d, dtype=f64,
                                                         device=dev)
    chans = (q, r, sig, mean0, lam_inv / 0.5)
    k, p = 2, 5
    load, gam = t(rng.normal(size=(k, p))), t(rng.uniform(0.5, 3.0, p))
    ydat = t(rng.normal(size=(n, p)))
    fmiss = torch.as_tensor(rng.uniform(size=(n, p)) < 0.1, device=dev)
    pot = F.factor_tip_potentials(ydat, fmiss, load, gam)
    dmask = torch.as_tensor(rng.uniform(size=(n, k)) < 0.3, device=dev)
    latent = t(rng.normal(size=(n, d)))
    thr = t(np.sort(rng.normal(size=(d, 2)), axis=1))
    cats = torch.as_tensor(rng.integers(0, 3, (n, d)), device=dev)
    names = ("location.precision.col1", "location.precision.col2",
             "location.diffusion.rates")

    def trait_gradient():
        xs = [params0[nm].detach().clone().requires_grad_(True)
              for nm in names]
        pp = {**params0, **dict(zip(names, xs))}
        return torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            trait.fn(pp, tree), xs)])

    def stacked(fn):
        return lambda: torch.stack([v.reshape(()) for v in fn()])

    return {
        "brownian_loglikelihood": lambda: C.brownian_loglikelihood(
            y, *tr, prec, scal, mean0, 2.0, 0.01),
        "drift_brownian_loglikelihood":
            lambda: C.drift_brownian_loglikelihood(y, *tr, prec, drift, scal,
                                                   mean0, 2.0),
        "ou_loglikelihood": lambda: C.ou_loglikelihood(
            y, *tr, prec, 0.7, mean0, scal),
        "brownian_loglikelihood_missing":
            lambda: C.brownian_loglikelihood_missing(y, miss, *tr, prec,
                                                     scal, mean0, 2.0),
        "affine_gaussian_tree_loglikelihood":
            lambda: C.affine_gaussian_tree_loglikelihood(y, miss, *tr,
                                                         *chans),
        "affine_gaussian_node_conditionals": lambda: torch.cat([
            v.reshape(-1) for v in C.affine_gaussian_node_conditionals(
                y, miss, *tr, *chans)]),
        "factor_tip_potentials": lambda: torch.cat(
            [v.reshape(-1) for v in pot]),
        "integrated_factor_loglikelihood":
            lambda: F.integrated_factor_loglikelihood(
                ydat, fmiss, *tr, load, gam, prec, scal, mean0, 1.5),
        "canonical_bp_loglikelihood (delta tips)": stacked(lambda: (
            F.canonical_bp_loglikelihood(*pot, *tr, lam_inv, scal, mean0,
                                         1.5),
            F.canonical_bp_loglikelihood(*pot, *tr, lam_inv, scal, mean0,
                                         1.5, dmask, pot[1]))),
        "liability_consistency_loglik": stacked(lambda: (
            L.liability_consistency_loglik(latent, cats, thr, 0.1),
            L.liability_consistency_loglik(latent, cats, thr))),
        "trait likelihood gradient (precision, branch rates)":
            trait_gradient,
    }


def p18_functions_path(out_dir, dev):
    """Phase 18b: p18_function_cases on the card and on the CPU, each
    output's largest deviation over its largest magnitude held to
    P18_REL_TOL. Returns the record."""
    import torch

    doc = os.path.join(out_dir, "makona_rrw.xml")
    t0 = time.perf_counter()
    got = {k: fn().detach().cpu().double() for k, fn in p18_function_cases(
        doc, out_dir, dev).items()}
    want = {k: fn().detach().double() for k, fn in p18_function_cases(
        doc, out_dir, "cpu").items()}
    worst = {}
    for label, w in want.items():
        g = got[label]
        fin = torch.isfinite(w)
        if g.shape != w.shape or not bool(fin.any()) or not bool(
                torch.equal(g[~fin], w[~fin])):
            raise AssertionError(f"P18b {label}: {g} against {w}")
        worst[label] = float((g[fin] - w[fin]).abs().max()) / max(
            float(w[fin].abs().max()), 1e-300)
        if not worst[label] <= P18_REL_TOL:
            raise AssertionError(f"P18b {label}: {worst[label]!r} > "
                                 f"{P18_REL_TOL}")
    top = max(worst, key=worst.get)
    rec = {"functions": len(worst), "max_rel_err": worst[top], "worst": top,
           "rel_err": worst, "seconds": time.perf_counter() - t0}
    log(f"[P18b] {len(worst)} functions on the card against the CPU in "
        f"{rec['seconds']:.2f} s: largest deviation {worst[top]!r} ({top}; "
        f"tolerance {P18_REL_TOL})")
    return rec


# phase 19: the gradient and HMC vocabulary and the phylogeographic GLM
P19_STEPS, P19_LOG_EVERY, P19_CHECK = 50, 10, 100  # 100
P19_LEAPFROG, P19_NUTS_STEP = 10, 0.02
P19_PROFILE, P19_SEED = PROFILE_STEPS, 19
P19_GLM_STATES = 64  # the interpreter runs a debug chain of <= 64 in full
P19_GLM_SCALE = P19_GLM_STATES / 200_000_000
P19_GLM_LEAPFROG, P19_GLM_STEP = 5, 0.02
P19_GLM_SEED, P19_COUNTRIES = 1919, 3
P19_BASTA_DEMES, P19_BASTA_REPS = 3, 2
P19_REL_TOL = 1e-12
P19_TESTXML_TOL = 1e-10  # of the largest entry, the card against the CPU


def hmc_document(path, data, n_steps=P19_STEPS, log_every=P19_LOG_EVERY,
                 expected=None):
    """Write the node-height HMC document of phase 19a at `path` on
    makona_data's taxa and alignment: HKY+Gamma4, a strict clock and a
    constant coalescent (a coalescentSimulator start tree); a
    <hamiltonianMonteCarloOperator> of nSteps P19_LEAPFROG over a
    <nodeHeightProxyParameter> with a <jointGradient id="heightGradient">
    of <nodeHeightGradient> and <coalescentGradient>, a
    <NoUTurnOperator> over clock.rate and popSize (log transform) with a
    <jointGradient> of <gradient>s, scale moves on kappa, alpha,
    clock.rate, popSize and the root height, and the subtree slide and
    narrow exchange. With `expected` (the CPU's analytic gradient), an
    <assertEqual> before <mcmc> holds heightGradient's analytic line to
    P19_TESTXML_TOL of its largest entry. Returns the log's file name."""
    import math

    cfg = data["cfg"]
    init = cfg["model"]["init"]
    pop = float(cfg["pop_size"])
    rate = float(init["ucld.mean"])
    name = "makona_hmc"
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += taxa_alignment_xml(data)
    out.append(_seq_models_xml(data, _COALESCENT_XML))
    out.append(f"""  <jointGradient id="heightGradient">
    <nodeHeightGradient><treeDataLikelihood idref="treeLikelihood"/></nodeHeightGradient>
    <coalescentGradient><coalescentLikelihood idref="coalescent"/></coalescentGradient>
  </jointGradient>
  <operators id="operators">
    <hamiltonianMonteCarloOperator weight="1" nSteps="{P19_LEAPFROG}" stepSize="0.0005"
        drawVariance="1.0" autoOptimize="true">
      <jointGradient idref="heightGradient"/>
      <nodeHeightProxyParameter id="proxy"><treeModel idref="treeModel"/></nodeHeightProxyParameter>
    </hamiltonianMonteCarloOperator>
    <NoUTurnOperator weight="1" stepSize="{P19_NUTS_STEP!r}">
      <jointGradient>
        <gradient><treeDataLikelihood idref="treeLikelihood"/><parameter idref="clock.rate"/></gradient>
        <gradient><coalescentLikelihood idref="coalescent"/><parameter idref="popSize"/></gradient>
      </jointGradient>
      <transform type="log"/>
    </NoUTurnOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="kappa"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="alpha"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="clock.rate"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="popSize"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="treeModel.rootHeight"/></scaleOperator>
    <subtreeSlide size="1.0" gaussian="true" weight="10"><treeModel idref="treeModel"/></subtreeSlide>
    <narrowExchange weight="10"><treeModel idref="treeModel"/></narrowExchange>
  </operators>""")
    if expected is not None:
        tol = P19_TESTXML_TOL * float(max(abs(v) for v in expected))
        vals = ", ".join(repr(float(v)) for v in expected)
        out.append(f"""  <assertEqual tolerance="{tol!r}" toleranceType="absolute">
    <message>node-height joint gradient at the start, against the CPU</message>
    <actual regex="analytic: \\[(.*)\\]"><jointGradient idref="heightGradient"/></actual>
    <expected>{vals}</expected>
  </assertEqual>""")
    out.append(f"""  <mcmc id="mcmc" chainLength="{n_steps}" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="kappa"/></logNormalPrior>
        <exponentialPrior mean="0.5" offset="0.0"><parameter idref="alpha"/></exponentialPrior>
        <logNormalPrior mean="{math.log(rate)!r}" stdev="1.0"><parameter idref="clock.rate"/></logNormalPrior>
        <logNormalPrior mean="{math.log(pop)!r}" stdev="1.0"><parameter idref="popSize"/></logNormalPrior>
        <coalescentLikelihood idref="coalescent"/>
      </prior>
      <likelihood id="likelihood">
        <treeDataLikelihood idref="treeLikelihood"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="{log_every}" fileName="{name}.log">
      <posterior idref="posterior"/>
      <parameter idref="clock.rate"/>
      <parameter idref="popSize"/>
      <parameter idref="treeModel.rootHeight"/>
    </log>
  </mcmc>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return f"{name}.log"


class BoundLaunches:
    """Counts, while entered, the kernel launches the bound operators'
    proposals add to a chain's own (one a posterior evaluation): 2 nSteps
    a leapfrog HMC proposal (inference/hmc.py), n_lf + 1 a NUTS proposal
    (its reported leapfrogs). `extra` is their sum, `proposals` each
    class's count, `ms` each class's proposal times (CUDA events on the
    card, the host clock elsewhere; each timed proposal synchronises)."""

    def __enter__(self):
        import torch

        from beast_mcmc_tpu_torch.inference import hmc
        from beast_mcmc_tpu_torch.inference.nuts import NutsOperator

        self.extra, self.proposals, self.ms = 0, {}, {}
        self._orig = hmc._Binds.propose
        box = self

        def propose(op, params, tree, *a, **k):
            if tree.heights.is_cuda:
                ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                ev0.record()
                out = box._orig(op, params, tree, *a, **k)
                ev1.record()
                torch.cuda.synchronize()
                ms = ev0.elapsed_time(ev1)
            else:
                t0 = time.perf_counter()
                out = box._orig(op, params, tree, *a, **k)
                ms = 1e3 * (time.perf_counter() - t0)
            kind = type(op).__name__
            box.proposals[kind] = box.proposals.get(kind, 0) + 1
            box.ms.setdefault(kind, []).append(ms)
            if isinstance(op, NutsOperator):
                box.extra += int(op.last_n_leapfrog) + 1
            elif kind in ("HmcOperator", "NodeHeightHmcOperator"):
                box.extra += 2 * op.n_leapfrog
            else:
                raise AssertionError(f"no launch count for {kind}")
            return out

        hmc._Binds.propose = propose
        return self

    def __exit__(self, *exc):
        from beast_mcmc_tpu_torch.inference import hmc

        hmc._Binds.propose = self._orig
        return False


def _median(xs):
    """The median of xs, or None where the operator was not drawn."""
    return statistics.median(xs) if xs else None


def _cli_chain(out_dir, args, label, n_steps, n_check, rows, expect,
               testxml=False):
    """Run the CLI on a document under BoundLaunches: its record;
    the launches predicted as the start, two a checked step, one a step,
    `rows` more (a log row's posterior, a report's evaluations), and the
    bound proposals' own. With `testxml`, every <assertEqual> must have
    been checked and held: on a simulated start tree a mismatch only warns
    "(skipped)" (config/xml_assert.py), and such a warning fails here."""
    import re

    with BoundLaunches() as bound:
        rc, text, warned, cli_s = _cli_in(out_dir, args)
    m = re.search(r"(\d+) states in ([0-9.]+)s = ([0-9.]+) states/sec; "
                  r"full-evaluation deviation (\S+)", text)
    if rc != 0 or m is None:
        raise AssertionError(f"{label}: rc {rc}\n{text[-3000:]}")
    skipped = [w for w in warned if "(skipped)" in w]
    if testxml and (skipped or "all embedded checks passed" not in text):
        raise AssertionError(f"{label} -testxml: {skipped}\n{text[-3000:]}")
    rec = {"rc": rc, "cli_seconds": cli_s, "steps": int(m.group(1)),
           "chain_seconds": float(m.group(2)),
           "states_per_s": float(m.group(3)),
           "full_evaluation_deviation": float(m.group(4).rstrip(";,")),
           "bound_proposals": bound.proposals,
           "bound_launches": bound.extra, "bound_ms": bound.ms}
    rec["predicted_launches"] = (1 + 2 * n_check + n_steps + rows
                                 + bound.extra)
    expect(rec["predicted_launches"], label)
    if not (rec["steps"] == n_steps
            and rec["full_evaluation_deviation"] <= FULL_EVAL_TOL):
        raise AssertionError(f"{label} chain: {rec}")
    return rec


def hmc_path(out_dir, reset_counts, read_counts, device_ms, dev,
             n_taxa=SPEC_TAXA, n_sites=SPEC_SITES, n_steps=P19_STEPS,
             log_every=P19_LOG_EVERY, n_profile=P19_PROFILE):
    """Phase 19a (see the module docstring) at n_taxa x n_sites: the
    jointGradient's analytic gradient on the CPU from the document, then
    `run makona_hmc.xml -testxml` through the CLI with the <assertEqual>
    holding the card's report to it, its peel_stream launches exactly as
    predicted (the report's 1 + 2 x heights evaluations, then _cli_chain's
    count), each bound proposal timed in the run (CUDA events), the log
    read back; a profiler window on the built analysis. Returns (record,
    launches)."""
    import math

    from beast_mcmc_tpu_torch.config import xml_assert
    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.inference.mcmc import run_chain

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    doc = os.path.join(out_dir, "makona_hmc.xml")
    hmc_document(doc, data, n_steps, log_every)
    # the CPU's analytic gradient at the document's start state
    cpu_ax = XmlAnalysis(doc, seed=P19_SEED, device="cpu", workdir=out_dir)
    cpu_ax.build(cpu_ax._ids["treeModel"])
    _, _, g_cpu = xml_assert.analytic_gradient(
        cpu_ax, cpu_ax.build(cpu_ax._ids["heightGradient"]))
    expected = g_cpu.numpy()
    del cpu_ax
    log_name = hmc_document(doc, data, n_steps, log_every, expected)
    rec = {"taxa": len(data["taxa"]), "sites": data["sites"],
           "patterns": data["patterns"],
           "document_seconds": time.perf_counter() - t0}
    launches = {}

    def expect(n, what):
        counts = read_counts()
        want = {k: n * (k == "peel_stream") for k in counts}
        launches[f"P19 {what}"] = counts
        if counts != want:
            raise AssertionError(f"P19 {what}: launches {counts}, "
                                 f"expected {want}")

    # the report's gradient (one evaluation) and central differences (two
    # a height) come before the chain, and its diagonal Hessian's as many
    # again where at most 64 values (config/xml_assert.py::gradient_report)
    n_heights = int(expected.size)
    report = (1 + 2 * n_heights) * (2 if n_heights <= 64 else 1)
    reset_counts()
    rows = n_steps // log_every
    a = _cli_chain(
        out_dir, ["run", doc, "-testxml", "-seed", str(P19_SEED),
                  "-device", str(dev)], "19a CLI", n_steps, P19_CHECK,
        rows + report, expect, testxml=True)
    a.update({"report_launches": report,
              "gradient_entries": n_heights,
              "gradient_tolerance": P19_TESTXML_TOL})
    lines = open(os.path.join(out_dir, log_name)).read().splitlines()
    body = [[float(v) for v in ln.split("\t")] for ln in lines[1:]]
    if len(body) != rows or not all(math.isfinite(v) for r in body
                                    for v in r):
        raise AssertionError(f"P19a log: {lines[:2]}")
    a["log_rows"] = len(body)

    # the bound proposals' times in the run, and a profiler window
    hmc_ms = a["bound_ms"].get("NodeHeightHmcOperator", [])
    nuts_ms = a["bound_ms"].get("NutsOperator", [])
    ax = XmlAnalysis(doc, seed=P19_SEED, device=dev, workdir=out_dir)
    chain = ax.prepare_chain()
    reset_counts()
    wall, busy = device_ms(lambda: run_chain(chain["step"], chain["state"],
                                             n_profile),
                           "p19a hmc chain", n_profile)
    a.update({"hmc_proposal_ms": hmc_ms, "nuts_proposal_ms": nuts_ms,
              "profile_ms_per_step": wall,
              "device_busy_share": None if busy is None else busy / wall,
              "device_events_per_step": device_ms.events,
              "profile_launches": read_counts()["peel_stream"]})
    rec["19a"] = a
    log(f"[P19a] CLI -testxml rc {a['rc']} in {a['cli_seconds']:.2f} s: "
        f"the jointGradient's {n_heights} entries equal the CPU's to "
        f"{P19_TESTXML_TOL} of the largest; {a['steps']} states in "
        f"{a['chain_seconds']:.2f} s = {a['states_per_s']} states/s, "
        f"full-evaluation deviation {a['full_evaluation_deviation']!r}, "
        f"peel_stream launches {a['predicted_launches']} as predicted "
        f"({a['report_launches']} the report's; bound proposals "
        f"{a['bound_proposals']}, {a['bound_launches']} of their own); "
        f"node-height HMC proposal ms {[round(x, 3) for x in hmc_ms]} "
        f"({P19_LEAPFROG} leapfrogs), NUTS proposal ms "
        f"{[round(x, 3) for x in nuts_ms]}; profile "
        f"{wall:.3f} ms a step, busy share {a['device_busy_share']}, "
        f"{a['device_events_per_step']} device events a step")
    return rec, launches


def glm_predictors(codes, seed=P19_GLM_SEED):
    """{name: [K(K-1)] values} of the GLM's predictors over the K location
    codes, in the complex order (upper triangle row-major, then the lower
    in transposed order; entry (a, b) the rate from a to b), each
    standardised: the log great-circle distance between centroids drawn
    over West Africa, the log origin and destination populations
    (lognormal), and a same-country indicator (P19_COUNTRIES countries),
    drawn with numpy from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = len(codes)
    lat = np.radians(rng.uniform(4.5, 12.5, k))
    lon = np.radians(rng.uniform(-15.0, -7.5, k))
    pop = rng.lognormal(12.0, 1.0, k)
    country = rng.integers(0, P19_COUNTRIES, k)
    iu = np.triu_indices(k, 1)
    frm = np.concatenate([iu[0], iu[1]])
    to = np.concatenate([iu[1], iu[0]])
    cos_d = (np.sin(lat[frm]) * np.sin(lat[to]) + np.cos(lat[frm])
             * np.cos(lat[to]) * np.cos(lon[frm] - lon[to]))
    dist = 6371.0 * np.arccos(np.clip(cos_d, -1.0, 1.0))
    cols = {"glm.logDistance": np.log(dist),
            "glm.logOriginPop": np.log(pop[frm]),
            "glm.logDestinationPop": np.log(pop[to]),
            "glm.sameCountry": (country[frm] == country[to]).astype(float)}
    return {n: (v - v.mean()) / v.std() for n, v in cols.items()}


def glm_document(path, src=NORTH_STAR_XML):
    """Write the north-star document with its BSSVS origin model replaced
    by a GLM over the same 56-state `geography`: a <glmSubstitutionModel>
    whose <glmModel family="logLinear"> has glm_predictors' four columns,
    coefficients with BSSVS indicators (a Poisson prior on their sum, a
    <bitFlipOperator>) under a normal prior, and a
    <hamiltonianMonteCarloOperator> on the coefficients with a
    <jointGradient> of a <glmSubstitutionModelGradient> (over a
    <treeDataLikelihood> of the locations, outside the posterior) and the
    prior's <gradient>. Returns the predictor names."""
    import re

    from beast_mcmc_tpu_torch.apps.makona import read_makona_xml

    text = open(src).read()
    codes = read_makona_xml(src)["location_codes"]
    preds = glm_predictors(codes)
    n_p = len(preds)
    design = "\n".join(
        f'            <parameter id="{n}" value="'
        + " ".join(repr(float(x)) for x in v) + '"/>'
        for n, v in preds.items())
    glm = f"""<glmSubstitutionModel id="originModel">
    <generalDataType idref="geography"/>
    <rootFrequencies>
      <frequencyModel id="geoFreqs" normalize="true">
        <generalDataType idref="geography"/>
        <frequencies><parameter id="geo.frequencies" dimension="{len(codes)}"/></frequencies>
      </frequencyModel>
    </rootFrequencies>
    <glmModel id="glm" family="logLinear" checkIdentifiability="false">
      <independentVariables>
        <parameter id="glm.coefficients" value="{' '.join(['0.1'] * n_p)}"/>
        <indicator><parameter id="glm.indicators" value="{' '.join(['1'] * n_p)}"/></indicator>
        <designMatrix id="glm.design">
{design}
        </designMatrix>
      </independentVariables>
    </glmModel>
  </glmSubstitutionModel>"""
    text, n = re.subn(r'<svsGeneralSubstitutionModel id="originModel">.*?'
                      r'</svsGeneralSubstitutionModel>', glm, text,
                      flags=re.S)
    assert n == 1, "no origin model"
    text = text.replace('<svsGeneralSubstitutionModel idref="originModel"/>',
                        '<glmSubstitutionModel idref="originModel"/>')
    text = text.replace('<parameter idref="geo.indicators"/>',
                        '<parameter idref="glm.indicators"/>')
    # the location likelihood the gradient element reads, outside the
    # posterior (the posterior's is the ancestral one, for the trees)
    text = text.replace("""  </ancestralTreeLikelihood>
""", """  </ancestralTreeLikelihood>
  <treeDataLikelihood id="geoTreeLikelihood">
    <attributePatterns idref="geoPatterns"/>
    <treeModel idref="treeModel"/>
    <siteModel idref="geoSiteModel"/>
  </treeDataLikelihood>
""", 1)
    text, n = re.subn(
        r'<scaleOperator scaleFactor="0.75" weight="15" '
        r'scaleAllIndependently="true">\s*<parameter idref="geo.rates"/>\s*'
        r'</scaleOperator>', f"""<hamiltonianMonteCarloOperator weight="3" nSteps="{P19_GLM_LEAPFROG}"
        stepSize="{P19_GLM_STEP!r}" autoOptimize="true">
      <jointGradient id="coefficientGradient">
        <glmSubstitutionModelGradient id="glmGradient">
          <treeDataLikelihood idref="geoTreeLikelihood"/>
          <glmSubstitutionModel idref="originModel"/>
        </glmSubstitutionModelGradient>
        <gradient><normalPrior idref="coefficientPrior"/>
          <parameter idref="glm.coefficients"/></gradient>
      </jointGradient>
      <parameter idref="glm.coefficients"/>
    </hamiltonianMonteCarloOperator>""", text)
    assert n == 1, "no rate operator"
    text = text.replace('<bitFlipOperator weight="21">',
                        '<bitFlipOperator weight="3">')
    text, n = re.subn(
        r'<cachedPrior>.*?</cachedPrior>\s*<poissonPrior [^>]*>', """<normalPrior id="coefficientPrior" mean="0.0" stdev="2.0">
          <parameter idref="glm.coefficients"/>
        </normalPrior>
        <poissonPrior mean="0.6931471805599453" offset="0.0">""", text,
        flags=re.S)
    assert n == 1, "no rates prior"
    text, n = re.subn(r'\s*<glmSubstitutionModel idref="originModel"/>'
                      r'(\s*<exponentialPrior)', r"\1", text)
    assert n == 1, "no connectivity prior"
    with open(path, "w") as f:
        f.write(text)
    return tuple(preds)


def glm_path(out_dir, reset_counts, read_counts, dev, scale=P19_GLM_SCALE,
             src=NORTH_STAR_XML):
    """Phase 19b (see the module docstring): `run makona_glm.xml -scale`
    through the CLI, its peel_stream launches exactly as predicted
    (_cli_chain), each coefficient HMC proposal timed in the run (CUDA
    events), the allocator's peak over the run, its log and
    location-annotated trees read back. Returns (record, launches)."""
    import torch

    from beast_mcmc_tpu_torch.apps.makona import read_makona_xml

    out_dir = os.path.join(out_dir, "p19")
    os.makedirs(out_dir, exist_ok=True)
    doc = os.path.join(out_dir, "makona_glm.xml")
    preds = glm_document(doc, src)
    cfg = read_makona_xml(doc)
    launches = {}

    def expect(n, label):
        counts = read_counts()
        want = {k: n * (k == "peel_stream") for k in counts}
        launches[f"P19 {label}"] = counts
        if counts != want:
            raise AssertionError(f"P19 {label}: launches {counts}, "
                                 f"expected {want}")

    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    n_states = max(int(200_000_000 * scale), 64)
    b = _cli_chain(out_dir, ["run", doc, "-scale", repr(scale),
                             "-device", str(dev)], "19b CLI", n_states,
                   100, n_states, expect)
    b["peak_allocated_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                               if dev != "cpu" else None)
    b["hmc_proposal_ms"] = b["bound_ms"].get("HmcOperator", [])
    lines = open(os.path.join(out_dir, "makona_joint.log")
                 ).read().splitlines()
    rows = [ln.split("\t") for ln in lines if ln[:1].isdigit()]
    if len(rows) != b["steps"]:
        raise AssertionError(f"P19b log: {lines[0]!r}, {len(rows)} rows")
    b["log_rows"] = len(rows)
    b["trees"] = check_joint_trees(os.path.join(out_dir,
                                                "makona_joint.trees"), cfg)
    if not b["trees"] >= 1:
        raise AssertionError(f"P19b trees: {b['trees']}")
    b["predictors"] = list(preds)
    ms = b["hmc_proposal_ms"]
    log(f"[P19b] CLI rc {b['rc']} in {b['cli_seconds']:.2f} s: "
        f"{b['steps']} states in {b['chain_seconds']:.2f} s = "
        f"{b['states_per_s']} states/s, full-evaluation deviation "
        f"{b['full_evaluation_deviation']!r}, peel_stream launches "
        f"{b['predicted_launches']} as predicted (bound proposals "
        f"{b['bound_proposals']}, {b['bound_launches']} of their own), "
        f"{b['log_rows']} log rows, {b['trees']} location-annotated trees; "
        f"coefficient HMC proposal ms {[round(x, 3) for x in ms]} "
        f"({P19_GLM_LEAPFROG} leapfrogs), peak allocated "
        f"{b['peak_allocated_gib']} GiB")
    return {"19b": b, "locations": len(cfg["location_codes"])}, launches


P19_FUNCTIONS_XML = """  <generalDataType id="lumpType">
{lump_states}
  </generalDataType>
  <stronglyLumpableCtmcRates id="lumpRates">
    <generalDataType idref="lumpType"/>
    <rates><parameter id="across" value="1.0 2.0"/></rates>
{lumps}
  </stronglyLumpableCtmcRates>
  <logRateSubstitutionModel id="lumpModel" normalize="false">
    <rootFrequencies><frequencyModel normalize="true">
      <generalDataType idref="lumpType"/>
      <frequencies><parameter id="lump.freqs" dimension="8"/></frequencies>
    </frequencyModel></rootFrequencies>
    <rateProvider><stronglyLumpableCtmcRates idref="lumpRates"/></rateProvider>
  </logRateSubstitutionModel>
  <logRateSubstitutionModel id="logRateModel">
    <rootFrequencies><frequencyModel idref="geoFreqs"/></rootFrequencies>
    <logRates><parameter id="logRates" value="{log_rates}"/></logRates>
  </logRateSubstitutionModel>
  <generalSubstitutionModel id="reversibleModel">
    <generalDataType idref="geography"/>
    <frequencies><frequencyModel idref="geoFreqs"/></frequencies>
    <rates><parameter id="reversible.rates" value="{rev_rates}"/></rates>
  </generalSubstitutionModel>
  <instantaneousMixtureSubstitutionModel id="mixtureModel">
    <mixtureWeights><parameter id="mixture.w" value="0.3"/></mixtureWeights>
    <generalSubstitutionModel idref="reversibleModel"/>
    <logRateSubstitutionModel idref="logRateModel"/>
    <rootFrequencies><frequencyModel idref="geoFreqs"/></rootFrequencies>
  </instantaneousMixtureSubstitutionModel>
  <generalizedSkyLineLikelihood id="skyline" linear="false">
    <populationSizes><parameter id="skyline.popSize" value="{sky_pops}"/></populationSizes>
    <groupSizes><parameter id="skyline.groupSize" value="{sky_groups}"/></groupSizes>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </generalizedSkyLineLikelihood>
  <skylineGradient id="skylineHeights"><generalizedSkyLineLikelihood idref="skyline"/></skylineGradient>
  <skylineGradient id="skylinePops" wrtParameter="populationSizes"><generalizedSkyLineLikelihood idref="skyline"/></skylineGradient>
  <yuleModel id="yule" units="years">
    <birthRate><parameter id="yule.birthRate" value="2.0" lower="0.0"/></birthRate>
  </yuleModel>
  <speciationLikelihood id="speciation">
    <model><yuleModel idref="yule"/></model>
    <speciesTree><treeModel idref="treeModel"/></speciesTree>
  </speciationLikelihood>
  <speciationLikelihoodGradient id="speciationHeights"><speciationLikelihood idref="speciation"/></speciationLikelihoodGradient>
  <speciationLikelihoodGradient id="speciationBirth" wrtParameter="birthRate"><speciationLikelihood idref="speciation"/></speciationLikelihoodGradient>
  <gradientWrtIncrements1D id="increments">
    <speciationLikelihoodGradient idref="speciationBirth"/>
    <parameter idref="yule.birthRate"/>
  </gradientWrtIncrements1D>
  <branchSubstitutionParameterGradient id="branchExact">
    <treeDataLikelihood idref="geoTreeLikelihood"/><parameter idref="glm.coefficients"/>
  </branchSubstitutionParameterGradient>
"""


def p19_functions_document(path, glm_doc):
    """The GLM document with 19c's elements added before <operators>: an
    8-state strongly lumpable rate provider (two lumps of four) under a
    log-rate model, a log-rate model over the document's locations, a
    reversible general model and their instantaneous mixture, a skyline of ten groups with its
    gradients, and a Yule speciation likelihood with its gradients and the
    increments' one, values drawn with numpy from P19_SEED."""
    import numpy as np

    from beast_mcmc_tpu_torch.apps.makona import read_makona_xml

    cfg = read_makona_xml(glm_doc)
    rng = np.random.default_rng(P19_SEED)
    k, n_taxa = len(cfg["location_codes"]), len(cfg["taxa"])
    codes = "ABCDEFGH"
    lump_states = "\n".join(f'    <state code="{c}"/>' for c in codes)
    lumps = []
    for li, members in enumerate((codes[:4], codes[4:])):
        props = "\n".join(
            f'      <proportions><state code="{c}"/><parameter '
            f'id="prop.{c}" value="'
            + " ".join(repr(float(x)) for x in rng.dirichlet(np.ones(4)))
            + '"/></proportions>' for c in members)
        within = " ".join(repr(float(x)) for x in rng.uniform(0.2, 2.0, 12))
        lumps.append(f"""    <lump>
      <stateSet><generalDataType idref="lumpType"/>{''.join(f'<state code="{c}"/>' for c in members)}</stateSet>
      <rates><parameter id="within{li}" value="{within}"/></rates>
{props}
    </lump>""")
    groups = [n_taxa // 10] * 10
    groups[-1] += n_taxa - 1 - sum(groups)
    block = P19_FUNCTIONS_XML.format(
        lump_states=lump_states, lumps="\n".join(lumps),
        log_rates=" ".join(repr(float(x)) for x in
                           rng.normal(0.0, 0.5, k * (k - 1))),
        rev_rates=" ".join(repr(float(x)) for x in
                           rng.uniform(0.2, 2.0, k * (k - 1) // 2)),
        sky_pops=" ".join(repr(float(x)) for x in rng.uniform(0.5, 3.0, 10)),
        sky_groups=" ".join(str(g) for g in groups))
    text = open(glm_doc).read().replace(
        '  <operators id="operators">', block + '  <operators id="operators">',
        1)
    with open(path, "w") as f:
        f.write(text)


def p19_function_cases(ax, dev):
    """{label: fn() -> tensor} of 19c on `ax` (the functions document on
    `dev`): the first-order surrogate's value and coefficient gradient at
    56 states x 1,610 taxa (config/interpreter.py's _surrogate_liks); the
    GLM, log-rate, lumpable and mixture generators at the start state;
    basta_loglikelihood at 1,610 taxa x P19_BASTA_DEMES demes (the
    document's start tree, tip demes, rates and population sizes drawn
    with numpy from P19_SEED) with its gradient; the analytic gradients
    of skylineGradient, speciationLikelihoodGradient (heights and birth
    rate), gradientWrtIncrements1D's report line, and the GLM
    coefficients' gradient over the location likelihood by
    glmSubstitutionModelGradient (the surrogate's) and by
    branchSubstitutionParameterGradient (exact)."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.config import xml_assert
    from beast_mcmc_tpu_torch.models import basta

    ax.build(ax._ids["treeModel"])
    geo = ax.build(ax._ids["geoTreeLikelihood"])
    sur = ax._surrogate_liks["geoTreeLikelihood"]
    built = {i: ax.build(ax._ids[i]) for i in (
        "originModel", "logRateModel", "lumpModel", "mixtureModel",
        "skylineHeights", "skylinePops", "speciationHeights",
        "speciationBirth", "increments", "branchExact", "glmGradient")}
    params0, tree0 = xml_assert.initial_eval_state(ax)
    rng = np.random.default_rng(P19_SEED)
    n = (tree0.heights.shape[0] + 1) // 2
    kd = P19_BASTA_DEMES
    demes = torch.as_tensor(rng.integers(0, kd, n), device=dev)
    mig_rates = torch.as_tensor(rng.uniform(0.05, 0.5, kd * (kd - 1)),
                                dtype=torch.float64, device=dev)
    pops = torch.as_tensor(rng.uniform(0.5, 5.0, kd), dtype=torch.float64,
                           device=dev)

    def grad(spec):
        return lambda: xml_assert.analytic_gradient(ax, spec)[2]

    def q_of(model_id):
        return lambda: built[model_id][1](params0)

    def basta_value_grad():
        r = mig_rates.clone().requires_grad_(True)
        p = pops.clone().requires_grad_(True)
        v = basta.basta_loglikelihood(
            demes, tree0.parent, tree0.children, tree0.heights,
            basta.migration_rate_matrix(r, kd), p)
        return torch.cat([v.reshape(1)] + list(torch.autograd.grad(
            v, (r, p))))

    def increments():
        line = built["increments"].report(ax).splitlines()[0]
        return torch.tensor([float(x) for x in line.split("[")[1].split(
            "]")[0].split(",")], dtype=torch.float64)

    return {
        "tree_loglikelihood_q_approx_grad value": lambda: torch.stack([
            sur.fn(params0, tree0), geo.fn(params0, tree0)]),
        "glmSubstitutionModelGradient (the surrogate's)":
            grad(built["glmGradient"]),
        "branchSubstitutionParameterGradient exact":
            grad(built["branchExact"]),
        "glmSubstitutionModel generator": q_of("originModel"),
        "logRateSubstitutionModel generator": q_of("logRateModel"),
        "stronglyLumpableCtmcRates generator": q_of("lumpModel"),
        "instantaneousMixtureSubstitutionModel generator":
            q_of("mixtureModel"),
        "basta_loglikelihood and gradient": basta_value_grad,
        "skylineGradient heights": grad(built["skylineHeights"]),
        "skylineGradient populations": grad(built["skylinePops"]),
        "speciationLikelihoodGradient heights": grad(
            built["speciationHeights"]),
        "speciationLikelihoodGradient birth rate": grad(
            built["speciationBirth"]),
        "gradientWrtIncrements1D": increments,
    }, (demes, mig_rates, pops, tree0)


def p19_functions_path(out_dir, dev, glm_doc):
    """Phase 19c: p19_function_cases on the card and on the CPU, each
    output's largest deviation over its largest magnitude held to
    P19_REL_TOL; basta_loglikelihood's ms on the card (CUDA events).
    Returns the record."""
    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.models import basta

    t0 = time.perf_counter()
    doc = os.path.join(os.path.dirname(glm_doc), "makona_glm_functions.xml")
    p19_functions_document(doc, glm_doc)
    out = {}
    for d in (dev, "cpu"):
        ax = XmlAnalysis(doc, seed=666, device=d,
                         workdir=os.path.dirname(doc))
        cases, b_in = p19_function_cases(ax, d)
        out[d] = {k: fn().detach().cpu().double() for k, fn in cases.items()}
        if d == dev:
            demes, rates, pops, tree0 = b_in
            n_basta = int(demes.shape[0])
            with torch.no_grad():
                basta_ms = _event_ms(lambda: basta.basta_loglikelihood(
                    demes, tree0.parent, tree0.children, tree0.heights,
                    basta.migration_rate_matrix(rates, P19_BASTA_DEMES),
                    pops),
                    P19_BASTA_REPS, d)
        del ax, cases
    worst = {}
    for label, w in out["cpu"].items():
        g = out[dev][label]
        if g.shape != w.shape or not bool(torch.isfinite(w).all()):
            raise AssertionError(f"P19c {label}: {g} against {w}")
        worst[label] = float((g - w).abs().max()) / max(
            float(w.abs().max()), 1e-300)
        if not worst[label] <= P19_REL_TOL:
            raise AssertionError(f"P19c {label}: {worst[label]!r} > "
                                 f"{P19_REL_TOL}")
    top = max(worst, key=worst.get)
    sur = out["cpu"]["glmSubstitutionModelGradient (the surrogate's)"]
    exact = out["cpu"]["branchSubstitutionParameterGradient exact"]
    rec = {"functions": len(worst), "max_rel_err": worst[top], "worst": top,
           "rel_err": worst, "basta_ms": basta_ms,
           "surrogate_gradient": sur.tolist(),
           "exact_gradient": exact.tolist(),
           "basta_taxa": n_basta,
           "basta_demes": P19_BASTA_DEMES,
           "seconds": time.perf_counter() - t0}
    log(f"[P19c] {len(worst)} functions on the card against the CPU in "
        f"{rec['seconds']:.2f} s: largest deviation {worst[top]!r} ({top}; "
        f"tolerance {P19_REL_TOL}); basta_loglikelihood at "
        f"{rec['basta_taxa']} taxa x {P19_BASTA_DEMES} demes "
        f"{basta_ms:.3f} ms; the GLM coefficients' gradient by "
        f"glmSubstitutionModelGradient (the surrogate's) "
        f"{rec['surrogate_gradient']} beside the exact "
        f"{rec['exact_gradient']}")
    return rec


# phase 20: phylogenetic factor analysis and the HMC skygrid
P20_STEPS, P20_LOG_EVERY, P20_CHECK = 30, 10, 100  # 50
P20_TRAITS, P20_FACTORS, P20_MISSING = 20, 4, 0.05
P20_RESIDUAL, P20_PSS = 0.25, 0.01  # residual variance; root sample size
P20_LEAPFROG, P20_HMC_STEP = 5, 0.002  # the loadings HMC
P20_PROFILE, P20_SEED, P20_TRAIT_SEED = 4, 20, 2020
P20_DRAW_REPS = 3  # timed factor draws
P20_SKY_STEPS, P20_SKY_LEAPFROG, P20_SKY_STEP = 50, 5, 0.02
P20_CELLS, P20_CUTOFF = 50, 2.0  # examples/makona_joint.xml's skygrid
P20_GP_DIM = 40  # the GP fields of 20c
P20_REL_TOL = 1e-12
P20_TESTXML_TOL = 1e-10  # of the largest entry, the card against the CPU


def factor_traits(data, seed=P20_TRAIT_SEED, p=P20_TRAITS, k=P20_FACTORS):
    """(traits [taxa, p] with about P20_MISSING of the entries NaN,
    loadings [p, k], the tips' factors [taxa, k]): k factors by a unit
    Brownian motion a year from 0 down makona_data's own tree (its tips'
    heights, its population size, its seed, as rrw_locations), loaded by
    standard normal loadings, plus normal residuals of variance
    P20_RESIDUAL, all drawn with numpy from `seed`."""
    import numpy as np

    from beast_mcmc_tpu_torch.apps.makona import tip_heights
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    parent, _, heights, root = simulate_coalescent_tree(
        np.random.default_rng(JOINT_SEED), tip_heights(data["dates"]),
        data["cfg"]["pop_size"])
    rng = np.random.default_rng(seed)
    n = len(data["taxa"])
    f = np.zeros((parent.shape[0], k))
    for node in np.argsort(-heights):  # parents before children
        if parent[node] >= 0:
            t = heights[parent[node]] - heights[node]
            f[node] = f[parent[node]] + rng.normal(0.0, np.sqrt(t), k)
    loadings = rng.normal(size=(p, k))
    y = f[:n] @ loadings.T + rng.normal(0.0, np.sqrt(P20_RESIDUAL), (n, p))
    y[rng.uniform(size=(n, p)) < P20_MISSING] = np.nan
    return y, loadings, f[:n]


def _vals(x):
    return " ".join(repr(float(v)) for v in x)


def _trait_taxa(data, traits):
    """The <taxa> lines with each taxon's traits as <attr name="traits">
    (NA where missing)."""
    import math

    taxa = taxa_alignment_xml(data)[:len(data["taxa"]) + 2]
    for i in range(len(data["taxa"])):
        attr = " ".join("NA" if math.isnan(v) else repr(float(v))
                        for v in traits[i])
        taxa[1 + i] = taxa[1 + i].replace(
            "</taxon>", f'<attr name="traits">{attr}</attr></taxon>')
    return taxa


_COALESCENT_XML = """  <coalescentLikelihood id="coalescent">
    <model><constantSize idref="constant"/></model>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </coalescentLikelihood>"""


def _seq_models_xml(data, after_tree="", likelihood="treeDataLikelihood"):
    """HKY+Gamma4, a strict clock and a constant coalescent's start tree
    on makona_data's alignment (the sequence model of phases 17a to 20c):
    `after_tree` (its own lines) after the <treeModel>, the tree
    likelihood as a <likelihood> element."""
    cfg = data["cfg"]
    init = cfg["model"]["init"]
    freqs = " ".join(repr(float(f)) for f in init["frequencies"])
    return f"""  <patterns id="patterns" from="1"><alignment idref="alignment"/></patterns>
  <constantSize id="constant" units="years">
    <populationSize><parameter id="popSize" value="{float(cfg['pop_size'])!r}" lower="0.0"/></populationSize>
  </constantSize>
  <coalescentSimulator id="startingTree">
    <taxa idref="taxa"/><constantSize idref="constant"/>
  </coalescentSimulator>
  <treeModel id="treeModel">
    <coalescentTree idref="startingTree"/>
    <rootHeight><parameter id="treeModel.rootHeight"/></rootHeight>
    <nodeHeights internalNodes="true"><parameter id="treeModel.internalNodeHeights"/></nodeHeights>
  </treeModel>
{after_tree + chr(10) if after_tree else ""}  <strictClockBranchRates id="clock">
    <rate><parameter id="clock.rate" value="{float(init['ucld.mean'])!r}" lower="0.0"/></rate>
  </strictClockBranchRates>
  <HKYModel id="hky">
    <frequencies><frequencyModel dataType="nucleotide">
      <frequencies><parameter id="frequencies" value="{freqs}"/></frequencies>
    </frequencyModel></frequencies>
    <kappa><parameter id="kappa" value="4.0" lower="0.0"/></kappa>
  </HKYModel>
  <siteModel id="siteModel">
    <substitutionModel><HKYModel idref="hky"/></substitutionModel>
    <gammaShape gammaCategories="4"><parameter id="alpha" value="{float(init['siteModel.alpha'])!r}" lower="0.0"/></gammaShape>
  </siteModel>
  <{likelihood} id="treeLikelihood" useAmbiguities="false">
    <patterns idref="patterns"/><treeModel idref="treeModel"/>
    <siteModel idref="siteModel"/><strictClockBranchRates idref="clock"/>
  </{likelihood}>"""


def _seq_priors_xml(data):
    import math

    cfg = data["cfg"]
    rate = float(cfg["model"]["init"]["ucld.mean"])
    return (f"""        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="kappa"/></logNormalPrior>
        <exponentialPrior mean="0.5" offset="0.0"><parameter idref="alpha"/></exponentialPrior>
        <logNormalPrior mean="{math.log(rate)!r}" stdev="1.0"><parameter idref="clock.rate"/></logNormalPrior>""")


_SEQ_OPS = """    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="kappa"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="alpha"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="clock.rate"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="treeModel.rootHeight"/></scaleOperator>
    <subtreeSlide size="1.0" gaussian="true" weight="10"><treeModel idref="treeModel"/></subtreeSlide>
    <narrowExchange weight="10"><treeModel idref="treeModel"/></narrowExchange>"""


def factor_model_xml(data, traits, loadings, factors):
    """The factor-analysis elements of phase 20a: the loadings L (P20_
    TRAITS x P20_FACTORS, as K column parameters, starting at the
    generating ones), the residual precision, an <integratedFactorModel>
    under a <traitDataLikelihood> (identity diffusion, a conjugate root
    prior of sample size P20_PSS), Bayesian-bridge row priors in a
    <matrixShrinkageLikelihood> whose global scales are products of
    multiplicative-gamma multipliers (<productParameter>s, a
    <multiplicativeGammaGibbsProvider>), the tips' factors (starting at
    the generating ones) in a <latentFactorModel> for the
    <factorProportionStatistic>."""
    import numpy as np

    p, k = loadings.shape
    cols = "\n".join(
        f'    <parameter id="L.{j + 1}" value="{_vals(loadings[:, j])}"/>'
        for j in range(k))
    ident = "\n".join(
        f'    <parameter value="{_vals(np.eye(k)[j])}"/>' for j in range(k))
    deltas = "\n".join(
        f'  <parameter id="delta.{j + 1}" value="1.0" lower="0.0"/>'
        for j in range(k))
    products = "\n".join(
        f'  <productParameter id="globalScale.{j + 1}">'
        + "".join(f'<parameter idref="delta.{l + 1}"/>' for l in range(j + 1))
        + "</productParameter>" for j in range(k))
    bridges = "\n".join(f"""      <bayesianBridge id="bridge.{j + 1}"><parameter idref="L.{j + 1}"/>
        <globalScale><productParameter idref="globalScale.{j + 1}"/></globalScale>
        <exponent><parameter value="0.5"/></exponent>
        <localScale><parameter id="localScale.{j + 1}" value="1.0" dimension="{p}" lower="0.0"/></localScale>
      </bayesianBridge>""" for j in range(k))
    delta_refs = "".join(f'<parameter idref="delta.{j + 1}"/>'
                         for j in range(k))
    return f"""  <matrixParameter id="L">
{cols}
  </matrixParameter>
  <parameter id="factorPrecision" value="{1.0 / P20_RESIDUAL!r}" dimension="{p}" lower="0.0"/>
  <matrixParameter id="factorDiffusion">
{ident}
  </matrixParameter>
  <multivariateDiffusionModel id="factorDiffusionModel">
    <precisionMatrix><matrixParameter idref="factorDiffusion"/></precisionMatrix>
  </multivariateDiffusionModel>
  <integratedFactorModel id="factorModel" traitName="traits">
    <treeModel idref="treeModel"/>
    <traitParameter><parameter id="leaf.traits"/></traitParameter>
    <loadings><matrixParameter idref="L"/></loadings>
    <precision><parameter idref="factorPrecision"/></precision>
  </integratedFactorModel>
  <traitDataLikelihood id="traitLikelihood" traitName="traits">
    <multivariateDiffusionModel idref="factorDiffusionModel"/>
    <treeModel idref="treeModel"/>
    <integratedFactorModel idref="factorModel"/>
    <conjugateRootPrior>
      <meanParameter><parameter value="0.0" dimension="{k}"/></meanParameter>
      <priorSampleSize><parameter value="{P20_PSS!r}"/></priorSampleSize>
    </conjugateRootPrior>
  </traitDataLikelihood>
{deltas}
{products}
  <matrixShrinkageLikelihood id="loadingsPrior">
    <matrixParameter idref="L"/>
    <rowPriors>
{bridges}
    </rowPriors>
  </matrixShrinkageLikelihood>
  <multiplicativeGammaGibbsProvider id="shrinkageProvider">
    <compoundParameter>{delta_refs}</compoundParameter>
    <matrixShrinkageLikelihood idref="loadingsPrior"/>
  </multiplicativeGammaGibbsProvider>
  <parameter id="factors.tips" value="{_vals(factors.reshape(-1))}"/>
  <dataFromTreeTips id="traitData" traitName="traits">
    <treeModel idref="treeModel"/>
    <traitParameter><parameter idref="leaf.traits"/></traitParameter>
  </dataFromTreeTips>
  <latentFactorModel id="latentFactors">
    <factors><parameter idref="factors.tips"/></factors>
    <loadings><matrixParameter idref="L"/></loadings>
    <columnPrecision><parameter idref="factorPrecision"/></columnPrecision>
    <data><dataFromTreeTips idref="traitData"/></data>
  </latentFactorModel>
  <factorProportionStatistic id="factorProportion">
    <latentFactorModel idref="latentFactors"/>
  </factorProportionStatistic>"""


def factor_document(path, data, n_steps=P20_STEPS, log_every=P20_LOG_EVERY):
    """Write the phylogenetic factor analysis of phase 20a at `path`:
    makona_data's taxa and alignment under HKY+Gamma4, a strict clock and
    a constant coalescent; P20_TRAITS traits a taxon (`factor_traits`)
    under `factor_model_xml`'s model; operators HMC on the loadings (a
    <jointGradient> of <integratedFactorAnalysisLoadingsGradient>),
    normalGammaPrecisionGibbsOperator over the multiplicative-gamma
    provider, integratedFactorsGibbsOperator on the tips' factors, scale
    moves on the residual precision and the sequence parameters, the tree
    moves; <log> of the posterior, the trait likelihood, the factor
    proportions and the first multiplier. Returns the log's file name."""
    import math

    traits, loadings, factors = factor_traits(data)
    k = loadings.shape[1]
    pop = float(data["cfg"]["pop_size"])
    name = "makona_factors"
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += _trait_taxa(data, traits)
    out += taxa_alignment_xml(data)[len(data["taxa"]) + 2:]
    out.append(_seq_models_xml(data))
    out.append(_COALESCENT_XML)
    out.append(factor_model_xml(data, traits, loadings, factors))
    gammas = "\n".join(
        f'        <gammaPrior shape="2.0" scale="1.0"><parameter '
        f'idref="delta.{j + 1}"/></gammaPrior>' for j in range(k))
    out.append(f"""  <operators id="operators">
    <hamiltonianMonteCarloOperator weight="1" nSteps="{P20_LEAPFROG}" stepSize="{P20_HMC_STEP!r}"
        drawVariance="1.0" autoOptimize="true">
      <jointGradient id="loadingsGradient">
        <integratedFactorAnalysisLoadingsGradient>
          <integratedFactorModel idref="factorModel"/>
          <traitDataLikelihood idref="traitLikelihood"/>
        </integratedFactorAnalysisLoadingsGradient>
      </jointGradient>
      <matrixParameter idref="L"/>
    </hamiltonianMonteCarloOperator>
    <normalGammaPrecisionGibbsOperator weight="2">
      <multiplicativeGammaGibbsProvider idref="shrinkageProvider"/>
      <prior><gammaPrior shape="2.0" scale="1.0"/></prior>
    </normalGammaPrecisionGibbsOperator>
    <integratedFactorsGibbsOperator weight="2">
      <integratedFactorModel idref="factorModel"/>
      <traitDataLikelihood idref="traitLikelihood"/>
      <parameter idref="factors.tips"/>
    </integratedFactorsGibbsOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="factorPrecision"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="popSize"/></scaleOperator>
{_SEQ_OPS}
  </operators>
  <mcmc id="mcmc" chainLength="{n_steps}" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
{_seq_priors_xml(data)}
        <logNormalPrior mean="{math.log(pop)!r}" stdev="1.0"><parameter idref="popSize"/></logNormalPrior>
        <coalescentLikelihood idref="coalescent"/>
        <matrixShrinkageLikelihood idref="loadingsPrior"/>
{gammas}
      </prior>
      <likelihood id="likelihood">
        <treeDataLikelihood idref="treeLikelihood"/>
        <traitDataLikelihood idref="traitLikelihood"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="{log_every}" fileName="{name}.log">
      <posterior idref="posterior"/>
      <traitDataLikelihood idref="traitLikelihood"/>
      <factorProportionStatistic idref="factorProportion"/>
      <parameter idref="delta.1"/>
    </log>
  </mcmc>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return f"{name}.log"


def skygrid_grid():
    """The north-star skygrid's P20_CELLS - 1 grid points (its cutOff over
    numGridPoints)."""
    n = P20_CELLS - 1
    return [P20_CUTOFF * (i + 1) / n for i in range(n)]


def skygrid_model_xml(pop):
    """An HMC skygrid: a <multiLocusNPCoalescentLikelihood> on the
    north-star skygrid's cells and a <randomField> of a
    <gaussianMarkovRandomField> (gamma prior on its precision) on the log
    population sizes, and their <jointGradient>."""
    import math

    return f"""  <parameter id="skygrid.gridPoints" value="{_vals(skygrid_grid())}"/>
  <multiLocusNPCoalescentLikelihood id="skygrid">
    <populationSizes><parameter id="skygrid.logPopSize" dimension="{P20_CELLS}" value="{math.log(pop)!r}"/></populationSizes>
    <gridPoints><parameter idref="skygrid.gridPoints"/></gridPoints>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </multiLocusNPCoalescentLikelihood>
  <gaussianMarkovRandomField id="skygrid.gmrf" dim="{P20_CELLS}">
    <precision><parameter id="skygrid.precision" value="0.1" lower="0.0"/></precision>
  </gaussianMarkovRandomField>
  <randomField id="skygrid.field">
    <data><parameter idref="skygrid.logPopSize"/></data>
    <distribution><gaussianMarkovRandomField idref="skygrid.gmrf"/></distribution>
  </randomField>
  <gammaPrior id="skygrid.precisionPrior" shape="0.001" scale="1000.0"><parameter idref="skygrid.precision"/></gammaPrior>
  <jointGradient id="skygridGradient">
    <multilocusNPCoalescentLikelihoodGradient>
      <multiLocusNPCoalescentLikelihood idref="skygrid"/><parameter idref="skygrid.logPopSize"/>
    </multilocusNPCoalescentLikelihoodGradient>
    <randomFieldGradient><randomField idref="skygrid.field"/></randomFieldGradient>
  </jointGradient>"""


def skygrid_document(path, data, n_steps=P20_SKY_STEPS,
                     log_every=P20_LOG_EVERY, expected=None):
    """Write the HMC skygrid of phase 20b at `path` on makona_data's taxa
    and alignment (HKY+Gamma4, a strict clock; a constant coalescent only
    for the start tree): `skygrid_model_xml`'s prior, HMC over the field
    with its <jointGradient>, a scale move on its precision, the sequence
    and tree moves. With `expected` (the CPU's analytic gradient), an
    <assertEqual> before <mcmc> holds the jointGradient's analytic line to
    P20_TESTXML_TOL of its largest entry. Returns the log's file name."""
    name = "makona_skygrid"
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += taxa_alignment_xml(data)
    out.append(_seq_models_xml(data))
    out.append(skygrid_model_xml(float(data["cfg"]["pop_size"])))
    out.append(f"""  <operators id="operators">
    <hamiltonianMonteCarloOperator weight="2" nSteps="{P20_SKY_LEAPFROG}" stepSize="{P20_SKY_STEP!r}"
        drawVariance="1.0" autoOptimize="true">
      <jointGradient idref="skygridGradient"/>
      <parameter idref="skygrid.logPopSize"/>
    </hamiltonianMonteCarloOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="skygrid.precision"/></scaleOperator>
{_SEQ_OPS}
  </operators>""")
    if expected is not None:
        tol = P20_TESTXML_TOL * float(max(abs(v) for v in expected))
        vals = ", ".join(repr(float(v)) for v in expected)
        out.append(f"""  <assertEqual tolerance="{tol!r}" toleranceType="absolute">
    <message>skygrid joint gradient at the start, against the CPU</message>
    <actual regex="analytic: \\[(.*)\\]"><jointGradient idref="skygridGradient"/></actual>
    <expected>{vals}</expected>
  </assertEqual>""")
    out.append(f"""  <mcmc id="mcmc" chainLength="{n_steps}" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
{_seq_priors_xml(data)}
        <multiLocusNPCoalescentLikelihood idref="skygrid"/>
        <randomField idref="skygrid.field"/>
        <gammaPrior idref="skygrid.precisionPrior"/>
      </prior>
      <likelihood id="likelihood">
        <treeDataLikelihood idref="treeLikelihood"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="{log_every}" fileName="{name}.log">
      <posterior idref="posterior"/>
      <multiLocusNPCoalescentLikelihood idref="skygrid"/>
      <parameter idref="skygrid.precision"/>
      <parameter idref="treeModel.rootHeight"/>
    </log>
  </mcmc>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return f"{name}.log"


def _read_log(path, rows, label):
    import math

    lines = open(path).read().splitlines()
    header = lines[0].split("\t")
    body = [[float(v) for v in ln.split("\t")] for ln in lines[1:]]
    if len(body) != rows or not all(math.isfinite(v) for r in body
                                    for v in r):
        raise AssertionError(f"{label} log: {header} {body[:2]}")
    return header, body


def factor_path(out_dir, reset_counts, read_counts, device_ms, dev,
                n_taxa=SPEC_TAXA, n_sites=SPEC_SITES, n_steps=P20_STEPS,
                log_every=P20_LOG_EVERY, n_profile=P20_PROFILE,
                draw_reps=P20_DRAW_REPS):
    """Phase 20a (see the module docstring) at n_taxa x n_sites: `run
    makona_factors.xml` through the CLI under BoundLaunches, its
    peel_stream launches exactly as predicted (the start, two a checked
    step, one a step, one a log row's posterior, each loadings HMC
    proposal's 2 nSteps), the deviation, states/s, each HMC proposal's ms
    (CUDA events), the log read back (finite, the factors' relative
    shares summing to their relative marginal share); then on the built
    analysis
    the ms of a tip-factor draw (CUDA events) and a profiler window of
    n_profile steps. Returns (record, launches)."""
    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.config.xml_factor import (
        FactorTreeGibbsOperator)
    from beast_mcmc_tpu_torch.inference.mcmc import run_chain

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    doc = os.path.join(out_dir, "makona_factors.xml")
    log_name = factor_document(doc, data, n_steps, log_every)
    rec = {"taxa": len(data["taxa"]), "sites": data["sites"],
           "patterns": data["patterns"], "traits": P20_TRAITS,
           "factors": P20_FACTORS,
           "document_seconds": time.perf_counter() - t0}
    launches = {}

    def expect(n, what):
        counts = read_counts()
        want = {k: n * (k == "peel_stream") for k in counts}
        launches[f"P20 {what}"] = counts
        if counts != want:
            raise AssertionError(f"P20 {what}: launches {counts}, "
                                 f"expected {want}")

    reset_counts()
    rows = n_steps // log_every
    a = _cli_chain(out_dir, ["run", doc, "-seed", str(P20_SEED),
                             "-device", str(dev)], "20a CLI", n_steps,
                   P20_CHECK, rows, expect)
    header, body = _read_log(os.path.join(out_dir, log_name), rows, "P20a")
    rel = [i for i, h in enumerate(header) if ".relativeProportion." in h]
    marginal = header.index("factorProportion.relativeMarginalProportion")
    if len(rel) != P20_FACTORS or not all(
            abs(sum(r[i] for i in rel) - r[marginal]) < 1e-8 for r in body):
        raise AssertionError(f"P20a factor proportions: {header} {body[:2]}")
    a["log_rows"] = len(body)
    a["factor_proportion"] = [body[0][header.index(
        "factorProportion.factorProportion")], body[-1][header.index(
            "factorProportion.factorProportion")]]
    a["hmc_proposal_ms"] = a["bound_ms"].get("HmcOperator", [])

    ax = XmlAnalysis(doc, seed=P20_SEED, device=dev, workdir=out_dir)
    chain = ax.prepare_chain()
    (draw,) = [op for op in chain["operators"]
               if isinstance(op, FactorTreeGibbsOperator)]
    st = chain["state"]
    gen = __import__("torch").Generator(device=dev).manual_seed(P20_SEED)
    a["factor_draw_ms"] = _event_ms(
        lambda: draw.propose(st.params, st.tree, gen, None), draw_reps, dev)
    reset_counts()
    wall, busy = device_ms(lambda: run_chain(chain["step"], st, n_profile),
                           "p20a factor chain", n_profile)
    expect(n_profile, "20a profile")
    a.update({"profile_ms_per_step": wall,
              "device_busy_share": None if busy is None else busy / wall,
              "device_events_per_step": device_ms.events})
    rec["20a"] = a
    log(f"[P20a] CLI rc {a['rc']} in {a['cli_seconds']:.2f} s: "
        f"{a['steps']} states in {a['chain_seconds']:.2f} s = "
        f"{a['states_per_s']} states/s, full-evaluation deviation "
        f"{a['full_evaluation_deviation']!r}, peel_stream launches "
        f"{a['predicted_launches']} as predicted (bound proposals "
        f"{a['bound_proposals']}, {a['bound_launches']} of their own); "
        f"loadings HMC proposal ms "
        f"{[round(x, 3) for x in a['hmc_proposal_ms']]} ({P20_LEAPFROG} "
        f"leapfrogs), tip-factor draw {a['factor_draw_ms']:.3f} ms "
        f"({n_taxa} x {P20_FACTORS} factors); factor proportion "
        f"{a['factor_proportion']}; profile {wall:.3f} ms a step, busy "
        f"share {a['device_busy_share']}, {a['device_events_per_step']} "
        f"device events a step")
    return rec, launches


def skygrid_path(out_dir, reset_counts, read_counts, dev, n_taxa=SPEC_TAXA,
                 n_sites=SPEC_SITES, n_steps=P20_SKY_STEPS,
                 log_every=P20_LOG_EVERY):
    """Phase 20b at n_taxa x n_sites: the skygrid jointGradient's analytic
    gradient on the CPU from the document, then `run makona_skygrid.xml
    -testxml` through the CLI with the <assertEqual> holding the card's
    report to it; its peel_stream launches exactly as predicted (the
    report differentiates the coalescent and the field, no peel: then
    _cli_chain's count), each field HMC proposal's ms, the log read back.
    Returns (record, launches)."""
    from beast_mcmc_tpu_torch.config import xml_assert
    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    doc = os.path.join(out_dir, "makona_skygrid.xml")
    skygrid_document(doc, data, n_steps, log_every)
    cpu_ax = XmlAnalysis(doc, seed=P20_SEED, device="cpu", workdir=out_dir)
    cpu_ax.build(cpu_ax._ids["treeModel"])
    _, _, g_cpu = xml_assert.analytic_gradient(
        cpu_ax, cpu_ax.build(cpu_ax._ids["skygridGradient"]))
    expected = g_cpu.numpy()
    del cpu_ax
    log_name = skygrid_document(doc, data, n_steps, log_every, expected)
    rec = {"document_seconds": time.perf_counter() - t0}
    launches = {}

    def expect(n, what):
        counts = read_counts()
        want = {k: n * (k == "peel_stream") for k in counts}
        launches[f"P20 {what}"] = counts
        if counts != want:
            raise AssertionError(f"P20 {what}: launches {counts}, "
                                 f"expected {want}")

    reset_counts()
    rows = n_steps // log_every
    b = _cli_chain(out_dir, ["run", doc, "-testxml", "-seed",
                             str(P20_SEED), "-device", str(dev)],
                   "20b CLI", n_steps, P20_CHECK, rows, expect,
                   testxml=True)
    _read_log(os.path.join(out_dir, log_name), rows, "P20b")
    b.update({"log_rows": rows, "gradient_entries": int(expected.size),
              "gradient_tolerance": P20_TESTXML_TOL,
              "hmc_proposal_ms": b["bound_ms"].get("HmcOperator", [])})
    rec["20b"] = b
    log(f"[P20b] CLI -testxml rc {b['rc']} in {b['cli_seconds']:.2f} s: "
        f"the skygrid jointGradient's {expected.size} entries equal the "
        f"CPU's to {P20_TESTXML_TOL} of the largest; {b['steps']} states in "
        f"{b['chain_seconds']:.2f} s = {b['states_per_s']} states/s, "
        f"full-evaluation deviation {b['full_evaluation_deviation']!r}, "
        f"peel_stream launches {b['predicted_launches']} as predicted "
        f"(bound proposals {b['bound_proposals']}, {b['bound_launches']} of "
        f"their own); field HMC proposal ms "
        f"{[round(x, 3) for x in b['hmc_proposal_ms']]} "
        f"({P20_SKY_LEAPFROG} leapfrogs)")
    return rec, launches


P20_FUNCTIONS_XML = """  <parameter id="gp.x" value="{gp_x}"/>
{gp_fields}
  <gaussianProcessPrediction id="gp.prediction">
    <parameter idref="gp.x"/>
    <gaussianProcessField idref="gp.squaredExponential"/>
    <bases><designMatrix><parameter value="{gp_pred}"/></designMatrix></bases>
  </gaussianProcessPrediction>
  <gaussianProcessConditionalDerivative id="gp.derivative">
    <field><parameter idref="gp.x"/></field>
    <gaussianProcessField idref="gp.squaredExponential"/>
  </gaussianProcessConditionalDerivative>
  <matrixParameter id="det.matrix">
{det_cols}
  </matrixParameter>
  <determinantPrior id="det.prior" shapeParameter="2.5"><matrixParameter idref="det.matrix"/></determinantPrior>
  <normalMatrixNormLikelihood id="matrix.norm">
    <globalPrecision><parameter value="{norm_prec}"/></globalPrecision>
    <matrix><matrixParameter idref="L"/></matrix>
  </normalMatrixNormLikelihood>
  <parameter id="gamma.x" value="{gamma_x}" lower="0.0"/>
  <multivariateGammaLikelihood id="mv.gamma">
    <data><parameter idref="gamma.x"/></data>
    <scale><parameter value="{gamma_scale}"/></scale>
    <shape><parameter value="{gamma_shape}"/></shape>
  </multivariateGammaLikelihood>
  <parameter id="simplex.x" value="{simplex}"/>
  <dirichletParameterPrior id="dirichlet.prior">
    <data><parameter idref="simplex.x"/></data>
    <countsParameter><parameter value="{counts}"/></countsParameter>
  </dirichletParameterPrior>"""
P20_KERNELS = (("squaredExponential", "SquaredExponential", ""),
               ("ornsteinUhlenbeck", "OrnsteinUhlenbeck",
                '<weightFunction type="sigmoid" scale="2.0" location="1.0"/>'),
               ("matern52", "Matern5/2",
                '<weightFunction type="linear" slope="0.5" intercept="1.0"/>'),
               ("matern32", "Matern3/2", ""),
               ("dotProduct", "DotProduct", ""))


def p20_functions_document(path, data):
    """20c's document on makona_data's taxa with their traits (no
    alignment): the coalescent start tree, phase 20a's factor model and
    20b's skygrid, a GP field of P20_GP_DIM points for each kernel type
    (one with an orthogonal projection, two with weight functions), the
    GP prediction and conditional derivative, and the small densities
    (determinantPrior on a 20 x 20 matrix, normalMatrixNormLikelihood on
    the loadings, multivariateGammaLikelihood, dirichletParameterPrior),
    values drawn with numpy from P20_SEED."""
    import numpy as np

    rng = np.random.default_rng(P20_SEED)
    traits, loadings, factors = factor_traits(data)
    seq = _seq_models_xml(data)
    start = seq[seq.index("  <constantSize"):seq.index("  <strictClock")]
    design = np.linspace(0.0, 4.0, P20_GP_DIM)
    fields = []
    for i, (nm, kt, weight) in enumerate(P20_KERNELS):
        ortho = ' orthogonalProjection="true"' if kt == "Matern3/2" else ""
        fields.append(f"""  <gaussianProcessField id="gp.{nm}" dim="{P20_GP_DIM}">
    <basis{ortho}>
      <designMatrix><parameter id="gp.design{i}" value="{_vals(design)}"/></designMatrix>
      <kernel type="{kt}">
        <scale><parameter id="gp.scale{i}" value="{0.5 + 0.2 * i!r}"/></scale>
        <length><parameter id="gp.length{i}" value="{0.6 + 0.15 * i!r}"/></length>
      </kernel>
      {weight}
    </basis>
    <gaussianNoise><parameter value="0.05"/></gaussianNoise>
  </gaussianProcessField>
  <randomField id="gpField.{nm}">
    <data><parameter idref="gp.x"/></data>
    <distribution><gaussianProcessField idref="gp.{nm}"/></distribution>
  </randomField>""")
    a = rng.normal(size=(20, 20))
    det = a @ a.T / 20 + np.eye(20)
    block = P20_FUNCTIONS_XML.format(
        gp_x=_vals(np.sin(design) + 0.1 * rng.normal(size=P20_GP_DIM)),
        gp_fields="\n".join(fields),
        gp_pred=_vals(rng.uniform(0.0, 4.0, 12)),
        det_cols="\n".join(f'    <parameter value="{_vals(det[:, j])}"/>'
                           for j in range(20)),
        norm_prec=_vals(rng.uniform(0.5, 2.0, P20_FACTORS)),
        gamma_x=_vals(rng.gamma(2.0, 1.0, 200)),
        gamma_scale=_vals(rng.uniform(0.5, 2.0, 200)),
        gamma_shape=_vals(rng.uniform(1.0, 4.0, 200)),
        simplex=_vals(rng.dirichlet(np.ones(50))),
        counts=_vals(rng.uniform(0.5, 3.0, 50)))
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += _trait_taxa(data, traits)
    out.append(start)
    out.append(factor_model_xml(data, traits, loadings, factors))
    out.append(skygrid_model_xml(float(data["cfg"]["pop_size"])))
    out.append(block)
    out.append("</beast>\n")
    with open(path, "w") as f:
        f.write("\n".join(out))


def p20_function_cases(ax, dev):
    """{label: fn() -> tensor} of 20c on `ax` (the functions document on
    `dev`, at its start state): the latentFactorModel density at 1,610 x
    P20_TRAITS x P20_FACTORS; the loadings Gibbs conditional (the rows'
    precisions and means), the tip-factor draw's conditional mean, the
    loadings scale's moments (the loadings as a scaled matrix of unit
    scale) and the multiplicative-gamma rates; each GP field's log
    density, the GP prediction's and conditional derivative's numbers, the
    NP coalescent with its gradient (the skygrid jointGradient) and the
    field's; the four small densities."""
    import dataclasses
    import re
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.config import xml_assert
    from beast_mcmc_tpu_torch.config import xml_factor as XF
    from beast_mcmc_tpu_torch.config.xml_hmc import MatrixParam

    ax.build(ax._ids["treeModel"])
    lfm = ax.build(ax._ids["latentFactors"]).latent_factor_model
    p, k = lfm.p, lfm.k
    loadings_op = XF.LoadingsGibbsOperator(
        lfm=lfm, prior_mu=np.zeros((p, k)), prior_tau=np.ones((p, k)))
    el = ET.fromstring('<integratedFactorsGibbsOperator>'
                       '<integratedFactorModel idref="factorModel"/>'
                       '<traitDataLikelihood idref="traitLikelihood"/>'
                       '<parameter idref="factors.tips"/>'
                       '</integratedFactorsGibbsOperator>')
    draw, _ = XF._integrated_factors_gibbs(ax, el, 1.0)
    provider = ax.build(ax._ids["shrinkageProvider"])
    liks = {eid: ax.build(ax._ids[eid]) for eid in (
        "skygrid", "skygrid.field", "det.prior", "matrix.norm", "mv.gamma",
        "dirichlet.prior", *(f"gpField.{nm}" for nm, _, _ in P20_KERNELS))}
    params0, tree0 = xml_assert.initial_eval_state(ax)
    params0 = ax.inject_derived(params0)
    names = tuple(lfm.loadings.names)
    scaled = MatrixParam(
        lambda pr: torch.stack([pr[c].reshape(-1) for c in names], 1)
        * pr["p20.scale"].reshape(-1)[None, :], names + ("p20.scale",), p)
    params_s = {**params0, "p20.scale": torch.ones(k, dtype=torch.float64,
                                                   device=dev)}
    scale_op = XF.LoadingsScaleGibbsOperator(
        lfm=dataclasses.replace(lfm, loadings=scaled),
        prior_mu=np.zeros(k), prior_tau=np.ones(k))

    def loadings_conditional():
        prec, mid, _ = loadings_op.moments(params0)
        chol = torch.linalg.cholesky(prec)
        return torch.cat([prec.reshape(-1), torch.cholesky_solve(
            mid[..., None], chol).reshape(-1)])

    def density(eid):
        return lambda: liks[eid].fn(params0, tree0)

    def report(eid):
        def fn():
            text = xml_assert.report_of(ax, ax._ids[eid])
            return torch.tensor([float(x) for x in re.findall(
                r"-?\d+\.?\d*(?:e[-+]?\d+)?", text)], dtype=torch.float64)

        return fn

    def gradient(eid):
        return lambda: xml_assert.analytic_gradient(
            ax, ax.build(ax._ids[eid]))[2]

    cases = {
        "latentFactorModel density": lambda: lfm.density(params0, tree0),
        "loadings Gibbs conditional (precisions, means)":
            loadings_conditional,
        "tip-factor draw conditional mean":
            lambda: draw.moments(params0, tree0)[2],
        "loadings scale moments": lambda: torch.cat(
            [v.reshape(-1) for v in scale_op.moments(params_s)]),
        "multiplicative-gamma rates": lambda: provider.rates(params0),
        "gaussianProcessPrediction": report("gp.prediction"),
        "gaussianProcessConditionalDerivative": report("gp.derivative"),
        "multiLocusNPCoalescentLikelihood": density("skygrid"),
        "skygrid jointGradient": gradient("skygridGradient"),
        "gaussianMarkovRandomField field": density("skygrid.field"),
        "determinantPrior": density("det.prior"),
        "normalMatrixNormLikelihood": density("matrix.norm"),
        "multivariateGammaLikelihood": density("mv.gamma"),
        "dirichletParameterPrior": density("dirichlet.prior"),
    }
    for nm, _, _ in P20_KERNELS:
        cases[f"gaussianProcessField {nm}"] = density(f"gpField.{nm}")
    return cases, draw, (params0, tree0)


def p20_functions_path(out_dir, dev, n_taxa=SPEC_TAXA, n_sites=SPEC_SITES,
                       draw_reps=P20_DRAW_REPS):
    """Phase 20c: p20_function_cases on the card and on the CPU, each
    output's largest deviation over its largest magnitude held to
    P20_REL_TOL; the tip-factor draw's conditional mean timed on the card
    (CUDA events). Returns the record."""
    import torch

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis

    t0 = time.perf_counter()
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    doc = os.path.join(out_dir, "makona_p20_functions.xml")
    p20_functions_document(doc, data)
    out = {}
    for d in (dev, "cpu"):
        ax = XmlAnalysis(doc, seed=P20_SEED, device=d, workdir=out_dir)
        cases, draw, (params0, tree0) = p20_function_cases(ax, d)
        out[d] = {k: fn().detach().cpu().double().reshape(-1)
                  for k, fn in cases.items()}
        if d == dev:
            with torch.no_grad():
                mean_ms = _event_ms(lambda: draw.moments(params0, tree0),
                                    draw_reps, d)
        del ax, cases, draw
    worst = {}
    for label, w in out["cpu"].items():
        g = out[dev][label]
        if g.shape != w.shape or not bool(torch.isfinite(w).all()):
            raise AssertionError(f"P20c {label}: {g} against {w}")
        worst[label] = float((g - w).abs().max()) / max(
            float(w.abs().max()), 1e-300)
        if not worst[label] <= P20_REL_TOL:
            raise AssertionError(f"P20c {label}: {worst[label]!r} > "
                                 f"{P20_REL_TOL}")
    top = max(worst, key=worst.get)
    rec = {"functions": len(worst), "max_rel_err": worst[top], "worst": top,
           "rel_err": worst, "factor_mean_ms": mean_ms,
           "seconds": time.perf_counter() - t0}
    log(f"[P20c] {len(worst)} functions on the card against the CPU in "
        f"{rec['seconds']:.2f} s: largest deviation {worst[top]!r} ({top}; "
        f"tolerance {P20_REL_TOL}); the tip-factor draw's conditional mean "
        f"({len(data['taxa'])} x {P20_FACTORS}) {mean_ms:.3f} ms")
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
P10_PATHS = {"benchmark2": (8, 10, 50, 6), "makona": (4, 3, 10, 2),
             "protein": (4, 3, 10, 3)}  # steps 100, 40, 40; checks 10, 6, 8
# (makona and protein before phase 20: warm-up 5, steps 20, checks 4, 5)
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


# ---------------------------------------------------------------------------
# phase 21: the model families outside the XML vocabulary
# ---------------------------------------------------------------------------

P21_SEED = 2121
P21_MIN_CLADE = 32  # 21a and 21c: smaller clades' internal branches collapse
P21_STEPS, P21_PROFILE = 50, 4  # 21a: one peel_stream_ring launch a step
P21_SWITCH = (0.3, 1.7)  # 21a: the two hidden classes' rates
P21_NMAX = 32  # 21a: the uniformization's bound on candidate jumps
P21_ARG_EVENTS, P21_ARG_STEPS = 32, 30  # 21b
P21_THORNEY_TIPS, P21_THORNEY_STEPS = 10_000, 200  # 21c
P21_THORNEY_SITES = 29_903  # SARS-CoV-2's genome, the Poisson scale
P21_EMP_TREES, P21_EMP_STEPS = 32, 50  # 21c: one peel_stream launch a step
P21_HOSTS, P21_ITEMS, P21_LOCATIONS = 200, 1000, 1000  # 21d
P21_EVENTS, P21_POINTS, P21_RASTER, P21_ROWS = 10_000, 100_000, 64, 10_000
P21_SPECIES = 8  # 21d: the species tree of the msc and the MUL-tree
P21_REL_TOL = 1e-12  # 21d, card against CPU (20c's)
P21_C7_TAXA, P21_C7_SITES = 128, 2000  # the C7 report's document
P21_C7_TOL = 1e-10  # of each analytic line's largest entry


def p21_data(dev, n_taxa=SPEC_TAXA, n_sites=SPEC_SITES, seed=JOINT_SEED):
    """makona_data's taxa, start tree and alignment (simulate_sites down
    the coalescent tree from `seed`) as phase 21 takes them: {"tree"
    (numpy parent, children, heights, root), "states" int64 [N, P] on
    `dev` with the patterns padded to a multiple of 128 by the ambiguous
    code 4, "weights" [P] (0 on the padding), "freqs" [4] (the data's),
    "patterns" (unpadded), "sites"}."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.apps.makona import (
        read_makona_xml, simulate_sites, tip_heights)
    from beast_mcmc_tpu_torch.apps.seqgen import compress_patterns
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    cfg = read_makona_xml()
    tree = simulate_coalescent_tree(np.random.default_rng(seed),
                                    tip_heights(cfg["dates"][:n_taxa]),
                                    cfg["pop_size"])
    sites = simulate_sites(cfg, tree, seed, dev, n_sites)
    pats, w = compress_patterns(sites)
    p = pats.shape[1]
    pad = -(-p // 128) * 128 - p
    states = torch.nn.functional.pad(pats, (0, pad), value=4)
    weights = torch.nn.functional.pad(w, (0, pad))
    counts = torch.stack([(sites == s).sum() for s in range(4)]).double()
    return {"cfg": cfg, "tree": tree, "states": states, "weights": weights,
            "freqs": counts / counts.sum(), "patterns": p,
            "sites": int(sites.shape[1])}


def constraint_groups(parent, children, root, n_tips, min_clade):
    """(groups int64 [M], constraint clades) of a binary tree (numpy) read
    as a resolution of its constraints tree, the tree with every internal
    branch of a clade of fewer than min_clade tips collapsed into its
    parent's polytomy: a kept internal node (the root, or a clade of
    min_clade tips or more) heads a group of its own, a collapsed one
    takes its parent's group, a tip a group of its own
    (tree/constrained.py's labels); the clades are the kept internal
    nodes' tip-index frozensets."""
    import numpy as np

    m = len(parent)
    order = [int(root)]
    for v in order:  # breadth first: parents before children
        order.extend(int(c) for c in children[v] if c >= 0)
    size = np.zeros(m, np.int64)
    tips_below = {}
    for v in reversed(order):
        if v < n_tips:
            size[v] = 1
            tips_below[v] = frozenset([v])
        else:
            a, b = (int(c) for c in children[v])
            size[v] = size[a] + size[b]
            tips_below[v] = tips_below[a] | tips_below[b]
    groups = np.arange(m, dtype=np.int64)
    clades = []
    for v in order:
        if v >= n_tips and v != root and size[v] < min_clade:
            groups[v] = groups[parent[v]]
        elif v >= n_tips:
            clades.append(tips_below[v])
    return groups, clades


def constraints_newick(parent, children, root, n_tips, min_clade):
    """The constraints tree of `constraint_groups` as a multifurcating
    Newick string over tip names t0, t1, ..."""
    groups, _ = constraint_groups(parent, children, root, n_tips, min_clade)

    def members(v):  # v's polytomy: collapsed internal children flattened
        out = []
        for c in children[v]:
            c = int(c)
            if c >= n_tips and groups[c] == groups[v]:
                out.extend(members(c))
            else:
                out.append(c)
        return out

    def text(v):
        if v < n_tips:
            return f"t{v}"
        return "(" + ",".join(text(c) for c in members(v)) + ")"

    return text(int(root)) + ";"


def clades_kept(trees, clades, n_tips):
    """Whether every clade (tip-index frozensets) is a clade of every tree
    ((parent, children, heights) numpy): each node's tip set hashed as
    the sum of random 64-bit keys of its tips, nodes in height order."""
    import numpy as np

    keys = np.random.default_rng(0).integers(1, 2 ** 62, n_tips,
                                             dtype=np.uint64)
    with np.errstate(over="ignore"):
        want = {int(np.sum(keys[sorted(c)], dtype=np.uint64))
                for c in clades}
    for parent, children, heights in trees:
        m = len(parent)
        h = np.zeros(m, np.uint64)
        h[:n_tips] = keys
        with np.errstate(over="ignore"):  # sums modulo 2^64
            for v in n_tips + np.argsort(heights[n_tips:], kind="stable"):
                h[v] = h[children[v, 0]] + h[children[v, 1]]
        if not want <= set(int(x) for x in h[n_tips:]):
            return False
    return True


def covarion_analysis(data, dev, groups):
    """Phase 21a's posterior and operators on p21_data: the HKY covarion
    with two hidden classes (P21_SWITCH rates, equal class frequencies,
    S = 8) by covarion_q and eigen_from_q_reversible, the tips
    sequence_error_partials of the sampled error rate expanded by
    expand_tip_partials_hidden, a strict clock and a constant coalescent
    on the dated start tree; the constrained NNI and SPR in `groups`,
    node heights, and scale moves on kappa, the switch rate, the error
    rate, the clock rate and the population size. Returns (log_post,
    operators, params0, tree0, model) with model(params) -> (eig, pf)."""
    import torch

    from beast_mcmc_tpu_torch.inference.operators import (
        ScaleOperator, UniformNodeHeightOperator)
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik)
    from beast_mcmc_tpu_torch.models.priors import (
        lognormal_logpdf, one_on_x_logpdf)
    from beast_mcmc_tpu_torch.models.substitution import (
        covarion_q, expand_tip_partials_hidden)
    from beast_mcmc_tpu_torch.models.tipstates import sequence_error_partials
    from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
    from beast_mcmc_tpu_torch.ops.eigen import eigen_from_q_reversible
    from beast_mcmc_tpu_torch.tree.constrained import (
        ConstrainedNNIOperator, ConstrainedUniformSPROperator)
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state

    f64 = torch.float64
    n_taxa = data["states"].shape[0]
    freqs = data["freqs"].to(dev)
    transition = torch.zeros((4, 4), dtype=torch.bool, device=dev)
    transition[0, 2] = transition[2, 0] = True
    transition[1, 3] = transition[3, 1] = True
    off = 1.0 - torch.eye(4, dtype=f64, device=dev)
    class_rates = torch.tensor(P21_SWITCH, dtype=f64, device=dev)
    class_freqs = torch.full((2,), 0.5, dtype=f64, device=dev)
    one = torch.ones(1, dtype=f64, device=dev)

    def model(params):
        r = torch.where(transition, params["kappa"], 1.0) * off
        q, pf = covarion_q(r, freqs, class_rates, class_freqs,
                           params["switch.rate"])
        return eigen_from_q_reversible(q, pf), pf

    def log_lik(params, tree):
        eig, pf = model(params)
        tips = expand_tip_partials_hidden(sequence_error_partials(
            data["states"], params["error.rate"]), 2)
        return tree_loglikelihood(tips, data["weights"], tree.parent,
                                  tree.children, tree.heights, tree.root,
                                  eig, pf, one, one, params["clock.rate"])

    def log_post(params, tree):
        err = params["error.rate"]
        return (log_lik(params, tree)
                + lognormal_logpdf(params["kappa"], 1.0, 1.25)
                + lognormal_logpdf(params["switch.rate"], 0.0, 1.0)
                + lognormal_logpdf(params["clock.rate"], -7.0, 1.0)
                + one_on_x_logpdf(params["pop.size"])
                + torch.where((err > 0) & (err < 0.1), torch.zeros_like(err),
                              torch.full_like(err, -torch.inf))
                + constant_coalescent_loglik(tree.heights, n_taxa,
                                             params["pop.size"]))

    init = data["cfg"]["model"]["init"]
    params0 = {k: torch.tensor(v, dtype=f64, device=dev) for k, v in {
        "kappa": 4.0, "switch.rate": 0.5, "error.rate": 0.005,
        "clock.rate": float(init["ucld.mean"]),
        "pop.size": float(data["cfg"]["pop_size"])}.items()}
    operators = [
        ConstrainedNNIOperator(groups=groups, weight=10.0),
        ConstrainedUniformSPROperator(groups=groups, weight=10.0),
        UniformNodeHeightOperator(weight=10.0),
        *(ScaleOperator(parameter=p, weight=2.0) for p in (
            "kappa", "switch.rate", "error.rate", "clock.rate", "pop.size"))]
    tree0 = make_tree_state(*data["tree"], f64, dev)
    return log_post, operators, params0, tree0, model


def _per_site(got, want):
    """Per-site deviation relative to max(|site logL|, 1) (F64_REL_TOL's
    measure)."""
    import torch

    return float(((got - want).abs() / torch.clamp_min(want.abs(), 1.0))
                 .max())


def _hold(label, got, want, tol):
    """max |got - want| over max |want| (finite, of one shape), raised
    above tol."""
    import torch

    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    if got.shape != want.shape or not bool(torch.isfinite(want).all()):
        raise AssertionError(f"{label}: {got} against {want}")
    err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-300)
    if not err <= tol:
        raise AssertionError(f"{label}: {err!r} > {tol}")
    return err


def covarion_path(data, reset_counts, read_counts, device_ms, dev,
                  n_steps=P21_STEPS, n_profile=P21_PROFILE,
                  min_clade=P21_MIN_CLADE, nmax=P21_NMAX):
    """Phase 21a on p21_data: the constraints tree of the start tree at
    min_clade; one launch of the S = 8 peel (peel_stream_ring on the
    card) at the start held per site against the node-by-node plain peel
    on the same device (F64_REL_TOL); a chain of n_steps steps with
    exactly one launch each, every constraint clade kept in every step's
    tree, the carried posterior against a fresh one (FULL_EVAL_TOL),
    states/s and a profiler window; then on the last tree, over all its
    branches, branch_expected_jumps of A<->G under the base HKY and
    sample_branch_histories (uniforms drawn on the host), each on the
    card against the CPU (P21_REL_TOL; the histories' states exactly), the
    dwell times summing to the branch lengths. Returns (record, launches,
    the trees: the start's and every step's, numpy)."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_mcmc_step, run_chain)
    from beast_mcmc_tpu_torch.models import treelikelihood as ttl
    from beast_mcmc_tpu_torch.models.substitution import (
        expand_tip_partials_hidden, hky_eigen, hky_q)
    from beast_mcmc_tpu_torch.models.tipstates import sequence_error_partials
    from beast_mcmc_tpu_torch.ops.eigen import transition_probs
    from beast_mcmc_tpu_torch.ops.markov_jumps import branch_expected_jumps
    from beast_mcmc_tpu_torch.ops.uniformization import (
        history_uniforms, sample_branch_histories, state_dwell_times)

    t0 = time.perf_counter()
    parent, children, heights, root = data["tree"]
    n_taxa = data["states"].shape[0]
    groups, clades = constraint_groups(parent, children, root, n_taxa,
                                       min_clade)
    log_post, ops, params0, tree0, model = covarion_analysis(data, dev,
                                                             groups)
    rec = {"taxa": n_taxa, "patterns": data["patterns"],
           "patterns_padded": int(data["states"].shape[1]), "states": 8,
           "constraint_clades": len(clades),
           "polytomies": int(len(set(groups[n_taxa:].tolist())))}
    launches = {}
    kname = "peel_stream_ring"

    def expect(n, what):
        counts = read_counts()
        launches[f"P21 {what}"] = counts
        want = {k: n * (k == kname) for k in counts}
        if counts != want:
            raise AssertionError(f"P21 {what}: launches {counts}, expected "
                                 f"{want}")

    # the kernel's launch at the start against the plain peel
    eig, pf = model(params0)
    tips = expand_tip_partials_hidden(sequence_error_partials(
        data["states"], params0["error.rate"]), 2)
    one = torch.ones(1, dtype=torch.float64, device=dev)
    pm = ttl.branch_transition_matrices(eig, tree0.parent, tree0.heights,
                                        params0["clock.rate"], one)
    if str(dev).startswith("cuda"):
        rec["route"] = ttl._route(pm)
        if rec["route"] != "stream":
            raise AssertionError(f"P21a route {rec['route']}")
    args = (tips, tree0.parent, tree0.children, tree0.heights, tree0.root,
            pm, pf, one)
    reset_counts()
    site = ttl._site_logliks(*args)
    expect(1, "21a kernel check")
    plain = ttl._plain_site_logliks(*args)
    rec["kernel_max_rel_err"] = _per_site(site, plain)
    if not rec["kernel_max_rel_err"] <= F64_REL_TOL:
        raise AssertionError(f"P21a kernel: {rec['kernel_max_rel_err']!r}")

    # the chain
    step = make_mcmc_step(log_post, ops)
    gen = torch.Generator(device=dev).manual_seed(P21_SEED)
    st = init_mcmc_state(params0, tree0, gen, ops, log_post)
    trees = [tuple(getattr(st.tree, f) for f in ("parent", "children",
                                                 "heights"))]
    reset_counts()
    t1 = time.perf_counter()
    for _ in range(n_steps):
        st = step(st)
        trees.append(tuple(getattr(st.tree, f) for f in (
            "parent", "children", "heights")))
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
    rec["chain_seconds"] = time.perf_counter() - t1
    rec["states_per_s"] = n_steps / rec["chain_seconds"]
    expect(n_steps, "21a chain")
    trees = [tuple(x.cpu().numpy() for x in t) for t in trees]
    if not clades_kept(trees, clades, n_taxa):
        raise AssertionError("P21a: a constraint clade was broken")
    fresh = log_post(st.params, st.tree)
    rec["full_evaluation_deviation"] = float(
        (fresh - st.log_posterior).abs())
    if not rec["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P21a deviation "
                             f"{rec['full_evaluation_deviation']!r}")
    rec["accepted"] = st.op_accept.tolist()
    rec["log_posterior"] = float(st.log_posterior)
    reset_counts()
    wall, busy = device_ms(lambda: run_chain(step, st, n_profile),
                           "p21a covarion chain", n_profile)
    expect(n_profile, "21a profile")
    rec.update({"profile_ms_per_step": wall,
                "device_busy_share": None if busy is None else busy / wall,
                "device_events_per_step": device_ms.events})

    # stochastic mapping on the last tree, every branch, card against CPU
    last = st.tree
    bl_rate = float(st.params["clock.rate"])
    rng = np.random.default_rng(P21_SEED)
    node_states = rng.integers(0, 4, last.parent.shape[0])
    obs = data["states"][:, 0].cpu().numpy()
    node_states[:n_taxa] = np.where(obs < 4, obs, node_states[:n_taxa])
    ag = torch.zeros((4, 4), dtype=torch.float64)
    ag[0, 2] = ag[2, 0] = 1.0
    uniforms = history_uniforms(torch.Generator().manual_seed(P21_SEED),
                                last.parent.shape[0], nmax)
    out = {}
    for d in (dev, "cpu"):
        par = last.parent.to(d)
        h = last.heights.to(d)
        freqs = data["freqs"].to(d)
        eig = hky_eigen(st.params["kappa"].to(d), freqs)
        q = hky_q(st.params["kappa"].to(d), freqs)
        bl = ttl.branch_lengths(par, h) * bl_rate
        probs = torch.nn.functional.one_hot(torch.tensor(
            node_states, device=d), 4).double()
        jumps = branch_expected_jumps(eig, q, ag.to(d), bl, probs, par,
                                      transition_probs(eig, bl))
        nz = (par >= 0).nonzero()[:, 0]
        hist = sample_branch_histories(
            None, q, bl[nz], probs.argmax(1)[par[nz]], probs.argmax(1)[nz],
            nmax, uniforms[nz.cpu()].to(d))
        dwell = state_dwell_times(hist, 4)
        sums = _hold(f"P21a dwell sums ({d})", dwell.sum(1), bl[nz], 1e-12)
        out[d] = (jumps, hist, dwell, sums)
    rec["branches"] = int(out["cpu"][1].n_jumps.shape[0])
    rec["expected_jumps_rel_err"] = _hold(
        "P21a branch_expected_jumps", out[dev][0], out["cpu"][0],
        P21_REL_TOL)
    if not torch.equal(out[dev][1].states.cpu(), out["cpu"][1].states):
        raise AssertionError("P21a histories: the states differ")
    rec["dwell_rel_err"] = _hold("P21a dwell times", out[dev][2],
                                 out["cpu"][2], P21_REL_TOL)
    rec["dwell_sum_rel_err"] = max(out[d][3] for d in out)
    rec["jumps_total"] = float(out["cpu"][0].sum())
    rec["history_jumps"] = int(out["cpu"][1].n_jumps.sum())
    rec["seconds"] = time.perf_counter() - t0
    log(f"[P21a] covarion S = 8 at {n_taxa} taxa x {rec['patterns']} "
        f"patterns ({rec['patterns_padded']} padded), "
        f"{rec['constraint_clades']} constraint clades, {rec['polytomies']} "
        f"polytomies: kernel vs plain {rec['kernel_max_rel_err']!r}; "
        f"{n_steps} steps {rec['states_per_s']:.2f} states/s, launches "
        f"{launches['P21 21a chain']}, clades kept, deviation "
        f"{rec['full_evaluation_deviation']!r}, accepted {rec['accepted']}; "
        f"profile {wall:.3f} ms a step, busy share "
        f"{rec['device_busy_share']}; {rec['branches']} branches: expected "
        f"A<->G jumps card vs CPU {rec['expected_jumps_rel_err']!r}, "
        f"histories {rec['history_jumps']} jumps, dwell card vs CPU "
        f"{rec['dwell_rel_err']!r}, sums {rec['dwell_sum_rel_err']!r}")
    return rec, launches, trees


def arg_with_reassortments(parent, children, heights, root, n_events,
                           n_partitions, rng):
    """The numpy fields of an ARG (models/arg.py::ARGState's, root an int)
    with n_events reassortments added to a binary tree (2n - 1 nodes) in
    its 2 n_events spare slots: each event puts a reassortment node r at a
    uniform height on a uniform non-root node's primary edge (r's left
    parent that edge's parent) and r's right parent, a new coalescence q,
    at a uniform height between r and the root on a uniform primary edge
    spanning it (not r's own); each partition's routing bit of r is a fair
    coin."""
    import numpy as np

    m0 = len(parent)
    m = m0 + 2 * n_events
    pl = np.concatenate([parent, np.full(2 * n_events, -1)]).astype(np.int64)
    pr = pl.copy()
    ch = np.concatenate([children, np.full((2 * n_events, 2), -1)]).astype(
        np.int64)
    h = np.concatenate([heights, np.zeros(2 * n_events)])
    side = np.zeros((m, n_partitions), bool)
    reassort = np.zeros(m, bool)
    active = np.concatenate([np.ones(m0, bool), np.zeros(2 * n_events, bool)])
    top = float(heights[root])

    def splice(node, below):  # node onto the primary edge above `below`
        p = pl[below]
        ch[p] = np.where(ch[p] == below, node, ch[p])
        pl[node] = pr[node] = p
        pl[below] = node
        if not reassort[below]:
            pr[below] = node

    for e in range(n_events):
        r, q = m0 + 2 * e, m0 + 2 * e + 1
        c = int(rng.choice(np.flatnonzero(active & (pl >= 0))))
        h[r] = rng.uniform(h[c], h[pl[c]])
        splice(r, c)
        ch[r] = (c, -1)
        reassort[r] = active[r] = True
        h[q] = rng.uniform(h[r], top)
        span = np.flatnonzero(active & (pl >= 0) & (h < h[q])
                              & (h[np.maximum(pl, 0)] > h[q])
                              & (np.arange(m) != r))
        x = int(rng.choice(span))
        splice(q, x)
        ch[q] = (x, r)
        pr[r] = q
        active[q] = True
        side[r] = rng.random(n_partitions) < 0.5
    return {"parent_left": pl, "parent_right": pr, "children": ch,
            "heights": h, "side": side, "is_reassort": reassort,
            "active": active, "root": int(root)}


def arg_path(data, reset_counts, read_counts, device_ms, dev,
             n_events=P21_ARG_EVENTS, n_steps=P21_ARG_STEPS):
    """Phase 21b: an ARG of n_events reassortments on the start tree, the
    padded patterns split in two partitions (segments), HKY+Gamma4 and a
    strict clock. Each partition's arg_partition_site_loglik by the level
    route (one peel_stream launch on the card) held per site against the
    node-by-node plain peel on the same device; then a chain of n_steps
    of reassort_height_move and partition_flip_move under
    arg_coalescent_loglik, accepted on the device, one launch a partition
    an evaluation (exactly), and the carried posterior against a fresh
    one. Returns (record, launches)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from beast_mcmc_tpu_torch import convert
    from beast_mcmc_tpu_torch.models import arg as A
    from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates
    from beast_mcmc_tpu_torch.models.substitution import hky_eigen
    from beast_mcmc_tpu_torch.ops.eigen import transition_probs

    t0 = time.perf_counter()
    f64 = torch.float64
    parent, children, heights, root = data["tree"]
    n_taxa = data["states"].shape[0]
    fields = arg_with_reassortments(parent, children, heights, root,
                                    n_events, 2,
                                    np.random.default_rng(P21_SEED))
    arg = convert.arg_from_numpy(type("ARG", (), fields), f64, dev)
    p_all = data["states"].shape[1]
    halves = (slice(0, p_all // 2), slice(p_all // 2, p_all))
    onehot = torch.nn.functional.one_hot(data["states"].clamp_max(3), 4)
    onehot = torch.where((data["states"] >= 4)[..., None], 1, onehot)
    tips = [onehot[:, sl].transpose(1, 2).to(f64).contiguous()
            for sl in halves]
    weights = [data["weights"][sl] for sl in halves]
    freqs = data["freqs"].to(dev)
    eig = hky_eigen(torch.tensor(4.0, dtype=f64, device=dev), freqs)
    rates, cat_w = (x.to(dev) for x in discrete_gamma_rates(
        torch.tensor(0.5, dtype=f64), 4))
    clock = float(data["cfg"]["model"]["init"]["ucld.mean"])
    pop = float(data["cfg"]["pop_size"])
    rho = 1.0 / pop

    def transition_fn(t):
        return transition_probs(eig, t[:, None] * clock * rates[None, :])

    def loglik(a, levels=True):
        return A.arg_loglikelihood(a, tips, weights, transition_fn, freqs,
                                   cat_w, levels)

    def log_post(a):
        return loglik(a) + A.arg_coalescent_loglik(a, n_taxa, pop, rho)

    rec = {"taxa": n_taxa, "reassortments": n_events,
           "patterns": [int(t.shape[-1]) for t in tips],
           "capacity": arg.capacity}
    launches = {}

    def expect(n, what):
        counts = read_counts()
        launches[f"P21 {what}"] = counts
        want = {k: n * (k == "peel_stream") for k in counts}
        if counts != want:
            raise AssertionError(f"P21 {what}: launches {counts}, expected "
                                 f"{want}")

    errs = []
    for p in range(2):
        reset_counts()
        site = A.arg_partition_site_loglik(arg, p, tips[p], transition_fn,
                                           freqs, cat_w, levels=True)
        expect(1, f"21b kernel check {p}")
        plain = A.arg_partition_site_loglik(arg, p, tips[p], transition_fn,
                                            freqs, cat_w, levels=False)
        errs.append(_per_site(site, plain))
    rec["kernel_max_rel_err"] = max(errs)
    if not rec["kernel_max_rel_err"] <= F64_REL_TOL:
        raise AssertionError(f"P21b kernel: {errs}")
    rec["ms_per_evaluation"] = _event_ms(lambda: loglik(arg), 3, dev)

    gen = torch.Generator(device=dev).manual_seed(P21_SEED)
    cur = log_post(arg)
    accepted = torch.zeros(2, dtype=torch.long, device=dev)
    reset_counts()
    t1 = time.perf_counter()
    for i in range(n_steps):
        move = i % 2
        if move == 0:
            prop, logh = A.reassort_height_move(arg, gen, 0.05)
        else:
            prop, logh = A.partition_flip_move(arg, gen)
        new = log_post(prop)
        u = torch.rand((), generator=gen, dtype=f64, device=dev)
        ok = torch.log(u) < new - cur + logh
        arg = A.ARGState(*(torch.where(ok, getattr(prop, f.name),
                                       getattr(arg, f.name))
                           for f in dataclasses.fields(A.ARGState)))
        cur = torch.where(ok, new, cur)
        accepted[move] += ok.long()
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
    rec["chain_seconds"] = time.perf_counter() - t1
    rec["states_per_s"] = n_steps / rec["chain_seconds"]
    expect(2 * n_steps, "21b chain")
    fresh = log_post(arg)
    rec["full_evaluation_deviation"] = float((fresh - cur).abs())
    if not (math.isfinite(float(cur))
            and rec["full_evaluation_deviation"] <= FULL_EVAL_TOL):
        raise AssertionError(f"P21b deviation {float(cur)} "
                             f"{rec['full_evaluation_deviation']!r}")
    rec["accepted"] = accepted.tolist()
    rec["log_posterior"] = float(cur)
    rec["seconds"] = time.perf_counter() - t0
    log(f"[P21b] ARG {n_taxa} taxa, {n_events} reassortments (capacity "
        f"{arg.capacity}), partitions {rec['patterns']} patterns: level "
        f"route vs plain {rec['kernel_max_rel_err']!r}, an evaluation "
        f"{rec['ms_per_evaluation']:.3f} ms; {n_steps} steps "
        f"{rec['states_per_s']:.2f} states/s, launches "
        f"{launches['P21 21b chain']}, accepted (height, flip) "
        f"{rec['accepted']}, deviation {rec['full_evaluation_deviation']!r}")
    return rec, launches


def thorney_path(reset_counts, read_counts, device_ms, dev,
                 n_tips=P21_THORNEY_TIPS, n_steps=P21_THORNEY_STEPS,
                 n_profile=P21_PROFILE):
    """Phase 21c's Thorney chain: a coalescent tree of n_tips tips, its
    constraints tree at P21_MIN_CLADE as a multifurcating Newick resolved
    by build_constrained_tree, mutation counts drawn Poisson about the
    branch lengths at P21_THORNEY_SITES, poisson_branch_length_loglik with
    the clock rate under the constant coalescent; the constrained NNI and
    SPR, node heights and the clock rate, n_steps steps with no kernel
    launch, the constraint clades kept in the last tree, the deviation,
    states/s and a profiler window. Returns (record, launches)."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_mcmc_step, run_chain)
    from beast_mcmc_tpu_torch.inference.operators import (
        ScaleOperator, UniformNodeHeightOperator)
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik)
    from beast_mcmc_tpu_torch.models.thorney import (
        poisson_branch_length_loglik)
    from beast_mcmc_tpu_torch.tree import constrained as C
    from beast_mcmc_tpu_torch.tree.topology import (
        make_tree_state, simulate_coalescent_tree)

    t0 = time.perf_counter()
    rng = np.random.default_rng(P21_SEED)
    sim = simulate_coalescent_tree(rng, np.zeros(n_tips), 1.0)
    newick = constraints_newick(sim[0], sim[1], sim[3], n_tips,
                                P21_MIN_CLADE)
    parent, children, heights, root, groups, names = \
        C.build_constrained_tree(newick, rng)
    index = {nm: i for i, nm in enumerate(names)}
    clades = [frozenset(index[t] for t in c)
              for c in C.clades_of_constraints(newick)]
    rec = {"tips": n_tips, "constraint_clades": len(clades),
           "build_seconds": time.perf_counter() - t0}
    bl = np.where(parent >= 0, heights[np.maximum(parent, 0)] - heights, 0)
    muts = torch.tensor(rng.poisson(bl * P21_THORNEY_SITES * 1e-3),
                        dtype=torch.float64, device=dev)

    def log_post(params, tree):
        return (poisson_branch_length_loglik(
            muts, tree.parent, tree.heights, params["clock.rate"],
            P21_THORNEY_SITES)
            + constant_coalescent_loglik(tree.heights, n_tips, 1.0))

    ops = [C.ConstrainedNNIOperator(groups=groups, weight=10.0),
           C.ConstrainedUniformSPROperator(groups=groups, weight=10.0),
           UniformNodeHeightOperator(weight=10.0),
           ScaleOperator(parameter="clock.rate", weight=2.0)]
    tree0 = make_tree_state(parent, children, heights, root, torch.float64,
                            dev)
    step = make_mcmc_step(log_post, ops)
    st = init_mcmc_state({"clock.rate": torch.tensor(
        1e-3, dtype=torch.float64, device=dev)}, tree0,
        torch.Generator(device=dev).manual_seed(P21_SEED), ops, log_post)
    reset_counts()
    t1 = time.perf_counter()
    st, _ = run_chain(step, st, n_steps)
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
    rec["chain_seconds"] = time.perf_counter() - t1
    rec["states_per_s"] = n_steps / rec["chain_seconds"]
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"P21c Thorney launched {counts}")
    fresh = log_post(st.params, st.tree)
    rec["full_evaluation_deviation"] = float(
        (fresh - st.log_posterior).abs())
    if not rec["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P21c deviation "
                             f"{rec['full_evaluation_deviation']!r}")
    if not clades_kept([tuple(getattr(st.tree, f).cpu().numpy() for f in (
            "parent", "children", "heights"))], clades, n_tips):
        raise AssertionError("P21c: a constraint clade was broken")
    rec["accepted"] = st.op_accept.tolist()
    wall, busy = device_ms(lambda: run_chain(step, st, n_profile),
                           "p21c thorney chain", n_profile)
    rec.update({"profile_ms_per_step": wall,
                "device_busy_share": None if busy is None else busy / wall,
                "device_events_per_step": device_ms.events,
                "seconds": time.perf_counter() - t0})
    log(f"[P21c] Thorney {n_tips} tips, {len(clades)} constraint clades "
        f"(built in {rec['build_seconds']:.2f} s): {n_steps} steps "
        f"{rec['states_per_s']:.2f} states/s, no launch, clades kept, "
        f"deviation {rec['full_evaluation_deviation']!r}, accepted "
        f"{rec['accepted']}; profile {wall:.3f} ms a step, busy share "
        f"{rec['device_busy_share']}, {device_ms.events} device events a "
        f"step")
    return rec, {"P21 21c thorney": counts}


def empirical_path(data, trees, reset_counts, read_counts, dev,
                   n_steps=P21_EMP_STEPS):
    """Phase 21c's empirical-tree chain: the trees (numpy parent,
    children, heights; 21a's start tree and its steps', the root the
    parentless node) stacked by stack_trees, EmpiricalTreeOperator alone,
    the GTR+Gamma4 tree likelihood of the padded patterns under the
    constant coalescent: n_steps steps of exactly one peel_stream launch
    each, the deviation. Returns (record, launches)."""
    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state, make_mcmc_step, run_chain)
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik)
    from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates
    from beast_mcmc_tpu_torch.models.substitution import gtr_eigen
    from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
    from beast_mcmc_tpu_torch.tree.empirical import (
        EmpiricalTreeOperator, stack_trees, tree_at)

    t0 = time.perf_counter()
    f64 = torch.float64
    n_taxa = data["states"].shape[0]
    ts = stack_trees([(p, c, h, int(np.flatnonzero(p < 0)[0]))
                      for p, c, h in trees], f64, dev)
    onehot = torch.nn.functional.one_hot(data["states"].clamp_max(3), 4)
    tips = torch.where((data["states"] >= 4)[..., None], 1, onehot) \
        .transpose(1, 2).to(f64).contiguous()
    freqs = data["freqs"].to(dev)
    eig = gtr_eigen(torch.tensor([1.0, 4.0, 0.6, 1.1, 4.2, 1.0], dtype=f64,
                                 device=dev), freqs)
    rates, cat_w = (x.to(dev) for x in discrete_gamma_rates(
        torch.tensor(0.5, dtype=f64), 4))
    clock = float(data["cfg"]["model"]["init"]["ucld.mean"])
    pop = float(data["cfg"]["pop_size"])

    def log_post(params, tree):
        return (tree_loglikelihood(tips, data["weights"], tree.parent,
                                   tree.children, tree.heights, tree.root,
                                   eig, freqs, rates, cat_w, clock)
                + constant_coalescent_loglik(tree.heights, n_taxa, pop))

    ops = [EmpiricalTreeOperator(trees=ts)]
    step = make_mcmc_step(log_post, ops)
    st = init_mcmc_state({}, tree_at(ts, 0),
                         torch.Generator(device=dev).manual_seed(P21_SEED),
                         ops, log_post)
    reset_counts()
    t1 = time.perf_counter()
    st, _ = run_chain(step, st, n_steps)
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()
    rec = {"trees": ts.n_trees, "chain_seconds": time.perf_counter() - t1}
    rec["states_per_s"] = n_steps / rec["chain_seconds"]
    counts = read_counts()
    want = {k: n_steps * (k == "peel_stream") for k in counts}
    if counts != want:
        raise AssertionError(f"P21c empirical: launches {counts}, expected "
                             f"{want}")
    fresh = log_post(st.params, st.tree)
    rec["full_evaluation_deviation"] = float(
        (fresh - st.log_posterior).abs())
    if not rec["full_evaluation_deviation"] <= FULL_EVAL_TOL:
        raise AssertionError(f"P21c empirical deviation "
                             f"{rec['full_evaluation_deviation']!r}")
    rec["accepted"] = st.op_accept.tolist()
    rec["seconds"] = time.perf_counter() - t0
    log(f"[P21c] empirical trees: {ts.n_trees} trees, {n_steps} steps "
        f"{rec['states_per_s']:.2f} states/s, launches {counts}, accepted "
        f"{rec['accepted']}, deviation {rec['full_evaluation_deviation']!r}")
    return rec, {"P21 21c empirical": counts}


def species_tree_of(parent, children, heights, root, n_tips, n_species):
    """(species parent, species heights, tip_species) numpy: n_species
    clades of a gene tree (the largest clade split in two until there are
    n_species) as species tips at height 0, the splitting nodes as the
    species tree's internal nodes at 0.95 of the gene node's height, so
    the gene tree is compatible and its coalescences interleave with the
    divergences."""
    import numpy as np

    def tips_under(v):
        out, stack = [], [v]
        while stack:
            x = stack.pop()
            if x < n_tips:
                out.append(x)
            else:
                stack.extend(int(c) for c in children[x])
        return out

    clades = [int(root)]
    splits = []
    while len(clades) < n_species:
        big = max((c for c in clades if c >= n_tips),
                  key=lambda c: len(tips_under(c)))
        clades.remove(big)
        clades.extend(int(c) for c in children[big])
        splits.append(big)
    s = 2 * n_species - 1
    sp_parent = np.full(s, -1)
    sp_heights = np.zeros(s)
    index = {c: i for i, c in enumerate(clades)}
    for j, g in enumerate(reversed(splits)):  # the root split last
        index[g] = n_species + j
        sp_heights[n_species + j] = 0.95 * heights[g]
    for g in splits:
        for c in children[g]:
            sp_parent[index[int(c)]] = index[g]
    tip_species = np.zeros(n_tips, np.int64)
    for c in clades:
        tip_species[tips_under(c)] = index[c]
    return sp_parent, sp_heights, tip_species


def p21_function_cases(data, seed=P21_SEED):
    """{label: fn(dev) -> tensor} of 21d on the host-made inputs of `seed`
    (numpy), each evaluated on a device from the same numbers: the msc and
    alloppnet densities of the start tree (a gene tree of n taxa) under
    an 8-species tree and an 8-tip MUL-tree; transmission and
    case-to-case densities of P21_HOSTS hosts; the DP Gibbs sweep of
    P21_ITEMS items at injected uniforms and the CRP, ddCRP and HDP
    priors; MDS and the antigenic likelihood of P21_LOCATIONS locations
    in 2 dimensions, the MDS gradient and both drift priors; Hawkes on
    P21_EVENTS events; point_in_polygon on P21_POINTS points and
    lattice_rate_matrix on a P21_RASTER square raster; the regressions on
    P21_ROWS rows; the hypermutation partials at the data's shape."""
    import math

    import numpy as np
    import torch

    from beast_mcmc_tpu_torch.models import (
        alloppnet, casetocase, clustering, geo, hawkes, mds, msc, regression,
        tipstates, transmission)
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    rng = np.random.default_rng(seed)
    f64 = torch.float64
    parent, children, heights, root = data["tree"]
    n_taxa = len(parent) // 2 + 1
    sp_parent, sp_heights, tip_species = species_tree_of(
        parent, children, heights, root, n_taxa, P21_SPECIES)
    sp_pops = rng.uniform(0.5, 2.0, len(sp_parent))
    # a network of 4 diploid and 2 tetraploid tips (an 8-tip MUL-tree),
    # every height below the gene tree's lowest coalescence
    low = 0.9 * float(heights[n_taxa:].min())
    net = dict(dip_parent=[4, 4, 5, 6, 5, 6, -1],
               dip_children=[[-1, -1]] * 4 + [[0, 1], [4, 2], [5, 3]],
               dip_heights=np.array([0, 0, 0, 0, 0.3, 0.6, 0.9]) * low,
               dip_root=6, tet_parent=[2, 2, -1],
               tet_children=[[-1, -1], [-1, -1], [0, 1]],
               tet_heights=np.array([0, 0, 0.2]) * low, tet_root=2,
               leg_a=1, leg_b=2, hyb_height=0.25 * low)
    mul_species = rng.integers(0, 8, n_taxa)
    mul_pops = rng.uniform(0.5, 2.0, 15)

    # transmission and case-to-case: one tip a host, the painting of
    # initial_painting, each host infected on the branch above its subtree
    hp, hc, hh, hr = simulate_coalescent_tree(rng, rng.uniform(
        0, 0.5, P21_HOSTS), 1.0)
    painting = casetocase.initial_painting(hp, hc, hr, P21_HOSTS)
    case_root = np.full(P21_HOSTS, -1)
    for v in range(len(hp)):
        if v == hr or painting[v] != painting[hp[v]]:
            case_root[painting[v]] = v
    frac = rng.uniform(0.05, 0.95, P21_HOSTS)
    donor = np.where(case_root == hr, np.arange(P21_HOSTS),
                     painting[np.maximum(hp[case_root], 0)])
    t_inf = np.where(case_root == hr, np.inf, hh[case_root] + frac * (
        hh[np.maximum(hp[case_root], 0)] - hh[case_root]))
    host_pops = rng.uniform(0.2, 2.0, P21_HOSTS)
    dist = rng.uniform(0, 10, (P21_HOSTS, P21_HOSTS))

    # clustering: a 1-D normal mixture
    items = np.concatenate([rng.normal(m, 0.5, P21_ITEMS // 4)
                            for m in (-3, 0, 2, 5)])
    assign0 = rng.integers(0, 6, P21_ITEMS)
    sweep_u = rng.random(P21_ITEMS)
    links = rng.integers(0, P21_ITEMS, P21_ITEMS)
    item_d = np.abs(items[:, None] - items[None, :])
    hdp_counts = rng.integers(0, 30, (40, 20))
    hdp_beta = rng.dirichlet(np.ones(20))

    # MDS and the antigenic likelihood
    locs = rng.normal(0, 3, (P21_LOCATIONS, 2))
    true = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    observed = true + rng.normal(0, 0.3, true.shape)
    mask = np.triu(rng.random(true.shape) < 0.3, 1)
    n_meas = 10 * P21_LOCATIONS
    vi = rng.integers(0, P21_LOCATIONS, n_meas)
    si = rng.integers(0, 200, n_meas)
    sera = rng.normal(0, 3, (200, 2))
    mtypes = rng.integers(0, 4, n_meas)
    potency = rng.uniform(6, 10, 200)
    avidity = rng.normal(0, 0.5, P21_LOCATIONS)
    v_off = rng.uniform(0, 10, P21_LOCATIONS)
    s_off = rng.uniform(0, 10, 200)
    # titres drawn about the model's own expectation (drift 0.1, sd of
    # precision 1.5), so that no interval's two cdfs both round to 1
    shift = np.zeros((1, 2))
    shift[0, 0] = 0.1
    gap = (locs[vi] + shift * v_off[vi, None]
           - sera[si] - shift * s_off[si, None])
    titres = (potency[si] + avidity[vi] - np.sqrt((gap ** 2).sum(1))
              + rng.normal(0, 1.5 ** -0.5, n_meas))

    # Hawkes, geo, regression, hypermutation
    ev_x = rng.normal(0, 1, (P21_EVENTS, 2))
    ev_t = np.sort(rng.uniform(0, 100, P21_EVENTS))
    pts = rng.uniform(-1.2, 1.2, (P21_POINTS, 2))
    ang = np.linspace(0, 2 * np.pi, 50, endpoint=False)
    star = np.stack([np.cos(ang), np.sin(ang)], 1) * np.where(
        np.arange(50) % 2, 0.45, 1.0)[:, None]
    valid = rng.random((P21_RASTER, P21_RASTER)) < 0.7
    cell_rates = rng.uniform(0.5, 2.0, (P21_RASTER, P21_RASTER))
    design = rng.normal(0, 1, (P21_ROWS, 5))
    beta = rng.normal(0, 0.3, 5)
    y_lin = np.exp(design @ beta + rng.normal(0, 0.2, P21_ROWS))
    y_bin = (rng.random(P21_ROWS) < 0.5).astype(float)
    y_cnt = rng.poisson(2.0, P21_ROWS).astype(float)
    sccs_n = rng.poisson(1.0, (P21_ROWS // 10, 10)).astype(float)
    sccs_x = rng.normal(0, 1, (P21_ROWS // 10, 10, 5))
    sccs_e = np.log(rng.uniform(0.1, 1.0, (P21_ROWS // 10, 10)))
    sccs_e[:, -2:] = -np.inf
    states = data["states"].cpu().numpy()
    ctx = rng.random(states.shape) < 0.2
    hyper = rng.random(states.shape[0]) < 0.3

    def T(x, d, dt=f64):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=d)

    def L(x, d):
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=d)

    def net_on(d):
        return alloppnet.AlloppNetwork(*(
            T(net[f], d) if f.endswith(("heights", "height")) else L(net[f], d)
            for f in alloppnet.AlloppNetwork._fields))

    def predictive(x):
        def fn(i, k, a):
            member = (a == k).to(x.dtype)
            n = member.sum()
            mean = (member * x).sum() / (n + 1.0)  # a N(0, 1) prior mean
            var = 0.25 + 1.0 / (n + 1.0)
            return -0.5 * (x[i] - mean) ** 2 / var - 0.5 * torch.log(
                2 * math.pi * var)
        return fn

    def sweep(d):
        x = T(items, d)
        out = clustering.dp_gibbs_sweep(None, L(assign0, d), predictive(x),
                                        0.7, 16, uniforms=T(sweep_u, d))
        return out.to(f64)

    def mds_grad(d):
        return mds.mds_location_gradient(T(observed, d),
                                         torch.as_tensor(mask, device=d),
                                         T(locs, d), 2.0)

    return {
        "msc": lambda d: msc.multispecies_coalescent_loglik(
            L(parent, d), L(children, d), T(heights, d), L(tip_species, d),
            L(sp_parent, d), T(sp_heights, d), T(sp_pops, d)),
        "alloppnet": lambda d: alloppnet.alloppnet_gene_tree_loglik(
            L(parent, d), L(children, d), T(heights, d), L(mul_species, d),
            net_on(d), T(mul_pops, d)),
        "alloppnet MUL-tree heights": lambda d: alloppnet.mul_tree(
            net_on(d))[2],
        "transmission": lambda d: transmission.transmission_loglik(
            L(hp, d), L(hc, d), T(hh, d), P21_HOSTS,
            L(np.arange(P21_HOSTS), d), L(donor, d), T(t_inf, d),
            T(host_pops, d)),
        "casetocase": lambda d: casetocase.case_to_case_loglik(
            L(hp, d), L(hc, d), T(hh, d), L(hr, d), L(painting, d),
            P21_HOSTS, T(hh[:P21_HOSTS], d), T(frac, d), 2.0, 0.3, 1.5,
            T(dist, d), 0.2),
        "casetocase infection times": lambda d: casetocase.infection_events(
            L(hp, d), L(painting, d), T(hh, d), L(hr, d), P21_HOSTS,
            T(frac, d))[0],
        "dp_gibbs_sweep": sweep,
        "crp prior": lambda d: clustering.crp_log_prior(
            L(assign0, d), 0.7, 16),
        "ddcrp prior": lambda d: clustering.ddcrp_log_prior(
            L(links, d), T(item_d, d), 0.7, 2.0),
        "hdp prior": lambda d: clustering.hdp_log_prior(
            L(hdp_counts, d), T(hdp_beta, d), 3.0, 2.0),
        "mds": lambda d: mds.mds_loglikelihood(
            T(observed, d), torch.as_tensor(mask, device=d), T(locs, d), 2.0),
        "mds gradient": mds_grad,
        "antigenic": lambda d: mds.antigenic_loglikelihood(
            T(titres, d), L(mtypes, d), L(vi, d), L(si, d), T(locs, d),
            T(sera, d), T(potency, d), 1.5, T(avidity, d), 0.1,
            T(v_off, d), T(s_off, d)),
        "antigenic drift prior (mds)": lambda d: mds.antigenic_drift_prior(
            T(locs, d), T(v_off, d), 0.3, 0.8),
        "antigenic drift prior (clustering)":
            lambda d: clustering.antigenic_drift_prior(
                T(locs, d), T(v_off, d), 0.3, 0.8),
        "hawkes": lambda d: hawkes.hawkes_loglikelihood(
            T(ev_x, d), T(ev_t, d), 4.0, 1.0, 0.05, 0.5, 0.4, 50.0),
        "hawkes rates": lambda d: torch.cat(hawkes.hawkes_event_rates(
            T(ev_x, d), T(ev_t, d), 4.0, 1.0, 0.05, 0.5, 0.4, 50.0)),
        "point_in_polygon": lambda d: geo.point_in_polygon(
            T(pts, d), T(star, d)).to(f64),
        "lattice_rate_matrix": lambda d: geo.lattice_rate_matrix(
            torch.as_tensor(valid, device=d), T(cell_rates, d)),
        "great_circle_distance": lambda d: geo.great_circle_distance(
            T(pts * 60, d), T(pts[::-1] * 60, d)),
        "linear regression": lambda d: regression.linear_regression_loglik(
            T(y_lin, d), T(design, d), T(beta, d), 2.0, log_transform=True),
        "logistic regression": lambda d: regression.glm_loglik(
            "logistic", T(y_bin, d), T(design, d), T(beta, d)),
        "log-linear regression": lambda d: regression.glm_loglik(
            "poisson", T(y_cnt, d), T(design, d), T(beta, d)),
        "sccs": lambda d: regression.sccs_conditional_loglik(
            T(sccs_n, d), T(sccs_x, d), T(beta, d), T(sccs_e, d)),
        "hypermutant_error_partials":
            lambda d: tipstates.hypermutant_error_partials(
                L(states, d), torch.as_tensor(ctx, device=d),
                torch.as_tensor(hyper, device=d), 0.3),
    }


def p21_functions_path(data, dev, seed=P21_SEED):
    """Phase 21d: p21_function_cases on the card and on the CPU, each
    output's largest deviation over its largest magnitude held to
    P21_REL_TOL (the sweep's assignments exactly). Returns the record."""
    t0 = time.perf_counter()
    cases = p21_function_cases(data, seed)
    worst = {}
    for label, fn in cases.items():
        got = fn(dev)
        want = fn("cpu")
        worst[label] = _hold(f"P21d {label}", got.reshape(-1),
                             want.reshape(-1), P21_REL_TOL)
        if label == "dp_gibbs_sweep" and worst[label] != 0.0:
            raise AssertionError("P21d dp_gibbs_sweep: the seats differ")
    top = max(worst, key=worst.get)
    rec = {"functions": len(worst), "max_rel_err": worst[top], "worst": top,
           "rel_err": worst, "seconds": time.perf_counter() - t0}
    log(f"[P21d] {len(worst)} functions on the card against the CPU in "
        f"{rec['seconds']:.2f} s: largest deviation {worst[top]!r} ({top}; "
        f"tolerance {P21_REL_TOL})")
    return rec


def c7_document(path, data):
    """The C7 check's document on makona_data's taxa and alignment:
    _seq_models_xml's HKY+Gamma4 tree likelihood with a <gradient> over
    kappa, the frequencies and the clock rate (6 values, so the report
    takes the Hessian diagonal)."""
    out = ['<?xml version="1.0" standalone="yes"?>', "<beast>"]
    out += taxa_alignment_xml(data)
    out.append(_seq_models_xml(data))
    out.append("""  <gradient id="c7Gradient">
    <treeDataLikelihood idref="treeLikelihood"/>
    <parameter idref="kappa"/><parameter idref="frequencies"/>
    <parameter idref="clock.rate"/>
  </gradient>
</beast>
""")
    with open(path, "w") as f:
        f.write("\n".join(out))


def c7_path(out_dir, dev, n_taxa=P21_C7_TAXA, n_sites=P21_C7_SITES):
    """Fault C7's check: the <gradient> report of c7_document on the card
    (the tree likelihood's Hessian diagonal through the plain peel under
    autograd_peel) against the CPU's, each analytic line (gradient,
    Hessian) to P21_C7_TOL of its largest entry; the numeric lines'
    deviations reported. Returns the record."""
    import re

    import numpy as np

    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.config.xml_assert import report_of

    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    data = makona_data(n_taxa, n_sites, JOINT_SEED, dev)
    doc = os.path.join(out_dir, "makona_c7.xml")
    c7_document(doc, data)
    lines = {}
    for d in (dev, "cpu"):
        ax = XmlAnalysis(doc, seed=P21_SEED, device=d, workdir=out_dir)
        text = report_of(ax, ax._ids["c7Gradient"])
        if "\nHessian\n" not in text:
            raise AssertionError(f"C7 report on {d}: {text}")
        vals = []
        for section in text.split("\nHessian\n"):
            for key in ("analytic:", "numeric :"):
                m = re.search(re.escape(key) + r" \[(.*?)\]", section)
                vals.append(np.array([float(x) for x in m.group(1).split(
                    ",")]))
        lines[d] = vals
    names = ("gradient analytic", "gradient numeric", "Hessian analytic",
             "Hessian numeric")
    rel = {}
    for i, nm in enumerate(names):
        a, b = lines[dev][i], lines["cpu"][i]
        rel[nm] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
    for nm in ("gradient analytic", "Hessian analytic"):
        if not rel[nm] <= P21_C7_TOL:
            raise AssertionError(f"C7 {nm}: {rel[nm]!r} > {P21_C7_TOL}")
    rec = {"taxa": n_taxa, "sites": n_sites, "values": len(lines["cpu"][0]),
           "rel_err": rel, "hessian": lines[dev][2].tolist(),
           "seconds": time.perf_counter() - t0}
    log(f"[P21 C7] <gradient> report over kappa, frequencies and clock.rate "
        f"({rec['values']} values) at {n_taxa} taxa x {n_sites} sites, card "
        f"against CPU: " + ", ".join(f"{k} {v!r}" for k, v in rel.items())
        + f" (analytic lines to {P21_C7_TOL}); Hessian {rec['hessian']}; "
        f"{rec['seconds']:.2f} s")
    return rec


def p21_paths(out_dir, reset_counts, read_counts, device_ms, dev,
              n_taxa=SPEC_TAXA, n_sites=SPEC_SITES, steps=P21_STEPS,
              arg_events=P21_ARG_EVENTS, arg_steps=P21_ARG_STEPS,
              thorney_tips=P21_THORNEY_TIPS, thorney_steps=P21_THORNEY_STEPS,
              emp_trees=P21_EMP_TREES, emp_steps=P21_EMP_STEPS,
              c7=(P21_C7_TAXA, P21_C7_SITES)):
    """Phase 21 (see the module docstring): 21a to 21d and the C7 check.
    Returns (record, launches)."""
    t0 = time.perf_counter()
    data = p21_data(dev, n_taxa, n_sites)
    rec = {"taxa": n_taxa, "sites": data["sites"],
           "patterns": data["patterns"], "data_seconds":
           time.perf_counter() - t0}
    rec["21a"], launches, trees = covarion_path(
        data, reset_counts, read_counts, device_ms, dev, steps)
    rec["21b"], more = arg_path(data, reset_counts, read_counts, device_ms,
                                dev, arg_events, arg_steps)
    launches.update(more)
    rec["21c"], more = thorney_path(reset_counts, read_counts, device_ms,
                                    dev, thorney_tips, thorney_steps)
    launches.update(more)
    rec["21c empirical"], more = empirical_path(
        data, trees[:emp_trees], reset_counts, read_counts, dev, emp_steps)
    launches.update(more)
    rec["21d"] = p21_functions_path(data, dev)
    rec["C7"] = c7_path(out_dir, dev, *c7)
    return rec, launches


# phase 22: the multi-process layer (beast_mcmc_tpu_torch/parallel/), two
# gloo ranks of the worker entry sharing the card, started once for 22a and
# 22b, and a one-rank NCCL world in this process (22c)
P22_RANKS = 2
P22_LIK = (1610, 4, 2048)  # 22a: taxa, categories, patterns (Makona's width)
P22_LIK_MESH = "1x2"
P22_DRY = (1441, 128)  # 22b: benchmark1's taxa, JAX dryrun's patterns
P22_DRY_MESHES = ("2x1", "1x2")
P22_ROUNDS, P22_SWAP_EVERY, P22_DELTA = 10, 12, 0.002  # JAX dryrun's
P22_SEED = 22
P22_TIMEOUT = 300  # seconds a rank may take, start-up included
P22_TOTAL_TOL = 1e-12  # the reduced total against this process's unsharded


def start_ranks(args, rendezvous, device, world=P22_RANKS):
    """Start `world` gloo ranks of `python -m beast_mcmc_tpu_torch.parallel`
    on one `device` with `args`."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the world is this host
    env.pop("LOCAL_RANK", None)
    return [subprocess.Popen(
        [sys.executable, "-m", "beast_mcmc_tpu_torch.parallel", "--init",
         f"file://{rendezvous}", "--world", str(world), "--rank", str(r),
         "--backend", "gloo", "--device", device, *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def finish_ranks(procs, timeout=P22_TIMEOUT):
    """Each rank's RESULT records; a rank that fails or outlives `timeout`
    fails the phase, and every rank is stopped."""
    results, failed = [], []
    deadline = time.perf_counter() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} did not end within {timeout} s")
                continue
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n"
                              f"{out[-2000:]}\n{err[-4000:]}")
            results.append([json.loads(line[len("RESULT "):])
                            for line in out.splitlines()
                            if line.startswith("RESULT ")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise AssertionError("P22: " + "\n".join(failed))
    return results


def parallel_path(reset_counts, read_counts, dev, out_dir=SMOKE_OUT,
                  lik=P22_LIK, dry=P22_DRY, rounds=P22_ROUNDS,
                  swap_every=P22_SWAP_EVERY, delta=P22_DELTA):
    """Phase 22 (see the module docstring): 22a and 22b on P22_RANKS gloo
    ranks of the worker sharing the card, while this process computes the
    unsharded total and runs 22c, a one-rank NCCL world. Returns (record,
    launches). The rendezvous files go into `out_dir`. With dev "cpu" (a
    rehearsal) the ranks are CPU ranks, 22c's world is gloo's and no
    kernel launches."""
    from beast_mcmc_tpu_torch.parallel import distributed
    from beast_mcmc_tpu_torch.parallel.__main__ import (
        FULL_EVAL_TOL, KERNELS, SITE_REL_TOL, SWAP_BAND, likelihood_inputs,
        likelihood_site_fn)
    from beast_mcmc_tpu_torch.parallel.mesh import make_mesh
    from beast_mcmc_tpu_torch.ops.cuda_peeling import peel_route
    from beast_mcmc_tpu_torch.utils.accum import stable_dot

    os.makedirs(out_dir, exist_ok=True)
    rdv = [os.path.join(out_dir, f"p22-{name}-{os.getpid()}")
           for name in ("gloo", "nccl")]
    for path in rdv:
        if os.path.exists(path):
            os.remove(path)
    n_taxa, n_cat, n_pat = lik
    args = ["likelihood", "--taxa", str(n_taxa), "--categories", str(n_cat),
            "--patterns", str(n_pat), "--mesh", P22_LIK_MESH, "--seed",
            str(P22_SEED)]
    for mesh in P22_DRY_MESHES:
        args += ["dryrun", "--taxa", str(dry[0]), "--patterns", str(dry[1]),
                 "--mesh", mesh, "--rounds", str(rounds), "--swap-every",
                 str(swap_every), "--delta", str(delta), "--seed",
                 str(P22_SEED)]
    device = "cpu" if dev == "cpu" else "cuda:0"
    t0 = time.perf_counter()
    procs = start_ranks(args, rdv[0], device)
    try:
        # this process, meanwhile: the unsharded total, then 22c
        site_fn, x = likelihood_site_fn(likelihood_inputs(*lik, P22_SEED),
                                        dev)
        reset_counts()
        unsharded = float(stable_dot(x["weights"], site_fn(x["tips"])))
        main_counts = read_counts()
        backend = "gloo" if dev == "cpu" else "nccl"
        distributed.initialize(f"file://{rdv[1]}", 1, 0, backend=backend,
                               device=device)
        try:
            reset_counts()
            nccl = float(distributed.sharded_pattern_loglik(
                make_mesh(1, 1), site_fn)(x["tips"], x["weights"]))
            nccl_counts = read_counts()
        finally:
            distributed.shutdown()
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    results = finish_ranks(procs)
    seconds = time.perf_counter() - t0
    rec = {"ranks": P22_RANKS, "seconds": seconds,
           "unsharded_total": unsharded, "22c": {
               "backend": backend, "mesh": [1, 1], "total": nccl,
               "equal_to_unsharded": nccl == unsharded,
               "launches": nccl_counts}}
    launches = {"P22 unsharded": main_counts, "P22 22c nccl": nccl_counts}
    n_modes = 1 + len(P22_DRY_MESHES)
    if [len(r) for r in results] != [n_modes] * P22_RANKS:
        raise AssertionError(f"P22: expected {n_modes} results a rank, got "
                             f"{[len(r) for r in results]}")
    # 22a: the pattern-sharded Makona likelihood
    lik_recs = [r[0] for r in results]
    kname = KERNELS[peel_route(2 * n_taxa - 1, n_cat, 4, 8)]
    totals = [r["total"] for r in lik_recs]
    rec["22a"] = {"mesh": lik_recs[0]["mesh"],
                  "shard_patterns": [r["shard_patterns"] for r in lik_recs],
                  "totals": totals,
                  "rel_err_vs_unsharded": abs(totals[0] - unsharded)
                  / abs(unsharded),
                  "kernel_vs_plain": [r["kernel_vs_plain"] for r in lik_recs],
                  "launches": [r["launches"] for r in lik_recs],
                  "rank_seconds": [r["seconds"] for r in lik_recs]}
    for r in lik_recs:
        launches[f"P22 22a rank {r['rank']}"] = r["launches"]
    # 22b: the dry run in each layout
    rec["22b"] = {}
    for m, mesh in enumerate(P22_DRY_MESHES):
        recs = [r[1 + m] for r in results]
        rec["22b"][mesh] = {k: [r[k] for r in recs] for k in (
            "slots", "patterns_local", "swap_acceptance", "swaps_accepted",
            "launches", "launches_per_batch_step",
            "full_evaluation_deviation", "kernel_vs_plain", "state_digest",
            "aggregate_states_per_s", "seconds")}
        rec["22b"][mesh]["cold_log_posterior"] = next(
            r["cold_log_posterior"] for r in recs
            if r["cold_log_posterior"] is not None)
        for r in recs:
            launches[f"P22 22b {mesh} rank {r['rank']}"] = r["launches"]
    log(f"[P22] {json.dumps(rec)}")

    def check(ok, what):
        if not ok:
            raise AssertionError(f"P22: {what}")

    def only(name, n):  # n launches of kernel `name` and no other
        return {**{k: 0 for k in main_counts},
                **({} if dev == "cpu" else {name: n})}

    check(main_counts == only(kname, 1), f"unsharded {main_counts}")
    check(len(set(totals)) == 1, f"22a: the ranks' totals differ {totals}")
    check(rec["22a"]["rel_err_vs_unsharded"] <= P22_TOTAL_TOL,
          f"22a: {totals[0]!r} against the unsharded {unsharded!r}")
    check(rec["22a"]["shard_patterns"] == [n_pat // P22_RANKS] * P22_RANKS,
          f"22a: shards {rec['22a']['shard_patterns']}")
    check(all(e <= SITE_REL_TOL for e in rec["22a"]["kernel_vs_plain"]),
          f"22a: a shard's {kname} vs plain {rec['22a']['kernel_vs_plain']}")
    # each rank: its shard's launch and the unsharded one
    check(all(c == only(kname, 2) for c in rec["22a"]["launches"]),
          f"22a: launches {rec['22a']['launches']}")
    dry_kname = KERNELS[peel_route(2 * dry[0] - 1, 4, 4, 8)]
    # the start, the batch steps, the full evaluation, the shard check
    expected = 1 + rounds * swap_every + 1 + 1
    for mesh, r in rec["22b"].items():
        check(all(SWAP_BAND[0] <= a <= SWAP_BAND[1]
                  for a in r["swap_acceptance"]),
              f"22b {mesh}: swap acceptance {r['swap_acceptance']}")
        check(all(c == only(dry_kname, expected) for c in r["launches"]),
              f"22b {mesh}: launches {r['launches']}, expected {expected} "
              f"of {dry_kname} a rank")
        check(all(d < FULL_EVAL_TOL for d in r["full_evaluation_deviation"]),
              f"22b {mesh}: deviation {r['full_evaluation_deviation']}")
        check(all(e <= SITE_REL_TOL for e in r["kernel_vs_plain"]),
              f"22b {mesh}: a shard's {dry_kname} vs plain "
              f"{r['kernel_vs_plain']}")
        check(len(set(map(json.dumps, r["swaps_accepted"]))) == 1,
              f"22b {mesh}: the ranks' swaps differ")
        check(math.isfinite(r["cold_log_posterior"]),
              f"22b {mesh}: cold chain {r['cold_log_posterior']}")
    chains, patterns = (rec["22b"][m] for m in P22_DRY_MESHES)
    check(len(set(chains["state_digest"])) == P22_RANKS,
          "22b 2x1: the chain shards' states are equal: their chains are "
          "copies")
    check(len(set(patterns["state_digest"])) == 1,
          f"22b 1x2: the pattern shards' states differ "
          f"{patterns['state_digest']}")
    check(nccl == unsharded, f"22c: {backend} total {nccl!r} against "
          f"{unsharded!r}")
    check(nccl_counts == only(kname, 1), f"22c: launches {nccl_counts}")
    return rec, launches


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

    # -- phase 17: marginal likelihoods, particles, the assertion layer --
    p17, p17_launches = mle_path(SMOKE_OUT, reset_counts, read_counts,
                                 device_ms, dev)
    p17["17b"], more = particles_path(doc, SMOKE_OUT, reset_counts,
                                      read_counts, dev)
    p17_launches.update(more)
    p17["17c"], more = oracles_path(SMOKE_OUT, reset_counts, read_counts,
                                    dev)
    p17_launches.update(more)
    p17["17d"] = p17_functions_path(SMOKE_OUT, dev)
    mark("17 marginal likelihood and particles")

    # -- phase 18: continuous phylogeography, the relaxed random walk ----
    p18, p18_launches = rrw_path(SMOKE_OUT, reset_counts, read_counts,
                                 device_ms, dev)
    p18["18b"] = p18_functions_path(SMOKE_OUT, dev)
    mark("18 continuous phylogeography")

    # -- phase 19: gradients and HMC, the phylogeographic GLM -----------
    p19, p19_launches = hmc_path(SMOKE_OUT, reset_counts, read_counts,
                                 device_ms, dev)
    more, more_launches = glm_path(SMOKE_OUT, reset_counts, read_counts,
                                   dev)
    p19.update(more)
    p19_launches.update(more_launches)
    p19["19c"] = p19_functions_path(
        SMOKE_OUT, dev, os.path.join(SMOKE_OUT, "p19", "makona_glm.xml"))
    mark("19 gradients, HMC and the GLM")

    # -- phase 20: phylogenetic factor analysis and the HMC skygrid -----
    p20, p20_launches = factor_path(SMOKE_OUT, reset_counts, read_counts,
                                    device_ms, dev)
    more, more_launches = skygrid_path(SMOKE_OUT, reset_counts, read_counts,
                                       dev)
    p20.update(more)
    p20_launches.update(more_launches)
    p20["20c"] = p20_functions_path(SMOKE_OUT, dev)
    mark("20 factor analysis and the HMC skygrid")

    # -- phase 21: the model families outside the XML vocabulary ---------
    p21, p21_launches = p21_paths(SMOKE_OUT, reset_counts, read_counts,
                                  device_ms, dev)
    mark("21 model families outside the XML vocabulary")

    # -- phase 22: the multi-process layer ------------------------------
    p22, p22_launches = parallel_path(reset_counts, read_counts, dev)
    mark("22 multi-process layer")

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
    p17a, p17b, p17c = p17["17a"], p17["17b"], p17["17c"]
    log(f"[summary p17] {p17['taxa']} taxa x {p17['sites']} sites "
        f"({p17['patterns']} patterns): 17a CLI -testxml "
        f"{p17a['cli_seconds']:.2f} s, ladder {p17a['ladder_states']} states "
        f"{p17a['ladder_states_per_s']} states/s (pilot "
        f"{p17a['pilot_states_per_s']}), peel_stream launches "
        f"{p17a['predicted_launches']} (predicted), rung deviation "
        f"{p17a['rung_deviation']!r}, GSS {p17a['gss_recomputed']!r} = "
        f"report; rung profile {p17a['profile_ms_per_step']:.3f} ms a step, "
        f"busy share {p17a['device_busy_share']}, "
        f"{p17a['device_events_per_step']} device events a step; 17b "
        f"{p17b['particles']} particles {p17b['aggregate_states_per_s']:.2f} "
        f"aggregate states/s (one chain, phase 12: "
        f"{p12['straight']['states_per_s']}), reload deviations "
        f"{max(p17b['reload_deviations'])!r}; 17c log m "
        f"{p17c['analytic']!r}: PS {p17c['ps']!r}, SS {p17c['ss']!r}, HM "
        f"{p17c['hm']!r}, GSS {p17c['gss']!r}; XML GSS {p17c['xml_gss']!r} "
        f"against {p17c['xml_analytic']!r}; 17d {p17['17d']['functions']} "
        f"functions, largest deviation {p17['17d']['max_rel_err']!r}; phase "
        f"{phases['17 marginal likelihood and particles']:.2f} s; on "
        f"{smi_line}")
    p18a = p18["18a"]
    log(f"[summary p18] {p18['taxa']} taxa x {p18['sites']} sites "
        f"({p18['patterns']} patterns) with 2-D locations: 18a CLI "
        f"{p18a['cli_seconds']:.2f} s, {p18a['states_per_s']} states/s, "
        f"peel_stream launches {p18a['predicted_launches']} (predicted), "
        f"deviation {p18a['full_evaluation_deviation']!r}, trait likelihood "
        f"{p18a['trait_ms']:.3f} ms, profile "
        f"{p18a['profile_ms_per_step']:.3f} ms a step, busy share "
        f"{p18a['device_busy_share']}, {p18a['device_events_per_step']} "
        f"device events a step; 18b {p18['18b']['functions']} functions, "
        f"largest deviation {p18['18b']['max_rel_err']!r}; phase "
        f"{phases['18 continuous phylogeography']:.2f} s; on {smi_line}")
    p19a, p19b = p19["19a"], p19["19b"]
    log(f"[summary p19] 19a {p19['taxa']} taxa x {p19['sites']} sites "
        f"({p19['patterns']} patterns): CLI {p19a['cli_seconds']:.2f} s, "
        f"{p19a['states_per_s']} states/s, peel_stream launches "
        f"{p19a['predicted_launches']} (predicted), deviation "
        f"{p19a['full_evaluation_deviation']!r}, node-height HMC proposal "
        f"{_median(p19a['hmc_proposal_ms'])} ms, busy share "
        f"{p19a['device_busy_share']}; 19b {p19['locations']} locations: "
        f"CLI {p19b['cli_seconds']:.2f} s, {p19b['states_per_s']} states/s, "
        f"peel_stream launches {p19b['predicted_launches']} (predicted), "
        f"deviation {p19b['full_evaluation_deviation']!r}, coefficient HMC "
        f"proposal {_median(p19b['hmc_proposal_ms'])} ms, "
        f"peak {p19b['peak_allocated_gib']} GiB; 19c "
        f"{p19['19c']['functions']} functions, largest deviation "
        f"{p19['19c']['max_rel_err']!r}, basta "
        f"{p19['19c']['basta_ms']:.3f} ms; phase "
        f"{phases['19 gradients, HMC and the GLM']:.2f} s; on {smi_line}")
    p20a, p20b = p20["20a"], p20["20b"]
    log(f"[summary p20] 20a {p20['taxa']} taxa x {p20['sites']} sites "
        f"({p20['patterns']} patterns), {p20['traits']} traits on "
        f"{p20['factors']} factors: CLI {p20a['cli_seconds']:.2f} s, "
        f"{p20a['states_per_s']} states/s, peel_stream launches "
        f"{p20a['predicted_launches']} (predicted), deviation "
        f"{p20a['full_evaluation_deviation']!r}, loadings HMC proposal "
        f"{_median(p20a['hmc_proposal_ms'])} ms, tip-factor draw "
        f"{p20a['factor_draw_ms']:.3f} ms, busy share "
        f"{p20a['device_busy_share']}; 20b skygrid CLI -testxml "
        f"{p20b['cli_seconds']:.2f} s, {p20b['states_per_s']} states/s, "
        f"peel_stream launches {p20b['predicted_launches']} (predicted), "
        f"deviation {p20b['full_evaluation_deviation']!r}, field HMC "
        f"proposal {_median(p20b['hmc_proposal_ms'])} ms; 20c "
        f"{p20['20c']['functions']} functions, largest deviation "
        f"{p20['20c']['max_rel_err']!r}; phase "
        f"{phases['20 factor analysis and the HMC skygrid']:.2f} s; on "
        f"{smi_line}")
    p21a, p21b, p21c, p21e = (p21[k] for k in ("21a", "21b", "21c",
                                               "21c empirical"))
    log(f"[summary p21] {p21['taxa']} taxa x {p21['sites']} sites "
        f"({p21['patterns']} patterns): 21a covarion S = 8 "
        f"{p21a['states_per_s']:.2f} states/s, peel_stream_ring launches "
        f"{p21_launches['P21 21a chain']['peel_stream_ring']} in "
        f"{P21_STEPS} steps, kernel vs plain "
        f"{p21a['kernel_max_rel_err']!r}, deviation "
        f"{p21a['full_evaluation_deviation']!r}, busy share "
        f"{p21a['device_busy_share']}, {p21a['constraint_clades']} clades "
        f"kept; stochastic mapping over {p21a['branches']} branches card vs "
        f"CPU {p21a['expected_jumps_rel_err']!r}, "
        f"{p21a['dwell_rel_err']!r}; 21b ARG {p21b['reassortments']} "
        f"reassortments, level route vs plain "
        f"{p21b['kernel_max_rel_err']!r}, "
        f"{p21b['ms_per_evaluation']:.3f} ms an evaluation, "
        f"{p21b['states_per_s']:.2f} states/s, peel_stream launches "
        f"{p21_launches['P21 21b chain']['peel_stream']}, deviation "
        f"{p21b['full_evaluation_deviation']!r}; 21c Thorney "
        f"{p21c['tips']} tips {p21c['states_per_s']:.2f} states/s, busy "
        f"share {p21c['device_busy_share']}, deviation "
        f"{p21c['full_evaluation_deviation']!r}; empirical "
        f"{p21e['trees']} trees {p21e['states_per_s']:.2f} states/s, "
        f"deviation {p21e['full_evaluation_deviation']!r}; 21d "
        f"{p21['21d']['functions']} functions, largest deviation "
        f"{p21['21d']['max_rel_err']!r} ({p21['21d']['worst']}); C7 "
        f"report card vs CPU {json.dumps(p21['C7']['rel_err'])}; phase "
        f"{phases['21 model families outside the XML vocabulary']:.2f} s; "
        f"on {smi_line}")
    p22a, p22c = p22["22a"], p22["22c"]
    log(f"[summary p22] {P22_RANKS} gloo ranks sharing the card: 22a "
        f"{P22_LIK} on a {P22_LIK_MESH} mesh, {p22a['shard_patterns']} "
        f"patterns a rank, totals {p22a['totals']} against the unsharded "
        f"{p22['unsharded_total']!r} ({p22a['rel_err_vs_unsharded']!r}), "
        f"each shard's peel vs plain {p22a['kernel_vs_plain']}; 22b "
        f"{P22_DRY} " + "; ".join(
            f"{m}: swap acceptance {r['swap_acceptance']}, launches a batch "
            f"step {r['launches_per_batch_step']}, deviation "
            f"{r['full_evaluation_deviation']}, shard peel vs plain "
            f"{r['kernel_vs_plain']}, cold log posterior "
            f"{r['cold_log_posterior']!r}, aggregate states/s a rank "
            f"{r['aggregate_states_per_s']}" for m, r in p22["22b"].items())
        + f"; 22c one NCCL rank {p22c['total']!r}, equal to the unsharded "
        f"{p22c['equal_to_unsharded']}; phase "
        f"{phases['22 multi-process layer']:.2f} s; on {smi_line}")
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
                             **p16_launches, **p17_launches,
                             **p18_launches, **p19_launches,
                             **p20_launches, **p21_launches,
                             **p22_launches}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

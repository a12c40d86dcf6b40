"""Analyses with the shape of the reference's benchmark configurations.

Counterpart of beast_mcmc_tpu/apps/benchmarks.py. benchmark2.xml is 62
taxa, 5,565 patterns, GTR+Gamma4, strict clock, constant coalescent; the
Makona shape is the same model on 1,610 taxa and 2,048 patterns;
benchmark1.xml is 1,441 taxa, HKY on three codon-position partitions of 593
patterns each with their own kappa and relative rate ("hky_codon3"). Sequence
content is random from a fixed seed (throughput depends on shapes, not on
nucleotides); the same seed gives the same tips, weights and start tree as
the JAX package's build_analysis.

`build_joint_analysis` is the Makona-1610 joint analysis of
examples/makona_joint.xml (the model that bench.py::measure_makona_joint
steps): GTR+Gamma4 under a discretised lognormal relaxed clock, a skygrid
coalescent, and an asymmetric K-location CTMC with BSSVS indicators on the
same tree, as the eight components of the JAX package's posterior, with
the document's fourteen operators. apps/makona.py reads the document and
simulates its inputs.

`measure_makona_joint` is bench.py::measure_makona_joint: the same
document built by the port's XML interpreter (its XmlAnalysis, the
interpreter's own alignment simulation) and stepped with the component
cache, in float64.
"""

from __future__ import annotations

import os
import time
from typing import Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.component_cache import (
    decompose_likelihood,
    full_lp_fn,
    make_components,
    seed_components,
)
from beast_mcmc_tpu_torch.inference.mcmc import apply_derived
from beast_mcmc_tpu_torch.inference.operators import (
    TREE_HEIGHTS,
    BitFlipOperator,
    DeltaExchangeOperator,
    NarrowExchangeOperator,
    RandomWalkOperator,
    RootHeightScaleOperator,
    ScaleOperator,
    UniformNodeHeightOperator,
    UpDownOperator,
    WideExchangeOperator,
    WilsonBaldingOperator,
)
from beast_mcmc_tpu_torch.inference.tree_operators import SubtreeSlideOperator
from beast_mcmc_tpu_torch.models.clock import (
    default_rate_categories,
    discretized_clock_rates,
)
from beast_mcmc_tpu_torch.models.coalescent import (
    constant_coalescent_loglik,
    gmrf_log_prior,
    skygrid_cut_points,
    skygrid_loglik,
)
from beast_mcmc_tpu_torch.models.priors import (
    exponential_logpdf,
    gamma_logpdf,
    lognormal_logpdf,
    one_on_x_logpdf,
    poisson_logpmf,
)
from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates, single_rate
from beast_mcmc_tpu_torch.models.substitution import (
    general_complex_q,
    gtr_eigen,
    hky_eigen,
    svs_connectivity_logprior,
)
from beast_mcmc_tpu_torch.models.treelikelihood import (
    multipartition_loglikelihood,
    tree_loglikelihood,
    tree_loglikelihood_q,
)
from beast_mcmc_tpu_torch.ops.peeling import pad_patterns
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    simulate_coalescent_tree,
)
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


def synthetic_tips(n_taxa: int, n_patterns: int, seed: int,
                   dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Random unambiguous nucleotide tip partials [N, 4, P] + weights [P]."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 4, size=(n_taxa, n_patterns))
    tips = np.zeros((n_taxa, 4, n_patterns), dtype)
    for s in range(4):
        tips[:, s, :] = states == s
    weights = rng.integers(1, 10, size=n_patterns).astype(dtype)
    return tips, weights


def build_analysis(n_taxa: int = 62, n_patterns: int = 5565,
                   model: str = "gtr_gamma", seed: int = 0,
                   dtype: torch.dtype = DEFAULT_FLOAT,
                   pad_multiple: int = 128, device=DEFAULT_DEVICE):
    """Returns (log_post, operators, params0, tree0, aux).

    aux["derived"] is the eigensystem/gamma-rate cache for
    make_mcmc_step(derived=...), used with aux["log_post_cached"]; the plain
    log_post always recomputes both. For "hky_codon3" n_patterns is the
    count per partition, aux["tips"] is [3, N, 4, P] and aux["weights"]
    [3, P].

    aux["log_post_chains"] and aux["log_post_cached_chains"] are the same
    posteriors over a chain batch (params and tree with a leading chain
    axis, as inference/mc3.py::replicate_state makes them): [B] from one
    peel launch for all B chains, the port's form of jax.vmap(log_post);
    differentiable in every chain's heights and parameters (one backward
    of their sum gives each chain's gradient: one launch and one level
    adjoint), the port's form of jax.vmap(jax.grad(log_post)).
    aux["components"] is the posterior as the addends of
    inference/component_cache.py (`make_components`): the likelihood (from
    the derived cache where there is one), the coalescent and the two
    priors."""
    # float32 products on the card stay full precision (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tips_np, weights_np = synthetic_tips(n_taxa, n_patterns, seed, np.float32)
    tips = torch.as_tensor(tips_np).to(device=device, dtype=dtype)
    weights = torch.as_tensor(weights_np).to(device=device, dtype=dtype)
    tips, weights = pad_patterns(tips, weights, pad_multiple)
    freqs = torch.tensor([0.3, 0.2, 0.2, 0.3], dtype=dtype, device=device)

    rng = np.random.default_rng(seed + 1)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), pop_size=0.5)
    tree0 = make_tree_state(parent, children, heights, root, dtype, device)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    derived = {}
    if model == "gtr_gamma":
        derived = {
            "eig": (lambda p: gtr_eigen(p["gtr.rates"], freqs), ("gtr.rates",)),
            "site.rates": (
                lambda p: discrete_gamma_rates(p["alpha"], 4, dtype=dtype),
                ("alpha",),
            ),
        }

        def log_lik(params, tree, cached: bool = False):
            if cached:
                eig = params["eig"]
                rates, cat_w = params["site.rates"]
            else:
                eig = gtr_eigen(params["gtr.rates"], freqs)
                rates, cat_w = discrete_gamma_rates(params["alpha"], 4,
                                                    dtype=dtype)
            return tree_loglikelihood(
                tips, weights, tree.parent, tree.children, tree.heights,
                tree.root, eig, freqs, rates, cat_w, params["clock.rate"])

        params0 = {
            "gtr.rates": torch.ones(6, dtype=dtype, device=device),
            "alpha": scalar(0.5),
            "clock.rate": scalar(1.0),
            "pop.size": scalar(0.5),
        }
        extra_ops = [
            ScaleOperator(parameter="gtr.rates", weight=2.0),
            ScaleOperator(parameter="alpha", weight=1.0),
        ]
    elif model == "hky_codon3":
        k_parts = 3
        parts = [synthetic_tips(n_taxa, n_patterns, seed + 10 * k, np.float32)
                 for k in range(k_parts)]
        parts = [pad_patterns(
            torch.as_tensor(tp).to(device=device, dtype=dtype),
            torch.as_tensor(w).to(device=device, dtype=dtype), pad_multiple)
            for tp, w in parts]
        tips = torch.stack([tp for tp, _ in parts])  # [3, N, 4, P]
        weights = torch.stack([w for _, w in parts])  # [3, P]
        freqs3 = freqs.expand(k_parts, 4)
        base_rates, base_w = single_rate(dtype=dtype, device=device)
        cat_w = base_w.expand(k_parts, 1)

        def log_lik(params, tree):
            # no derived cache: one batched eigh of [3, 4, 4] per evaluation
            eigs = hky_eigen(params["kappa"], freqs3)
            cat_rates = params["mu"][..., None] * base_rates
            return multipartition_loglikelihood(
                tips, weights, tree.parent, tree.children, tree.heights,
                tree.root, eigs, freqs3, cat_rates, cat_w,
                params["clock.rate"])

        params0 = {
            "kappa": torch.full((k_parts,), 2.0, dtype=dtype, device=device),
            "mu": torch.ones(k_parts, dtype=dtype, device=device),
            "clock.rate": scalar(1.0),
            "pop.size": scalar(0.5),
        }
        extra_ops = [
            ScaleOperator(parameter="kappa", weight=3.0),
            DeltaExchangeOperator(parameter="mu", weight=3.0),
        ]
    elif model == "hky":
        def log_lik(params, tree):
            eig = hky_eigen(params["kappa"], freqs)
            rates, cat_w = single_rate(dtype=dtype, device=device)
            return tree_loglikelihood(
                tips, weights, tree.parent, tree.children, tree.heights,
                tree.root, eig, freqs, rates, cat_w, params["clock.rate"])

        params0 = {
            "kappa": scalar(2.0),
            "clock.rate": scalar(1.0),
            "pop.size": scalar(0.5),
        }
        extra_ops = [ScaleOperator(parameter="kappa", weight=1.0)]
    else:
        raise ValueError(model)

    def log_prior(params, tree, chains=False):
        return (one_on_x_logpdf(params["pop.size"], chains)
                + lognormal_logpdf(params["clock.rate"], 0.0, 1.0, chains)
                + constant_coalescent_loglik(tree.heights, n_taxa,
                                             params["pop.size"]))

    def log_post(params, tree):
        return log_lik(params, tree) + log_prior(params, tree)

    def log_post_chains(params, tree):
        return log_lik(params, tree) + log_prior(params, tree, True)

    if derived:
        def log_post_cached(params, tree):
            return log_lik(params, tree, cached=True) + log_prior(params, tree)

        def log_post_cached_chains(params, tree):
            return (log_lik(params, tree, cached=True)
                    + log_prior(params, tree, True))

        def lik_component(params, tree):
            return log_lik(params, tree, cached=True)
        params0 = apply_derived(derived, params0)
    else:
        log_post_cached, log_post_cached_chains = log_post, log_post_chains
        lik_component = log_lik

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
    aux = {
        "tips": tips, "weights": weights, "freqs": freqs,
        "log_lik": log_lik, "derived": derived,
        "log_post_cached": log_post_cached,
        "log_post_chains": log_post_chains,
        "log_post_cached_chains": log_post_cached_chains,
        "components": [
            (lik_component, "likelihood"),
            (lambda p, t: constant_coalescent_loglik(t.heights, n_taxa,
                                                     p["pop.size"]),
             "coalescent"),
            (lambda p, t: one_on_x_logpdf(p["pop.size"]), "pop.size prior"),
            (lambda p, t: lognormal_logpdf(p["clock.rate"], 0.0, 1.0),
             "clock.rate prior"),
        ],
    }
    return log_post, operators, params0, tree0, aux


# The constants of examples/makona_joint.xml (its <parameter> values, the
# skygrid's grid, the priors' settings); apps/makona.py reads the same
# keys from the document. Parameters are named by their XML ids, the two
# anonymous ones by their role (convert.py::JOINT_RENAMES).
MAKONA_JOINT = {
    "init": {
        "skygrid.precision": 0.1, "skygrid.logPopSize": [1.0] * 50,
        "skygrid.numGridPoints": 49.0, "skygrid.cutOff": 2.0,
        "initialDemo.popSize": 2.0, "ucld.mean": 0.0012,
        "frequencies": [0.32, 0.21, 0.19, 0.28], "gtr.ac": 1.0,
        "gtr.ag": 4.0, "gtr.at": 1.0, "gtr.cg": 1.0, "gtr.gt": 1.0,
        "siteModel.alpha": 0.3, "ucld.stdev": 0.3,
    },
    "gamma_categories": 4,
    "precision_prior": (0.001, 1000.0),  # gammaPrior shape, scale
    "rates_prior": (1.0, 1.0),  # gammaPrior on geo.rates
    "nonzero_mean": 38.8162,  # poissonPrior on the indicators' sum
    "ucld_mean_prior": 0.001,  # exponentialPrior mean
}

GTR_RATES = ("gtr.ac", "gtr.ag", "gtr.at", "gtr.cg", None, "gtr.gt")


def joint_params(model, n_taxa: int, n_locations: int,
                 dtype=DEFAULT_FLOAT, device=DEFAULT_DEVICE) -> dict:
    """The joint analysis's parameters at the model's initial values: the
    CTMC's K(K-1) rates and indicators at 1, uniform location
    frequencies, and the relaxed clock's categories as the XML layer
    assigns them."""
    k = n_locations
    out = {
        "geo.rates": torch.ones(k * (k - 1), dtype=dtype, device=device),
        "geo.indicators": torch.ones(k * (k - 1), dtype=dtype,
                                     device=device),
        "geo.frequencies": torch.full((k,), 1.0 / k, dtype=dtype,
                                      device=device),
        "branchRates.categories": default_rate_categories(2 * n_taxa - 1,
                                                          device),
    }
    out.update({name: torch.tensor(v, dtype=dtype, device=device)
                for name, v in model["init"].items()})
    return out


def gtr_site_model(params, n_categories: int, dtype=DEFAULT_FLOAT):
    """(eigensystem, freqs, category rates, category weights) of the
    sequence partition: GTR with rateCT fixed at 1, frequencies
    normalised, discrete Gamma."""
    f = params["frequencies"]
    freqs = f / torch.sum(f)
    one = torch.ones((), dtype=f.dtype, device=f.device)
    rates6 = torch.stack([params[n].reshape(()) if n else one
                          for n in GTR_RATES])
    rates, cat_w = discrete_gamma_rates(params["siteModel.alpha"],
                                        n_categories, dtype=dtype)
    return gtr_eigen(rates6, freqs), freqs, rates, cat_w


def geo_model(params):
    """(Q [K, K], normalised frequencies [K]) of the location trait: the
    asymmetric CTMC on the BSSVS-masked rates (rates x indicators)."""
    f = params["geo.frequencies"]
    return (general_complex_q(params["geo.rates"] * params["geo.indicators"],
                              f), f / torch.sum(f))


def clock_rates(params) -> torch.Tensor:
    """[M] branch rates of the discretised lognormal relaxed clock."""
    return discretized_clock_rates(params["branchRates.categories"],
                                   params["ucld.mean"], params["ucld.stdev"])


def build_joint_analysis(location_tips: np.ndarray, seq_tips: np.ndarray,
                         seq_weights: np.ndarray, tree, model=None,
                         dtype: torch.dtype = DEFAULT_FLOAT,
                         device=DEFAULT_DEVICE, params=None):
    """Returns (log_post, operators, params0, tree0, aux) of the joint
    analysis, from numpy: location_tips [N, K] (each taxon's location row,
    1 where allowed), seq_tips [N, 4, P] with seq_weights [P], and the
    starting tree (parent, children, heights, root) with the tips dated
    (their heights). `params` replaces the initial values (convert.py
    carries the JAX package's).

    The posterior is eight components (inference/component_cache.py), in
    the JAX package's order: gammaPrior (skygrid.precision), skygrid,
    gammaPrior (geo.rates), poissonPrior (the indicators' sum),
    originModel.connectivity, exponentialPrior (ucld.mean),
    treeLikelihood, geoLikelihood. log_post is their cache-free sum
    (`full_lp_fn`) and params0 holds the seeded cache. aux["components"]
    and aux["op_tree_flags"] go to make_mcmc_step(components=,
    op_tree_flags=); aux["tips"] and aux["geo_tips"] are the two
    partitions' tips on the device ([N, 4, P] padded, [N, K, 1]).

    The sequence partition's patterns are padded to a multiple of 128 and
    peel through the kernel the route gives them (1,610 taxa: peel_stream);
    the one-column trait stays unpadded and peels by the plain level peel
    (tree_loglikelihood_q)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = model or MAKONA_JOINT
    n_taxa, k = location_tips.shape
    seq_t, seq_w = pad_patterns(
        torch.tensor(seq_tips, dtype=dtype, device=device),
        torch.tensor(seq_weights, dtype=dtype, device=device),
        128 if seq_weights.shape[0] >= 32 else 1)
    geo_t = torch.tensor(location_tips, dtype=dtype,
                         device=device)[:, :, None]
    geo_w = torch.ones(1, dtype=dtype, device=device)
    tree0 = make_tree_state(*tree, dtype=dtype, device=device)
    cuts = skygrid_cut_points(int(model["init"]["skygrid.numGridPoints"]),
                              float(model["init"]["skygrid.cutOff"]), dtype,
                              device)
    n_cat = model["gamma_categories"]
    prec_shape, prec_scale = model["precision_prior"]
    rate_shape, rate_scale = model["rates_prior"]
    geo_rate, geo_w1 = single_rate(dtype=dtype, device=device)

    def skygrid(p, t):
        gamma = p["skygrid.logPopSize"]
        return (skygrid_loglik(t.heights, n_taxa, gamma, cuts)
                + gmrf_log_prior(gamma, p["skygrid.precision"]))

    def tree_likelihood(p, t):
        eig, freqs, rates, cat_w = gtr_site_model(p, n_cat, dtype)
        return tree_loglikelihood(seq_t, seq_w, t.parent, t.children,
                                  t.heights, t.root, eig, freqs, rates,
                                  cat_w, clock_rates(p))

    def geo_likelihood(p, t):
        q, freqs = geo_model(p)
        return tree_loglikelihood_q(geo_t, geo_w, t.parent, t.children,
                                    t.heights, t.root, q, freqs, geo_rate,
                                    geo_w1, 1.0)

    fns = [
        (lambda p, t: gamma_logpdf(p["skygrid.precision"], prec_shape,
                                   prec_scale), "gammaPrior"),
        (skygrid, "skygrid"),
        (lambda p, t: gamma_logpdf(p["geo.rates"], rate_shape, rate_scale),
         "gammaPrior"),
        (lambda p, t: poisson_logpmf(torch.sum(p["geo.indicators"]),
                                     model["nonzero_mean"]), "poissonPrior"),
        (lambda p, t: svs_connectivity_logprior(p["geo.indicators"], k),
         "originModel.connectivity"),
        (lambda p, t: exponential_logpdf(p["ucld.mean"],
                                         model["ucld_mean_prior"]),
         "exponentialPrior"),
        (tree_likelihood, "treeLikelihood"),
        (geo_likelihood, "geoLikelihood"),
    ]
    params0 = (params if params is not None
               else joint_params(model, n_taxa, k, dtype, device))
    comps = make_components(fns, params0, tree0)
    params0 = seed_components(params0, tree0, comps)
    # the document's operators, in its order and with its weights
    # (examples/makona_joint.xml:6628-6665)
    operators = [
        ScaleOperator(parameter="ucld.mean", weight=3.0),
        ScaleOperator(parameter="ucld.stdev", weight=3.0),
        ScaleOperator(parameter="siteModel.alpha", weight=1.0),
        ScaleOperator(parameter="gtr.ag", weight=1.0),
        ScaleOperator(parameter="skygrid.precision", weight=3.0),
        RandomWalkOperator(parameter="skygrid.logPopSize", window=0.5,
                           weight=10.0),
        SubtreeSlideOperator(size=0.05, gaussian=True, weight=15.0),
        NarrowExchangeOperator(weight=15.0),
        WideExchangeOperator(weight=3.0),
        WilsonBaldingOperator(weight=3.0),
        RootHeightScaleOperator(scale_factor=0.75, weight=3.0),
        UniformNodeHeightOperator(weight=30.0),
        ScaleOperator(parameter="geo.rates", mode="independent",
                      weight=15.0),
        BitFlipOperator(parameter="geo.indicators", weight=21.0),
    ]
    op_tree_flags = [op.modifies_params == () for op in operators]
    aux = {"components": comps, "op_tree_flags": op_tree_flags,
           "tips": seq_t, "geo_tips": geo_t}
    return full_lp_fn(comps), operators, params0, tree0, aux


MAKONA_JOINT_XML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, os.pardir, "examples",
                                "makona_joint.xml")


def xml_joint_chain(path: str = MAKONA_JOINT_XML,
                    device=DEFAULT_DEVICE) -> dict:
    """The chain of bench.py::measure_makona_joint for the document at
    `path`: the port's XmlAnalysis, the posterior of its <mcmc> decomposed
    into its leaves, each a component of the cache (seeded at the
    initial state, config/xml_assert.py::initial_eval_state), and
    make_mcmc_step over the document's operators with their tree flags.
    In float64 (the JAX package's float32 path fails its own self-check),
    the chain's generator seeded with 7 as bench.py seeds its key.
    Returns {"analysis", "operators", "tree_flags" (whether each operator
    moves the tree), "components", "log_post" (the cache-free sum),
    "step", "state"}."""
    from beast_mcmc_tpu_torch.config.interpreter import XmlAnalysis
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state
    from beast_mcmc_tpu_torch.inference.mcmc import (
        init_mcmc_state,
        make_mcmc_step,
    )

    ax = XmlAnalysis(path, scale=1.0, max_states=10, dtype=torch.float64,
                     device=device)
    mcmc_el = ax.root.find("mcmc")
    post = ax._posterior_of(mcmc_el)
    operators, tids = ax.build(ax.deref(mcmc_el.find("operators")))
    params0, tree0 = initial_eval_state(ax)
    comps = make_components([(lf.fn, lf.name)
                             for lf in decompose_likelihood(post)],
                            params0, tree0)
    params0 = seed_components(params0, tree0, comps)
    lp_fn = full_lp_fn(comps)
    flags = [t is not None for t in tids]
    step = make_mcmc_step(lp_fn, operators, components=comps,
                          op_tree_flags=flags)
    state = init_mcmc_state(
        params0, tree0, torch.Generator(device=device).manual_seed(7),
        operators, lp_fn, dtype=torch.float64)
    return {"analysis": ax, "operators": operators, "tree_flags": flags,
            "components": comps, "log_post": lp_fn, "step": step,
            "state": state}


def measure_makona_joint(path: str = MAKONA_JOINT_XML, n_steps: int = 192,
                         device=DEFAULT_DEVICE, n_warmup: int = 16,
                         record=None, counts=None) -> float:
    """States/s of the Makona-1610 joint analysis built from the document
    through the XML interpreter and stepped with the component-cached
    posterior (xml_joint_chain): n_warmup steps, then n_steps timed, then
    the carried log posterior held against a fresh evaluation (< 0.1).
    `record`, a dict, receives the chain, "seconds", "deviation",
    "log_posterior" and "steps_per_operator" (the timed steps' draws of
    each operator); `counts`, a (reset, read) pair, is reset just before
    the timed steps and read just after them into record["launches"]."""
    chain = xml_joint_chain(path, device)
    step, state, lp_fn = chain["step"], chain["state"], chain["log_post"]

    def sync():
        if state.log_posterior.device.type == "cuda":
            torch.cuda.synchronize(state.log_posterior.device)

    for _ in range(n_warmup):  # warm the caches
        state = step(state)
    sync()
    before = (state.op_accept + state.op_reject).tolist()
    if counts is not None:
        counts[0]()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = step(state)
    sync()
    dt = time.perf_counter() - t0
    launches = counts[1]() if counts is not None else None
    lp = float(state.log_posterior)
    assert lp == lp, "NaN posterior in Makona joint chain"
    # the carried-against-fresh self-check: the cache must stay exact
    fresh = float(lp_fn(state.params, state.tree))
    assert abs(lp - fresh) < 0.1, (lp, fresh)
    if record is not None:
        record.update(chain)
        record.update({
            "state": state, "seconds": dt, "deviation": abs(lp - fresh),
            "log_posterior": lp, "launches": launches,
            "steps_per_operator": [a - b for a, b in zip(
                (state.op_accept + state.op_reject).tolist(), before)]})
    return n_steps / dt

"""GY94+G4 codons at BEAST's benchmark1 size: 1,441 taxa, 593 patterns.

A frozen copy of the GY94+Gamma4 analysis the port's bring-up ran as its
one card-paced chain (`chip_smoke.py::codon_analysis(1441, 593,
n_categories=4)` with `_strict_clock_analysis`), on an alignment
simulated along its start tree: kappa, omega and alpha under scale
moves, uniform codon frequencies, a strict clock and a constant
coalescent, built from the program's own functions (the spec
builder has no codon model). The eigensystem and the Gamma rates are
derived entries, rebuilt only by the moves that change them. On the card
a 61-state tree of this size peels through the v1 streaming kernel
(`csrc/peel_stream_ring.cu`), one launch for every chain of a batch.
"""

from __future__ import annotations

import numpy as np


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The data both sides read: tip codon states [N, P] (0..60, the sense
    codons in ACGT order), pattern weights [P], tip heights [N] (all 0:
    contemporaneous tips) and the start tree (`parent`, `heights`). The
    sites are simulated from `seed` along that tree (a coalescent at
    `start_pop_size` from `tree_seed`, the same in every run) under the
    configuration's GY94+G4 and strict clock, as BEAST's
    beagleSequenceSimulator makes an alignment; its distinct columns with
    their counts, split back to `patterns` columns."""
    import torch

    from phylobench import simulate
    from phylobench.reference import _plain
    from phylobench.reference.codon_gy94g4_bench1 import _generators

    n = cfg["taxa"]
    tip_heights = np.zeros(n)
    parent, heights = simulate.coalescent_tree(
        np.random.default_rng(cfg["tree_seed"]), tip_heights,
        cfg["start_pop_size"])
    f64 = dict(dtype=torch.float64, device=device)
    q, freqs = _generators({"kappa": torch.tensor([cfg["kappa"]]),
                            "omega": torch.tensor([cfg["omega"]])},
                           torch.float64, device)
    cat_rates = torch.as_tensor(_plain.gamma_category_rates(
        np.asarray([cfg["alpha"]]), cfg["gamma_categories"])[0], **f64)
    gen = torch.Generator(device=device).manual_seed(int(
        np.random.default_rng([seed, 0x636f64]).integers(2 ** 62)))
    sites = simulate.sequences(parent, heights,
                               np.full(2 * n - 1, cfg["clock_rate"]), q[0],
                               freqs, cat_rates, cfg["patterns"], gen, device)
    states, weights = simulate.patterns(sites, cfg["patterns"])
    return {"states": states, "weights": weights, "tip_heights": tip_heights,
            "parent": parent, "heights": heights}


def build(cfg: dict, seed: int, device) -> dict:
    """The program's analysis on `device`: its chain-axis posterior (over
    the derived cache), operators, derived entries and start point, with
    the inputs the reference is handed."""
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
    from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates
    from beast_mcmc_tpu_torch.models.substitution import gy94_eigen
    from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state
    from phylobench import simulate

    dtype = getattr(torch, cfg["dtype"])
    inputs = make_inputs(cfg, seed, device)
    n, n_cat = cfg["taxa"], cfg["gamma_categories"]
    states = torch.as_tensor(inputs["states"], dtype=torch.long,
                             device=device)
    tips = torch.nn.functional.one_hot(states, 61).to(dtype).permute(
        0, 2, 1).contiguous()  # [N, 61, P]
    weights = torch.as_tensor(inputs["weights"], dtype=dtype, device=device)
    freqs = torch.full((61,), 1.0 / 61, dtype=dtype, device=device)
    parent = inputs["parent"]
    tree0 = make_tree_state(parent, simulate.children(parent),
                            inputs["heights"], parent.size - 1, dtype,
                            device)

    def eigen(params):
        return gy94_eigen(params["kappa"], params["omega"], freqs)

    def site_rates(params):
        return discrete_gamma_rates(params["alpha"], n_cat, dtype=dtype)

    def log_lik(params, tree):
        rates, cat_w = params["site.rates"]
        return tree_loglikelihood(
            tips, weights, tree.parent, tree.children, tree.heights,
            tree.root, params["eig"], freqs, rates, cat_w,
            params["clock.rate"])

    def log_post_chains(params, tree):
        return (log_lik(params, tree)
                + one_on_x_logpdf(params["pop.size"], True)
                + lognormal_logpdf(params["clock.rate"], 0.0, 1.0, True)
                + constant_coalescent_loglik(tree.heights, n,
                                             params["pop.size"]))

    derived = {"eig": (eigen, ("kappa", "omega")),
               "site.rates": (site_rates, ("alpha",))}
    params0 = apply_derived(derived, {
        k: torch.tensor(cfg[key], dtype=dtype, device=device)
        for k, key in (("kappa", "kappa"), ("omega", "omega"),
                       ("alpha", "alpha"), ("clock.rate", "clock_rate"),
                       ("pop.size", "pop_size"))})
    operators = [
        ScaleOperator(parameter="kappa", weight=1.0),
        ScaleOperator(parameter="omega", weight=1.0),
        ScaleOperator(parameter="alpha", weight=1.0),
        ScaleOperator(parameter="pop.size", weight=3.0),
        UpDownOperator(up=("clock.rate",), down=(TREE_HEIGHTS,), weight=3.0),
        UniformNodeHeightOperator(weight=15.0),
        RootHeightScaleOperator(weight=3.0),
        NarrowExchangeOperator(weight=15.0),
        WideExchangeOperator(weight=3.0),
        WilsonBaldingOperator(weight=3.0),
    ]
    return {"log_posterior_chains": log_post_chains, "operators": operators,
            "derived": derived, "params0": params0, "tree0": tree0,
            "inputs": inputs,
            "shape": {"taxa": n, "nodes": 2 * n - 1, "categories": n_cat,
                      "states": 61, "patterns": cfg["patterns"]}}

"""Analyses with the shape of the reference's benchmark configurations.

Counterpart of beast_mcmc_tpu/apps/benchmarks.py. benchmark2.xml is 62
taxa, 5,565 patterns, GTR+Gamma4, strict clock, constant coalescent; the
Makona shape is the same model on 1,610 taxa and 2,048 patterns. Sequence
content is random from a fixed seed (throughput depends on shapes, not on
nucleotides); the same seed gives the same tips, weights and start tree as
the JAX package's build_analysis.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.mcmc import apply_derived
from beast_mcmc_tpu_torch.inference.operators import (
    TREE_HEIGHTS,
    NarrowExchangeOperator,
    RootHeightScaleOperator,
    ScaleOperator,
    UniformNodeHeightOperator,
    UpDownOperator,
    WideExchangeOperator,
    WilsonBaldingOperator,
)
from beast_mcmc_tpu_torch.models.coalescent import constant_coalescent_loglik
from beast_mcmc_tpu_torch.models.priors import lognormal_logpdf, one_on_x_logpdf
from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates, single_rate
from beast_mcmc_tpu_torch.models.substitution import gtr_eigen, hky_eigen
from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
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
    log_post always recomputes both."""
    if model == "hky_codon3":
        raise NotImplementedError(
            "hky_codon3 needs the multipartition likelihood, which this "
            "package does not have yet")
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

    def log_prior(params, tree):
        return (one_on_x_logpdf(params["pop.size"])
                + lognormal_logpdf(params["clock.rate"], 0.0, 1.0)
                + constant_coalescent_loglik(tree.heights, n_taxa,
                                             params["pop.size"]))

    def log_post(params, tree):
        return log_lik(params, tree) + log_prior(params, tree)

    if derived:
        def log_post_cached(params, tree):
            return log_lik(params, tree, cached=True) + log_prior(params, tree)
        params0 = apply_derived(derived, params0)
    else:
        log_post_cached = log_post

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
    }
    return log_post, operators, params0, tree0, aux

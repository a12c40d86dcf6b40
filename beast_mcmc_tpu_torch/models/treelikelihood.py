"""Tree data likelihood: tree + substitution + site + clock -> logL.

Counterpart of beast_mcmc_tpu/models/treelikelihood.py. Where
ops/cuda_peeling.py::peel_route gives a shape the deep kernel (S = 4 trees
whose branch matrices overflow shared memory), the peel goes through
ops/cuda_stream2.py: by levels of depth from the root, with no height order,
all partitions in one launch (its plain version for CPU tensors). Every
other shape goes by the device: CUDA tensors to the kernels through
ops/cuda_peeling.py::peel_site_loglik_auto, with the schedule that
`peel_schedule` builds for the route (the level schedule for the resident
and matrix-product kernels too, the height order only for the v1 streaming
one); CPU tensors to the height-ordered plain peel.

Every function here is differentiable on every route and both devices, in
the heights, the branch rates, the eigensystem, the category rates and
weights and the frequencies: each peel is an autograd Function over the
peel's adjoint (ops/peeling.py).
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops.cuda_peeling import (
    peel_loglikelihood_auto,
    peel_route,
    peel_schedule,
    peel_site_loglik_auto,
)
from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule
from beast_mcmc_tpu_torch.ops.cuda_stream2 import peel_site_loglik_deep
from beast_mcmc_tpu_torch.ops.eigen import EigenSystem, transition_probs
from beast_mcmc_tpu_torch.ops.peeling import (
    peel_loglikelihood,
    peel_order_from_heights,
    peel_site_loglik,
)
from beast_mcmc_tpu_torch.utils.accum import stable_dot


def branch_lengths(parent: torch.Tensor, heights: torch.Tensor) -> torch.Tensor:
    """Time length of the branch above each node; 0 at the root."""
    bl = heights[parent.clamp_min(0)] - heights
    return torch.where(parent >= 0, bl, torch.zeros_like(bl))


def branch_transition_matrices(eig: EigenSystem, parent: torch.Tensor,
                               heights: torch.Tensor, branch_rates,
                               category_rates: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] matrices of every node's parent branch; [K, M, C, S, S]
    from a batched eigensystem and category_rates [K, C]."""
    bl = branch_lengths(parent, heights) * branch_rates
    t = bl[:, None] * category_rates[..., None, :]
    return transition_probs(eig, t)


def _route(p_mats: torch.Tensor) -> str:
    """`peel_route` of these [..., M, C, S, S] matrices: the kernel a CUDA
    peel goes to ("deep" takes its plain version on the CPU too)."""
    m, c, s = p_mats.shape[-4:-1]
    return peel_route(m, c, s, p_mats.element_size())


def _site_logliks(tip_partials, parent, children, heights, root, p_mats,
                  freqs, category_weights) -> torch.Tensor:
    """Per-pattern log-likelihoods of one tree, or [K, P] of K partitions
    on it from the deep route. The deep route orders the peel by depth
    alone (`level_schedule`, which computes the depth once); on a CUDA
    device the resident and matrix-product routes do too, and the v1
    streaming one takes the height order (`peel_schedule`); the CPU's plain
    peel takes the height order."""
    n_taxa = tip_partials.shape[-3]
    route = _route(p_mats)
    if route == "deep":
        return peel_site_loglik_deep(
            tip_partials, children, None, root, p_mats, freqs,
            category_weights, level_schedule(children, n_taxa, parent))
    if tip_partials.is_cuda:
        order, schedule = peel_schedule(route, children, heights, parent)
        return peel_site_loglik_auto(tip_partials, children, order, root,
                                     p_mats, freqs, category_weights,
                                     schedule)
    order = peel_order_from_heights(heights, n_taxa, parent)
    return peel_site_loglik(tip_partials, children, order, root, p_mats,
                            freqs, category_weights)


def tree_loglikelihood(tip_partials, pattern_weights, parent, children,
                       heights, root, eig: EigenSystem, freqs,
                       category_rates, category_weights,
                       branch_rates) -> torch.Tensor:
    """Pattern-weighted log-likelihood of the tree, float64 0-d tensor."""
    p_mats = branch_transition_matrices(eig, parent, heights, branch_rates,
                                        category_rates)
    return stable_dot(pattern_weights, _site_logliks(
        tip_partials, parent, children, heights, root, p_mats, freqs,
        category_weights))


def tree_site_logliks(tip_partials, parent, children, heights, root,
                      eig: EigenSystem, freqs, category_rates,
                      category_weights, branch_rates) -> torch.Tensor:
    """Per-pattern log-likelihoods [P] (the getSiteLogLikelihoods
    surface)."""
    p_mats = branch_transition_matrices(eig, parent, heights, branch_rates,
                                        category_rates)
    return _site_logliks(tip_partials, parent, children, heights, root,
                         p_mats, freqs, category_weights)


def multipartition_loglikelihood(tip_partials, pattern_weights, parent,
                                 children, heights, root, eigs: EigenSystem,
                                 freqs, category_rates, category_weights,
                                 branch_rates) -> torch.Tensor:
    """Sum over K partitions on one shared tree, float64 0-d tensor.

    tip_partials [K, N, S, P], pattern_weights [K, P], eigs batched over K,
    freqs [K, S], category_rates and category_weights [K, C] (a partition's
    relative rate folds into its category rates); branch_rates is shared.
    The branch matrices of all partitions come from one batched product.
    On the deep route all K partitions are one peel (one kernel launch, the
    grid's second axis). Elsewhere the peel order, and on a CUDA device the
    schedule of the route's kernel (`peel_schedule`), are computed once and
    each partition is one peel."""
    k_parts, n_taxa = tip_partials.shape[:2]
    p_mats = branch_transition_matrices(eigs, parent, heights, branch_rates,
                                        category_rates)  # [K, M, C, S, S]
    route = _route(p_mats)
    if route == "deep":
        return stable_dot(pattern_weights, _site_logliks(
            tip_partials, parent, children, heights, root, p_mats, freqs,
            category_weights))
    if tip_partials.is_cuda:
        order, schedule = peel_schedule(route, children, heights, parent)

        def peel(*a):
            return peel_loglikelihood_auto(*a, schedule)
    else:
        order = peel_order_from_heights(heights, n_taxa, parent)
        peel = peel_loglikelihood
    return torch.sum(torch.stack([
        peel(tip_partials[k], children, order, root, p_mats[k], freqs[k],
             category_weights[k], pattern_weights[k])
        for k in range(k_parts)]))


def tree_loglikelihood_pmats(tip_partials, pattern_weights, children, heights,
                             root, parent, p_mats, freqs,
                             category_weights) -> torch.Tensor:
    """Tree likelihood from branch matrices [M, C, S, S] built by the caller
    (epoch or branch-specific models), for any state count."""
    return stable_dot(pattern_weights, _site_logliks(
        tip_partials, parent, children, heights, root, p_mats, freqs,
        category_weights))


def ascertainment_correction(site_logl_excluded: torch.Tensor) -> torch.Tensor:
    """log(1 - sum_e P(excluded pattern e)): the per-site normaliser when
    the excluded patterns can never be observed."""
    return torch.log1p(-torch.sum(torch.exp(site_logl_excluded)))


def ascertained_loglik(site_logl_data, pattern_weights,
                       site_logl_excluded) -> torch.Tensor:
    """Ascertainment-corrected total: each observed site is renormalised by
    the probability of being ascertainable."""
    corr = ascertainment_correction(site_logl_excluded)
    return stable_dot(pattern_weights, site_logl_data - corr)

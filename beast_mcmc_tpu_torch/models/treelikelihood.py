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

`tree_loglikelihood_q`, the non-reversible route of the discrete traits,
builds its matrices by ops/expm.py and peels with the plain PyTorch peel on
both devices, as the JAX package does: a one-column trait (C * P = 1) takes
its level form, and no kernel is launched.

Every function here is differentiable on every route and both devices, in
the heights, the branch rates, the eigensystem, the category rates and
weights and the frequencies: each peel is an autograd Function over the
peel's adjoint (ops/peeling.py).

A chain batch: a tree whose `parent` is [B, M] (children [B, M, 2],
heights [B, M], root [B]) carries a leading chain axis through every
function here, with the eigensystem batched over B (or shared), branch
rates [B] and category rates and weights [B, C] (or shared); the totals
are [B]. The whole batch is one peel: one launch of the route's kernel for
all B chains (ops/cuda_peeling.py::peel_site_loglik_auto). It takes no
gradient.
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
from beast_mcmc_tpu_torch.ops.expm import transition_probs_expm
from beast_mcmc_tpu_torch.ops.peeling import (
    peel_loglikelihood,
    peel_order_from_heights,
    peel_site_loglik,
)
from beast_mcmc_tpu_torch.utils.accum import chain_dot, stable_dot


def branch_lengths(parent: torch.Tensor, heights: torch.Tensor) -> torch.Tensor:
    """Time length of the branch above each node; 0 at the root. [B, M]
    parent and heights give every chain's, row by row."""
    if parent.dim() == 1:
        bl = heights[parent.clamp_min(0)] - heights
    else:
        bl = torch.gather(heights, -1, parent.clamp_min(0)) - heights
    return torch.where(parent >= 0, bl, torch.zeros_like(bl))


def branch_transition_matrices(eig: EigenSystem, parent: torch.Tensor,
                               heights: torch.Tensor, branch_rates,
                               category_rates: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] matrices of every node's parent branch; [K, M, C, S, S]
    from a batched eigensystem and category_rates [K, C]. A chain batch
    ([B, M] parent and heights, branch_rates [B] or [B, M], category_rates
    [B, C] or [B, K, C], the eigensystem batched over [B] or [B, K], or
    shared) gives [B, M, C, S, S] or [B, K, M, C, S, S]; category rates
    [C] are shared by the chains."""
    if parent.dim() == 1:
        bl = branch_lengths(parent, heights) * branch_rates
        t = bl[:, None] * category_rates[..., None, :]
        return transition_probs(eig, t)
    rates = torch.as_tensor(branch_rates, dtype=heights.dtype,
                            device=heights.device)
    bl = branch_lengths(parent, heights) * (rates[:, None] if rates.dim() == 1
                                            else rates)  # [B, M]
    cat = _with_chains(category_rates, parent.shape[0], 2)
    if cat.dim() == 3:  # [B, K, C]
        t = bl[:, None, :, None] * cat[:, :, None, :]
    else:
        t = bl[:, :, None] * cat[:, None, :]
    return transition_probs(eig, t)


def _with_chains(x: torch.Tensor, b_n: int, dim: int) -> torch.Tensor:
    """x with the leading chain axis of a [B, ...] batch, broadcast where x
    is shared by the chains (x.dim() == dim - 1)."""
    return x.expand(b_n, *x.shape) if x.dim() < dim else x


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
    peel takes the height order. A chain batch ([B, M] parent) is one
    chain-axis peel on both devices: [B, P], or [B, K, P] on the deep
    route."""
    n_taxa = tip_partials.shape[-3]
    route = _route(p_mats)
    if parent.dim() == 2:
        b_n, lead = parent.shape[0], p_mats.dim() - 4
        freqs = _with_chains(freqs, b_n, lead + 1)
        category_weights = _with_chains(category_weights, b_n, lead + 1)
        order, schedule = peel_schedule(route, children, heights, parent)
        return peel_site_loglik_auto(tip_partials, children, order, root,
                                     p_mats, freqs, category_weights,
                                     schedule)
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
    """Pattern-weighted log-likelihood of the tree, float64 0-d tensor; [B]
    for a chain batch."""
    p_mats = branch_transition_matrices(eig, parent, heights, branch_rates,
                                        category_rates)
    return _weighted(pattern_weights, _site_logliks(
        tip_partials, parent, children, heights, root, p_mats, freqs,
        category_weights), parent)


def _weighted(pattern_weights, site, parent) -> torch.Tensor:
    """The pattern-weighted sum in float64: 0-d, or [B] for a chain batch
    ([B, M] parent)."""
    if parent.dim() == 2:
        return chain_dot(pattern_weights, site)
    return stable_dot(pattern_weights, site)


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
    each partition is one peel. A chain batch ([B, M] parent, eigs batched
    over [B, K], category_rates [B, K, C]) gives [B]: on the deep route one
    launch for every chain and partition, elsewhere one chain-axis peel a
    partition."""
    k_parts, n_taxa = tip_partials.shape[:2]
    p_mats = branch_transition_matrices(eigs, parent, heights, branch_rates,
                                        category_rates)  # [K, M, C, S, S]
    route = _route(p_mats)
    if parent.dim() == 2:
        if route == "deep":
            return chain_dot(pattern_weights, _site_logliks(
                tip_partials, parent, children, heights, root, p_mats, freqs,
                category_weights))
        return torch.stack([chain_dot(pattern_weights[k], _site_logliks(
            tip_partials[k], parent, children, heights, root, p_mats[:, k],
            freqs[..., k, :], category_weights[..., k, :]))
            for k in range(k_parts)]).sum(0)
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


def tree_loglikelihood_q(tip_partials, pattern_weights, parent, children,
                         heights, root, q: torch.Tensor, freqs,
                         category_rates, category_weights,
                         branch_rates) -> torch.Tensor:
    """Pattern-weighted log-likelihood, float64 0-d, through the expm
    transition path for a generator q [S, S] that may be non-reversible
    (beast_mcmc_tpu/models/treelikelihood.py:124-150): branch lengths times
    the clock rates, expm matrices [M, C, S, S], then the plain peel
    (ops/peeling.py; its level form where C * P <= 8), never a kernel."""
    bl = branch_lengths(parent, heights) * branch_rates
    p_mats = transition_probs_expm(q, bl[:, None] * category_rates[None, :])
    order = peel_order_from_heights(heights, tip_partials.shape[0], parent)
    return peel_loglikelihood(tip_partials, children, order, root, p_mats,
                              freqs, category_weights, pattern_weights)


def tree_loglikelihood_pmats(tip_partials, pattern_weights, children, heights,
                             root, parent, p_mats, freqs,
                             category_weights) -> torch.Tensor:
    """Tree likelihood from branch matrices [M, C, S, S] built by the caller
    (epoch or branch-specific models), for any state count; [B] from a
    chain batch's [B, M, C, S, S]."""
    return _weighted(pattern_weights, _site_logliks(
        tip_partials, parent, children, heights, root, p_mats, freqs,
        category_weights), parent)


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

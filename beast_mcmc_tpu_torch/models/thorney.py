"""Thorney BEAST: an approximate branch-length likelihood for huge trees.

Counterpart of beast_mcmc_tpu/models/thorney.py
(PoissonBranchLengthLikelihoodDelegate.java:39-56;
ThorneyDataLikelihoodDelegate, ConstrainedTreeModel). In place of a site
peel on trees of 10^4 tips and more, each branch's reconstructed mutation
count is Poisson about the time tree's expected substitutions on it: one
vectorised Poisson log-pmf over the [M] branches, differentiable in the
heights and rates by autograd (getGradientWrtTime:51-56).
"""

from __future__ import annotations

import torch


def poisson_branch_length_loglik(mutations: torch.Tensor,
                                 parent: torch.Tensor, heights: torch.Tensor,
                                 branch_rates, scale: float = 1.0
                                 ) -> torch.Tensor:
    """Sum over the non-root branches of log Poisson(k_b; t_b r_b scale):
    mutations [M] on each node's parent branch, branch_rates [M] or a
    scalar clock rate, scale the data's sites."""
    dt = heights.dtype
    is_branch = parent >= 0
    t = torch.where(is_branch, heights[parent.clamp_min(0)] - heights,
                    torch.zeros_like(heights))
    rates = torch.as_tensor(branch_rates, dtype=dt, device=heights.device)
    mean = t * rates * scale
    mean_safe = torch.where(is_branch,
                            torch.clamp_min(mean, torch.finfo(dt).tiny),
                            torch.ones_like(mean))
    k = mutations.to(dt)
    # k = 0 on a zero-length branch is P = 1, not 0 log 0 = NaN
    k_term = torch.where(k > 0, k * torch.log(mean_safe), torch.zeros_like(k))
    ll = k_term - mean - torch.lgamma(k + 1.0)
    return torch.sum(torch.where(is_branch, ll, torch.zeros_like(ll)))


def mutation_counts_from_branch_lengths(genetic_branch_lengths: torch.Tensor,
                                        sequence_length: float
                                        ) -> torch.Tensor:
    """Substitutions-per-site branch lengths of a data tree rounded to
    integer mutation counts (branch length times L)."""
    return torch.round(genetic_branch_lengths * sequence_length)

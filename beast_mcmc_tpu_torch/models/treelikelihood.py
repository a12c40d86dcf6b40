"""Tree data likelihood: tree + substitution + site + clock -> logL.

Counterpart of beast_mcmc_tpu/models/treelikelihood.py. The peel goes by
the device of the tensors: CUDA tensors to the kernels through
ops/cuda_peeling.py::peel_loglikelihood_auto, CPU tensors to the plain peel.
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops.cuda_peeling import peel_loglikelihood_auto
from beast_mcmc_tpu_torch.ops.eigen import EigenSystem, transition_probs
from beast_mcmc_tpu_torch.ops.peeling import (
    peel_loglikelihood,
    peel_order_from_heights,
)


def branch_lengths(parent: torch.Tensor, heights: torch.Tensor) -> torch.Tensor:
    """Time length of the branch above each node; 0 at the root."""
    bl = heights[parent.clamp_min(0)] - heights
    return torch.where(parent >= 0, bl, torch.zeros_like(bl))


def branch_transition_matrices(eig: EigenSystem, parent: torch.Tensor,
                               heights: torch.Tensor, branch_rates,
                               category_rates: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] matrices of every node's parent branch."""
    bl = branch_lengths(parent, heights) * branch_rates
    t = bl[:, None] * category_rates[None, :]
    return transition_probs(eig, t)


def tree_loglikelihood(tip_partials, pattern_weights, parent, children,
                       heights, root, eig: EigenSystem, freqs,
                       category_rates, category_weights,
                       branch_rates) -> torch.Tensor:
    """Pattern-weighted log-likelihood of the tree, float64 0-d tensor."""
    n_taxa = tip_partials.shape[0]
    p_mats = branch_transition_matrices(eig, parent, heights, branch_rates,
                                        category_rates)
    order = peel_order_from_heights(heights, n_taxa, parent)
    peel = peel_loglikelihood_auto if tip_partials.is_cuda else peel_loglikelihood
    return peel(tip_partials, children, order, root, p_mats, freqs,
                category_weights, pattern_weights)

"""Epoch branch model: time-sliced substitution models convolved on
branches.

Counterpart of beast_mcmc_tpu/models/epoch.py, every function of it: the
role of EpochBranchModel.java:47 and of the buffer convolution of
SubstitutionModelDelegate.java:303+ (beagle.convolveTransitionMatrices).
A branch spanning epoch boundaries gets P = P_oldest(l_E) @ ... @
P_youngest(l_0), l_e its overlap with epoch e. The overlaps are one clamp
over [M, E]; the convolution is a Python loop over the epochs of batched
[M, C, S, S] matrix products. The clade model's reachability matrix is
ceil(log2 M) boolean-valued matrix squarings on the device, with no host
walk of the tree, so it follows the current topology.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from beast_mcmc_tpu_torch.ops.eigen import EigenSystem, transition_probs
from beast_mcmc_tpu_torch.ops.expm import transition_probs_expm


def _p_mats(model, t_mc: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] from an EigenSystem (reversible) or a generator Q."""
    if isinstance(model, EigenSystem):
        return transition_probs(model, t_mc)
    return transition_probs_expm(model, t_mc)


def epoch_overlaps(parent: torch.Tensor, heights: torch.Tensor,
                   boundaries: torch.Tensor) -> torch.Tensor:
    """[M, E] time overlap of each node's parent branch with each epoch.
    Epoch e spans [b_{e-1}, b_e) with b_{-1} = 0 and b_{E-1} = inf;
    `boundaries` are the E-1 interior transition times, ascending
    (EpochBranchModel transitionTimes)."""
    dt = heights.dtype
    pidx = torch.clamp_min(parent, 0)
    h1 = torch.where(parent >= 0, heights[pidx], heights)
    zero = torch.zeros(1, dtype=dt, device=heights.device)
    b = boundaries.to(dt)
    lo = torch.cat([zero, b])
    hi = torch.cat([b, torch.full_like(zero, math.inf)])
    return torch.clamp_min(torch.minimum(h1[:, None], hi[None, :])
                           - torch.maximum(heights[:, None], lo[None, :]),
                           0.0)


def epoch_branch_matrices(models: Sequence[Union[EigenSystem, torch.Tensor]],
                          boundaries: torch.Tensor, parent: torch.Tensor,
                          heights: torch.Tensor, branch_rates,
                          category_rates: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] per-branch matrices: the oldest-first product of each
    epoch model's transition matrix over the branch's overlap with that
    epoch. models[e] is an EigenSystem or a generator Q [S, S]."""
    dt = heights.dtype
    overlaps = epoch_overlaps(parent, heights, boundaries)
    m = parent.shape[0]
    rates = torch.as_tensor(branch_rates, dtype=dt,
                            device=heights.device).expand(m)
    acc = None
    for e, model in enumerate(models):
        t_mc = (overlaps[:, e] * rates)[:, None] * category_rates[None, :]
        p_e = _p_mats(model, t_mc)
        # epoch e is older than e - 1: it multiplies from the left
        acc = p_e if acc is None else torch.matmul(p_e, acc)
    return acc


def ancestor_closure(parent: torch.Tensor, dtype=None) -> torch.Tensor:
    """[M, M] reachability S[v, u] = 1 iff u is an ancestor-or-self of v:
    ceil(log2 M) squarings of (I + P) clipped at 1, on the device."""
    m = int(parent.shape[0])
    dt = dtype or torch.float32
    is_root = parent < 0
    p_mat = torch.nn.functional.one_hot(torch.clamp_min(parent, 0),
                                        m).to(dt)
    p_mat = torch.where(is_root[:, None], torch.zeros_like(p_mat), p_mat)
    s_mat = torch.eye(m, dtype=dt, device=parent.device) + p_mat
    for _ in range(int(math.ceil(math.log2(max(m, 2))))):
        s_mat = torch.clamp_max(s_mat @ s_mat, 1.0)
    return s_mat


def clade_branch_matrices(base_model, clade_specs, parent: torch.Tensor,
                          heights: torch.Tensor, root, branch_rates,
                          category_rates: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] per-branch matrices for clade-specific substitution
    models (BranchSpecificBranchModel.setupNodeMaps:240-366): each clade's
    MRCA subtree takes the clade model; the stem branch is the oldest-first
    product P_base((1-w) L) @ P_clade(w L) (setConvolvedNodeMap:353-365).
    clade_specs is [(tip_mask [N], model, stem_weight)], each model an
    EigenSystem or a generator Q."""
    dt = heights.dtype
    dev = heights.device
    m = parent.shape[0]
    rates = torch.as_tensor(branch_rates, dtype=dt, device=dev).expand(m)
    pidx = torch.clamp_min(parent, 0)
    blen = torch.where(parent >= 0, heights[pidx] - heights,
                       torch.zeros_like(heights)) * rates
    s_mat = ancestor_closure(parent, dt)
    ar = torch.arange(m, device=dev)
    fracs = []
    for tip_mask, _model, w in clade_specs:
        tip_v = torch.as_tensor(tip_mask, device=dev).to(dt)
        n = tip_v.shape[0]
        cnt = tip_v @ s_mat[:n]  # clade tips below each node
        cand = cnt >= torch.sum(tip_v)
        mrca = torch.argmin(torch.where(cand, heights,
                                        torch.full_like(heights, math.inf)))
        below = s_mat[:, mrca] > 0
        wv = torch.as_tensor(w, dtype=dt, device=dev)
        fracs.append(torch.where(ar == mrca, wv,
                                 below.to(dt)))
    frac_base = 1.0
    for f in fracs:
        frac_base = frac_base - f
    acc = None
    for model, frac in zip([base_model] + [c[1] for c in clade_specs],
                           [frac_base] + fracs):
        t_mc = (blen * frac)[:, None] * category_rates[None, :]
        p_e = _p_mats(model, t_mc)
        # the base is the oldest segment, leftmost; clade portions are the
        # younger (child-side) end of the stem branch
        acc = p_e if acc is None else torch.matmul(acc, p_e)
    return acc

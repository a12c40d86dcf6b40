"""Markov-jump expectations: robust counting of substitutions and rewards.

Counterpart of beast_mcmc_tpu/ops/markov_jumps.py (MarkovJumpsCore.java;
Minin & Suchard 2008). The expected number of labelled transitions, or the
accumulated reward, on a branch of length t given its endpoint states comes
from the eigensystem of the generator:

  J(t) = U [ (U^-1 (Q o L) U) o I(t) ] U^-1,
  I_kl(t) = (e^{l_k t} - e^{l_l t}) / (l_k - l_l),  I_kk(t) = t e^{l_k t},

and E[N_L | a at 0, b at t] = J(t)_ab / P(t)_ab. Every function takes t of
any shape [...] and gives [..., S, S]; `branch_expected_jumps` runs all the
branches of a tree at once.
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops.eigen import EigenSystem

# below this |x| = |l_k - l_l| t / 2, sinh(x) / x is 1 + x^2 / 6 to within
# float64 rounding
_SINHC_SERIES = 1e-4


def _spectral_integral(values: torch.Tensor, t) -> torch.Tensor:
    """I_kl = int_0^t e^{l_k s} e^{l_l (t - s)} ds in closed form, [..., S,
    S] for t [...]. Where |x| = |l_k - l_l| t / 2 < 1 it is taken as t
    e^{(l_k + l_l) t / 2} sinh(x) / x, exact at equal eigenvalues (t e^{l
    t}) and without the cancellation of the difference quotient at close
    ones; elsewhere as the difference quotient."""
    t = torch.as_tensor(t, dtype=values.dtype, device=values.device)
    tt = t[..., None, None]
    lk, ll = values[:, None], values[None, :]
    x = 0.5 * (lk - ll) * tt
    near = x.abs() < 1.0
    series = x.abs() < _SINHC_SERIES
    xs = torch.where(series, torch.ones_like(x), x)
    sinhc = torch.where(series, 1.0 + x * x / 6.0, torch.sinh(xs) / xs)
    close = tt * torch.exp(0.5 * (lk + ll) * tt) * sinhc
    gap = torch.where(near, torch.ones_like(x), (lk - ll).expand_as(x))
    far = (torch.exp(lk * tt) - torch.exp(ll * tt)) / gap
    return torch.where(near, close, far)


def joint_jump_matrix(eig: EigenSystem, q: torch.Tensor, label: torch.Tensor,
                      t) -> torch.Tensor:
    """J(t)[a, b] = E[N_label 1{X_t = b} | X_0 = a], unnormalised: label
    [S, S] is a 0/1 mask (or weights) over the transitions counted."""
    inner = eig.U_inv @ (q * label) @ eig.U
    return eig.U @ (inner * _spectral_integral(eig.values, t)) @ eig.U_inv


def expected_jumps(eig: EigenSystem, q: torch.Tensor, label: torch.Tensor,
                   t, p_matrix: torch.Tensor) -> torch.Tensor:
    """E[N_label | a at 0, b at t] for every endpoint pair, [..., S, S]."""
    return (joint_jump_matrix(eig, q, label, t)
            / torch.clamp_min(p_matrix, 1e-300))


def expected_reward(eig: EigenSystem, reward: torch.Tensor, t,
                    p_matrix: torch.Tensor) -> torch.Tensor:
    """E[int_0^t r(X_s) ds | endpoints] for a state reward r [S]: the same
    spectral form with diag(reward) for Q o L."""
    inner = eig.U_inv @ (reward[:, None] * eig.U)
    j = eig.U @ (inner * _spectral_integral(eig.values, t)) @ eig.U_inv
    return j / torch.clamp_min(p_matrix, 1e-300)


def branch_expected_jumps(eig: EigenSystem, q: torch.Tensor,
                          label: torch.Tensor, branch_lengths: torch.Tensor,
                          node_probs: torch.Tensor, parent: torch.Tensor,
                          p_matrices: torch.Tensor) -> torch.Tensor:
    """Expected labelled counts on every node's parent branch [M], given
    each node's state distribution node_probs [M, S] (marginal, or one-hot
    sampled states), the rate-scaled branch_lengths [M] and the branches'
    matrices p_matrices [M, S, S] of one category: the expectation over
    endpoint pairs weighted by probs_parent[a] P_ab probs_child[b]. The
    root's entry is 0."""
    e = expected_jumps(eig, q, label, branch_lengths, p_matrices)
    probs_parent = node_probs[parent.clamp_min(0).long()]
    w = probs_parent[:, :, None] * p_matrices * node_probs[:, None, :]
    w = w / torch.clamp_min(w.sum((-2, -1), keepdim=True), 1e-300)
    counts = torch.sum(w * e, dim=(-2, -1))
    return torch.where(parent >= 0, counts, torch.zeros_like(counts))

"""Rate-matrix construction, spectral decomposition and P(t).

Counterpart of beast_mcmc_tpu/ops/eigen.py. A reversible Q is made
symmetric by D = diag(sqrt(pi)), so a real symmetric eigh suffices:
Q = (D^-1 V) W (V^T D). The eigh runs in float64 through
torch.linalg.eigh (the JAX package's f64 route), whatever the input dtype.

Where the JAX package maps these functions over K partitions with jax.vmap,
here the axis is written out: a leading K on the rates and frequencies gives
an EigenSystem with a leading K on every field, from one eigh call (each
call synchronises with the host on a CUDA device).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EigenSystem:
    """Q = U diag(values) U_inv; right eigenvectors in U's columns."""

    values: torch.Tensor  # [..., S]
    U: torch.Tensor  # [..., S, S]
    U_inv: torch.Tensor  # [..., S, S]


def normalized_q(rates_symmetric: torch.Tensor,
                 freqs: torch.Tensor) -> torch.Tensor:
    """Q[i,j] = R[i,j] pi[j] off the diagonal, rows summing to 0, scaled so
    that the mean rate -sum_i pi_i Q[i,i] is 1. R's diagonal is ignored."""
    s = freqs.shape[-1]
    eye = torch.eye(s, dtype=rates_symmetric.dtype, device=freqs.device)
    q = rates_symmetric * freqs[..., None, :]
    q = q - eye * q
    q = q - eye * torch.sum(q, dim=-1, keepdim=True)
    mean_rate = -torch.sum(freqs * torch.diagonal(q, dim1=-2, dim2=-1), dim=-1)
    return q / mean_rate[..., None, None]


def reversible_eigen(rates_symmetric: torch.Tensor,
                     freqs: torch.Tensor) -> EigenSystem:
    """Spectral decomposition of a reversible Q by pi-symmetrisation, in
    float64, cast back to the inputs' dtype."""
    out_dt = torch.promote_types(rates_symmetric.dtype, freqs.dtype)
    rates_symmetric = rates_symmetric.to(torch.float64)
    freqs = freqs.to(torch.float64)
    q = normalized_q(rates_symmetric, freqs)
    sqrt_pi = torch.sqrt(freqs)
    a = q * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    a = 0.5 * (a + a.transpose(-1, -2))  # exact symmetry
    w, v = torch.linalg.eigh(a)
    u = v / sqrt_pi[..., :, None]
    u_inv = v.transpose(-1, -2) * sqrt_pi[..., None, :]
    return EigenSystem(values=w.to(out_dt), U=u.to(out_dt),
                       U_inv=u_inv.to(out_dt))


def transition_probs(eig: EigenSystem, t: torch.Tensor) -> torch.Tensor:
    """P(t) = U exp(values t) U_inv, batched over t's shape: [..., S, S].
    With a batched eigensystem (values [K, S]) t is [K, ...] and row k of t
    goes with system k. Negative round-off entries are clamped to 0."""
    k_shape = eig.values.shape[:-1]
    s = eig.values.shape[-1]
    ones = (1,) * (t.dim() - len(k_shape))  # t's axes after the batch
    values = eig.values.reshape(*k_shape, *ones, s)
    e = torch.exp(values * t[..., None])  # [..., S]
    p = ((eig.U.reshape(*k_shape, *ones, s, s) * e[..., None, :])
         @ eig.U_inv.reshape(*k_shape, *ones, s, s))
    return torch.clamp_min(p, 0.0)

"""Batched matrix exponentials for the non-reversible generators.

Counterpart of beast_mcmc_tpu/ops/expm.py:28,65. A non-reversible Q has no
real symmetric eigensystem, so P(t) = expm(Q t) is computed directly, by
scaling and squaring: each matrix is scaled by 2^-s so that its inf-norm is
at most 0.5, an order-N Taylor polynomial is taken in Horner form (N - 1
batched products), and the result is squared s times. With norm <= 0.5 the
truncation error is 0.5^(N+1) / (N+1)!: about 2e-17 for N = 17 (float64),
1e-9 for N = 9 (float32).

The JAX package takes a fixed 30 (float64) or 16 (float32) masked
squarings, so that nothing is data-dependent at trace time. Nothing is
traced here: the squarings stop at the largest s of the batch, read once
on the host, and each matrix is squared exactly its own s times, as there.
The batched products are torch.matmul (cuBLAS on the card), as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import torch

_MAX_SQUARINGS = {torch.float64: 30, torch.float32: 16}


def expm_taylor(a: torch.Tensor) -> torch.Tensor:
    """expm of a [..., S, S] float64 or float32 batch."""
    dt = a.dtype
    order = 17 if dt == torch.float64 else 9
    max_squarings = _MAX_SQUARINGS[dt]
    eye = torch.eye(a.shape[-1], dtype=dt, device=a.device)
    # the squarings that bring each matrix's inf-norm under 0.5
    nrm = torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1)
    s = torch.ceil(torch.log2(torch.clamp_min(nrm, 0.25) * 4.0))
    s = torch.clamp(s, 0.0, float(max_squarings))
    a = a / torch.exp2(s)[..., None, None]
    # Horner: P = I + A (I + A/2 (I + ... (I + A/N)))
    p = eye + a / order
    for k in range(order - 1, 0, -1):
        p = eye + torch.matmul(a, p) / k
    n_sq = int(s.max()) if s.numel() else 0  # one copy to the host
    for k in range(n_sq):
        p = torch.where((s > k)[..., None, None], torch.matmul(p, p), p)
    return p


def transition_probs_expm(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = expm(q t) [M, C, S, S] over branch times t [M, C] for one
    generator q [S, S], clipped to [0, 1] (the reference takes abs of the
    complex-eigen reconstruction, GenericBastaLikelihoodDelegate.java:929).
    """
    m, c = t.shape
    a = q[None, :, :] * t.reshape(-1)[:, None, None].to(q.dtype)
    p = expm_taylor(a).reshape(m, c, q.shape[0], q.shape[1])
    return torch.clamp(p, 0.0, 1.0)

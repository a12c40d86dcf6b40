"""Ordered latent liability: discrete traits from thresholded latent
Brownian variables.

Counterpart of beast_mcmc_tpu/models/liability.py (ref: src/dr/evomodel/
continuous/OrderedLatentLiabilityLikelihood.java: binary or ordinal tip
data are deterministic threshold functions of latent continuous traits
that diffuse on the tree; the latent values are sampled by MCMC). The
latent tip matrix is a regular parameter; this module supplies the
data-consistency likelihood (0 or -inf, or a smooth penalty for
gradient-based samplers) that pairs with models/continuous.py.
"""

from __future__ import annotations

import math

import torch


def liability_consistency_loglik(
    latent: torch.Tensor,  # [N, D] latent tip values (sampled)
    data: torch.Tensor,  # int[N, D] observed ordinal category per dim
    thresholds: torch.Tensor,  # [D, K-1] ascending cut points per dim
    smooth: float = 0.0,
) -> torch.Tensor:
    """log P(data | latent): 0 when every latent value lies in its
    category's threshold interval, else -inf (or a smooth hinge penalty of
    scale `smooth` for gradient-based samplers)."""
    dt, dev = latent.dtype, latent.device
    d = latent.shape[1]
    data = torch.as_tensor(data, device=dev).long()
    cuts = torch.cat([torch.full((d, 1), -math.inf, dtype=dt, device=dev),
                      torch.as_tensor(thresholds, device=dev).to(dt),
                      torch.full((d, 1), math.inf, dtype=dt, device=dev)], 1)
    cols = torch.arange(d, device=dev)[None, :]
    lo = cuts[cols, data]
    hi = cuts[cols, data + 1]
    if smooth > 0:
        pen = (torch.clamp_min(lo - latent, 0.0)
               + torch.clamp_min(latent - hi, 0.0))
        return -torch.sum(pen * pen) / (2.0 * smooth * smooth)
    ok = torch.all((latent >= lo) & (latent <= hi))
    return torch.where(ok, torch.zeros((), dtype=dt, device=dev),
                       torch.full((), -math.inf, dtype=dt, device=dev))


def binary_liability_data(tip_states: torch.Tensor) -> torch.Tensor:
    """Binary data as ordinal categories with a single threshold at 0 (the
    reference's binary latent-liability convention)."""
    return torch.as_tensor(tip_states).to(torch.int32)

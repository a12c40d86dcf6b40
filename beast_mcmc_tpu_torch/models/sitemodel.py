"""Across-site rate variation: the discretised gamma, invariant sites,
free rates.

Counterpart of beast_mcmc_tpu/models/sitemodel.py (GammaSiteModel's
calculateCategoryRates): K categories at the median quantiles
(2i+1)/(2K) of Gamma(alpha, 1/alpha); an optional invariant category of
rate 0 and weight pInv; rates normalised so that the weighted mean over all
categories is 1; mu rescales all rates. With exact_quantiles the rates of a
concrete alpha come from the reference's published AS91 algorithm
(utils/as91.py), as JAX's do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from beast_mcmc_tpu_torch.ops.special import log_gamma_category_quantiles
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


def discrete_gamma_rates(alpha: torch.Tensor, n_categories: int,
                         p_invariant: Optional[torch.Tensor] = None,
                         mu: Optional[torch.Tensor] = None,
                         dtype: torch.dtype = DEFAULT_FLOAT,
                         exact_quantiles: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rates [C], weights [C]), computed in float64 and cast to `dtype`.
    The scale 1/alpha cancels in the mean normalisation, which is taken in
    log space so it stays exact where raw quantiles underflow. With
    `p_invariant` the result has C + 1 entries: category 0 is the invariant
    one (rate exactly 0, weight pInv). alpha [B] (a chain batch, with
    p_invariant and mu 0-d or [B]) gives rates and weights [B, C]: the
    quantiles are normalised over the last axis.

    exact_quantiles: JAX's bit-parity route (beast_mcmc_tpu/models/
    sitemodel.py:52-65). A concrete alpha, one value in a tensor that does
    not require grad, without p_invariant (and mu, if given, not requiring
    grad either), takes the reference's AS91 median rates, computed in
    float64 on the host (one read of alpha); any other input the smooth
    quantiles below."""
    alpha = torch.as_tensor(alpha)
    if (exact_quantiles and p_invariant is None and alpha.numel() == 1
            and not alpha.requires_grad
            and not (isinstance(mu, torch.Tensor) and mu.requires_grad)):
        a_c = float(alpha)
        if a_c > 0:
            from beast_mcmc_tpu_torch.utils.as91 import gamma_category_rates

            rates = torch.tensor(gamma_category_rates(a_c, n_categories),
                                 dtype=torch.float64, device=alpha.device)
            weights = torch.full((n_categories,), 1.0 / n_categories,
                                 dtype=torch.float64, device=alpha.device)
            if mu is not None:
                rates = rates * torch.as_tensor(mu, dtype=torch.float64)
            return rates.to(dtype), weights.to(dtype)
    alpha = alpha.to(torch.float64)
    k = n_categories
    lq = log_gamma_category_quantiles(alpha, k)
    lnorm = torch.logsumexp(lq, dim=-1, keepdim=True) - math.log(k)
    rates = torch.exp(lq - lnorm)
    weights = torch.full((*alpha.shape, k), 1.0 / k, dtype=torch.float64,
                         device=alpha.device)
    if p_invariant is not None:
        p_inv = torch.as_tensor(p_invariant, dtype=torch.float64,
                                device=alpha.device)
        p_inv = p_inv.reshape(()) if alpha.dim() == 0 else p_inv[..., None]
        rates = torch.cat([rates.new_zeros((*alpha.shape, 1)),
                           rates / (1.0 - p_inv)], dim=-1)
        weights = torch.cat([p_inv.expand(*alpha.shape, 1),
                             weights * (1.0 - p_inv)], dim=-1)
    if mu is not None:
        mu = torch.as_tensor(mu)
        rates = rates * (mu[..., None] if alpha.dim() and mu.dim() else mu)
    return rates.to(dtype), weights.to(dtype)


def single_rate(mu: Optional[torch.Tensor] = None,
                dtype: torch.dtype = DEFAULT_FLOAT,
                device=DEFAULT_DEVICE) -> Tuple[torch.Tensor, torch.Tensor]:
    """One category of rate mu (1 without it): ([1], [1]); mu [B] (a chain
    batch) gives rates [B, 1] and the shared weights [1]."""
    r = torch.ones(1, dtype=dtype, device=device)
    if mu is not None:
        r = r * torch.as_tensor(mu)[..., None]
    return r, torch.ones(1, dtype=dtype, device=device)


def invariant_only_rates(p_invariant: torch.Tensor,
                         mu: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """No gamma, just +I: one zero-rate category plus one at 1/(1 - pInv).
    p_invariant [B] (a chain batch, mu 0-d or [B]) gives [B, 2] each."""
    p_inv = torch.as_tensor(p_invariant)
    rates = torch.stack([torch.zeros_like(p_inv), 1.0 / (1.0 - p_inv)], -1)
    weights = torch.stack([p_inv, 1.0 - p_inv], -1)
    if mu is not None:
        rates = rates * torch.as_tensor(mu)[..., None]
    return rates, weights


def free_rates(rates: torch.Tensor, weights: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Free-rate site model: arbitrary positive rates and simplex weights,
    renormalised so that the expected rate is 1."""
    w = weights / torch.sum(weights)
    return rates / torch.sum(w * rates), w

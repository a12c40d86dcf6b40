"""Across-site rate variation: the discretised gamma.

Counterpart of beast_mcmc_tpu/models/sitemodel.py (GammaSiteModel's
calculateCategoryRates): K categories at the median quantiles
(2i+1)/(2K) of Gamma(alpha, 1/alpha), normalised to mean rate 1, equal
weights; mu rescales all rates.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from beast_mcmc_tpu_torch.ops.special import log_gamma_category_quantiles
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


def discrete_gamma_rates(alpha: torch.Tensor, n_categories: int,
                         mu: Optional[torch.Tensor] = None,
                         dtype: torch.dtype = DEFAULT_FLOAT
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rates [C], weights [C]), computed in float64 and cast to `dtype`.
    The scale 1/alpha cancels in the mean normalisation, which is taken in
    log space so it stays exact where raw quantiles underflow."""
    alpha = torch.as_tensor(alpha).to(torch.float64)
    k = n_categories
    lq = log_gamma_category_quantiles(alpha, k)
    lnorm = torch.logsumexp(lq, dim=0) - math.log(k)
    rates = torch.exp(lq - lnorm)
    weights = torch.full((k,), 1.0 / k, dtype=torch.float64,
                         device=alpha.device)
    if mu is not None:
        rates = rates * mu
    return rates.to(dtype), weights.to(dtype)


def single_rate(mu: Optional[torch.Tensor] = None,
                dtype: torch.dtype = DEFAULT_FLOAT,
                device=DEFAULT_DEVICE) -> Tuple[torch.Tensor, torch.Tensor]:
    r = torch.ones(1, dtype=dtype, device=device)
    if mu is not None:
        r = r * mu
    return r, torch.ones(1, dtype=dtype, device=device)

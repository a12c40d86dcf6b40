"""Prior log densities of the main path.

Counterpart of beast_mcmc_tpu/models/priors.py:34,89. Each returns the sum
of the elementwise log density, -inf outside the support.
"""

from __future__ import annotations

import math

import torch


def lognormal_logpdf(x: torch.Tensor, mu: float, sigma: float) -> torch.Tensor:
    """mu, sigma in log space (LogNormalDistribution.java,
    meanInRealSpace=false)."""
    safe = x > 0
    lx = torch.log(torch.where(safe, x, torch.ones_like(x)))
    z = (lx - mu) / sigma
    lp = -0.5 * z * z - lx - math.log(sigma) - 0.5 * math.log(2 * math.pi)
    return torch.sum(torch.where(safe, lp, torch.full_like(lp, -math.inf)))


def one_on_x_logpdf(x: torch.Tensor) -> torch.Tensor:
    """Improper 1/x prior (OneOnXPrior)."""
    safe = x > 0
    lp = -torch.log(torch.where(safe, x, torch.ones_like(x)))
    return torch.sum(torch.where(safe, lp, torch.full_like(lp, -math.inf)))

"""Prior log densities of the main path.

Counterpart of beast_mcmc_tpu/models/priors.py:34,89. Each returns the sum
of the elementwise log density, -inf outside the support; with
`chains=True` the leading axis of x is a chain batch's, and the sum is
taken per chain ([B]).
"""

from __future__ import annotations

import math

import torch


def _total(lp: torch.Tensor, chains: bool) -> torch.Tensor:
    return lp.reshape(lp.shape[0], -1).sum(-1) if chains else torch.sum(lp)


def lognormal_logpdf(x: torch.Tensor, mu: float, sigma: float,
                     chains: bool = False) -> torch.Tensor:
    """mu, sigma in log space (LogNormalDistribution.java,
    meanInRealSpace=false)."""
    safe = x > 0
    lx = torch.log(torch.where(safe, x, torch.ones_like(x)))
    z = (lx - mu) / sigma
    lp = -0.5 * z * z - lx - math.log(sigma) - 0.5 * math.log(2 * math.pi)
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)


def one_on_x_logpdf(x: torch.Tensor, chains: bool = False) -> torch.Tensor:
    """Improper 1/x prior (OneOnXPrior)."""
    safe = x > 0
    lp = -torch.log(torch.where(safe, x, torch.ones_like(x)))
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)

"""Prior log densities of the main path and of the Makona joint analysis.

Counterpart of beast_mcmc_tpu/models/priors.py:34,45,61,89,95. Each
returns the sum of the elementwise log density, -inf outside the support;
with `chains=True` the leading axis of x is a chain batch's, and the sum
is taken per chain ([B]).
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


def gamma_logpdf(x: torch.Tensor, shape: float, scale: float,
                 chains: bool = False) -> torch.Tensor:
    """Gamma(shape, scale) (GammaDistribution.java, <gammaPrior>)."""
    safe = x > 0
    xs = torch.where(safe, x, torch.ones_like(x))
    lp = ((shape - 1) * torch.log(xs) - xs / scale - math.lgamma(shape)
          - shape * math.log(scale))
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)


def exponential_logpdf(x: torch.Tensor, mean: float,
                       chains: bool = False) -> torch.Tensor:
    """Exponential of the given mean (<exponentialPrior>)."""
    lp = -x / mean - math.log(mean)
    return _total(torch.where(x >= 0, lp, torch.full_like(lp, -math.inf)),
                  chains)


def poisson_logpmf(k: torch.Tensor, mean: float,
                   chains: bool = False) -> torch.Tensor:
    """Poisson of the given mean at (real-valued) counts k
    (<poissonPrior>)."""
    k = torch.as_tensor(k)
    return _total(k * math.log(mean) - mean - torch.lgamma(k + 1.0), chains)

"""Prior log densities of the main path, the Makona joint analysis and the
config layer's priors.

Counterpart of beast_mcmc_tpu/models/priors.py:22,28,34,45,61,80,89,95,100.
Each returns the sum of the elementwise log density, -inf outside the
support; with `chains=True` the leading axis of x is a chain batch's, and
the sum is taken per chain ([B]).
"""

from __future__ import annotations

import math

import torch


def _total(lp: torch.Tensor, chains: bool) -> torch.Tensor:
    return lp.reshape(lp.shape[0], -1).sum(-1) if chains else torch.sum(lp)


def uniform_logpdf(x: torch.Tensor, lower: float, upper: float,
                   chains: bool = False) -> torch.Tensor:
    """Uniform on [lower, upper] (<uniformPrior>)."""
    lp = torch.full_like(x, -math.log(upper - lower))
    inside = (x >= lower) & (x <= upper)
    return _total(torch.where(inside, lp, torch.full_like(lp, -math.inf)),
                  chains)


def normal_logpdf(x: torch.Tensor, mean: float, stdev: float,
                  chains: bool = False) -> torch.Tensor:
    """Normal(mean, stdev) (<normalPrior>)."""
    z = (x - mean) / stdev
    return _total(-0.5 * z * z - math.log(stdev)
                  - 0.5 * math.log(2 * math.pi), chains)


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


def dirichlet_logpdf(x: torch.Tensor, alpha,
                     chains: bool = False) -> torch.Tensor:
    """Dirichlet(alpha) on a simplex x (<dirichletPrior>); -inf off the
    simplex (a sum more than 1e-8 from 1, or an entry <= 0). With
    `chains` each row of x [B, K] is a chain's simplex."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    alpha = alpha.expand(x.shape)
    positive = _total((x <= 0).to(x.dtype), chains) == 0
    safe = positive & (torch.abs(_total(x, chains) - 1.0) < 1e-8)
    xs = torch.where(x > 0, x, torch.ones_like(x))
    lp = (_total((alpha - 1) * torch.log(xs), chains)
          + torch.lgamma(_total(alpha, chains))
          - _total(torch.lgamma(alpha), chains))
    return torch.where(safe, lp, torch.full_like(lp, -math.inf))


def ctmc_scale_logpdf(rate: torch.Tensor, tree_length,
                      chains: bool = False) -> torch.Tensor:
    """The CTMC reference prior of an overall clock rate
    (CTMCScalePrior.java:51): p(rate) proportional to sqrt(T / rate)
    e^{-rate T}, T the tree length in time units. With `chains` rate is
    [B, ...] and tree_length [B], one per chain."""
    safe = rate > 0
    rs = torch.where(safe, rate, torch.ones_like(rate))
    tl = torch.as_tensor(tree_length, dtype=rate.dtype, device=rate.device)
    if chains:
        tl = tl.reshape(-1, *([1] * (rate.dim() - 1)))
    lp = (0.5 * (torch.log(tl) - torch.log(rs)) - rs * tl
          - math.lgamma(0.5))
    return _total(torch.where(safe, lp, torch.full_like(lp, -math.inf)),
                  chains)

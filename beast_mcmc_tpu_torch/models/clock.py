"""The uncorrelated lognormal relaxed clock, discretised.

Counterpart of beast_mcmc_tpu/models/clock.py:22,36 and of the
<discretizedBranchRates> rate function of
beast_mcmc_tpu/config/interpreter.py:2499-2514. A clock model is a function
from its parameters to a per-node rate [M]: the rate of the branch above
each node (the root's entry is unused).
"""

from __future__ import annotations

import torch


def lognormal_quantile(q: torch.Tensor, mean, stdev,
                       mean_in_real_space: bool = True) -> torch.Tensor:
    """Quantile of the UCLD rate distribution. With mean_in_real_space
    (BEAST's ucld.mean), mu = log(mean) - sigma^2 / 2 so that E[rate] =
    mean; otherwise `mean` is mu itself."""
    sigma = torch.as_tensor(stdev, dtype=q.dtype, device=q.device)
    mean = torch.as_tensor(mean, dtype=q.dtype, device=q.device)
    mu = torch.log(mean) - 0.5 * sigma * sigma if mean_in_real_space else mean
    return torch.exp(mu + sigma * torch.special.ndtri(q))


def discretized_lognormal_rates(categories: torch.Tensor, mean, stdev,
                                n_categories: int | None = None,
                                mean_in_real_space: bool = True,
                                dtype: torch.dtype = torch.float64
                                ) -> torch.Tensor:
    """Each branch's rate is the lognormal quantile at (c + 0.5) / K of its
    integer category c (DiscretizedBranchRates.java:327-340 setupRates).
    K defaults to the number of categories given."""
    k = n_categories or categories.shape[-1]
    q = (categories.to(dtype) + 0.5) / k
    return lognormal_quantile(q, mean, stdev, mean_in_real_space)


def default_rate_categories(n_nodes: int, device=None) -> torch.Tensor:
    """int64[M] categories the XML layer gives <discretizedBranchRates>: one
    slot per branch, node i in category i mod (M - 1)."""
    return torch.arange(n_nodes, device=device) % (n_nodes - 1)


def discretized_clock_rates(categories: torch.Tensor, mean, stdev,
                            dtype: torch.dtype = torch.float64
                            ) -> torch.Tensor:
    """The <discretizedBranchRates> rate function over M = categories'
    length nodes: K = M - 1 categories, the mean in real space."""
    return discretized_lognormal_rates(categories, mean, stdev,
                                       categories.shape[-1] - 1, True, dtype)


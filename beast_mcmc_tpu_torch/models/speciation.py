"""Speciation (birth-death) tree priors: the Gernhard (2008) conditioned
reconstructed process and its pure-birth case.

Counterpart of beast_mcmc_tpu/models/speciation.py:26-72
(Gernhard08BirthDeathModel.java:220-260 logTreeProbability /
logNodeProbability; YuleModel.java), parameterised as the reference does:

  r   = lambda - mu        (birth diff rate)
  a   = mu / lambda        (relative death rate; 0 => Yule)
  rho = sampling probability

density over internal-node heights x (unconditioned on the root):
  logL = (n-1) log(r rho) + n log(1-a)
       + sum_internal [ -2 log(rho + ((1-rho)-a) e^{-r h}) - r h ]
       + extra root term [ -r h_root - log(rho + ((1-rho)-a) e^{-r h_root}) ]

The serially sampled birth-death models of the JAX module are not ported.
"""

from __future__ import annotations

import math

import torch


def birth_death_loglik(heights: torch.Tensor, n_taxa: int, root,
                       birth_diff_rate, relative_death_rate=0.0,
                       sample_probability=1.0,
                       labeled: bool = True) -> torch.Tensor:
    """Gernhard08 birth-death density on an ultrametric tree's node
    heights; 0-d. labeled=True adds the LABELED coefficient 2^(n-1)/(n-1)!
    of the reference's default <birthDeathModel> (logCoeff). A chain
    batch, heights [B, M] and root [B] with the rates 0-d or [B], gives
    [B]."""
    dt, dev = heights.dtype, heights.device
    chains = heights.dim() == 2
    r, a, rho = (torch.as_tensor(v, dtype=dt, device=dev)
                 for v in (birth_diff_rate, relative_death_rate,
                           sample_probability))
    n = n_taxa
    m = heights.shape[-1]
    internal = torch.arange(m, device=dev) >= n

    def col(v):  # a chain's rate beside its row of heights
        return v[..., None] if chains and v.dim() == 1 else v

    mrh = -col(r) * heights
    z = torch.log(col(rho) + ((1.0 - col(rho)) - col(a)) * torch.exp(mrh))
    node_terms = torch.where(internal, -2.0 * z + mrh, torch.zeros_like(z))
    root = torch.as_tensor(root, device=dev)
    if chains:
        root = root.reshape(-1, 1)
        root_term = (torch.gather(mrh, -1, root)
                     - torch.gather(z, -1, root)).reshape(-1)
    else:
        root = root.reshape(1)
        root_term = (mrh[root] - z[root]).reshape(())
    c1 = (n - 1) * torch.log(r * rho) + n * torch.log1p(-a)
    if labeled:
        c1 = c1 + (n - 1) * math.log(2.0) - math.lgamma(n)
    return c1 + torch.sum(node_terms, dim=-1) + root_term


def yule_loglik(heights: torch.Tensor, n_taxa: int, root, birth_rate,
                labeled: bool = True) -> torch.Tensor:
    """The pure-birth case (YuleModel.java; a = 0, rho = 1)."""
    return birth_death_loglik(heights, n_taxa, root, birth_rate, 0.0, 1.0,
                              labeled=labeled)

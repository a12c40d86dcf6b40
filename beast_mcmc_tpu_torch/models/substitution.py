"""Nucleotide substitution models: parameters -> EigenSystem.

Counterpart of beast_mcmc_tpu/models/substitution.py. States A,C,G,T =
0..3; Q normalised to mean rate 1; GTR takes 6 exchangeabilities in the
reference order AC, AG, AT, CG, CT, GT.
"""

from __future__ import annotations

from typing import Optional

import torch

from beast_mcmc_tpu_torch.ops.eigen import EigenSystem, reversible_eigen
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


def symmetric_rates_from_vector(rates: torch.Tensor,
                                state_count: int) -> torch.Tensor:
    """Upper-triangle exchange-rate vector -> symmetric [S,S] matrix."""
    s = state_count
    iu = torch.triu_indices(s, s, 1, device=rates.device)
    r = torch.zeros((s, s), dtype=rates.dtype, device=rates.device)
    r = r.index_put((iu[0], iu[1]), rates)
    return r + r.T


def jc_eigen(freqs: Optional[torch.Tensor] = None, dtype=DEFAULT_FLOAT,
             device=DEFAULT_DEVICE) -> EigenSystem:
    """JC69: equal rates, equal frequencies."""
    if freqs is None:
        freqs = torch.full((4,), 0.25, dtype=dtype, device=device)
    return reversible_eigen(torch.ones((4, 4), dtype=freqs.dtype,
                                       device=freqs.device), freqs)


def hky_eigen(kappa, freqs: torch.Tensor) -> EigenSystem:
    """HKY85: kappa on the transitions A<->G and C<->T, 1 elsewhere. A
    kappa of shape [K] with freqs [K, 4] gives K systems at once."""
    kappa = torch.as_tensor(kappa, dtype=freqs.dtype, device=freqs.device)
    transition = torch.zeros((4, 4), dtype=torch.bool, device=freqs.device)
    transition[0, 2] = transition[2, 0] = transition[1, 3] = transition[3, 1] = True
    ones = torch.ones((4, 4), dtype=freqs.dtype, device=freqs.device)
    rates = torch.where(transition, kappa[..., None, None] * ones, ones)
    return reversible_eigen(rates, freqs)


def gtr_eigen(rates6: torch.Tensor, freqs: torch.Tensor) -> EigenSystem:
    """GTR with 6 exchangeabilities in reference order."""
    return reversible_eigen(symmetric_rates_from_vector(rates6, 4), freqs)

"""Substitution models: parameters -> EigenSystem.

Counterpart of beast_mcmc_tpu/models/substitution.py. Nucleotide states
A,C,G,T = 0..3; Q normalised to mean rate 1; GTR takes 6 exchangeabilities
in the reference order AC, AG, AT, CG, CT, GT. The amino-acid models take
their 190 exchangeabilities and 20 frequencies from models/data/
aa_matrices.py (order ACDEFGHIKLMNPQRSTVWY); the codon models run over the
61 sense codons of data/codons.py. The non-reversible generators of the
discrete-trait models (`complex_q`, `general_complex_q`) return a
normalised Q for ops/expm.py instead of an EigenSystem, and
`svs_connectivity_logprior` is the BSSVS indicator graph's prior.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from beast_mcmc_tpu_torch.data.codons import UNIVERSAL_CODE, codon_structure
from beast_mcmc_tpu_torch.models.data.aa_matrices import AA_MODELS
from beast_mcmc_tpu_torch.ops.eigen import EigenSystem, reversible_eigen
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


def symmetric_rates_from_vector(rates: torch.Tensor,
                                state_count: int) -> torch.Tensor:
    """Upper-triangle exchange-rate vector -> symmetric [S,S] matrix;
    [..., S(S-1)/2] rates (a chain batch) give [..., S, S]."""
    s = state_count
    lead = rates.shape[:-1]
    iu = torch.triu_indices(s, s, 1, device=rates.device)
    r = torch.zeros((s, s, *lead), dtype=rates.dtype, device=rates.device)
    r = r.index_put((iu[0], iu[1]), rates.movedim(-1, 0))
    r = r.movedim((0, 1), (-2, -1))
    return r + r.transpose(-1, -2)


def jc_eigen(freqs: Optional[torch.Tensor] = None, dtype=DEFAULT_FLOAT,
             device=DEFAULT_DEVICE) -> EigenSystem:
    """JC69: equal rates, equal frequencies."""
    if freqs is None:
        freqs = torch.full((4,), 0.25, dtype=dtype, device=device)
    return reversible_eigen(torch.ones((4, 4), dtype=freqs.dtype,
                                       device=freqs.device), freqs)


def hky_eigen(kappa, freqs: torch.Tensor) -> EigenSystem:
    """HKY85: kappa on the transitions A<->G and C<->T, 1 elsewhere. A
    kappa of shape [K] with freqs [K, 4] gives K systems at once; a chain
    batch's kappa [B] or [B, K] gives [B] or [B, K] (freqs broadcast)."""
    kappa = torch.as_tensor(kappa, dtype=freqs.dtype, device=freqs.device)
    transition = torch.zeros((4, 4), dtype=torch.bool, device=freqs.device)
    transition[0, 2] = transition[2, 0] = transition[1, 3] = transition[3, 1] = True
    ones = torch.ones((4, 4), dtype=freqs.dtype, device=freqs.device)
    rates = torch.where(transition, kappa[..., None, None] * ones, ones)
    return reversible_eigen(rates, freqs)


def gtr_eigen(rates6: torch.Tensor, freqs: torch.Tensor) -> EigenSystem:
    """GTR with 6 exchangeabilities in reference order; rates6 [B, 6] (a
    chain batch) gives B systems from one batched eigh."""
    return reversible_eigen(symmetric_rates_from_vector(rates6, 4), freqs)


def tn93_eigen(kappa1, kappa2, freqs: torch.Tensor) -> EigenSystem:
    """TN93: separate purine (A<->G, kappa1) and pyrimidine (C<->T, kappa2)
    transition rates."""
    k1 = torch.as_tensor(kappa1, dtype=freqs.dtype, device=freqs.device)
    k2 = torch.as_tensor(kappa2, dtype=freqs.dtype, device=freqs.device)
    # exchangeabilities AC, AG, AT, CG, CT, GT
    one = torch.ones((), dtype=freqs.dtype, device=freqs.device)
    return gtr_eigen(torch.stack([one, k1, one, one, k2, one]), freqs)


def general_reversible_eigen(rates_vec: torch.Tensor,
                             freqs: torch.Tensor) -> EigenSystem:
    """S-state reversible model from S(S-1)/2 exchangeabilities (discrete
    traits, phylogeography)."""
    return reversible_eigen(
        symmetric_rates_from_vector(rates_vec, freqs.shape[-1]), freqs)


def svs_masked_rates(rates_vec: torch.Tensor,
                     indicators: torch.Tensor) -> torch.Tensor:
    """BSSVS: elementwise indicator mask over the exchangeabilities;
    masked-out rates become 0."""
    return rates_vec * indicators


def empirical_aa_eigen(model_name: str, freqs: Optional[torch.Tensor] = None,
                       dtype=DEFAULT_FLOAT, device=DEFAULT_DEVICE
                       ) -> EigenSystem:
    """Empirical amino-acid replacement model (Dayhoff, JTT, WAG, LG, mt*,
    cpREV, FLU, Blosum62). freqs=None uses the model's published
    frequencies; pass alignment frequencies for the +F variants."""
    entry = AA_MODELS[model_name.upper()]
    if freqs is None:
        freqs = torch.tensor(entry["frequencies"], dtype=dtype, device=device)
    rates = torch.tensor(entry["rates"], dtype=freqs.dtype,
                         device=freqs.device)
    return general_reversible_eigen(rates, freqs)


def _codon_rates(codon_freqs: torch.Tensor, code):
    """(single, is_transition, is_nonsynonymous), each [61, 61], on the
    frequencies' device."""
    return tuple(torch.as_tensor(a, dtype=codon_freqs.dtype,
                                 device=codon_freqs.device)
                 for a in codon_structure(code or UNIVERSAL_CODE))


def gy94_eigen(kappa, omega, codon_freqs: torch.Tensor,
               code=None) -> EigenSystem:
    """Goldman-Yang 1994 codon model: single-nucleotide codon exchanges at
    rate kappa^[transition] * omega^[nonsynonymous]; reversible with respect
    to the codon frequencies."""
    single, is_ts, is_nonsyn = _codon_rates(codon_freqs, code)
    kappa = torch.as_tensor(kappa, dtype=codon_freqs.dtype,
                            device=codon_freqs.device)
    omega = torch.as_tensor(omega, dtype=codon_freqs.dtype,
                            device=codon_freqs.device)
    return reversible_eigen(single * kappa ** is_ts * omega ** is_nonsyn,
                            codon_freqs)


def mg94_eigen(alpha, beta, kappa, codon_freqs: torch.Tensor,
               code=None) -> EigenSystem:
    """Muse-Gaut 1994 codon model, HKY-parameterised: synonymous rate alpha
    (dS), non-synonymous beta (dN), each times kappa for transitions;
    multi-position changes 0."""
    single, is_ts, is_nonsyn = _codon_rates(codon_freqs, code)
    alpha, beta, kappa = (torch.as_tensor(v, dtype=codon_freqs.dtype,
                                          device=codon_freqs.device)
                          for v in (alpha, beta, kappa))
    return reversible_eigen(
        single * kappa ** is_ts * torch.where(is_nonsyn > 0, beta, alpha),
        codon_freqs)


def complex_q(rates_full: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Non-reversible generator from all S(S-1) off-diagonal rates in
    row-major order (the diagonal skipped): Q_ij = r_ij pi_j, rows summing
    to 0, unit expected rate (ComplexSubstitutionModel.java setupMatrix;
    beast_mcmc_tpu/models/substitution.py:159)."""
    s = freqs.shape[-1]
    off = ~torch.eye(s, dtype=torch.bool, device=freqs.device)
    r = torch.zeros((s, s), dtype=freqs.dtype, device=freqs.device)
    q = r.masked_scatter(off, rates_full.to(freqs.dtype)) * freqs[None, :]
    q = q - torch.diag(torch.sum(q, dim=1))
    return q / -torch.sum(freqs * torch.diagonal(q))


def general_complex_q(rates: torch.Tensor,
                      freqs: torch.Tensor) -> torch.Tensor:
    """The generator of <svsGeneralSubstitutionModel> with K(K-1) rates in
    the reference's complex order: the upper triangle row-major, then the
    lower triangle in transposed (column-major) order
    (ComplexSubstitutionModel.setupQMatrix:211-230); Q_ij = r_ij pi_j with
    freqs normalised here, scaled to unit expected rate. Counterpart of
    beast_mcmc_tpu/config/xml_geo.py:139 (_complex_q_fn, its defaults)."""
    k = freqs.shape[-1]
    pi = freqs / torch.sum(freqs)
    iu = torch.triu_indices(k, k, 1, device=freqs.device)
    n_half = k * (k - 1) // 2
    r = rates.to(pi.dtype)
    q = torch.zeros((k, k), dtype=pi.dtype, device=pi.device)
    q = q.index_put((iu[0], iu[1]), r[:n_half] * pi[iu[1]])
    q = q.index_put((iu[1], iu[0]), r[n_half:] * pi[iu[0]])
    q = q - torch.diag(torch.sum(q, dim=1))
    return q / -torch.sum(pi * torch.diagonal(q))


def svs_connectivity_logprior(indicators: torch.Tensor,
                              k: int) -> torch.Tensor:
    """0 where the BSSVS indicators [K(K-1)], in general_complex_q's order,
    leave the directed rate graph strongly connected, else -inf
    (SVSGeneralSubstitutionModel.getLogLikelihood():111-115;
    beast_mcmc_tpu/config/xml_geo.py:230-260). All-pairs reachability by
    ceil(log2 K) squarings of the boolean adjacency with self-loops."""
    ind = indicators.reshape(-1) > 0.5
    n_half = k * (k - 1) // 2
    iu = torch.triu_indices(k, k, 1, device=ind.device)
    adj = torch.eye(k, dtype=torch.bool, device=ind.device)
    adj = adj.index_put((iu[0], iu[1]), ind[:n_half])
    adj = adj.index_put((iu[1], iu[0]), ind[n_half:])
    # float products: the counts stay far below 2^24, so > 0 is exact
    a = adj.to(torch.float32)
    for _ in range(math.ceil(math.log2(max(k, 2)))):
        a = ((a @ a) > 0).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float64, device=ind.device)
    return torch.where(torch.all(a > 0), zero, zero - math.inf)

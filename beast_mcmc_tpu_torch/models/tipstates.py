"""Tip-data uncertainty: sequence error and APOBEC hypermutation.

Counterpart of beast_mcmc_tpu/models/tipstates.py (TipStatesModel.java:45;
SequenceErrorModel.java:123-200; HypermutantErrorModel.java:95-140). Each
model is a function from the observed states and its error parameters to
the [N, 4, P] tip partials the peel reads, so an error rate is sampled as
any other parameter. Nucleotide codes A, C, G, T = 0..3; 4 and above are
ambiguous or gaps (partial 1 in every state).
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_FLOAT

# each state's transition partner (A<->G, C<->T)
_TS_PARTNER = (2, 3, 0, 1)


def sequence_error_partials(tip_states: torch.Tensor, base_error_rate=0.0,
                            age_related_rate=None, tip_ages=None,
                            transitions_only: bool = False,
                            dtype=DEFAULT_FLOAT) -> torch.Tensor:
    """[N, 4, P] partials p(observed | true) under the sequence error
    model: p_undamaged = (1 - base) exp(-rate age) on the observed state,
    the rest spread over the transition partner alone or over all three
    others (SequenceErrorModel.java:128-155). tip_states int [N, P];
    tip_ages [N] with age_related_rate. The rates may be 0-d tensors (a
    sampled error rate), differentiable."""
    n, p = tip_states.shape
    dev = tip_states.device
    base = torch.as_tensor(base_error_rate, dtype=dtype, device=dev)
    p_und = (1.0 - base).expand(n, 1)
    if age_related_rate is not None:
        ages = torch.as_tensor(tip_ages, dtype=dtype, device=dev)
        rate = torch.as_tensor(age_related_rate, dtype=dtype, device=dev)
        p_und = p_und * torch.exp(-rate * ages)[:, None]
    if transitions_only:
        p_ts, p_tv = 1.0 - p_und, torch.zeros_like(p_und)
    else:
        p_ts = p_tv = (1.0 - p_und) / 3.0
    obs = tip_states[:, None, :]  # [N, 1, P]
    s_axis = torch.arange(4, device=dev)[None, :, None]
    partner = torch.tensor(_TS_PARTNER, device=dev)[obs.clamp(0, 3)]
    out = torch.where(s_axis == obs, p_und[:, :, None],
                      torch.where(s_axis == partner, p_ts[:, :, None],
                                  p_tv[:, :, None]))
    return torch.where(obs >= 4, torch.ones_like(out), out)


def hypermutant_error_partials(tip_states: torch.Tensor,
                               apobec_context: torch.Tensor,
                               hypermutated: torch.Tensor, rate,
                               dtype=DEFAULT_FLOAT) -> torch.Tensor:
    """[N, 4, P] partials under the APOBEC hypermutation model: an A in a
    hypermutable context on a hypermutated tip is really a G with
    probability `rate` (HypermutantErrorModel.java:129-140); elsewhere
    the observed state's one-hot partial (1 everywhere for an ambiguous
    state). apobec_context bool [N, P], hypermutated bool [N], rate 0-d or
    [N]."""
    n, p = tip_states.shape
    dev = tip_states.device
    r = torch.as_tensor(rate, dtype=dtype, device=dev).expand(n)[:, None]
    base = torch.nn.functional.one_hot(tip_states.clamp(0, 3).long(),
                                       4).to(dtype)
    base = torch.where((tip_states >= 4)[:, :, None], torch.ones_like(base),
                       base).transpose(1, 2)  # [N, 4, P]
    eff = apobec_context & (tip_states == 0) & hypermutated[:, None]
    a_row = torch.where(eff, 1.0 - r, base[:, 0, :])
    g_row = torch.where(eff, r.expand(n, p), base[:, 2, :])
    return torch.stack([a_row, base[:, 1, :], g_row, base[:, 3, :]], dim=1)


def hypermutation_count_statistic(apobec_context: torch.Tensor,
                                  hypermutated: torch.Tensor) -> torch.Tensor:
    """The hypermutable sites on hypermutated tips (HypermutantAlignment's
    statistic)."""
    return torch.sum(apobec_context & hypermutated[:, None])

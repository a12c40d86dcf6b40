"""Constant-size coalescent tree prior.

Counterpart of beast_mcmc_tpu/models/coalescent.py:28-74. Intervals come
from a device-side sort of node heights with lineage deltas (+1 at tips,
-1 at coalescences); lineage counts are their prefix sum.
logL = sum_coal -log N(t_i) - sum_intervals C(k,2) [L(t_end) - L(t_start)]
with intensity L(t) = int 1/N.
"""

from __future__ import annotations

from typing import Callable

import torch

from beast_mcmc_tpu_torch.utils.accum import prefix_sum


def coalescent_intervals(heights: torch.Tensor, n_taxa: int):
    """(times[M], lineages[M], is_coal[M]): sorted event times, the
    lineages alive in (times[i], times[i+1]), and the coalescence flags.
    At equal heights tips sort before coalescences."""
    m = heights.shape[0]
    ar = torch.arange(m, device=heights.device)
    delta = torch.where(ar < n_taxa, 1, -1)
    # lexsort (height, then delta descending) from two stable sorts
    sec = torch.sort(-delta, stable=True).indices
    order = sec[torch.sort(heights[sec], stable=True).indices]
    times = heights[order]
    deltas = delta[order]
    lineages = prefix_sum(deltas, dim=0)
    return times, lineages, deltas < 0


def coalescent_loglik(heights: torch.Tensor, n_taxa: int,
                      log_pop: Callable[[torch.Tensor], torch.Tensor],
                      intensity: Callable[[torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """Coalescent density for a parametric demographic."""
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    dt_intensity = intensity(times[1:]) - intensity(times[:-1])
    k = lineages[:-1]
    choose2 = (k * (k - 1) / 2.0).to(heights.dtype)
    interval_term = -torch.sum(choose2 * dt_intensity)
    event_term = -torch.sum(torch.where(is_coal, log_pop(times),
                                        torch.zeros_like(times)))
    return interval_term + event_term


def constant_coalescent_loglik(heights: torch.Tensor, n_taxa: int,
                               pop_size) -> torch.Tensor:
    """Constant population size (ConstantPopulation.java)."""
    pop = torch.as_tensor(pop_size, dtype=heights.dtype, device=heights.device)
    return coalescent_loglik(
        heights, n_taxa,
        log_pop=lambda t: torch.log(pop).expand(t.shape),
        intensity=lambda t: t / pop,
    )

"""Coalescent tree priors: constant size, and the skygrid with its GMRF
smoothing prior.

Counterpart of beast_mcmc_tpu/models/coalescent.py:28-74,138-194.
Intervals come from a device-side sort of node heights with lineage deltas
(+1 at tips, -1 at coalescences); lineage counts are their prefix sum.
logL = sum_coal -log N(t_i) - sum_intervals C(k,2) [L(t_end) - L(t_start)]
with intensity L(t) = int 1/N.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from beast_mcmc_tpu_torch.utils.accum import prefix_sum


def coalescent_intervals(heights: torch.Tensor, n_taxa: int):
    """(times[M], lineages[M], is_coal[M]): sorted event times, the
    lineages alive in (times[i], times[i+1]), and the coalescence flags.
    At equal heights tips sort before coalescences. heights [B, M] (a chain
    batch) gives [B, M] each, row by row."""
    m = heights.shape[-1]
    ar = torch.arange(m, device=heights.device)
    delta = torch.where(ar < n_taxa, 1, -1)
    # lexsort (height, then delta descending) from two stable sorts
    sec = torch.sort(-delta, stable=True).indices
    order = sec[torch.sort(heights[..., sec], dim=-1, stable=True).indices]
    times = torch.gather(heights, -1, order)
    deltas = delta[order]
    lineages = prefix_sum(deltas, dim=-1)
    return times, lineages, deltas < 0


def coalescent_loglik(heights: torch.Tensor, n_taxa: int,
                      log_pop: Callable[[torch.Tensor], torch.Tensor],
                      intensity: Callable[[torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """Coalescent density for a parametric demographic; [B] for heights
    [B, M]."""
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    dt_intensity = intensity(times[..., 1:]) - intensity(times[..., :-1])
    k = lineages[..., :-1]
    choose2 = (k * (k - 1) / 2.0).to(heights.dtype)
    interval_term = -torch.sum(choose2 * dt_intensity, dim=-1)
    event_term = -torch.sum(torch.where(is_coal, log_pop(times),
                                        torch.zeros_like(times)), dim=-1)
    return interval_term + event_term


def constant_coalescent_loglik(heights: torch.Tensor, n_taxa: int,
                               pop_size) -> torch.Tensor:
    """Constant population size (ConstantPopulation.java). A chain batch,
    heights [B, M] and pop_size [B], gives [B]."""
    pop = torch.as_tensor(pop_size, dtype=heights.dtype, device=heights.device)
    pop = pop[..., None] if heights.dim() == 2 and pop.dim() == 1 else pop
    return coalescent_loglik(
        heights, n_taxa,
        log_pop=lambda t: torch.log(pop).expand(t.shape),
        intensity=lambda t: t / pop,
    )


def skygrid_cut_points(n_grid: int, cutoff: float, dtype=torch.float64,
                       device=None) -> torch.Tensor:
    """The [n_grid] interior boundaries that <gmrfSkyGridLikelihood> makes
    from numGridPoints and cutOff: linspace(cutoff / n, cutoff, n)
    (beast_mcmc_tpu/config/xml_ext.py:194-230), numpy's, so that an event
    on a boundary falls in the same cell."""
    return torch.tensor(np.linspace(cutoff / n_grid, cutoff, n_grid),
                        dtype=dtype, device=device)


def skygrid_loglik(heights: torch.Tensor, n_taxa: int,
                   log_pop_sizes: torch.Tensor,
                   cut_points: torch.Tensor) -> torch.Tensor:
    """Coalescent density under a piecewise-constant N(t): cell k covers
    [cut_{k-1}, cut_k) with cut_{-1} = 0 and cut_{K-1} = inf, gamma[k] =
    log N there. The interval term is a masked interval-by-cell overlap
    sum; an event exactly at a grid point belongs to the cell below it
    (searchsorted, side left), as in the JAX package."""
    dt = heights.dtype
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    zero = torch.zeros(1, dtype=dt, device=heights.device)
    lo = torch.cat([zero, cut_points])
    hi = torch.cat([cut_points, torch.full_like(zero, float("inf"))])
    t0, t1 = times[:-1, None], times[1:, None]
    overlap = torch.clamp(torch.minimum(t1, hi) - torch.maximum(t0, lo),
                          min=0.0)
    k = lineages[:-1]
    choose2 = (k * (k - 1) / 2.0).to(dt)
    interval_term = -torch.sum(choose2[:, None] * overlap
                               * torch.exp(-log_pop_sizes)[None, :])
    cell = torch.searchsorted(cut_points, times, side="left")
    event_term = -torch.sum(torch.where(is_coal, log_pop_sizes[cell],
                                        torch.zeros_like(times)))
    return interval_term + event_term


def gmrf_log_prior(log_pop_sizes: torch.Tensor, precision) -> torch.Tensor:
    """First-order GMRF (RW1) smoothing prior on the skygrid's log
    populations (GMRFSkyrideLikelihood calculateLogFieldLikelihood):
    (K-1)/2 log(tau / 2 pi) - tau / 2 sum (g_{k+1} - g_k)^2."""
    tau = torch.as_tensor(precision, dtype=log_pop_sizes.dtype,
                          device=log_pop_sizes.device)
    diffs = torch.diff(log_pop_sizes)
    k1 = diffs.shape[0]
    return (0.5 * k1 * (torch.log(tau) - math.log(2 * math.pi))
            - 0.5 * tau * torch.sum(diffs * diffs))

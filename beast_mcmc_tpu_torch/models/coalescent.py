"""Coalescent tree priors: constant size, exponential growth, and the
skygrid with its GMRF smoothing prior.

Counterpart of beast_mcmc_tpu/models/coalescent.py:28-95,138-194.
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


def exponential_growth_loglik(heights: torch.Tensor, n_taxa: int,
                              pop_size, growth_rate) -> torch.Tensor:
    """Exponential growth N(t) = N0 exp(-r t) backwards in time
    (ExponentialGrowth.java getIntensity). A chain batch, heights [B, M]
    with pop_size and growth_rate [B], gives [B]."""
    n0 = torch.as_tensor(pop_size, dtype=heights.dtype, device=heights.device)
    r = torch.as_tensor(growth_rate, dtype=heights.dtype,
                        device=heights.device)
    if heights.dim() == 2:
        n0 = n0[..., None] if n0.dim() == 1 else n0
        r = r[..., None] if r.dim() == 1 else r

    def intensity(t):
        # (exp(r t) - 1) / (r N0); the r -> 0 limit t / N0, via expm1
        return torch.where(torch.abs(r) < 1e-12, t / n0,
                           torch.expm1(r * t) / (r * n0))

    return coalescent_loglik(heights, n_taxa,
                             lambda t: torch.log(n0) - r * t, intensity)


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
    (searchsorted, side left), as in the JAX package. A chain batch,
    heights [B, M] and log_pop_sizes [B, K], gives [B]."""
    dt = heights.dtype
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    zero = torch.zeros(1, dtype=dt, device=heights.device)
    lo = torch.cat([zero, cut_points])
    hi = torch.cat([cut_points, torch.full_like(zero, float("inf"))])
    t0, t1 = times[..., :-1, None], times[..., 1:, None]
    overlap = torch.clamp(torch.minimum(t1, hi) - torch.maximum(t0, lo),
                          min=0.0)
    k = lineages[..., :-1]
    choose2 = (k * (k - 1) / 2.0).to(dt)
    interval_term = -torch.sum(
        choose2[..., None] * overlap
        * torch.exp(-log_pop_sizes)[..., None, :], dim=(-2, -1))
    cell = torch.searchsorted(cut_points, times, side="left")
    at_cell = (torch.gather(log_pop_sizes, -1, cell) if times.dim() == 2
               else log_pop_sizes[cell])
    event_term = -torch.sum(torch.where(is_coal, at_cell,
                                        torch.zeros_like(times)), dim=-1)
    return interval_term + event_term


def gmrf_log_prior(log_pop_sizes: torch.Tensor, precision) -> torch.Tensor:
    """First-order GMRF (RW1) smoothing prior on the skygrid's log
    populations (GMRFSkyrideLikelihood calculateLogFieldLikelihood):
    (K-1)/2 log(tau / 2 pi) - tau / 2 sum (g_{k+1} - g_k)^2. A chain batch,
    log_pop_sizes [B, K] and precision [B], gives [B]."""
    tau = torch.as_tensor(precision, dtype=log_pop_sizes.dtype,
                          device=log_pop_sizes.device)
    diffs = torch.diff(log_pop_sizes, dim=-1)
    k1 = diffs.shape[-1]
    return (0.5 * k1 * (torch.log(tau) - math.log(2 * math.pi))
            - 0.5 * tau * torch.sum(diffs * diffs, dim=-1))

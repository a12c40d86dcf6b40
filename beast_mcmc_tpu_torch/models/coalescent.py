"""Coalescent tree priors.

Counterpart of beast_mcmc_tpu/models/coalescent.py, every function of it
(CoalescentLikelihood.java:99-124, the demographic functions of
dr.evolution.coalescent, the skyline, skyride, skygrid, EBSP and SIR
models). Intervals come from a device-side sort of node heights with
lineage deltas (+1 at tips, -1 at coalescences); lineage counts are their
prefix sum.
logL = sum_coal -log N(t_i) - sum_intervals C(k,2) [L(t_end) - L(t_start)]
with intensity L(t) = int 1/N.

The JAX package's scans become their PyTorch forms with no host read: the
EBSP's max/min associative scans are torch.cummax / cummin (flipped for
the reverse one), the SIR ODE's lax.scan a fixed Python loop of RK4 steps
over tensors, jnp.interp the searchsorted form of `_interp`. The functions
past skygrid_loglik and gmrf_log_prior take one tree (no chain axis).
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



# ---------------------------------------------------------------------------
# Helpers: searchsorted over any dtypes, jnp.interp
# ---------------------------------------------------------------------------

def _searchsorted(sorted_seq: torch.Tensor, values, side: str = "left"
                  ) -> torch.Tensor:
    """jnp.searchsorted: values may be a number or another dtype."""
    v = torch.as_tensor(values, device=sorted_seq.device).to(
        sorted_seq.dtype)
    return torch.searchsorted(sorted_seq.contiguous(), v.contiguous(),
                              side=side)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """jnp.interp(x, xp, fp): piecewise-linear on ascending xp, fp[0] and
    fp[-1] outside, JAX's formula (a zero-width cell takes its left
    value)."""
    n = xp.shape[0]
    i = torch.clamp(_searchsorted(xp, x, "right"), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    np_dt = np.float64 if xp.dtype == torch.float64 else np.float32
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np_dt).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _t(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _choose2(lineages: torch.Tensor, dt) -> torch.Tensor:
    return (lineages * (lineages - 1) / 2.0).to(dt)


# ---------------------------------------------------------------------------
# Parametric demographics
# ---------------------------------------------------------------------------

def logistic_growth_loglik(heights, n_taxa: int, pop_size, growth_rate,
                           t50) -> torch.Tensor:
    """Logistic growth (LogisticGrowth.java:setTime50, c = 1/(exp(r t50)
    - 2) so that N(t50) = N0 / 2): N(t) = N0 (1+c) / (1 + c e^{rt})."""
    n0, r = _t(pop_size, heights), _t(growth_rate, heights)
    c = 1.0 / (torch.expm1(r * _t(t50, heights)) - 1.0)
    return coalescent_loglik(
        heights, n_taxa,
        lambda t: torch.log(n0) + torch.log1p(c) - torch.log1p(
            c * torch.exp(r * t)),
        lambda t: (t + c * torch.expm1(r * t) / r) / (n0 * (1.0 + c)))


def expansion_loglik(heights, n_taxa: int, pop_size, ancestral_prop,
                     growth_rate) -> torch.Tensor:
    """Expansion: N(t) = N0 (p + (1-p) e^{-rt}) (Expansion.java)."""
    n0, p = _t(pop_size, heights), _t(ancestral_prop, heights)
    r = _t(growth_rate, heights)
    return coalescent_loglik(
        heights, n_taxa,
        lambda t: torch.log(n0) + torch.log(p + (1 - p) * torch.exp(-r * t)),
        lambda t: torch.log(p * torch.exp(r * t) + (1 - p)) / (p * r * n0))


def _safe_expm1_over(lam, x):
    """expm1(lam x) / lam, x where |lam| < 1e-12."""
    small = torch.abs(lam) < 1e-12
    return torch.where(small, x, torch.expm1(lam * x) / lam)


def piecewise_exponential_loglik(heights, n_taxa: int, thetas, lambdas,
                                 widths) -> torch.Tensor:
    """Piecewise-exponential demographic
    (PiecewiseExponentialPopulation.java:83-118): with a theta vector epoch
    e restarts at N = theta_e and decays at its lambda; with one theta the
    epochs chain. thetas [K] or [1], lambdas [1] or [K], widths [K-1]."""
    dt, dev = heights.dtype, heights.device
    thetas = torch.atleast_1d(_t(thetas, heights))
    lambdas = torch.atleast_1d(_t(lambdas, heights))
    widths = _t(widths, heights).reshape(-1)
    k = max(thetas.shape[0], lambdas.shape[0])
    zero = torch.zeros(1, dtype=dt, device=dev)
    starts = torch.cat([zero, prefix_sum(widths)])
    lam = lambdas.expand(k)
    if thetas.shape[0] == 1:
        decay = torch.cat([zero, prefix_sum(lam[:-1] * widths)])
        th = thetas[0] * torch.exp(-decay)
    else:
        th = thetas.expand(k)
    full = _safe_expm1_over(lam[:-1], widths) / th[:-1]
    cum_full = torch.cat([zero, prefix_sum(full)])

    def epoch_of(t):
        return torch.clamp(_searchsorted(starts[1:], t, "right"), 0, k - 1)

    def log_pop(t):
        e = epoch_of(t)
        return torch.log(th[e]) - lam[e] * (t - starts[e])

    def intensity(t):
        e = epoch_of(t)
        return cum_full[e] + _safe_expm1_over(lam[e], t - starts[e]) / th[e]

    return coalescent_loglik(heights, n_taxa, log_pop, intensity)


def cataclysm_loglik(heights, n_taxa: int, pop_size, growth_rate,
                     spike_factor, cat_time) -> torch.Tensor:
    """Cataclysmic demographic (CataclysmicDemographic.java): backwards in
    time N grows at d = log(spikeFactor) / catTime up to the cataclysm,
    then declines at growth_rate; the spike is N0 * spikeFactor."""
    n0, r = _t(pop_size, heights), _t(growth_rate, heights)
    tc = _t(cat_time, heights)
    d = torch.log(_t(spike_factor, heights)) / tc
    spike = n0 * torch.exp(tc * d)
    i_spike = (torch.exp(-d * tc) - 1.0) / n0 / (-d)

    def log_pop(t):
        return torch.where(t < tc, torch.log(n0) + t * d,
                           torch.log(spike) - (t - tc) * r)

    def intensity(t):
        before = (torch.exp(-d * t) - 1.0) / n0 / (-d)
        u = torch.clamp_min(t - tc, 0.0)
        after = i_spike + torch.where(torch.abs(r) < 1e-12, u / spike,
                                      torch.expm1(r * u) / (spike * r))
        return torch.where(t < tc, before, after)

    return coalescent_loglik(heights, n_taxa, log_pop, intensity)


# ---------------------------------------------------------------------------
# Bayesian skyline and the skyride
# ---------------------------------------------------------------------------

def bayesian_skyline_loglik(heights: torch.Tensor, n_taxa: int,
                            pop_sizes: torch.Tensor,
                            group_sizes: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant Bayesian skyline (BayesianSkylineLikelihood):
    group k spans coalescent events [cum_{k-1}, cum_k); an inter-event
    interval takes the population of the group of the next coalescent
    event."""
    dt = heights.dtype
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    coal_before = prefix_sum(is_coal.to(torch.int64))
    cum_groups = prefix_sum(group_sizes.to(torch.int64))

    def group_of(j):
        return _searchsorted(cum_groups, j, "right")

    next_event = torch.clamp_max(coal_before[:-1], n_taxa - 2)
    n_interval = pop_sizes[group_of(next_event)]
    choose2 = _choose2(lineages[:-1], dt)
    interval_term = -torch.sum(choose2 * torch.diff(times) / n_interval)
    event_idx = torch.clamp_min(coal_before - 1, 0)
    event_term = -torch.sum(torch.where(
        is_coal, torch.log(pop_sizes[group_of(event_idx)]),
        torch.zeros_like(times)))
    return interval_term + event_term


def bayesian_skyline_linear_loglik(heights: torch.Tensor, n_taxa: int,
                                   pop_sizes: torch.Tensor,
                                   group_sizes: torch.Tensor
                                   ) -> torch.Tensor:
    """Piecewise-linear Bayesian skyline (BayesianSkylineLikelihood.java
    LINEAR_TYPE:87,187-210): N(t) goes linearly from pop_sizes[k] at group
    k's start to pop_sizes[k+1] at its end (boundaries at coalescent
    events, group 0 from the first sampling time); an interval's intensity
    is dt log(N_end / N_start) / (N_end - N_start)."""
    dt_ = heights.dtype
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    n_events = n_taxa - 1
    coal_times = torch.sort(heights[n_taxa:]).values
    cum = prefix_sum(group_sizes.to(torch.int64))
    k_groups = group_sizes.shape[0]
    t0 = torch.min(heights[:n_taxa])
    ends = coal_times[torch.clamp(cum - 1, 0, n_events - 1)]
    starts = torch.cat([t0.reshape(1), ends[:-1]])

    def n_of(t):
        g = torch.clamp(_searchsorted(ends, t, "left"), 0, k_groups - 1)
        span = torch.clamp_min(ends[g] - starts[g], 1e-300)
        frac = torch.clamp((t - starts[g]) / span, 0.0, 1.0)
        return pop_sizes[g] * (1.0 - frac) + pop_sizes[g + 1] * frac

    ta, tb = times[:-1], times[1:]
    ns, ne = n_of(ta), n_of(tb)
    d = tb - ta
    diff = ne - ns
    near = torch.abs(diff) < 1e-9 * torch.clamp_min(ns, 1e-300)
    safe_diff = torch.where(near, torch.ones_like(diff), diff)
    intensity = torch.where(
        near, d / ns,
        d * (torch.log(torch.clamp_min(ne, 1e-300))
             - torch.log(torch.clamp_min(ns, 1e-300))) / safe_diff)
    choose2 = _choose2(lineages[:-1], dt_)
    interval_term = -torch.sum(choose2 * intensity)
    event_term = -torch.sum(torch.where(
        is_coal, torch.log(torch.clamp_min(n_of(times), 1e-300)),
        torch.zeros_like(times)))
    return interval_term + event_term


def gmrf_skyride_loglik(heights: torch.Tensor, n_taxa: int,
                        log_pops: torch.Tensor) -> torch.Tensor:
    """Skyride coalescent density (GMRFSkyrideLikelihood.java:57
    calculateLogCoalescentLikelihood): one field value per coalescent
    event; an inter-event interval takes the value of the next coalescent
    event back in time."""
    dt = heights.dtype
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    coal_before = prefix_sum(is_coal.to(torch.int64))
    next_event = torch.clamp_max(coal_before[:-1], n_taxa - 2)
    gamma = log_pops[next_event]
    choose2 = _choose2(lineages[:-1], dt)
    interval_term = -torch.sum(choose2 * torch.diff(times)
                               * torch.exp(-gamma))
    event_idx = torch.clamp_min(coal_before - 1, 0)
    event_term = -torch.sum(torch.where(is_coal, log_pops[event_idx],
                                        torch.zeros_like(times)))
    return interval_term + event_term


def skyride_coalescent_midpoints(heights: torch.Tensor, n_taxa: int
                                 ) -> torch.Tensor:
    """The coalescent event times [n_taxa - 1], ascending: the knots of
    the skyride field."""
    return torch.sort(heights[n_taxa:]).values


def gmrf_skyride_time_aware_prior(heights: torch.Tensor, n_taxa: int,
                                  log_pops: torch.Tensor,
                                  precision) -> torch.Tensor:
    """Time-aware GMRF smoothing prior of the skyride field
    (GMRFSkyrideLikelihood.java setupGMRFWeights: weights 2 / (delta_i +
    delta_{i+1}), delta_i the i-th coalescent interval):
    (n-1)/2 log tau - tau/2 sum_i (g_{i+1} - g_i)^2 w_i."""
    tau = _t(precision, heights)
    knots = skyride_coalescent_midpoints(heights, n_taxa)
    t0 = torch.max(heights[:n_taxa] * 0.0)  # the field starts at 0
    starts = torch.cat([t0.reshape(1), knots[:-1]])
    delta = knots - starts
    w = 2.0 / (delta[:-1] + delta[1:] + 1e-300)
    diff = log_pops[1:] - log_pops[:-1]
    n_field = log_pops.shape[0]
    return (0.5 * (n_field - 1) * torch.log(tau)
            - 0.5 * tau * torch.sum(diff * diff * w))


def gmrf_skyride_uniform_prior(log_pops: torch.Tensor, precision
                               ) -> torch.Tensor:
    """The uniform-weight GMRF prior (timeAwareSmoothing off)."""
    tau = _t(precision, log_pops)
    diff = log_pops[1:] - log_pops[:-1]
    n_field = log_pops.shape[0]
    return (0.5 * (n_field - 1) * torch.log(tau)
            - 0.5 * tau * torch.sum(diff * diff))


def grouped_skyride_loglik(heights, n_taxa: int, log_pops: torch.Tensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped skyride: one log-space field value per group of coalescent
    events (GMRFSkyrideLikelihood.java with groupSizes)."""
    return bayesian_skyline_loglik(heights, n_taxa, torch.exp(log_pops),
                                   group_sizes)


def grouped_skyride_gmrf_prior(heights, n_taxa: int, log_pops: torch.Tensor,
                               group_sizes: torch.Tensor, precision,
                               covariates=None, beta=None,
                               lam=1.0) -> torch.Tensor:
    """GMRF prior over the grouped field with optional fixed effects
    (setupGMRFWeights and the skygrid-with-covariates residual gamma - Z
    beta): weights 2 / (delta_i + delta_{i+1}) of the group durations,
    mixed with unit weights by lambda."""
    dt = heights.dtype
    tau = _t(precision, heights)
    resid = log_pops
    if covariates is not None:
        resid = resid - covariates @ beta
    coal = torch.sort(heights[n_taxa:]).values
    cum = prefix_sum(group_sizes.to(torch.int64))
    n_events = n_taxa - 1
    ends = coal[torch.clamp(cum - 1, 0, n_events - 1)]
    t0 = torch.min(heights[:n_taxa])
    starts = torch.cat([t0.reshape(1), ends[:-1]])
    delta = torch.clamp_min(ends - starts, 1e-300)
    w_time = 2.0 / (delta[:-1] + delta[1:])
    lam = torch.as_tensor(lam, dtype=dt, device=heights.device)
    w = lam * w_time + (1.0 - lam)
    diff = resid[1:] - resid[:-1]
    n_field = log_pops.shape[0]
    return (0.5 * (n_field - 1) * torch.log(tau)
            - 0.5 * tau * torch.sum(diff * diff * w))


# ---------------------------------------------------------------------------
# SIR epidemic demographic (SIRModel: the ODE integrated numerically,
# Ne(t) = N I(t) / (2 beta S(t)), the intensity by the trapezoid rule)
# ---------------------------------------------------------------------------

def sir_trajectories(r0, recovery_rate, i0_prop, t_grid: torch.Tensor):
    """(S [T], I [T]) of the SIR ODE integrated backward in time with RK4
    on t_grid, from S(0) = 1 - i0, I(0) = i0, beta = R0 gamma; each state
    floored at 1e-12. The JAX package's lax.scan is a loop over the T - 1
    steps."""
    gamma = _t(recovery_rate, t_grid)
    beta = _t(r0, t_grid) * gamma

    def deriv(s, i):
        # backward time: the forward derivatives negated
        return beta * s * i, -(beta * s * i - gamma * i)

    i0 = _t(i0_prop, t_grid)
    s, i = 1.0 - i0, i0
    ss, ii = [s], [i]
    hs = torch.diff(t_grid)
    for n in range(hs.shape[0]):
        h = hs[n]
        k1 = deriv(s, i)
        k2 = deriv(s + 0.5 * h * k1[0], i + 0.5 * h * k1[1])
        k3 = deriv(s + 0.5 * h * k2[0], i + 0.5 * h * k2[1])
        k4 = deriv(s + h * k3[0], i + h * k3[1])
        s = torch.clamp_min(
            s + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0]), 1e-12)
        i = torch.clamp_min(
            i + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]), 1e-12)
        ss.append(s)
        ii.append(i)
    return torch.stack(ss), torch.stack(ii)


def sir_coalescent_loglik(heights: torch.Tensor, n_taxa: int, r0,
                          recovery_rate, i0_prop, n_total, t_max: float,
                          n_grid: int = 256) -> torch.Tensor:
    """Coalescent density under the SIR effective size Ne(t) = N I(t) /
    (2 beta S(t)) (Volz 2009), trapezoid intensity on a fixed grid of
    n_grid points over [0, t_max], the last Ne beyond it."""
    dt = heights.dtype
    t_grid = torch.as_tensor(np.linspace(0.0, t_max, n_grid), dtype=dt,
                             device=heights.device)
    s, i = sir_trajectories(r0, recovery_rate, i0_prop, t_grid)
    gamma = _t(recovery_rate, heights)
    beta = _t(r0, heights) * gamma
    ne = _t(n_total, heights) * i / (2.0 * beta * s)
    inv_ne = 1.0 / ne
    cum = torch.cat([torch.zeros(1, dtype=dt, device=heights.device),
                     prefix_sum(0.5 * (inv_ne[1:] + inv_ne[:-1])
                                * torch.diff(t_grid))])
    log_ne = torch.log(ne)

    def log_pop(t):
        return _interp(torch.clamp(t, 0.0, t_max), t_grid, log_ne)

    def intensity(t):
        base = _interp(torch.clamp(t, 0.0, t_max), t_grid, cum)
        return base + torch.clamp_min(t - t_max, 0.0) * inv_ne[-1]

    return coalescent_loglik(heights, n_taxa, log_pop, intensity)


def multilocus_skygrid_loglik(heights_list, n_taxa_list,
                              log_pop_sizes: torch.Tensor,
                              cut_points: torch.Tensor,
                              ploidy_factors=None) -> torch.Tensor:
    """Multilocus skygrid (GMRFMultilocusSkyrideLikelihood.java:53): the
    locus trees share one grid of log N, each scaled by its ploidy
    factor; the sum of the loci's skygrid densities."""
    total = torch.zeros((), dtype=log_pop_sizes.dtype,
                        device=log_pop_sizes.device)
    if ploidy_factors is None:
        ploidy_factors = [1.0] * len(heights_list)
    for heights, n_taxa, ploidy in zip(heights_list, n_taxa_list,
                                       ploidy_factors):
        gamma_eff = log_pop_sizes + torch.log(_t(ploidy, log_pop_sizes))
        total = total + skygrid_loglik(heights, n_taxa, gamma_eff,
                                       cut_points)
    return total


# ---------------------------------------------------------------------------
# Extended Bayesian skyline (EBSP; VariableDemographicModel.java,
# VDdemographicFunction)
# ---------------------------------------------------------------------------

def _ebsp_pop_at(t, knot_times, values, active):
    """Ne(t) of the EBSP field: linear between active knots (active[0] is
    always on), constant past the last one. The JAX package's max and
    reverse-min associative scans are torch.cummax and a flipped
    torch.cummin."""
    k = knot_times.shape[0]
    j = torch.arange(k, device=knot_times.device)
    prev_active = torch.cummax(torch.where(active, j, torch.full_like(j, -1)),
                               0).values
    next_active = torch.flip(torch.cummin(torch.flip(
        torch.where(active, j, torch.full_like(j, k)), [0]), 0).values, [0])
    idx = torch.clamp(_searchsorted(knot_times, t, "right") - 1, 0, k - 1)
    lo = torch.clamp_min(prev_active[idx], 0)
    hi_raw = next_active[torch.clamp_max(idx + 1, k - 1)]
    has_hi = (hi_raw < k) & (idx + 1 < k)
    hi = torch.where(has_hi, torch.clamp_max(hi_raw, k - 1), lo)
    t_lo, t_hi = knot_times[lo], knot_times[hi]
    span_raw = t_hi - t_lo
    degenerate = (hi == lo) | (span_raw <= 0)
    safe_span = torch.where(degenerate, torch.ones_like(span_raw), span_raw)
    frac = torch.clamp((t - t_lo) / safe_span, 0.0, 1.0)
    frac = torch.where(degenerate, torch.zeros_like(frac), frac)
    return values[lo] * (1.0 - frac) + values[hi] * frac


def ebsp_knots(all_coal_times: torch.Tensor, use_midpoints: bool = True
               ) -> torch.Tensor:
    """Knot times of the EBSP field over the merged, sorted coalescent
    times of all loci: 0, then the midpoints between events (or the events
    but the last)."""
    e = torch.sort(all_coal_times).values
    zero = torch.zeros(1, dtype=e.dtype, device=e.device)
    if use_midpoints:
        return torch.cat([zero, 0.5 * (e[:-1] + e[1:])])
    return torch.cat([zero, e[:-1]])


def ebsp_coalescent_loglik(trees_heights, trees_n_taxa, ploidies,
                           pop_values: torch.Tensor,
                           indicators: torch.Tensor,
                           use_midpoints: bool = True) -> torch.Tensor:
    """The sum over loci of the coalescent density under the shared
    indicator-selected piecewise-linear Ne(t), scaled by each locus'
    ploidy; each locus integrates over its inter-event intervals split at
    every knot, where Ne is linear."""
    all_coal = torch.cat([h[n:] for h, n in zip(trees_heights,
                                                trees_n_taxa)])
    dt = all_coal.dtype
    knots = ebsp_knots(all_coal, use_midpoints)
    active = torch.cat([torch.ones(1, dtype=torch.bool,
                                   device=all_coal.device),
                        indicators > 0.5])

    def pop(t):
        return _ebsp_pop_at(t, knots, pop_values, active)

    total = torch.zeros((), dtype=dt, device=all_coal.device)
    for heights, n_taxa, ploidy in zip(trees_heights, trees_n_taxa,
                                       ploidies):
        times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
        grid = torch.sort(torch.cat([times, knots])).values
        k_at = lineages[torch.clamp(
            _searchsorted(times, grid[:-1], "right") - 1, 0,
            times.shape[0] - 1)]
        inside = (grid[:-1] >= times[0]) & (grid[1:] <= times[-1])
        ta, tb = grid[:-1], grid[1:]
        ns, ne = ploidy * pop(ta), ploidy * pop(tb)
        d = tb - ta
        diff = ne - ns
        near = torch.abs(diff) < 1e-9 * torch.clamp_min(ns, 1e-300)
        safe_diff = torch.where(near, torch.ones_like(diff), diff)
        lin = d * (torch.log(torch.clamp_min(ne, 1e-300))
                   - torch.log(torch.clamp_min(ns, 1e-300))) / safe_diff
        intensity = torch.where(near, d / torch.clamp_min(ns, 1e-300), lin)
        choose2 = _choose2(k_at, dt)
        total = total - torch.sum(torch.where(inside, choose2 * intensity,
                                              torch.zeros_like(intensity)))
        total = total - torch.sum(torch.where(
            is_coal, torch.log(ploidy * pop(times)),
            torch.zeros_like(times)))
    return total


# ---------------------------------------------------------------------------
# Smooth skygrid (SmoothSkygridLikelihood.java:427-459,
# GlobalSigmoidSmoothFunction.java:32-35): the intensity by Gauss-Legendre
# quadrature on panels split at every event and grid time
# ---------------------------------------------------------------------------

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(8)


def smooth_skygrid_loglik(heights: torch.Tensor, n_taxa: int,
                          log_pop_sizes: torch.Tensor,
                          cut_points: torch.Tensor,
                          smooth_rate) -> torch.Tensor:
    """Smooth-skygrid coalescent log density: the lineage count and 1/N are
    sums of global sigmoids sigma(r (t - step));
    logL = sum_internal log invN(h_i) - int_0^root k(k-1)/2 invN dt."""
    fdt = heights.dtype
    r = _t(smooth_rate, heights)
    root_h = torch.max(heights)
    tip_h, int_h = heights[:n_taxa], heights[n_taxa:]
    inv_pops = torch.exp(-log_pop_sizes)
    steps = inv_pops[1:] - inv_pops[:-1]
    cuts = cut_points.to(fdt)

    def k_smooth(t):
        up = torch.sigmoid(r * (t[..., None] - tip_h))
        down = torch.sigmoid(r * (t[..., None] - int_h))
        return torch.sum(up, -1) - torch.sum(down, -1)

    def inv_n(t):
        return inv_pops[0] + torch.sum(
            steps * torch.sigmoid(r * (t[..., None] - cuts)), -1)

    breaks = torch.sort(torch.cat([
        torch.zeros(1, dtype=fdt, device=heights.device),
        torch.minimum(torch.clamp_min(heights, 0.0), root_h),
        torch.minimum(torch.clamp_min(cuts, 0.0), root_h)])).values
    lo, hi = breaks[:-1], breaks[1:]
    half, mid = 0.5 * (hi - lo), 0.5 * (hi + lo)
    nodes = torch.as_tensor(_GL_NODES, dtype=fdt, device=heights.device)
    wts = torch.as_tensor(_GL_WEIGHTS, dtype=fdt, device=heights.device)
    t_eval = mid[:, None] + half[:, None] * nodes[None, :]
    k = k_smooth(t_eval)
    integrand = 0.5 * k * (k - 1.0) * inv_n(t_eval)
    integral = torch.sum(half[:, None] * wts[None, :] * integrand)
    return torch.sum(torch.log(inv_n(int_h))) - integral


# ---------------------------------------------------------------------------
# The other parametric demographics (dr.evolution.coalescent.*): closed-form
# interval integrals where the reference has them, Gauss-Legendre panels
# where it integrates numerically (ExponentialLogistic.getIntegral)
# ---------------------------------------------------------------------------

def coalescent_loglik_integral(heights: torch.Tensor, n_taxa: int,
                               log_pop: Callable[[torch.Tensor],
                                                 torch.Tensor],
                               integral: Callable) -> torch.Tensor:
    """Coalescent density from per-interval integrals integral(t0, t1) =
    int dt / N(t), for demographics whose intensity from 0 diverges
    (LinearGrowth.java getIntegral); a one-lineage interval contributes
    nothing, even where its integral is infinite."""
    times, lineages, is_coal = coalescent_intervals(heights, n_taxa)
    dt_intensity = integral(times[:-1], times[1:])
    choose2 = _choose2(lineages[:-1], heights.dtype)
    interval_term = -torch.sum(torch.where(
        choose2 > 0, choose2 * dt_intensity, torch.zeros_like(choose2)))
    event_term = -torch.sum(torch.where(is_coal, log_pop(times),
                                        torch.zeros_like(times)))
    return interval_term + event_term


def quad_interval_integral(log_pop: Callable, quad: int = 16) -> Callable:
    """integral(t0, t1) of 1/N by Gauss-Legendre quadrature of `quad`
    nodes (the reference's numerical fallback,
    ExponentialLogistic.java getIntegral)."""
    nodes, wts = np.polynomial.legendre.leggauss(quad)

    def integral(t0, t1):
        half, mid = 0.5 * (t1 - t0), 0.5 * (t1 + t0)
        t = mid[..., None] + half[..., None] * torch.as_tensor(
            nodes, dtype=t0.dtype, device=t0.device)
        inv_n = torch.exp(-log_pop(t))
        return half * torch.sum(torch.as_tensor(
            wts, dtype=t0.dtype, device=t0.device) * inv_n, dim=-1)

    return integral


def const_exponential_loglik(heights, n_taxa: int, n0, n1,
                             growth_rate) -> torch.Tensor:
    """Exponential decline to an ancestral constant N1
    (ConstExponential.java): N0 e^{-rt} until T = log(N0/N1) / r, then
    N1."""
    n0, n1 = _t(n0, heights), _t(n1, heights)
    r = _t(growth_rate, heights)
    t_switch = torch.log(n0 / n1) / r

    def log_pop(t):
        return torch.where(t < t_switch, torch.log(n0) - r * t,
                           torch.log(n1).expand(t.shape))

    def intensity(t):
        return (torch.expm1(r * torch.minimum(t, t_switch)) / (r * n0)
                + torch.clamp_min(t - t_switch, 0.0) / n1)

    return coalescent_loglik(heights, n_taxa, log_pop, intensity)


def exp_constant_loglik(heights, n_taxa: int, n0, growth_rate,
                        change_time) -> torch.Tensor:
    """A recent plateau, then exponential growth (ExpConstant.java):
    N0 e^{-r T} for t < T, N0 e^{-rt} after."""
    n0, r = _t(n0, heights), _t(growth_rate, heights)
    tc = _t(change_time, heights)
    plateau = n0 * torch.exp(-r * tc)

    def log_pop(t):
        return torch.where(t < tc, torch.log(plateau).expand(t.shape),
                           torch.log(n0) - r * t)

    def intensity(t):
        flat = torch.minimum(t, tc) / plateau
        te = torch.maximum(t, tc)
        return flat + (torch.expm1(r * te) - torch.expm1(r * tc)) / (r * n0)

    return coalescent_loglik(heights, n_taxa, log_pop, intensity)


def const_logistic_loglik(heights, n_taxa: int, n0, n1, growth_rate,
                          shape) -> torch.Tensor:
    """Logistic growth from an ancestral constant N1 (ConstLogistic.java):
    N(t) = N1 + (N0 - N1)(1 + c) e^{-rt} / (c + e^{-rt}), its intensity by
    getIntensity's partial fractions."""
    n0, n1 = _t(n0, heights), _t(n1, heights)
    r, c = _t(growth_rate, heights), _t(shape, heights)

    def log_pop(t):
        e = torch.exp(-r * t)
        return torch.log(n1 + (n0 - n1) * (1.0 + c) * e / (c + e))

    aa = n1 + (n0 - n1) * (1.0 + c)
    bb = n1 * c

    def antiderivative(t):
        e = torch.exp(-r * t)
        return (torch.log(bb + aa * e) / (-aa * r)
                + c * torch.log(aa + bb / e) / (bb * r))

    return coalescent_loglik(
        heights, n_taxa, log_pop,
        lambda t: antiderivative(t) - antiderivative(torch.zeros_like(t)))


def linear_growth_loglik(heights, n_taxa: int, slope) -> torch.Tensor:
    """N(t) = slope * t growing into the past from 0 (LinearGrowth.java,
    getIntegral = log(t1 / t0) / N0); every event time must be > 0."""
    n0 = _t(slope, heights)

    def integral(t0, t1):
        return torch.where(t1 > t0, (torch.log(t1) - torch.log(t0)) / n0,
                           torch.zeros_like(t0))

    return coalescent_loglik_integral(
        heights, n_taxa, lambda t: torch.log(n0) + torch.log(t), integral)


def power_law_growth_loglik(heights, n_taxa: int, n0, power
                            ) -> torch.Tensor:
    """N(t) = N0 t^r, r > 1 (PowerLawGrowth.java:getIntegral)."""
    n0, r = _t(n0, heights), _t(power, heights)

    def integral(t0, t1):
        return torch.where(
            t1 > t0, (torch.pow(t0, 1.0 - r) - torch.pow(t1, 1.0 - r))
            / (n0 * (r - 1.0)), torch.zeros_like(t0))

    return coalescent_loglik_integral(
        heights, n_taxa, lambda t: torch.log(n0) + r * torch.log(t),
        integral)


def flexible_growth_loglik(heights, n_taxa: int, n0, k, power
                           ) -> torch.Tensor:
    """N(t) = N0 K t^r / (1 + K t^{r-1}) (FlexibleGrowth.java)."""
    n0, kk, r = _t(n0, heights), _t(k, heights), _t(power, heights)

    def log_pop(t):
        return (torch.log(n0) + torch.log(kk) + r * torch.log(t)
                - torch.log1p(kk * torch.pow(t, r - 1.0)))

    def integral(t0, t1):
        term = ((torch.pow(t0, 1.0 - r) - torch.pow(t1, 1.0 - r))
                / ((r - 1.0) * kk))
        return torch.where(t1 > t0, (term + torch.log(t1 / t0)) / n0,
                           torch.zeros_like(t0))

    return coalescent_loglik_integral(heights, n_taxa, log_pop, integral)


def multi_epoch_exponential_loglik(heights, n_taxa: int, n0, rates,
                                   transition_times) -> torch.Tensor:
    """Piecewise exponential in log N with per-epoch rates
    (MultiEpochExponential.java): rates [K], transition_times [K-1]
    ascending, the last epoch unbounded; closed-form expm1 increments
    summed over a masked epoch overlap."""
    fdt, dev = heights.dtype, heights.device
    n0 = _t(n0, heights)
    rates = _t(rates, heights).reshape(-1)
    tt = _t(transition_times, heights).reshape(-1)
    zero = torch.zeros(1, dtype=fdt, device=dev)
    lo = torch.cat([zero, tt])
    hi = torch.cat([tt, torch.full_like(zero, math.inf)])
    log_n_start = torch.cat([
        zero, prefix_sum(-rates[:-1] * (hi[:-1] - lo[:-1]))]) + torch.log(n0)

    def log_pop(t):
        te = t[..., None]
        inside = (te >= lo) & (te < hi)
        ln = log_n_start - rates * (te - lo)
        return torch.sum(torch.where(inside, ln, torch.zeros_like(ln)), -1)

    def intensity(t):
        te = t[..., None]
        a = torch.minimum(torch.maximum(te, lo), hi) - lo
        a = torch.where(te > lo, a, torch.zeros_like(a))
        inv_nstart = torch.exp(-log_n_start)
        inc = torch.where(torch.abs(rates) < 1e-12, a * inv_nstart,
                          torch.expm1(rates * a) / rates * inv_nstart)
        return torch.sum(inc, -1)

    return coalescent_loglik(heights, n_taxa, log_pop, intensity)


def exponential_sawtooth_loglik(heights, n_taxa: int, n0, growth_rate,
                                wavelength, offset,
                                n_cycles_max: int = 64) -> torch.Tensor:
    """Periodic exponential-growth sawtooth (ExponentialSawtooth.java): t
    shifted by offset * wavelength, wrapped mod wavelength, exponential
    within each cycle; the intensity by counting whole cycles."""
    n0, r = _t(n0, heights), _t(growth_rate, heights)
    wl = _t(wavelength, heights)
    off = _t(offset, heights) * wl

    def base_intensity(t):
        return torch.expm1(r * t) / (r * n0)

    def intensity(t):
        ts = t + off
        cycles = torch.floor(ts / wl)
        frac = ts - cycles * wl
        return (cycles * base_intensity(wl) + base_intensity(frac)
                - base_intensity(off))

    return coalescent_loglik(
        heights, n_taxa,
        lambda t: torch.log(n0) - r * torch.remainder(t + off, wl),
        intensity)


def exponential_logistic_loglik(heights, n_taxa: int, n0, growth_rate, t50,
                                ancestral_rate, transition_time,
                                quad: int = 32) -> torch.Tensor:
    """A logistic recent phase switching to exponential decline at
    transition_time (ExponentialLogistic.java; c = 1/(exp(r t50) - 2) as
    ExponentialLogisticModel.java:126 sets it); every interval's integral
    by Gauss-Legendre quadrature, split at the transition."""
    n0, r = _t(n0, heights), _t(growth_rate, heights)
    c = 1.0 / (torch.expm1(r * _t(t50, heights)) - 1.0)
    r1, tt = _t(ancestral_rate, heights), _t(transition_time, heights)

    def logistic_log_pop(t):
        return torch.log(n0) + torch.log1p(c) - torch.log1p(
            c * torch.exp(r * t))

    n1_log = logistic_log_pop(tt)

    def log_pop(t):
        return torch.where(t < tt, logistic_log_pop(t),
                           n1_log - r1 * (t - tt))

    base = quad_interval_integral(log_pop, quad)

    def integral(t0, t1):
        ts = torch.minimum(torch.maximum(tt, t0), t1)
        return base(t0, ts) + base(ts, t1)

    return coalescent_loglik_integral(heights, n_taxa, log_pop, integral)

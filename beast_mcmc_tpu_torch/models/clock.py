"""Branch rate (molecular clock) models.

Counterpart of beast_mcmc_tpu/models/clock.py, every function of it, and of
the <discretizedBranchRates> rate function of
beast_mcmc_tpu/config/interpreter.py:2499-2514. A clock model is a function
from its parameters to a per-node rate [M]: the rate of the branch above
each node (the root's entry is unused). Walks from the root to the nodes
are pointer doubling over the parent array, ceil(log2 M) rounds of
gathers on the device: no host read and no recursion.
"""

from __future__ import annotations

import math

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



def strict_clock_rates(rate, n_nodes: int, dtype=None) -> torch.Tensor:
    """One global rate (StrictClockBranchRates.java:42)."""
    return torch.as_tensor(rate, dtype=dtype).expand(n_nodes)


def continuous_quantile_rates(quantiles: torch.Tensor, mean, stdev,
                              mean_in_real_space: bool = True
                              ) -> torch.Tensor:
    """Continuous-quantile relaxed clock (ContinuousBranchRates.java): each
    branch has q in (0, 1), smooth in q."""
    return lognormal_quantile(quantiles, mean, stdev, mean_in_real_space)


def arbitrary_rates(rates: torch.Tensor) -> torch.Tensor:
    """Unconstrained per-branch rates (ArbitraryBranchRates.java:55)."""
    return rates


def _parent_heights(parent: torch.Tensor, heights: torch.Tensor):
    """(is_root, clamped parent index, the parent's height, the node's own
    height at the root)."""
    is_root = parent < 0
    pidx = torch.clamp_min(parent, 0)
    return is_root, pidx, torch.where(is_root, heights, heights[pidx])


def rate_epoch_rates(heights: torch.Tensor, parent: torch.Tensor,
                     epoch_times: torch.Tensor,
                     epoch_rates: torch.Tensor) -> torch.Tensor:
    """Epoch clock (RateEpochBranchRateModel): a branch's rate is the
    time-weighted average of the epoch rates across its span; epoch_times
    [E-1] ascending, epoch_rates [E]."""
    dt = heights.dtype
    _, _, t1 = _parent_heights(parent, heights)
    t0 = heights
    zero = torch.zeros(1, dtype=dt, device=heights.device)
    lo = torch.cat([zero, epoch_times.to(dt)])
    hi = torch.cat([epoch_times.to(dt), torch.full_like(zero, math.inf)])
    overlap = torch.clamp_min(torch.minimum(t1[:, None], hi[None, :])
                              - torch.maximum(t0[:, None], lo[None, :]), 0.0)
    dur = t1 - t0
    avg = (torch.sum(overlap * epoch_rates[None, :], dim=1)
           / torch.where(dur > 0, dur, torch.ones_like(dur)))
    return torch.where(dur > 0, avg, epoch_rates[0].expand(dur.shape))


# ---------------------------------------------------------------------------
# Local clocks
# ---------------------------------------------------------------------------

def _doubling_steps(n_nodes: int) -> int:
    """ceil(log2 n_nodes), at least 1: the pointer-doubling rounds that
    reach the root from any node."""
    steps = 1
    while (1 << steps) < n_nodes:
        steps += 1
    return steps


def ancestor_or_self_mask(parent: torch.Tensor, node) -> torch.Tensor:
    """bool[M]: is `node` an ancestor-or-self of each node? Pointer
    doubling, O(M log M), no host read (`node` may be a 0-d device
    tensor)."""
    m = parent.shape[0]
    ar = torch.arange(m, device=parent.device)
    hit = ar == torch.as_tensor(node, device=parent.device)
    jump = torch.where(parent >= 0, parent, ar)
    for _ in range(_doubling_steps(m)):
        hit = hit | hit[jump]
        jump = jump[jump]
    return hit


def local_clock_rates(assignment: torch.Tensor,
                      clock_rates: torch.Tensor) -> torch.Tensor:
    """Fixed local clocks (LocalClockModel): each branch carries an integer
    clock index into a small rate vector."""
    return clock_rates[assignment]


def random_local_clock_rates(parent: torch.Tensor, heights: torch.Tensor,
                             indicators: torch.Tensor, rates: torch.Tensor,
                             mean_rate=None,
                             rates_are_multipliers: bool = False,
                             threshold: float = 0.5) -> torch.Tensor:
    """Random local clock (Drummond & Suchard 2010; RandomLocalClockModel
    .java recursivelyCompute:179-210, recalculateScaleFactor:214-240).

    A non-root node whose indicator exceeds `threshold` starts a new rate
    on the branch above it (or multiplies the inherited one); otherwise the
    parent's rate is inherited. The rates are then scaled so that the
    time-weighted mean rate is mean_rate (1 where not given): scale =
    sum(t) / sum(t * unscaled) * mean_rate. The root-to-node propagation is
    pointer doubling over the parent array, ceil(log2 M) rounds of gathers
    (12 at M = 3,219)."""
    m = parent.shape[0]
    dt = heights.dtype
    ar = torch.arange(m, device=parent.device)
    is_root = parent < 0
    sel = (indicators > threshold) & ~is_root
    jump = torch.where(is_root, ar, parent)
    rates = rates.to(dt)
    if rates_are_multipliers:
        # log unscaled rate: the sum of the selected log-multipliers on the
        # root -> node path, a prefix sum by doubling
        acc = torch.where(sel, torch.log(rates), torch.zeros_like(rates))
        j = jump
        for _ in range(_doubling_steps(m)):
            acc = acc + torch.where(j != ar, acc[j], torch.zeros_like(acc))
            j = j[j]
        unscaled = torch.exp(acc)
    else:
        # the variable at the nearest selected ancestor-or-self, else 1
        resolved = sel | is_root
        value = torch.where(sel, rates, torch.ones_like(rates))
        j = jump
        for _ in range(_doubling_steps(m)):
            value = torch.where(resolved, value, value[j])
            resolved = resolved | resolved[j]
            j = j[j]
        unscaled = value
    _, pidx, _ = _parent_heights(parent, heights)
    t = torch.where(is_root, torch.zeros_like(heights),
                    heights[pidx] - heights)
    scale = torch.sum(t) / torch.sum(t * unscaled)
    if mean_rate is not None:
        scale = scale * torch.as_tensor(mean_rate, dtype=dt,
                                        device=heights.device)
    return unscaled * scale


# ---------------------------------------------------------------------------
# Autocorrelated and shrinkage rate priors
# ---------------------------------------------------------------------------

def branch_rate_increments(parent: torch.Tensor, heights: torch.Tensor,
                           log_rates: torch.Tensor,
                           scale_by_time: bool = False):
    """(increments [M], valid [M]): log(rate_child) - log(rate_parent),
    divided by sqrt(branch time) with scale_by_time
    (AutoCorrelatedBranchRatesDistribution BY_TIME); the root's entry is
    0 and not valid."""
    is_root, pidx, _ = _parent_heights(parent, heights)
    inc = log_rates - log_rates[pidx]
    if scale_by_time:
        t = torch.where(is_root, torch.ones_like(heights),
                        heights[pidx] - heights)
        inc = inc / torch.sqrt(torch.clamp_min(t, 1e-300))
    return torch.where(is_root, torch.zeros_like(inc), inc), ~is_root


def autocorrelated_rates_log_density(parent: torch.Tensor,
                                     heights: torch.Tensor,
                                     log_rates: torch.Tensor, precision,
                                     scale_by_time: bool = True
                                     ) -> torch.Tensor:
    """Autocorrelated relaxed-clock prior: each branch's log-rate increment
    is N(0, t / precision) (AutoCorrelatedBranchRatesDistribution.java)."""
    is_root, pidx, _ = _parent_heights(parent, heights)
    inc = log_rates - log_rates[pidx]
    var = 1.0 / torch.as_tensor(precision, dtype=heights.dtype,
                                device=heights.device)
    if scale_by_time:
        var = var * torch.where(is_root, torch.ones_like(heights),
                                heights[pidx] - heights)
    ll = -0.5 * (torch.log(2 * math.pi * var) + inc * inc / var)
    return torch.sum(torch.where(is_root, torch.zeros_like(ll), ll))


def shrinkage_local_clock_log_density(parent: torch.Tensor,
                                      heights: torch.Tensor,
                                      log_rates: torch.Tensor, global_scale,
                                      exponent=0.25,
                                      local_scales=None) -> torch.Tensor:
    """Shrinkage random local clock: the Bayesian-bridge prior on the
    per-branch log-rate increments (AutoCorrelatedRatesWithBayesianBridge
    .java)."""
    from beast_mcmc_tpu_torch.models.priors import bayesian_bridge_logpdf

    inc, valid = branch_rate_increments(parent, heights, log_rates)
    lp = bayesian_bridge_logpdf(inc, global_scale, exponent,
                                local_scales=local_scales, reduce=False)
    return torch.sum(torch.where(valid, lp, torch.zeros_like(lp)))


# ---------------------------------------------------------------------------
# Mixture-model branch rates
# ---------------------------------------------------------------------------

def _lognormal_mu(means, sigma, mean_in_real_space: bool):
    return (torch.log(means) - 0.5 * sigma * sigma if mean_in_real_space
            else means)


def lognormal_mixture_cdf(x, weights, means, stdevs,
                          mean_in_real_space: bool = True) -> torch.Tensor:
    """CDF of a mixture of lognormals at x (the last axis of weights,
    means and stdevs is the component)."""
    x = torch.as_tensor(x)
    sigma = torch.as_tensor(stdevs, dtype=x.dtype, device=x.device)
    mu = _lognormal_mu(torch.as_tensor(means, dtype=x.dtype, device=x.device),
                       sigma, mean_in_real_space)
    z = (torch.log(x)[..., None] - mu) / sigma
    w = torch.as_tensor(weights, dtype=x.dtype, device=x.device)
    return torch.sum(w * torch.special.ndtr(z), dim=-1)


def mixture_model_rates(quantiles: torch.Tensor, weights: torch.Tensor,
                        means: torch.Tensor, stdevs: torch.Tensor,
                        mean_in_real_space: bool = True,
                        iters: int = 60) -> torch.Tensor:
    """Mixture-of-lognormals relaxed clock (MixtureModelBranchRates.java):
    the branch rate is the mixture quantile at the branch's quantile. The
    quantile has no closed form: `iters` rounds of bisection in log space
    between the components' z = -9 and z = +9 quantiles."""
    sigma = torch.as_tensor(stdevs, dtype=quantiles.dtype,
                            device=quantiles.device)
    mu = _lognormal_mu(torch.as_tensor(means, dtype=quantiles.dtype,
                                       device=quantiles.device),
                       sigma, mean_in_real_space)
    lo = torch.min(mu - 9.0 * sigma).expand(quantiles.shape)
    hi = torch.max(mu + 9.0 * sigma).expand(quantiles.shape)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        c = lognormal_mixture_cdf(torch.exp(mid), weights, means, stdevs,
                                  mean_in_real_space)
        go_up = c < quantiles
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return torch.exp(0.5 * (lo + hi))


# ---------------------------------------------------------------------------
# Latent-state branch rates
# ---------------------------------------------------------------------------

def latent_state_branch_rates(rates: torch.Tensor,
                              latent_proportions: torch.Tensor
                              ) -> torch.Tensor:
    """rate * (1 - proportion) for a branch that spends a fraction of its
    time in a latent state (LatentStateBranchRateModel.java
    getBranchRate)."""
    return rates * (1.0 - latent_proportions)


def two_state_occupancy_log_density(branch_times: torch.Tensor,
                                    latent_proportions: torch.Tensor,
                                    rate_to_latent, rate_from_latent,
                                    condition_on_active_end: bool = True
                                    ) -> torch.Tensor:
    """Log density of the latent-occupancy fraction of a two-state CTMC
    over each branch (LatentStateBranchRateModel.java /
    SericolaLatentStateBranchRateModel; Pedler 1971), as the JAX package's
    function: with V the latent time over [0, t], starting active,
      P(V = 0)         = exp(-a t)
      f(v, end active) = e^{-a(t-v) - b v} sqrt(ab (t-v)/v) I1(2 sqrt(ab v (t-v)))
      f(v, end latent) = a e^{-a(t-v) - b v} I0(2 sqrt(ab v (t-v)))
    conditioned on the active end (divided by P(X_t = active)) where asked,
    with the Jacobian log t to proportion space; a proportion of exactly 0
    takes the atom. The Bessel functions are the exponentially scaled ones
    with exp(x) folded into the exponent."""
    t = branch_times
    dt, dev = t.dtype, t.device
    a = torch.as_tensor(rate_to_latent, dtype=dt, device=dev)
    b = torch.as_tensor(rate_from_latent, dtype=dt, device=dev)
    v = latent_proportions * t
    u = t - v
    x = 2.0 * torch.sqrt(a * b * torch.clamp_min(u, 0.0)
                         * torch.clamp_min(v, 1e-300))
    log_common = -a * u - b * v + x
    log_f_active = (log_common + 0.5 * (
        torch.log(a * b) + torch.log(torch.clamp_min(u, 1e-300))
        - torch.log(torch.clamp_min(v, 1e-300)))
        + torch.log(torch.clamp_min(torch.special.i1e(x), 1e-300)))
    log_f_latent = (log_common + torch.log(a)
                    + torch.log(torch.clamp_min(torch.special.i0e(x),
                                                1e-300)))
    if condition_on_active_end:
        s = a + b
        p_aa = b / s + (a / s) * torch.exp(-s * t)
        log_f = log_f_active - torch.log(p_aa)
        log_atom = -a * t - torch.log(p_aa)
    else:
        log_f = torch.logaddexp(log_f_active, log_f_latent)
        log_atom = -a * t
    lp = torch.where(latent_proportions > 0.0, log_f + torch.log(t),
                     log_atom)
    return torch.sum(lp)

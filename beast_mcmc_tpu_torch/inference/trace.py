"""Trace statistics: mean, stderr, autocorrelation time, ESS.

Own copy of beast_mcmc_tpu/inference/trace.py (numpy only), the role of
dr.inference.trace.TraceCorrelation (TraceCorrelation.java:71-87: ACT by
summing sample autocovariances until they go negative, capped at maxLag;
ESS = n / (ACT/stepSize)). Host-side numpy; the runner's ESS reads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_LAG = 2000


@dataclasses.dataclass
class TraceStats:
    mean: float
    stdev: float
    variance: float
    act: float  # autocorrelation time in steps
    ess: float
    std_error_of_mean: float


def analyze(samples: np.ndarray, step_size: int = 1) -> TraceStats:
    """TraceCorrelation's ACT estimator: Geyer-style initial sequence sum
    of autocovariances gamma_0 + 2 sum gamma_k while the running sum stays
    positive (the reference stops when the pairwise sums go negative)."""
    x = np.asarray(samples, np.float64)
    n = x.size
    if n < 2:  # degenerate trace (e.g. logEvery > chainLength)
        m = float(x.mean()) if n else float("nan")
        return TraceStats(m, 0.0, 0.0, float(step_size), float(n), 0.0)
    mean = x.mean()
    d = x - mean
    max_lag = min(n - 1, MAX_LAG)
    gamma = np.empty(max_lag)
    for k in range(max_lag):
        gamma[k] = np.dot(d[: n - k], d[k:]) / (n - k)
    var = gamma[0]
    # the reference's PAIRWISE initial-sequence rule (TraceCorrelation.
    # java:140-168): add 2*(gamma[lag-1] + gamma[lag]) at every EVEN lag
    # while the pair sum stays positive, then stop
    var_stat = gamma[0]
    for lag in range(2, max_lag, 2):
        pair = gamma[lag - 1] + gamma[lag]
        if pair > 0:
            var_stat += 2.0 * pair
        else:
            break
    if gamma[0] == 0:
        act = 0.0
    else:
        act = step_size * var_stat / gamma[0]
    ess = 1.0 if act == 0 else (step_size * n) / act
    return TraceStats(
        mean=float(mean),
        stdev=float(np.sqrt(max(var, 0.0))),
        variance=float(var),
        act=float(act),
        ess=float(ess),
        std_error_of_mean=float(np.sqrt(max(var_stat, 0.0) / n)),
    )


def effective_sample_size(samples: np.ndarray) -> float:
    return analyze(samples).ess

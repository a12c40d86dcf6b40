"""Convergence diagnostics: PSRF across chains and clade-frequency
distance between tree samples.

Roles of the reference's in-run convergence monitor (ref:
src/dr/evomodel/tree/Convergence.java — compares running clade
frequencies against a reference tree set and reports the max deviation)
plus the standard Gelman-Rubin potential scale reduction factor the
reference's users compute across independent runs.

The port's own copy of beast_mcmc_tpu/apps/convergence.py: host-side numpy
over this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from beast_mcmc_tpu_torch.apps.treeannotator import TreeSample, _clades_of


def psrf(chains: Sequence[np.ndarray]) -> float:
    """Gelman-Rubin potential scale reduction factor over m chains of one
    scalar trace (split-free, standard between/within variance form)."""
    chains = [np.asarray(c, float) for c in chains]
    n = min(len(c) for c in chains)
    x = np.stack([c[:n] for c in chains])  # [m, n]
    m = x.shape[0]
    means = x.mean(axis=1)
    w = x.var(axis=1, ddof=1).mean()
    b = n * means.var(ddof=1)
    var_hat = (n - 1) / n * w + b / n
    return float(np.sqrt(var_hat / w)) if w > 0 else np.inf


def psrf_report(traces: Sequence[Dict[str, np.ndarray]]) -> Dict[str, float]:
    """PSRF per column across chains (columns present in all chains)."""
    keys = set(traces[0])
    for t in traces[1:]:
        keys &= set(t)
    return {k: psrf([t[k] for t in traces]) for k in sorted(keys)}


def clade_frequencies(trees: Sequence[TreeSample],
                      burnin_fraction: float = 0.1) -> Dict[int, float]:
    """Posterior clade support: clade bitmask -> frequency."""
    start = int(len(trees) * burnin_fraction)
    trees = trees[start:]
    counts: Dict[int, int] = {}
    for t in trees:
        for clade in set(_clades_of(t).values()):
            counts[clade] = counts.get(clade, 0) + 1
    n = max(len(trees), 1)
    return {c: k / n for c, k in counts.items()}


def max_clade_deviation(sample: Sequence[TreeSample],
                        reference: Sequence[TreeSample],
                        burnin_fraction: float = 0.1) -> float:
    """Max |clade frequency difference| between a running sample and a
    reference tree set (ref: Convergence.java getMaxCladeDeviation role —
    the ASDSF-style statistic)."""
    f1 = clade_frequencies(sample, burnin_fraction)
    f2 = clade_frequencies(reference, burnin_fraction)
    clades = set(f1) | set(f2)
    return max(abs(f1.get(c, 0.0) - f2.get(c, 0.0)) for c in clades)


def converged(traces: Sequence[Dict[str, np.ndarray]],
              psrf_threshold: float = 1.05) -> bool:
    return all(v < psrf_threshold for v in psrf_report(traces).values())

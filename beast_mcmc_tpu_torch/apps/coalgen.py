"""CoalGen: simulate coalescent genealogies under demographic models.

Role of the reference's coalescent-simulator app (ref: src/dr/app/coalgen/
CoalGenApp.java, dr.evolution.coalescent.CoalescentSimulator): draw
serial-sample genealogies for a taxon/date set under a demographic
function and write them as a NEXUS trees file — the front half of the
simulation workflow (coalgen -> seqgen -> analysis round-trip testing).

Host-side numpy (tree generation is not a device workload); the
demographic time-change is exact: with k lineages from time t0, the
coalescent wait w solves  [I(t0+w) - I(t0)] k(k-1)/2 = E,  E ~ Exp(1),
where I(t) = integral_0^t du / N(u) is the demographic intensity (ref:
dr.evolution.coalescent.DemographicFunction.getIntensity). Constant and
exponential-growth inverses are closed-form; any other model supplies
intensity() and is inverted by bisection.

The port's own copy of beast_mcmc_tpu/apps/coalgen.py: host-side numpy over
this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Sequence

import numpy as np


class Demographic:
    """N(t) with t measured backwards from the most recent tip."""

    def intensity(self, t: float) -> float:
        raise NotImplementedError

    def inverse_intensity(self, x: float) -> float:
        """Smallest t with intensity(t) = x; default bisection."""
        lo, hi = 0.0, 1.0
        while self.intensity(hi) < x:
            hi *= 2.0
            if hi > 1e300:
                return np.inf
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if self.intensity(mid) < x:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)


@dataclasses.dataclass
class ConstantPopulation(Demographic):
    pop_size: float = 1.0

    def intensity(self, t):
        return t / self.pop_size

    def inverse_intensity(self, x):
        return x * self.pop_size


@dataclasses.dataclass
class ExponentialGrowth(Demographic):
    """N(t) = N0 exp(-r t) backwards in time (ref:
    dr.evolution.coalescent.ExponentialGrowth)."""
    pop_size: float = 1.0
    growth_rate: float = 0.0

    def intensity(self, t):
        r = self.growth_rate
        if abs(r) < 1e-12:
            return t / self.pop_size
        return (np.exp(r * t) - 1.0) / (r * self.pop_size)

    def inverse_intensity(self, x):
        r = self.growth_rate
        if abs(r) < 1e-12:
            return x * self.pop_size
        arg = 1.0 + r * self.pop_size * x
        return np.inf if arg <= 0 else np.log(arg) / r


@dataclasses.dataclass
class LogisticGrowth(Demographic):
    """N(t) = N0 (1+c) / (1 + c exp(r t)) with c = exp(-r t50) (ref:
    dr.evolution.coalescent.LogisticGrowth); numeric inverse."""
    pop_size: float = 1.0
    growth_rate: float = 1.0
    t50: float = 0.0

    def intensity(self, t):
        r, c = self.growth_rate, np.exp(-self.growth_rate * self.t50)
        n0 = self.pop_size * (1.0 + c)
        # integral of (1 + c e^{ru}) / n0 du
        return (t + c * (np.exp(r * t) - 1.0) / r) / n0


def simulate_demographic_tree(
    rng: np.random.Generator,
    tip_heights: Sequence[float],
    demographic: Demographic,
):
    """(parent, children, heights, root) of one simulated genealogy."""
    tip_heights = np.asarray(tip_heights, np.float64)
    n = len(tip_heights)
    m = 2 * n - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m, np.float64)
    heights[:n] = tip_heights

    pending = sorted(range(n), key=lambda i: tip_heights[i])
    active: List[int] = []
    t = float(tip_heights[pending[0]])
    nxt = n
    while len(active) > 1 or pending:
        while pending and tip_heights[pending[0]] <= t + 1e-300:
            active.append(pending.pop(0))
        if len(active) < 2:
            t = float(tip_heights[pending[0]])
            continue
        k = len(active)
        e = rng.exponential(1.0)
        target = demographic.intensity(t) + 2.0 * e / (k * (k - 1))
        t_new = demographic.inverse_intensity(target)
        if pending and t_new > tip_heights[pending[0]]:
            t = float(tip_heights[pending[0]])
            continue
        t = float(t_new)
        i, j = rng.choice(k, size=2, replace=False)
        a, b = active[i], active[j]
        heights[nxt] = t
        children[nxt] = (a, b)
        parent[a] = parent[b] = nxt
        active = [x for x in active if x not in (a, b)] + [nxt]
        nxt += 1
    return parent, children, heights, int(active[0])


def simulate_trees_nexus(
    taxa: Sequence[str],
    tip_dates: Optional[Sequence[float]] = None,
    demographic: Demographic = None,
    n_trees: int = 100,
    seed: int = 42,
) -> str:
    """NEXUS trees block of simulated genealogies (TreeAnnotator-ready)."""
    from beast_mcmc_tpu_torch.tree.topology import to_newick

    demographic = demographic or ConstantPopulation(1.0)
    if tip_dates is None:
        tip_heights = np.zeros(len(taxa))
    else:
        d = np.asarray(tip_dates, np.float64)
        tip_heights = d.max() - d  # forward dates -> backwards heights
    rng = np.random.default_rng(seed)
    lines = ["#NEXUS", "begin trees;"]
    for i in range(n_trees):
        parent, children, heights, root = simulate_demographic_tree(
            rng, tip_heights, demographic)
        nwk = to_newick(parent, children, heights, root, list(taxa))
        lines.append(f"tree SIM_{i} = {nwk}")
    lines.append("end;")
    return "\n".join(lines) + "\n"


def main(argv=None):
    args = list(argv if argv is not None else sys.argv[1:])
    taxa, dates, demo, n_trees, seed, out = [], None, None, 100, 42, None
    pop, growth = 1.0, 0.0
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-taxa":
            taxa = args[i + 1].split(","); i += 2
        elif a == "-dates":
            dates = [float(x) for x in args[i + 1].split(",")]; i += 2
        elif a == "-popsize":
            pop = float(args[i + 1]); i += 2
        elif a == "-growth":
            growth = float(args[i + 1]); i += 2
        elif a == "-ntrees":
            n_trees = int(args[i + 1]); i += 2
        elif a == "-seed":
            seed = int(args[i + 1]); i += 2
        else:
            out = a; i += 1
    demo = (ExponentialGrowth(pop, growth) if growth != 0.0
            else ConstantPopulation(pop))
    text = simulate_trees_nexus(taxa, dates, demo, n_trees, seed)
    if out:
        open(out, "w").write(text)
    else:
        sys.stdout.write(text)


if __name__ == "__main__":
    main()

"""Sericola-series Markov reward distributions (host-side numpy).

Counterpart of beast_mcmc_tpu/ops/sericola.py, the port's own copy (numpy
and scipy; the reference evaluates these per branch on the CPU too).
Functional role of dr.inference.markovjumps.SericolaSeriesMarkovReward
(SericolaSeriesMarkovReward.java:16-450), the engine behind
RewardsAwareBranchModel: the joint density

    W[i, j](x, t) = d/dx P(X_t = j, R_t <= x | X_0 = i)

of a CTMC's end state and its accumulated reward R_t = int r_{X_s} ds,
computed by Sericola's uniformization series (B. Sericola, "Occupation
times in Markov processes", Comm. Statist. Stochastic Models 16 (2000):
the C^{(h)}(n, k) recursion, relations (12)/(13)).

These are small dense recursions over [dim, dim] matrices (dim = the
number of reward classes, 2-4 in practice): they run on the host, and the
per-branch W matrices go to the peel as ordinary transition operands on
the analysis's device (config/xml_ext.py).

States must be supplied with DISTINCT reward rates sorted ascending
(the caller permutes; RewardsAwareBranchModel.sortW does the same)."""

from __future__ import annotations

import numpy as np
from scipy.special import comb, gammaln


class SericolaMarkovReward:
    def __init__(self, q: np.ndarray, r: np.ndarray, epsilon: float = 1e-10):
        self.q = np.asarray(q, float)
        self.r = np.asarray(r, float)
        self.dim = self.q.shape[0]
        self.phi = self.dim - 1
        self.epsilon = epsilon
        # uniformization rate: the largest exit rate
        self.lam = -np.min(np.diag(self.q))
        self.p = np.eye(self.dim) + self.q / self.lam
        self._c = None
        self._n = -1

    # -- Poisson series depth ------------------------------------------------
    def _n_steps(self, time: float) -> int:
        tol = 1.0 - self.epsilon
        i, s = -1, 0.0
        while abs(s - tol) > self.epsilon and s < 1.0:
            i += 1
            s += np.exp(-self.lam * time + i * np.log(self.lam * time)
                        - gammaln(i + 1.0))
            if i > 5000:
                break
        return i

    # -- the C^{(h)}(n, k) tables -------------------------------------------
    def _grow(self, time: float, extra: int) -> None:
        need = self._n_steps(time) + extra
        if need <= self._n:
            return
        n_max = need
        dim, phi = self.dim, self.phi
        c = np.zeros((phi + 1, n_max + 1, n_max + 1, dim, dim))
        for h in range(1, phi + 1):
            for u in range(h):
                c[h, 0, 0, u, u] = 1.0
        pn = np.eye(dim)
        p = self.p
        r = self.r
        for n in range(1, n_max + 1):
            for h in range(1, phi + 1):
                for k in range(1, n + 1):
                    # relation (12): rows u >= h
                    for u in range(h, phi + 1):
                        cc = ((r[u] - r[h]) / (r[u] - r[h - 1])
                              * c[h, n, k - 1, u, :])
                        d = p[u, :] @ c[h, n - 1, k - 1]
                        c[h, n, k, u, :] = cc + d * (
                            (r[h] - r[h - 1]) / (r[u] - r[h - 1]))
                if h + 1 <= phi:
                    for u in range(h + 1, phi + 1):
                        c[h + 1, n, 0, u, :] = c[h, n, n, u, :]
            pn = pn @ p
            c[phi, n, n, :phi, :] = pn[:phi, :]
            for h in range(phi, 0, -1):
                for k in range(n - 1, -1, -1):
                    # relation (13): rows u <= h-1
                    for u in range(h):
                        cc = ((r[h - 1] - r[u]) / (r[h] - r[u])
                              * c[h, n, k + 1, u, :])
                        d = p[u, :] @ c[h, n - 1, k]
                        c[h, n, k, u, :] = cc + d * (
                            (r[h] - r[h - 1]) / (r[h] - r[u]))
                    for u in range(h - 1):
                        c[h - 1, n, n, u, :] = c[h, n, 0, u, :]
        self._c = c
        self._n = n_max

    def _h_of(self, x: float, time: float) -> int:
        r = self.r
        if x < r[0] * time or x > r[self.phi] * time:
            raise ValueError("x outside [r_min t, r_max t]")
        h = 1
        while x > r[h] * time:
            h += 1
        return h

    def pdf(self, x: float, time: float) -> np.ndarray:
        """[dim, dim] joint reward density d/dx P(X_t=j, R_t<=x | X_0=i)
        (computePdf, SericolaSeriesMarkovReward.java:142-175 +
        loopCyclePdf:311-330)."""
        if x <= self.r[0] * time or x >= self.r[self.phi] * time:
            return np.zeros((self.dim, self.dim))
        h = self._h_of(x, time)
        self._grow(time, 1)
        n_max = self._n - 1
        r = self.r
        xh = (x - r[h - 1] * time) / ((r[h] - r[h - 1]) * time)
        factor = self.lam / (r[h] - r[h - 1])
        w = np.zeros((self.dim, self.dim))
        for n in range(n_max + 1):
            premult = np.exp(-self.lam * time
                             + n * np.log(self.lam * time)
                             - gammaln(n + 1.0))
            k = np.arange(n + 1)
            coef = comb(n, k) * xh ** k * (1.0 - xh) ** (n - k)
            diff = (self._c[h, n + 1, 1:n + 2] - self._c[h, n + 1, :n + 1])
            w += factor * premult * np.tensordot(coef, diff, axes=(0, 0))
        return w

    def cdf(self, x: float, time: float) -> np.ndarray:
        """[dim, dim] P(X_t=j, R_t<=x | X_0=i) (computeCdf +
        accumulateCdf)."""
        h = self._h_of(x, time)
        self._grow(time, 0)
        r = self.r
        xh = (x - r[h - 1] * time) / ((r[h] - r[h - 1]) * time)
        w = np.zeros((self.dim, self.dim))
        for n in range(self._n + 1):
            premult = np.exp(-self.lam * time
                             + n * np.log(self.lam * time)
                             - gammaln(n + 1.0))
            k = np.arange(n + 1)
            coef = comb(n, k) * xh ** k * (1.0 - xh) ** (n - k)
            w += premult * np.tensordot(coef, self._c[h, n, :n + 1],
                                        axes=(0, 0))
        return w


def reward_branch_matrices(
    q: np.ndarray,
    reward_rates: np.ndarray,
    total_rewards: np.ndarray,
    branch_lengths: np.ndarray,
    epsilon: float = 1e-10,
) -> np.ndarray:
    """Per-branch W matrices in the ORIGINAL state order (ref:
    RewardsAwareBranchModel.java:102-130 — pdf of the branch's total
    reward over its length; states sorted by reward rate internally and
    mapped back, the sortW step)."""
    order = np.argsort(reward_rates, kind="stable")
    inv = np.argsort(order)
    qs = q[np.ix_(order, order)]
    rs = reward_rates[order]
    engine = SericolaMarkovReward(qs, rs, epsilon)
    out = np.zeros((len(branch_lengths), q.shape[0], q.shape[0]))
    for b, (x, t) in enumerate(zip(total_rewards, branch_lengths)):
        if t <= 0:
            out[b] = np.eye(q.shape[0])
            continue
        w = engine.pdf(float(x), float(t))
        out[b] = w[np.ix_(inv, inv)]
    return out

"""Piecewise-deterministic MCMC: the Zig-Zag and Bouncy Particle samplers.

Counterpart of beast_mcmc_tpu/inference/pdmp.py (the reference's
ReversibleZigZagOperator.java, BouncyParticleOperator.java). Event times
are simulated by Poisson thinning against the user's gradient bound. JAX's
lax.while_loop becomes a host loop over the candidate events inside the
horizon, at most max_events: their times are drawn at once, so a proposal
makes one host copy (their count). Each candidate takes one gradient (one
kernel launch on a CUDA device); the one past the horizon takes none, since
JAX's thinning discards its gradient. `last_n_events` holds the gradients
of the last proposal, so a chain step with such a proposal makes
last_n_events + 1 posterior evaluations.

Both are Gibbs-style (the flow leaves the target invariant; velocities are
drawn anew each proposal): log-Hastings +inf, acceptance statistic NaN.
Exactness needs `grad_bound` to dominate the rate along the trajectory;
where it does not, the flip probability is clipped at 1, as in JAX.
Positive parameters move in log space as in HmcOperator.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beast_mcmc_tpu_torch.inference.hmc import HmcOperator, value_grad
from beast_mcmc_tpu_torch.inference.nuts import _no_ignored_settings


class _Pdmp(HmcOperator):
    last_n_events = 0

    def __post_init__(self):
        _no_ignored_settings(self)

    def _start(self, params, tree, gen, lam_total):
        """(y0, dU/dy as a function of y, the candidate event times inside
        the horizon [n], n). The max_events exponential gaps are drawn at
        once; their running sum, clamped at the horizon, gives the times,
        and one host copy gives their count."""
        y0 = self._pack(params).to(tree.heights.dtype).detach()
        u = self.neg_log_density(params, tree)
        gaps = torch.empty(self.max_events, dtype=y0.dtype, device=y0.device
                           ).exponential_(generator=gen) / lam_total
        times = torch.clamp_max(torch.cumsum(gaps, 0), self.travel_time)
        n = int(torch.count_nonzero(times < self.travel_time))
        return y0, lambda y: value_grad(u, y), times[:n], n

    def _finish(self, params, tree, y0, y, v, t, n):
        """The last leg, to the horizon unless max_events stopped the flow
        first, and the Gibbs-style result."""
        if n < self.max_events:
            y = y + v * (self.travel_time - t)
        self.last_n_events = n
        y = torch.where(torch.all(torch.isfinite(y)), y, y0)
        dt = y0.dtype
        return (self._unpack(params, y), tree,
                torch.full((), math.inf, dtype=dt, device=y0.device),
                torch.full((), math.nan, dtype=dt, device=y0.device))


@dataclasses.dataclass
class ZigZagOperator(_Pdmp):
    """Zig-Zag process: velocities in {-1, +1}^d; coordinate i flips at
    rate max(0, v_i dU/dy_i), simulated by thinning against grad_bound
    (a scalar or one bound a coordinate)."""

    travel_time: float = 1.0
    grad_bound: float = 10.0
    max_events: int = 256
    adaptable: bool = False

    def propose(self, params, tree, gen, tuning):
        assert self._log_posterior is not None, "ZigZagOperator not bound"
        dt, dev = tree.heights.dtype, tree.heights.device
        dim = self._pack(params).shape[0]
        bounds = torch.as_tensor(self.grad_bound, dtype=dt, device=dev
                                 ).expand(dim).contiguous()
        v = torch.where(torch.rand(dim, generator=gen, dtype=dt, device=dev)
                        < 0.5, -1.0, 1.0).to(dt)
        y0, grad, times, n = self._start(params, tree, gen, torch.sum(bounds))
        # each candidate's coordinate ~ bounds / their sum, thinned by the
        # true rate over its bound
        coords = (torch.multinomial(bounds, n, replacement=True,
                                    generator=gen).tolist() if n else [])
        us = torch.rand(n, generator=gen, dtype=dt, device=dev)
        y, t = y0, 0.0
        for i, c in enumerate(coords):
            y = y + v * (times[i] - t)
            t = times[i]
            g = grad(y)
            rate = torch.clamp_min(v[c] * g[c], 0.0)
            flip = us[i] < torch.clamp_max(rate / bounds[c], 1.0)
            v = v.clone()
            v[c] = torch.where(flip, -v[c], v[c])
        return self._finish(params, tree, y0, y, v, t, n)


@dataclasses.dataclass
class BouncyParticleOperator(_Pdmp):
    """Bouncy Particle Sampler: Gaussian velocity; bounces reflect v off
    grad U at rate max(0, v . grad U), thinned against grad_bound, and the
    velocity is refreshed at refresh_rate."""

    travel_time: float = 1.0
    grad_bound: float = 20.0
    refresh_rate: float = 1.0
    max_events: int = 256
    adaptable: bool = False

    def propose(self, params, tree, gen, tuning):
        assert self._log_posterior is not None, "BPS operator not bound"
        dt, dev = tree.heights.dtype, tree.heights.device
        dim = self._pack(params).shape[0]
        lam_total = self.grad_bound + self.refresh_rate
        v = torch.randn(dim, generator=gen, dtype=dt, device=dev)
        y0, grad, times, n = self._start(params, tree, gen, lam_total)
        us = torch.rand((n, 2), generator=gen, dtype=dt, device=dev)
        v_refresh = torch.randn((n, dim), generator=gen, dtype=dt, device=dev)
        refresh = us[:, 0] < self.refresh_rate / lam_total
        y, t = y0, 0.0
        for i in range(n):
            y = y + v * (times[i] - t)
            t = times[i]
            g = grad(y)
            vg = torch.dot(v, g)
            bounce = us[i, 1] < torch.clamp_max(
                torch.clamp_min(vg, 0.0) / self.grad_bound, 1.0)
            v_bounce = v - 2.0 * vg / torch.clamp_min(torch.dot(g, g),
                                                      1e-30) * g
            v = torch.where(refresh[i], v_refresh[i],
                            torch.where(bounce, v_bounce, v))
        return self._finish(params, tree, y0, y, v, t, n)

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
Over a chain batch (`propose_chains`) each chain has its own velocity and
event times; the batch runs to its largest event count, a chain past its
own masked, one evaluation of all chains an event; `last_n_events` is
then a list, one count a chain.
Exactness needs `grad_bound` to dominate the rate along the trajectory;
where it does not, the flip probability is clipped at 1, as in JAX.
Positive parameters move in log space as in HmcOperator.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beast_mcmc_tpu_torch.inference.hmc import (
    HmcOperator,
    _normal,
    per_chain,
    value_grad,
)
from beast_mcmc_tpu_torch.inference.nuts import _no_ignored_settings


def _exponentials(gen, shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device
                       ).exponential_(generator=gen)


def _uniforms(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def _coordinates(gen, bounds, n):
    """n coordinates of each row of bounds [..., dim], each with
    probability bound / sum of the bounds: [..., n]."""
    return torch.multinomial(bounds, n, replacement=True, generator=gen)


class _Pdmp(HmcOperator):
    last_n_events = 0
    _reports = ("last_n_events",)

    def __post_init__(self):
        _no_ignored_settings(self)

    def _start(self, lp, params, tree, gen, lam_total):
        """(y0, dU/dy as a function of y, the candidate event times inside
        the horizon [B, n], the counts n [B] a list, and n's largest). The
        max_events exponential gaps are drawn at once; their running sum,
        clamped at the horizon, gives the times, and one host copy gives
        their counts."""
        y0 = self._pack(params).to(tree.heights.dtype).detach()
        u = self.neg_log_density(lp, params, tree)
        lead = y0.shape[:-1]
        gaps = _exponentials(gen, (*lead, self.max_events), y0) / lam_total
        times = torch.clamp_max(torch.cumsum(gaps, -1), self.travel_time)
        n = torch.count_nonzero(times < self.travel_time, dim=-1).tolist()
        n_max = max(n)
        return y0, lambda y: value_grad(u, y), times[..., :n_max], n, n_max

    def _active(self, n, n_max, y0):
        """[..., n_max] bool: whether the chain has its i-th event."""
        return (torch.arange(n_max, device=y0.device)
                < torch.as_tensor(n, device=y0.device)[..., None])

    def _finish(self, params, tree, y0, y, v, t, n):
        """The last leg, to the horizon unless max_events stopped the flow
        first, and the Gibbs-style result."""
        short = torch.as_tensor(n, device=y0.device) < self.max_events
        y = torch.where(per_chain(short, y),
                        y + v * per_chain(self.travel_time - t, y), y)
        self.last_n_events = n
        y = torch.where(per_chain(torch.isfinite(y).all(-1), y), y, y0)
        dt = y0.dtype
        lead = y0.shape[:-1]
        return (self._unpack(params, y), tree,
                torch.full(lead, math.inf, dtype=dt, device=y0.device),
                torch.full(lead, math.nan, dtype=dt, device=y0.device))


@dataclasses.dataclass
class ZigZagOperator(_Pdmp):
    """Zig-Zag process: velocities in {-1, +1}^d; coordinate i flips at
    rate max(0, v_i dU/dy_i), simulated by thinning against grad_bound
    (a scalar or one bound a coordinate)."""

    travel_time: float = 1.0
    grad_bound: float = 10.0
    max_events: int = 256
    adaptable: bool = False

    def _propose(self, lp, params, tree, gen, tuning):
        dt, dev = tree.heights.dtype, tree.heights.device
        probe = self._pack(params)
        dim = probe.shape[-1]
        bounds = torch.as_tensor(self.grad_bound, dtype=dt, device=dev
                                 ).expand(dim).contiguous()
        v = torch.where(_uniforms(gen, probe.shape, probe) < 0.5, -1.0,
                        1.0).to(dt)
        y0, grad, times, n, n_max = self._start(lp, params, tree, gen,
                                                torch.sum(bounds))
        # each candidate's coordinate ~ bounds / their sum, thinned by the
        # true rate over its bound
        lead = probe.shape[:-1]
        coords = (_coordinates(gen, bounds.expand(*lead, dim), n_max)
                  if n_max else torch.zeros((*lead, 0), dtype=torch.long,
                                            device=dev))
        us = _uniforms(gen, (*lead, n_max), y0)
        active = self._active(n, n_max, y0)
        y, t = y0, torch.zeros(lead, dtype=dt, device=dev)
        for i in range(n_max):
            act = active[..., i]
            y = torch.where(per_chain(act, y),
                            y + v * per_chain(times[..., i] - t, y), y)
            t = torch.where(act, times[..., i], t)
            g = grad(y)
            c = coords[..., i:i + 1]
            vc = torch.gather(v, -1, c)[..., 0]
            rate = torch.clamp_min(vc * torch.gather(g, -1, c)[..., 0], 0.0)
            flip = act & (us[..., i] < torch.clamp_max(
                rate / bounds[c[..., 0]], 1.0))
            v = v.scatter(-1, c, torch.where(flip, -vc, vc)[..., None])
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

    def _propose(self, lp, params, tree, gen, tuning):
        dt, dev = tree.heights.dtype, tree.heights.device
        probe = self._pack(params)
        lead, dim = probe.shape[:-1], probe.shape[-1]
        lam_total = self.grad_bound + self.refresh_rate
        v = _normal(gen, probe)
        y0, grad, times, n, n_max = self._start(lp, params, tree, gen,
                                                lam_total)
        us = _uniforms(gen, (*lead, n_max, 2), y0)
        v_refresh = _normal(gen, y0.new_empty((*lead, n_max, dim)))
        refresh = us[..., 0] < self.refresh_rate / lam_total
        active = self._active(n, n_max, y0)
        y, t = y0, torch.zeros(lead, dtype=dt, device=dev)
        for i in range(n_max):
            act = active[..., i]
            y = torch.where(per_chain(act, y),
                            y + v * per_chain(times[..., i] - t, y), y)
            t = torch.where(act, times[..., i], t)
            g = grad(y)
            vg = torch.sum(v * g, dim=-1)
            bounce = us[..., i, 1] < torch.clamp_max(
                torch.clamp_min(vg, 0.0) / self.grad_bound, 1.0)
            v_bounce = v - per_chain(2.0 * vg / torch.clamp_min(
                torch.sum(g * g, dim=-1), 1e-30), g) * g
            v_new = torch.where(per_chain(refresh[..., i], v),
                                v_refresh[..., i, :],
                                torch.where(per_chain(bounce, v), v_bounce, v))
            v = torch.where(per_chain(act, v), v_new, v)
        return self._finish(params, tree, y0, y, v, t, n)

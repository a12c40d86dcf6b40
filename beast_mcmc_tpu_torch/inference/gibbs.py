"""Block Gibbs operators: the GMRF block update and the elliptical slice
sampler of a Gaussian-prior parameter.

Counterpart of beast_mcmc_tpu/inference/gibbs.py, its
GmrfBlockUpdateOperator (:92-248) and EllipticalSliceOperator (:249-320);
the module's other classes stay with ROADMAP queue item 4f.

  - GmrfBlockUpdateOperator (GMRFSkyrideBlockUpdateOperator.java:245-345):
    scale the precision, find the mode of the field's full conditional
    under the new precision by Newton's method, propose the field from the
    Gaussian (Laplace) approximation at the mode, and correct with the
    forward and backward proposal densities. The tridiagonal algebra runs
    dense in the field's dtype on its device (fields are O(taxa) long; one
    Cholesky a direction), with a fixed number of Newton steps. The solves
    and the Cholesky report their status on the device (solve_ex,
    cholesky_ex): a singular or indefinite system gives NaN, which rejects
    the proposal, as JAX's NaNs do. No value is read on the host, and the proposal vmaps
    over a chain batch.
  - EllipticalSliceOperator (EllipticalSliceOperator.java:63, Murray,
    Adams and MacKay 2010): the ellipse through the current state and a
    prior draw preserves N(mu, Sigma); the angle is slice-sampled on the
    likelihood, the bound posterior less the prior. JAX's capped
    lax.while_loop becomes a host loop over the chain batch, finished
    chains masked, one host copy of the done flags an iteration (as
    inference/samplers.py's slice samplers); the cap and the collapse to
    angle 0 when no point is found are JAX's.

Both are Gibbs-style: log-Hastings +inf for the slice sampler; the block
update's is its proposal-density ratio. Their draws go through the
helpers `_uniform`, `_uniforms` and `_normal` of this module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from beast_mcmc_tpu_torch.inference.hmc import _Binds
from beast_mcmc_tpu_torch.inference.operators import (
    Operator,
    _normal,
    _uniform,
    _uniforms,
)
from beast_mcmc_tpu_torch.utils.accum import prefix_sum


def _nan_unless_ok(x, info):
    """x where a linalg `_ex` call succeeded (info 0), else NaN."""
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


@dataclasses.dataclass
class GmrfBlockUpdateOperator(Operator):
    """The skyride/skygrid block update of the field `field` (gamma, log
    population sizes) and its precision `precision` (tau). With
    cut_points the field is a skygrid's on that grid; without, a
    skyride's, one entry a coalescent interval (time-aware RW1 weights
    with time_aware)."""

    field: str = ""
    precision: str = ""
    n_taxa: int = 0
    scale_factor: float = 2.0
    time_aware: bool = False
    cut_points: Optional[Tuple[float, ...]] = None
    newton_iters: int = 12
    adaptable: bool = True

    @property
    def modifies_params(self):
        return (self.field, self.precision)

    def initial_adapt(self) -> float:
        return math.sqrt(self.scale_factor - 1.0)

    def tuning(self, adapt_value):
        return 1.0 + adapt_value * adapt_value

    def _suff_stats(self, tree):
        """(w [F], n_events [F]): the exposure and the coalescences of
        each field entry."""
        from beast_mcmc_tpu_torch.models.coalescent import (
            coalescent_intervals,
        )

        dt, dev = tree.heights.dtype, tree.heights.device
        times, lineages, is_coal = coalescent_intervals(tree.heights,
                                                        self.n_taxa)
        k = lineages[:-1]
        choose2 = (k * (k - 1) / 2.0).to(dt)
        expo = choose2 * torch.diff(times)
        if self.cut_points is not None:
            cuts = torch.as_tensor(self.cut_points, dtype=dt, device=dev)
            f = cuts.shape[0] + 1
            zero = torch.zeros(1, dtype=dt, device=dev)
            lo = torch.cat([zero, cuts])
            hi = torch.cat([cuts, torch.full_like(zero, math.inf)])
            frac = torch.clamp(torch.minimum(times[1:, None], hi[None])
                               - torch.maximum(times[:-1, None], lo[None]),
                               min=0.0)
            w = torch.sum(choose2[:, None] * frac, dim=0)
            cell = torch.searchsorted(cuts, times, side="left")
            n_events = torch.zeros(f, dtype=dt, device=dev).index_add(
                0, cell, is_coal.to(dt))
            return w, n_events
        # skyride: entry i governs the interval ending at the i-th
        # coalescence
        f = self.n_taxa - 1
        coal_before = prefix_sum(is_coal.long())
        idx = torch.clamp(coal_before[:-1], max=f - 1)
        w = torch.zeros(f, dtype=dt, device=dev).index_add(0, idx, expo)
        return w, torch.ones(f, dtype=dt, device=dev)

    def _q_matrix(self, tau, tree, f, dt):
        """The tau-scaled RW1 precision (uniform weights; the time-aware
        variant weights the off-diagonals by the inter-knot spacings,
        GMRFSkyrideLikelihood setupGMRFWeights)."""
        dev = tree.heights.device
        if self.time_aware and self.cut_points is None:
            from beast_mcmc_tpu_torch.models.coalescent import (
                skyride_coalescent_midpoints,
            )

            knots = skyride_coalescent_midpoints(tree.heights, self.n_taxa)
            sp = torch.diff(torch.cat([torch.zeros(1, dtype=dt, device=dev),
                                       knots.to(dt)]))
            offd = -2.0 / torch.clamp(sp[:-1] + sp[1:], min=1e-12)
            diag = torch.zeros(f, dtype=dt, device=dev)
            diag = torch.cat([-offd, diag[-1:]]) + torch.cat([diag[:1],
                                                              -offd])
            return tau * (torch.diag(diag) + torch.diag(offd, 1)
                          + torch.diag(offd, -1))
        diag = torch.full((f,), 2.0, dtype=dt, device=dev)
        diag[0] = diag[-1] = 1.0
        off = torch.full((f - 1,), -1.0, dtype=dt, device=dev)
        return tau * (torch.diag(diag) + torch.diag(off, 1)
                      + torch.diag(off, -1))

    def propose(self, params, tree, gen, tuning):
        dt = tree.heights.dtype
        gamma = params[self.field].reshape(-1).to(dt)
        f = gamma.shape[0]
        tau = params[self.precision].reshape(-1)[0].to(dt)

        # the precision proposal (getNewPrecision:94-108): a uniform slab /
        # power mixture over [tau / s, tau s]
        s = torch.as_tensor(tuning, dtype=dt, device=gamma.device)
        length = s - 1.0 / s
        u1 = _uniform(gen, gamma)
        u2 = _uniform(gen, gamma)
        slab = (1.0 / s + length * u2) * tau
        power = torch.pow(s, 2.0 * u2 - 1.0) * tau
        tau_new = torch.where(u1 < length / (length + 2.0 * torch.log(s)),
                              slab, power)

        w, n_events = self._suff_stats(tree)

        def newton(q, g):
            for _ in range(self.newton_iters):
                grad = -(q @ g) + (w * torch.exp(-g) - n_events)
                jac = q + torch.diag(w * torch.exp(-g))
                g = g + _nan_unless_ok(*torch.linalg.solve_ex(jac, grad))
            return g

        def laplace(q, mode):
            d1 = w * torch.exp(-mode)
            qw = q + torch.diag(d1)
            canon = d1 * (mode + 1.0) - n_events
            chol = _nan_unless_ok(*torch.linalg.cholesky_ex(qw))
            mean = torch.cholesky_solve(canon[:, None], chol)[:, 0]
            return qw, chol, mean, torch.sum(torch.log(torch.diagonal(chol)))

        q_new = self._q_matrix(tau_new, tree, f, dt)
        q_cur = self._q_matrix(tau, tree, f, dt)

        _, chol_f, mean_f, logdet_f = laplace(q_new, newton(q_new, gamma))
        z = _normal(gen, gamma, (f,))
        # x = mean + (L^T)^-1 z (getMultiNormal: U v = z with U = L^T)
        v = torch.linalg.solve_triangular(chol_f.T, z[:, None],
                                          upper=True)[:, 0]
        gamma_new = mean_f + v

        qw_b, _, mean_b, logdet_b = laplace(q_cur, newton(q_cur, gamma_new))
        d = gamma - mean_b
        h = logdet_b - 0.5 * d @ (qw_b @ d) - logdet_f + 0.5 * z @ z

        ok = torch.isfinite(h) & torch.all(torch.isfinite(gamma_new))
        old_g, old_t = params[self.field], params[self.precision]
        new_params = {
            **params,
            self.field: gamma_new.reshape(old_g.shape).to(old_g.dtype),
            self.precision: tau_new.reshape(old_t.shape).to(old_t.dtype),
        }
        return new_params, tree, torch.where(
            ok, h, torch.full_like(h, -math.inf)).to(dt)


@dataclasses.dataclass
class EllipticalSliceOperator(_Binds, Operator):
    """Elliptical slice sampling of `parameter` (a vector) under its
    multivariate-normal prior N(prior_mean, Sigma), Sigma = prior_chol
    prior_chol^T, whose log density up to a constant is
    prior_logpdf(v, mu) (v [..., d]). The slice is on the bound posterior
    less that prior. Over a chain batch each chain has its own ellipse and
    bracket, and the loop goes on until every chain has its point or the
    cap; `last_n_evaluations` holds the evaluations of the last
    proposal."""

    parameter: str = ""
    prior_mean: Sequence[float] = ()
    prior_chol: object = None
    prior_logpdf: Optional[Callable] = None
    max_iters: int = 64
    adaptable: bool = False
    last_n_evaluations = 0
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def modifies_params(self):
        return (self.parameter,)

    def _propose(self, lp, params, tree, gen, tuning):
        x = params[self.parameter]
        dt, dev = x.dtype, x.device
        lead = x.shape[:1]
        mu = torch.as_tensor(self.prior_mean, dtype=dt, device=dev)
        chol = torch.as_tensor(self.prior_chol, dtype=dt, device=dev)
        n_eval = [0]

        def f(v):  # the posterior less the prior: the likelihood
            n_eval[0] += 1
            return (lp({**params, self.parameter: v.to(dt)}, tree)
                    - self.prior_logpdf(v, mu))

        nu = (chol @ _normal(gen, x, x.shape)[..., None])[..., 0]
        logy = f(x) + torch.log(_uniforms(gen, x, lead))
        a = _uniforms(gen, x, lead) * 2.0 * math.pi
        lo, hi = a - 2.0 * math.pi, a

        def point(t):
            t = t[..., None]
            return (x - mu) * torch.cos(t) + nu * torch.sin(t) + mu

        a_fin = torch.zeros_like(a)
        done = torch.zeros(lead, dtype=torch.bool, device=dev)
        for _ in range(self.max_iters):
            ok = ~done & (f(point(a)) > logy)
            a_fin = torch.where(ok, a, a_fin)
            done = done | ok
            if not any((~done).tolist()):
                break
            lo = torch.where(done, lo, torch.where(a < 0, a, lo))
            hi = torch.where(done, hi, torch.where(a < 0, hi, a))
            a = torch.where(done, a,
                            lo + (hi - lo) * _uniforms(gen, x, lead))
        # past the cap the angle collapses to 0: the current state
        self.last_n_evaluations = n_eval[0]
        new = point(torch.where(done, a_fin, torch.zeros_like(a_fin)))
        return ({**params, self.parameter: new.to(dt)}, tree,
                torch.full(lead, math.inf, dtype=dt, device=dev))

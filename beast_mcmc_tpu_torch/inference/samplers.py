"""Slice, elliptical-slice and multivariate-normal proposal operators.

Counterpart of beast_mcmc_tpu/inference/samplers.py (the reference's
SliceOperator, EllipticalSliceOperator and
AdaptableVarianceMultivariateNormalOperator):

  - SliceOperator: Neal (2003) stepping out and shrinkage on one random
    coordinate. JAX's lax.while_loops become host loops with the same
    iteration caps, one host copy of the loop's test an iteration; each
    iteration evaluates the posterior (one kernel launch on a CUDA device).
    Gibbs-style: log-Hastings +inf. Both slice samplers also propose over a
    chain batch (`propose_chains`), the loops in step until every chain
    has its point.
  - EllipticalSliceOperator: Murray, Adams and MacKay's elliptical slice
    for a parameter with an isotropic Gaussian prior factor in the bound
    posterior, the operator of inference/gibbs.py with Sigma = sd^2 I; it
    subtracts that factor to get the "likelihood". Gibbs-style.
  - MvnOperator: a multivariate-normal random walk with a fixed Cholesky
    factor and a Robbins-Monro global scale; `empirical_covariance` builds
    the factor from a window of samples.
  - AvmvnOperator: the in-chain adaptive form, its running Welford
    statistics in `params` under `stats_key`, updated after every step by
    the hook that `make_post_update` returns for make_mcmc_step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.hmc import _Binds, _normal
from beast_mcmc_tpu_torch.inference.operators import Operator

_MAX_STEPOUT = 32
_MAX_SHRINK = 64


def _gibbs(params, tree, lead, dt, device):
    """A Gibbs-style result: always accepted, no acceptance statistic."""
    return (params, tree, torch.full(lead, math.inf, dtype=dt, device=device),
            torch.full(lead, math.nan, dtype=dt, device=device))


def _exponential(gen, lead, dt, device):
    return torch.empty(lead, dtype=dt, device=device).exponential_(
        generator=gen)


def _uniform(gen, lead, dt, device):
    return torch.rand(lead, generator=gen, dtype=dt, device=device)


def _coordinate(gen, n, lead, device):
    return torch.randint(0, n, (*lead, 1), generator=gen, device=device)


def _any(flags) -> bool:
    """One host copy of a [B] flag: whether any chain holds it."""
    return any(flags.tolist())


@dataclasses.dataclass
class SliceOperator(_Binds, Operator):
    """Univariate slice sampler on one random coordinate of `parameter`,
    from a bracket of `width`. With log_transform the slice runs in log
    space, the Jacobian folded into its target. Over a chain batch each
    chain slices its own coordinate: the stepping-out and shrinkage loops
    go on, in step, until every chain has its point, a chain that is done
    masked; each pass evaluates the posterior once over the chain axis.
    `last_n_evaluations` holds the evaluations of the last proposal."""

    parameter: str = ""
    width: float = 1.0
    log_transform: bool = False
    last_n_evaluations = 0
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _propose(self, lp, params, tree, gen, tuning):
        dt, dev = tree.heights.dtype, tree.heights.device
        x = params[self.parameter]
        lead = x.shape[:1]
        flat = x.reshape(*lead, -1).to(dt)
        idx = _coordinate(gen, flat.shape[-1], lead, dev)

        def put(v):
            val = torch.exp(v) if self.log_transform else v
            return flat.scatter(-1, idx, val[..., None]).reshape(
                x.shape).to(x.dtype)

        n_eval = [0]

        def logf(v):
            n_eval[0] += 1
            out = lp({**params, self.parameter: put(v)}, tree)
            return out + v if self.log_transform else out

        v0 = torch.gather(flat, -1, idx)[..., 0]
        v0 = torch.log(v0) if self.log_transform else v0
        # the vertical level: log u + logf(v0), u ~ U(0, 1)
        logy = logf(v0) - _exponential(gen, lead, dt, dev)
        lo = v0 - _uniform(gen, lead, dt, dev) * self.width
        hi = lo + self.width
        f_lo, f_hi = logf(lo), logf(hi)
        for _ in range(_MAX_STEPOUT):  # stepping out
            out_lo, out_hi = f_lo > logy, f_hi > logy
            step_lo, step_hi = (any(f) for f in torch.stack(
                [out_lo, out_hi]).tolist())
            if not (step_lo or step_hi):
                break
            if step_lo:
                lo = torch.where(out_lo, lo - self.width, lo)
                f_lo = torch.where(out_lo, logf(lo), f_lo)
            if step_hi:
                hi = torch.where(out_hi, hi + self.width, hi)
                f_hi = torch.where(out_hi, logf(hi), f_hi)
        v1 = v0  # where shrinkage finds no point, x stays: also exact
        found = torch.zeros(lead, dtype=torch.bool, device=dev)
        for _ in range(_MAX_SHRINK):  # shrinkage
            v_new = lo + _uniform(gen, lead, dt, dev) * (hi - lo)
            hit = ~found & (logf(v_new) > logy)
            v1 = torch.where(hit, v_new, v1)
            found = found | hit
            if not _any(~found):
                break
            lo = torch.where(v_new >= v0, lo, v_new)
            hi = torch.where(v_new < v0, hi, v_new)
        self.last_n_evaluations = n_eval[0]
        return _gibbs({**params, self.parameter: put(v1)}, tree, lead, dt,
                      dev)


@dataclasses.dataclass
class EllipticalSliceOperator(_Binds, Operator):
    """Elliptical slice sampling of `parameter` under its Gaussian prior
    N(prior_mean, prior_stdev^2 I), a factor of the bound posterior
    (EllipticalSliceOperator.java; Murray, Adams and MacKay 2010): the
    isotropic case of inference/gibbs.py's operator, whose proposal
    (gibbs.elliptical_slice) it runs. Over a chain batch each chain has
    its own ellipse and bracket; the shrinkage goes on, in step, until
    every chain has its point. `last_n_evaluations` holds the evaluations
    of the last proposal."""

    parameter: str = ""
    prior_mean: float = 0.0
    prior_stdev: float = 1.0
    last_n_evaluations = 0
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _propose(self, lp, params, tree, gen, tuning):
        from beast_mcmc_tpu_torch.inference.gibbs import elliptical_slice

        x = params[self.parameter]
        d = x[0].numel()
        mu = torch.full((d,), float(self.prior_mean), dtype=x.dtype,
                        device=x.device)
        sd = float(self.prior_stdev)
        chol = sd * torch.eye(d, dtype=x.dtype, device=x.device)

        def prior_logpdf(v, m):
            return torch.sum(-0.5 * ((v - m) / sd) ** 2, dim=-1)

        p, t, logh, self.last_n_evaluations = elliptical_slice(
            lp, params, tree, gen, self.parameter, mu, chol, prior_logpdf,
            _MAX_SHRINK)
        return p, t, logh


class _Packed:
    """One chain's parameters packed into one vector, in log space with
    log_transform (a chain batch vmaps these operators)."""

    def _pack(self, params):
        flat = torch.cat([torch.atleast_1d(params[n]).reshape(-1)
                          for n in self.parameters])
        return torch.log(flat) if self.log_transform else flat

    def _unpack(self, params, y):
        x = torch.exp(y) if self.log_transform else y
        out, i = dict(params), 0
        for n in self.parameters:
            v = params[n]
            out[n] = x[i:i + v.numel()].reshape(v.shape).to(v.dtype)
            i += v.numel()
        return out

    def initial_adapt(self) -> float:
        return float(np.log(self.scale))

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def _step(self, params, tree, y0, y1):
        """The proposal at y1 with its Jacobian term; y0 kept (and -inf)
        where y1 is not finite."""
        logh = (torch.sum(y1) - torch.sum(y0) if self.log_transform
                else y0.new_zeros(()))
        ok = torch.all(torch.isfinite(y1))
        return (self._unpack(params, torch.where(ok, y1, y0)), tree,
                torch.where(ok, logh, torch.full_like(logh, -math.inf)))


@dataclasses.dataclass
class MvnOperator(_Packed, Operator):
    """Multivariate-normal random walk y' = y + s L eps over the named
    parameters (in log space with log_transform). L is the Cholesky factor
    of the proposal covariance (identity by default); the global scale s
    adapts by Robbins-Monro."""

    parameters: Sequence[str] = ()
    scale: float = 0.2
    chol: Optional[np.ndarray] = None  # [dim, dim] lower-triangular
    log_transform: bool = True
    adaptable: bool = True

    def propose(self, params, tree, gen, tuning):
        dt = tree.heights.dtype
        y0 = self._pack(params).to(dt)
        eps = torch.randn(y0.shape, generator=gen, dtype=dt, device=y0.device)
        if self.chol is not None:
            eps = torch.as_tensor(self.chol, dtype=dt, device=y0.device) @ eps
        return self._step(params, tree, y0, y0 + tuning * eps)


def empirical_covariance(samples: np.ndarray, log_space: bool = True):
    """The Cholesky factor of the covariance of samples [n, dim] (in log
    space with log_space), for MvnOperator's `chol`."""
    s = np.log(samples) if log_space else np.asarray(samples)
    cov = np.cov(s, rowvar=False)
    cov = np.atleast_2d(cov) + 1e-8 * np.eye(s.shape[1])
    return np.linalg.cholesky(cov)


@dataclasses.dataclass
class AvmvnOperator(_Packed, Operator):
    """The reference's adaptive-variance multivariate normal operator
    (AdaptableVarianceMultivariateNormalOperator.java:59): a random walk
    whose covariance is the chain's own running empirical covariance mixed
    with an identity ridge,

        Sigma = s^2 ((1 - beta) Cov_emp + beta I / dim),

    the empirical term on from `warmup` updates, s adapted by Robbins-Monro.
    The Welford statistics (mean, scatter, n) live in `params` under
    `stats_key`; `make_post_update` updates them after every step."""

    parameters: Sequence[str] = ()
    scale: float = 0.2
    beta: float = 0.05
    warmup: int = 100
    log_transform: bool = True
    adaptable: bool = True

    @property
    def stats_key(self) -> str:
        return "_avmvn:" + ",".join(self.parameters)

    def init_stats(self, params):
        """params with zeroed statistics under stats_key."""
        y = self._pack(params)
        d = y.shape[0]
        return {**params, self.stats_key: {
            "mean": y.new_zeros(d), "scatter": y.new_zeros(d, d),
            "n": y.new_zeros(())}}

    def update_stats(self, params):
        """One Welford update from the chain's current state."""
        st = params[self.stats_key]
        y = self._pack(params).to(st["mean"].dtype)
        n1 = st["n"] + 1.0
        delta = y - st["mean"]
        mean = st["mean"] + delta / n1
        return {**params, self.stats_key: {
            "mean": mean, "scatter": st["scatter"] + torch.outer(delta,
                                                                 y - mean),
            "n": n1}}

    def propose(self, params, tree, gen, tuning):
        dt = tree.heights.dtype
        st = params[self.stats_key]
        y0 = self._pack(params).to(dt)
        d = y0.shape[0]
        n = st["n"].to(dt)
        eye = torch.eye(d, dtype=dt, device=y0.device)
        cov_emp = st["scatter"].to(dt) / torch.clamp_min(n - 1.0, 1.0)
        use_emp = (n >= self.warmup).to(dt)
        mix = (1.0 - self.beta) * use_emp
        cov = mix * cov_emp + ((1.0 - mix) + self.beta * use_emp) / d * eye
        # cholesky_ex: no host sync; a failed factor shows as a non-finite
        # proposal, kept at y0 and rejected
        chol = torch.linalg.cholesky_ex(cov + 1e-10 * eye)[0]
        eps = torch.randn((d,), generator=gen, dtype=dt, device=y0.device)
        return self._step(params, tree, y0, y0 + tuning * (chol @ eps))


def make_post_update(operators):
    """The hook for make_mcmc_step(post_update=...) that updates the
    statistics of every operator that keeps them (AVMVN); None when none
    does."""
    stateful = [op for op in operators if hasattr(op, "update_stats")]
    if not stateful:
        return None

    def post_update(params):
        for op in stateful:
            params = op.update_stats(params)
        return params

    return post_update

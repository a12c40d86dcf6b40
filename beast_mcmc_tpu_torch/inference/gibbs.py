"""Gibbs operators: the conjugate draws, the GMRF block update, the
elliptical slice sampler and the trait moves.

Counterpart of beast_mcmc_tpu/inference/gibbs.py, every class of it:

  - NormalNormalMeanGibbs and NormalGammaPrecisionGibbs
    (NormalNormalMeanGibbsOperator.java, NormalGammaPrecisionGibbsOperator
    .java): a mean or a precision drawn from its conjugate full
    conditional;
  - GmrfBlockUpdateOperator (GMRFSkyrideBlockUpdateOperator.java:245-345):
    scale the precision, find the mode of the field's full conditional
    under the new precision by Newton's method, propose the field from the
    Gaussian (Laplace) approximation at the mode, and correct with the
    forward and backward proposal densities. The tridiagonal algebra runs
    dense in the field's dtype on its device (fields are O(taxa) long; one
    Cholesky a direction), with a fixed number of Newton steps;
  - EllipticalSliceOperator (EllipticalSliceOperator.java:63, Murray,
    Adams and MacKay 2010): the ellipse through the current state and a
    prior draw preserves N(mu, Sigma); the angle is slice-sampled on the
    likelihood, the bound posterior less the prior. JAX's capped
    lax.while_loop becomes a host loop over the chain batch, finished
    chains masked, one host copy of the done flags an iteration (as
    inference/samplers.py's slice samplers, whose isotropic elliptical
    slice runs `elliptical_slice`); the cap and the collapse to angle 0
    when no point is found are JAX's;
  - InternalTraitGibbsOperator (TraitGibbsOperator), PrecisionWishart
    GibbsOperator (PrecisionMatrixGibbsOperator.java:63, a Bartlett draw)
    and LatentLiabilityGibbsOperator (NewLatentLiabilityGibbs.java:
    139-280): the moves of the continuous-trait models; their XML tags are
    config/xml_hmc.py's <precisionGibbsOperator> and
    <internalTraitGibbsOperator> and config/xml_traits.py's
    <newLatentLiabilityGibbsOperator> (config/xml_factor.py's factor and
    liability Gibbs moves draw through this module's helpers).

All but the block update and the latent liabilities are Gibbs moves,
log-Hastings +inf. The linear algebra reports failure on the device
(solve_ex, inv_ex, cholesky_ex): a singular or indefinite system rejects
the proposal (NaN in the block update, -inf log Hastings in the others),
where torch.linalg would raise and JAX returns NaN; no value is read on
the host, and every proposal but the slice sampler's (a chain-axis
proposal of its own) vmaps over a chain batch. Their draws go through the
helpers `_uniform`, `_uniforms`, `_normal`, `_gamma` and `_randint` of
this module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.hmc import _Binds
from beast_mcmc_tpu_torch.inference.operators import (
    Operator,
    _normal,
    _uniform,
    _uniforms,
    gamma_draw,
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


def elliptical_slice(lp, params, tree, gen, parameter, mu, chol,
                     prior_logpdf, max_iters):
    """One elliptical slice proposal of `parameter` over a chain batch
    ([B, ...] params, the chain-axis posterior `lp`), under the Gaussian
    prior N(mu, chol chol^T) whose log density up to a constant is
    prior_logpdf(v, mu) (v [..., d], the chain's values flattened). Returns
    (params, tree, log Hastings [B] = +inf, the posterior evaluations)."""
    x = params[parameter]
    dt, dev = x.dtype, x.device
    lead = x.shape[:1]
    flat = x.reshape(*lead, -1)
    n_eval = [0]

    def f(v):  # the posterior less the prior: the likelihood
        n_eval[0] += 1
        return (lp({**params, parameter: v.reshape(x.shape).to(dt)}, tree)
                - prior_logpdf(v, mu))

    nu = (chol @ _normal(gen, flat, flat.shape)[..., None])[..., 0]
    logy = f(flat) + torch.log(_uniforms(gen, flat, lead))
    a = _uniforms(gen, flat, lead) * 2.0 * math.pi
    lo, hi = a - 2.0 * math.pi, a

    def point(t):
        t = t[..., None]
        return (flat - mu) * torch.cos(t) + nu * torch.sin(t) + mu

    a_fin = torch.zeros_like(a)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        ok = ~done & (f(point(a)) > logy)
        a_fin = torch.where(ok, a, a_fin)
        done = done | ok
        if not any((~done).tolist()):
            break
        lo = torch.where(done, lo, torch.where(a < 0, a, lo))
        hi = torch.where(done, hi, torch.where(a < 0, hi, a))
        a = torch.where(done, a, lo + (hi - lo) * _uniforms(gen, flat, lead))
    # past the cap the angle collapses to 0: the current state
    new = point(torch.where(done, a_fin, torch.zeros_like(a_fin)))
    return ({**params, parameter: new.reshape(x.shape).to(dt)}, tree,
            torch.full(lead, math.inf, dtype=dt, device=dev), n_eval[0])


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
        mu = torch.as_tensor(self.prior_mean, dtype=x.dtype, device=x.device)
        chol = torch.as_tensor(self.prior_chol, dtype=x.dtype,
                               device=x.device)
        p, t, logh, self.last_n_evaluations = elliptical_slice(
            lp, params, tree, gen, self.parameter, mu, chol,
            self.prior_logpdf, self.max_iters)
        return p, t, logh


# ---------------------------------------------------------------------------
# conjugate draws (NormalNormalMeanGibbsOperator.java,
# NormalGammaPrecisionGibbsOperator.java) and the trait Gibbs moves
# ---------------------------------------------------------------------------


def _gamma(gen, shape, like, size=()):
    """Gamma(shape, 1) draws of `size` (operators.gamma_draw)."""
    return gamma_draw(gen, shape, like, size)


def _randint(gen, low: int, high: int, like) -> torch.Tensor:
    """A uniform int64 [1] in [low, high) on `like`'s device."""
    return torch.randint(low, high, (1,), generator=gen, device=like.device)


def _gibbs_logh(tree, ok=True):
    """+inf (always accepted), or -inf where a factorisation failed."""
    inf = torch.full((), math.inf, dtype=tree.heights.dtype,
                     device=tree.heights.device)
    return torch.where(torch.as_tensor(ok, device=inf.device), inf, -inf)


def _inv_ex(a):
    """(inverse, ok) of a matrix, NaN where it is singular."""
    inv, info = torch.linalg.inv_ex(a)
    return _nan_unless_ok(inv, info), info == 0


def _chol_ex(a):
    """(lower Cholesky factor, ok), NaN where a is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(a)
    return _nan_unless_ok(chol, info), info == 0


def _data(params, names, dt):
    return torch.cat([params[n].reshape(-1) for n in names]).to(dt)


@dataclasses.dataclass
class NormalNormalMeanGibbs(Operator):
    """mu | x ~ N((p0 m0 + n tau xbar) / (p0 + n tau), 1 / (p0 + n tau))
    for iid Normal(mu, 1 / tau) data with a Normal(m0, 1 / p0) prior on mu
    (NormalNormalMeanGibbsOperator.java doOperation); tau is
    precision_of(params)."""

    mean_param: str = ""
    data_params: Sequence[str] = ()
    precision_of: Optional[Callable] = None
    prior_mean: float = 0.0
    prior_stdev: float = 1.0
    adaptable: bool = False

    @property
    def modifies_params(self):
        return (self.mean_param,)

    def propose(self, params, tree, gen, tuning):
        dt = tree.heights.dtype
        xs = _data(params, self.data_params, dt)
        tau = torch.as_tensor(self.precision_of(params), dtype=dt,
                              device=xs.device)
        p0 = 1.0 / self.prior_stdev ** 2
        prec = p0 + xs.shape[0] * tau
        mean = (p0 * self.prior_mean + tau * torch.sum(xs)) / prec
        draw = mean + _normal(gen, xs) / torch.sqrt(prec)
        old = params[self.mean_param]
        return ({**params, self.mean_param: draw.expand(old.shape).to(
            old.dtype)}, tree, _gibbs_logh(tree))


@dataclasses.dataclass
class NormalGammaPrecisionGibbs(Operator):
    """tau | x ~ Gamma(a0 + n / 2, rate0 + sum (x - mu)^2 / 2) for iid
    Normal(mu, 1 / tau) data with a Gamma(shape a0, scale) prior on tau
    (NormalGammaPrecisionGibbsOperator.java doOperation); mu is
    mean_of(params)."""

    precision_param: str = ""
    data_params: Sequence[str] = ()
    mean_of: Optional[Callable] = None
    prior_shape: float = 1.0
    prior_scale: float = 1.0  # BEAST's gammaPrior scale; the rate is 1/scale
    adaptable: bool = False

    @property
    def modifies_params(self):
        return (self.precision_param,)

    def propose(self, params, tree, gen, tuning):
        dt = tree.heights.dtype
        xs = _data(params, self.data_params, dt)
        mu = torch.as_tensor(self.mean_of(params), dtype=dt,
                             device=xs.device)
        shape = self.prior_shape + 0.5 * xs.shape[0]
        rate = 1.0 / self.prior_scale + 0.5 * torch.sum((xs - mu) ** 2)
        draw = _gamma(gen, shape, xs) / rate
        old = params[self.precision_param]
        return ({**params, self.precision_param: draw.expand(old.shape).to(
            old.dtype)}, tree, _gibbs_logh(tree))


def _set_row(x, row, value):
    """x [R, d] with row `row` (int64 [1]) replaced by value [d]."""
    hit = torch.arange(x.shape[0], device=x.device)[:, None] == row
    return torch.where(hit, value[None, :], x)


@dataclasses.dataclass
class InternalTraitGibbsOperator(Operator):
    """A Gibbs draw of one internal, non-root node's trait from its full
    conditional under the Brownian branch-increment density
    (TraitGibbsOperator: the parent p and children c1, c2 give N(weighted
    mean, Lambda^-1 / w), w = 1/t_up + 1/t1 + 1/t2). A singular precision
    or covariance rejects the proposal."""

    trait_param: str = ""
    dim: int = 1
    n_tips: int = 0
    prec_of: Optional[Callable] = None  # params -> [d, d] Lambda
    adaptable: bool = False

    @property
    def modifies_params(self):
        return (self.trait_param,)

    def propose(self, params, tree, gen, tuning):
        d, n = self.dim, self.n_tips
        x = params[self.trait_param].reshape(-1, d)
        # a uniform internal node other than the root (sample_excluding)
        r = _randint(gen, 0, x.shape[0] - n - 1, x)
        node = n + r + (r >= tree.root - n).long()
        cov_base, ok_inv = _inv_ex(self.prec_of(params).to(x.dtype))
        p = tree.parent[node]
        c1, c2 = tree.children[node, 0], tree.children[node, 1]
        h = tree.heights
        w1 = 1.0 / (h[p] - h[node])
        w2 = 1.0 / (h[node] - h[c1])
        w3 = 1.0 / (h[node] - h[c2])
        w = w1 + w2 + w3
        mean = ((x[p] * w1[:, None] + x[c1] * w2[:, None]
                 + x[c2] * w3[:, None]) / w[:, None])[0]
        chol, ok_chol = _chol_ex(cov_base / w)
        new = mean + chol @ _normal(gen, x, (d,))
        x2 = _set_row(x, node, new)
        return ({**params, self.trait_param: x2.reshape(
            params[self.trait_param].shape)}, tree,
            _gibbs_logh(tree, ok_inv & ok_chol))


@dataclasses.dataclass
class PrecisionWishartGibbsOperator(Operator):
    """The exact conjugate Wishart draw of the diffusion precision given
    the sampled node traits (PrecisionMatrixGibbsOperator.java:63: the
    posterior degrees of freedom are the prior's plus the branches, the
    inverse scale the prior's plus sum over branches of dx dx^T / t), by
    the Bartlett decomposition. The d column parameters of the precision
    matrix take the draw's columns. A failed factorisation rejects."""

    trait_param: str = ""
    dim: int = 1
    col_params: Sequence[str] = ()
    prior_df: float = 2.0
    prior_scale: object = None  # [d, d] prior scale matrix (host)
    adaptable: bool = False

    @property
    def modifies_params(self):
        return tuple(self.col_params)

    def propose(self, params, tree, gen, tuning):
        d = self.dim
        x = params[self.trait_param].reshape(-1, d)
        dt = x.dtype
        pidx = torch.clamp_min(tree.parent, 0)
        has_parent = tree.parent >= 0
        t_b = torch.where(has_parent, tree.heights[pidx] - tree.heights,
                          torch.ones_like(tree.heights))
        diff = x - x[pidx]
        mask = has_parent.to(dt)
        s_mat = torch.einsum("m,md,me->de", mask / t_b, diff, diff)
        scale0_inv, ok0 = _inv_ex(torch.as_tensor(
            np.asarray(self.prior_scale), dtype=dt, device=x.device))
        post_scale, ok1 = _inv_ex(scale0_inv + s_mat)
        df = self.prior_df + torch.sum(mask)
        chol, ok2 = _chol_ex(post_scale)
        z = torch.tril(_normal(gen, x, (d, d)), -1)
        i = torch.arange(d, dtype=dt, device=x.device)
        # chi draws on the diagonal: the square root of Gamma((df - i)/2, 2)
        c_diag = torch.sqrt(2.0 * _gamma(gen, 0.5 * (df - i), x, (d,)))
        a_mat = z + torch.diag(c_diag)
        w_draw = chol @ a_mat @ a_mat.T @ chol.T
        out = dict(params)
        for j, cn in enumerate(self.col_params):
            out[cn] = w_draw[:, j].to(params[cn].dtype).reshape(
                params[cn].shape)
        return out, tree, _gibbs_logh(tree, ok0 & ok1 & ok2)


@dataclasses.dataclass
class LatentLiabilityGibbsOperator(Operator):
    """One tip's latent trait drawn from its tree full conditional N(mean_i,
    s_i Lambda^-1), rejecting draws outside the box its discrete datum
    allows (NewLatentLiabilityGibbs.java:139-280). On a fixed topology the
    conditional weights W_i (cond_weights [N, N]) and Schur scalars s_i
    (cond_scale [N]) are host constants; the precision stays live. The
    max_attempts draws are made at once and the first inside the box
    taken, where JAX draws them one at a time until one is; none inside
    (or a failed factorisation) rejects. Hastings: the proposal density of
    the old draw over the new one's."""

    trait_param: str = ""
    dim: int = 1
    n_tips: int = 0
    cond_weights: object = None
    cond_scale: object = None
    mu0: object = None  # [D] root prior mean
    lo: object = None  # [N, D]
    hi: object = None  # [N, D]
    prec_of: Optional[Callable] = None
    max_attempts: int = 64
    adaptable: bool = False

    @property
    def modifies_params(self):
        return (self.trait_param,)

    def propose(self, params, tree, gen, tuning):
        d, n = self.dim, self.n_tips
        x = params[self.trait_param].reshape(n, d)
        dt, dev = x.dtype, x.device

        def const(v):
            return torch.as_tensor(np.asarray(v), dtype=dt, device=dev)

        i = _randint(gen, 0, n, x)
        w = const(self.cond_weights)[i][0]
        s = const(self.cond_scale)[i][0]
        mu0 = const(self.mu0)
        mean = mu0 + w @ (x - mu0[None, :])
        lam_inv, ok_inv = _inv_ex(self.prec_of(params).to(dt))
        cov = s * lam_inv
        chol, ok_chol = _chol_ex(cov)
        lo, hi = const(self.lo)[i][0], const(self.hi)[i][0]
        v = mean + _normal(gen, x, (self.max_attempts, d)) @ chol.T
        inside = torch.all((v >= lo) & (v <= hi), dim=-1)
        first = torch.argmax(inside.long())
        x_i = x[i][0]
        found = inside.any()
        new = torch.where(found, v[first], x_i)
        prec_c, ok_prec = _inv_ex(cov)

        def lp(u):
            dlt = u - mean
            return -0.5 * dlt @ prec_c @ dlt

        ok = found & ok_inv & ok_chol & ok_prec
        logh = torch.where(ok, lp(x_i) - lp(new),
                           torch.full((), -math.inf, dtype=dt, device=dev))
        x2 = _set_row(x, i, new)
        return ({**params, self.trait_param: x2.reshape(
            params[self.trait_param].shape)}, tree,
            logh.to(tree.heights.dtype))

"""Phylogenetic factor analysis with analytically integrated factors.

Counterpart of beast_mcmc_tpu/models/factor.py, every function of it (ref:
src/dr/evomodel/treedatalikelihood/continuous/
IntegratedFactorAnalysisLikelihood.java): P observed traits per tip are a
linear map of K latent factors, y_i | f_i ~ N(L^T f_i, Gamma^-1) with
diagonal trait precision Gamma; the factors evolve on the tree as a
K-dimensional Brownian diffusion with precision Lambda. Each tip
contributes a canonical Gaussian potential on the factor scale,

    P_i = L_obs Gamma_obs L_obs^T,  b_i = L_obs Gamma_obs y_obs,
    g_i = -1/2 (n_obs log 2pi - sum log gamma_obs + y^T Gamma y),

and the tree marginal is the singularity-safe canonical belief propagation
of models/continuous.py. The JAX package's scan over the height-sorted
nodes goes here by levels of depth (models/continuous.py::tree_levels):
the tips' pushes in one batched step, then each level's in one. The
host-side long-double oracle `canonical_bp_loglikelihood_np` stays numpy,
as in the JAX package. Gradients come from torch.autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from beast_mcmc_tpu_torch.models.continuous import (
    _branch_times,
    _dot,
    _inv,
    _logdet,
    _mv,
    _per_branch,
    _push_canonical,
    _sym,
    _t,
    _upward,
    tree_levels,
)

_LOG_2PI = math.log(2.0 * math.pi)


def factor_tip_potentials(
    tip_data: torch.Tensor,      # [N, P] (missing entries arbitrary)
    tip_missing: torch.Tensor,   # bool [N, P]
    loadings: torch.Tensor,      # [K, P]
    trait_precision: torch.Tensor,  # [P] diagonal of Gamma
):
    """Canonical Gaussian potentials on the factor scale, one per tip.

    Returns (P [N, K, K], b [N, K], g [N])."""
    dt = tip_data.dtype
    obs = (~torch.as_tensor(tip_missing, device=tip_data.device)).to(dt)
    gam = trait_precision[None, :] * obs
    y = torch.where(obs > 0, tip_data, torch.zeros_like(tip_data))
    lg = torch.einsum("kp,np->nkp", loadings, gam)
    p_tip = _sym(torch.einsum("nkp,jp->nkj", lg, loadings))
    b_tip = torch.einsum("nkp,np->nk", lg, y)
    n_obs = obs.sum(1)
    log_gam = torch.where(obs > 0, torch.log(trait_precision)[None, :],
                          torch.zeros_like(obs))
    g_tip = -0.5 * (n_obs * _LOG_2PI - log_gam.sum(1)
                    + torch.einsum("np,np->n", y * gam, y))
    return p_tip, b_tip, g_tip


def integrated_factor_loglikelihood(
    tip_data: torch.Tensor,      # [N, P]
    tip_missing: torch.Tensor,   # bool [N, P]
    parent: torch.Tensor,
    children: torch.Tensor,
    heights: torch.Tensor,
    root,
    loadings: torch.Tensor,      # [K, P]
    trait_precision: torch.Tensor,  # [P]
    factor_precision: Optional[torch.Tensor] = None,  # [K, K]; I if None
    branch_rate_scalars=1.0,
    root_prior_mean: Optional[torch.Tensor] = None,   # [K]
    root_prior_sample_size: float = 1.0,
) -> torch.Tensor:
    """log p(observed tip data | tree, L, Gamma, Lambda), latent factors
    and internal node states integrated out; conjugate factor root prior
    N(mean0, (k0 Lambda)^-1) (ref: IntegratedFactorAnalysisLikelihood.java;
    standard BEAST usage fixes Lambda = I)."""
    k = loadings.shape[0]
    dt = tip_data.dtype
    if factor_precision is None:
        lam_inv = torch.eye(k, dtype=dt, device=tip_data.device)
    else:
        lam_inv = _inv(factor_precision.to(dt))
    p0, b0, g0 = factor_tip_potentials(tip_data, tip_missing, loadings,
                                       trait_precision)
    return canonical_bp_loglikelihood(
        p0, b0, g0, parent, children, heights, root, lam_inv,
        branch_rate_scalars=branch_rate_scalars,
        root_prior_mean=root_prior_mean,
        root_prior_sample_size=root_prior_sample_size,
    )


def _push_canonical_delta(p, b, g, o_mask, y, t, lam_inv, eye,
                          cov_extra=None):
    """Push a tip potential that ALSO carries exact (delta) observations
    on the masked dims through its branch: message(x_parent) =
    int delta(x_O - y_O) exp(-x'Px/2 + b'x + g) N(x; x_p, t Sigma) dx, in
    closed form. cov_extra adds independent observation noise to the
    branch (exact for y = x + e). Batched over leading axes."""
    k = b.shape[-1]
    o = o_mask.to(b.dtype)
    u = 1.0 - o
    t = torch.as_tensor(t, dtype=b.dtype, device=b.device)
    cov = t[..., None, None] * lam_inv
    if cov_extra is not None:
        cov = cov + cov_extra
    # J = C^-1 (a tiny ridge guards t = 0)
    j_mat = _inv(cov + 1e-30 * eye)
    a_mat = p + j_mat
    uu = u[..., :, None] * u[..., None, :]
    a_uu = a_mat * uu + torch.diag_embed(o)
    w = _inv(a_uu) * uu
    ld_auu = _logdet(a_uu)
    y_o = torch.where(o > 0, y, torch.zeros_like(y))
    c0 = (b - _mv(a_mat, y_o)) * u
    ju = j_mat * u[..., :, None]
    jut = ju.transpose(-1, -2)
    p_out = j_mat - jut @ (w @ ju)
    b_out = _mv(j_mat, y_o) + _mv(jut, _mv(w, c0))
    ld_c = _logdet(cov + 1e-30 * eye)
    g_out = (g - 0.5 * (k * _LOG_2PI + ld_c)
             - 0.5 * _dot(y_o, _mv(a_mat, y_o)) + _dot(b, y_o)
             + 0.5 * u.sum(-1) * _LOG_2PI
             - 0.5 * ld_auu + 0.5 * _dot(c0, _mv(w, c0)))
    return p_out, b_out, g_out


def canonical_bp_loglikelihood(
    p0: torch.Tensor,   # [N, K, K] tip potential precisions
    b0: torch.Tensor,   # [N, K]
    g0: torch.Tensor,   # [N]
    parent: torch.Tensor,
    children: torch.Tensor,
    heights: torch.Tensor,
    root,
    lam_inv: torch.Tensor,  # [K, K] per-unit-time diffusion covariance
    branch_rate_scalars=1.0,
    root_prior_mean: Optional[torch.Tensor] = None,
    root_prior_sample_size: float = 1.0,
    tip_delta_mask: Optional[torch.Tensor] = None,   # [N, K] exact dims
    tip_delta_values: Optional[torch.Tensor] = None,  # [N, K]
    tip_cov_extra: Optional[torch.Tensor] = None,    # [N, K, K] obs noise
) -> torch.Tensor:
    """Marginal log-likelihood of ARBITRARY canonical Gaussian tip
    potentials propagated up a Brownian tree (the engine behind the
    integrated factor model, repeated-measures replicates and
    jointPartialsProvider compositions; ref: ContinuousTraitPartials
    Provider implementations). Every child's message, the tips' included,
    is pushed through its branch at its own level."""
    n, k = b0.shape
    m = parent.shape[0]
    dt = b0.dtype
    dev = b0.device
    eye = torch.eye(k, dtype=dt, device=dev)
    lam_inv = lam_inv.to(dt)
    bl = _branch_times(parent, heights) * _per_branch(
        branch_rate_scalars, m, heights)
    delta = tip_delta_mask is not None or tip_cov_extra is not None
    if delta:
        dmask = (torch.zeros((n, k), dtype=dt, device=dev)
                 if tip_delta_mask is None else tip_delta_mask.to(dt))
        dvals = (torch.zeros((n, k), dtype=dt, device=dev)
                 if tip_delta_values is None else tip_delta_values.to(dt))
        zeros_k = torch.zeros(k, dtype=dt, device=dev)

        def push_tips(p, b, g):
            return _push_canonical_delta(
                p, b, g, dmask, dvals, bl[:n], lam_inv, eye,
                None if tip_cov_extra is None else tip_cov_extra.to(dt))

        def push(p, b, g, c):
            # internal nodes carry no delta observations and no extra noise
            return _push_canonical_delta(p, b, g, zeros_k.expand_as(b),
                                         zeros_k.expand_as(b), bl[c],
                                         lam_inv, eye)
    else:
        def push_tips(p, b, g):
            return _push_canonical(p, b, g, bl[:n], lam_inv, eye)

        def push(p, b, g, c):
            return _push_canonical(p, b, g, bl[c], lam_inv, eye)

    p_t, b_t, g_t = push_tips(p0.to(dt), b0, g0.to(dt))
    _, _, at_root = _upward(p_t, b_t, g_t, m,
                            tree_levels(parent, children, n), push)
    k0 = _t(root_prior_sample_size, b0)
    mean0 = (torch.zeros(k, dtype=dt, device=dev) if root_prior_mean is None
             else _t(root_prior_mean, b0))
    p_r, b_r, g_r = _push_canonical(*at_root, 1.0 / k0, lam_inv, eye)
    return g_r - 0.5 * (mean0 @ (p_r @ mean0)) + b_r @ mean0


def factor_marginal_mvn(
    tip_cov: torch.Tensor,       # [N, N] tree covariance (incl. root 1/k0)
    loadings: torch.Tensor,      # [K, P]
    trait_precision: torch.Tensor,  # [P]
    factor_covariance: Optional[torch.Tensor] = None,  # [K, K] Sigma
):
    """Dense marginal covariance of vec(tip data): the oracle identity
    Cov(y_i, y_j) = L^T Cov(f_i, f_j) L + delta_ij Gamma^-1 used by the
    tests; O(N^2 P^2), never on the sampling path."""
    k, p = loadings.shape
    sig = (torch.eye(k, dtype=loadings.dtype, device=loadings.device)
           if factor_covariance is None else factor_covariance)
    lsl = loadings.T @ sig @ loadings
    cov = torch.kron(tip_cov.to(loadings.dtype), lsl)
    noise = torch.kron(torch.eye(tip_cov.shape[0], dtype=loadings.dtype,
                                 device=loadings.device),
                       torch.diag(1.0 / trait_precision))
    return cov + noise


def factor_tip_potentials_cov(
    tip_data: torch.Tensor,      # [N, P]
    tip_missing: torch.Tensor,   # bool [N, P]
    loadings: torch.Tensor,      # [K, P]
    noise_cov: torch.Tensor,     # [P, P] full residual covariance
):
    """Factor-scale canonical tip potentials with a FULL residual
    covariance (integrated factors plus repeated-measures noise: V =
    Gamma^-1 + S_rm; ref: RepeatedMeasures wrapping IntegratedFactor
    AnalysisLikelihood). Missing dims are marginalised exactly by masked
    conditioning. All tips in one batched step."""
    dt = tip_data.dtype
    o = (~torch.as_tensor(tip_missing, device=tip_data.device)).to(dt)
    mask = o[:, :, None] * o[:, None, :]
    c_mat = noise_cov * mask + torch.diag_embed(1.0 - o)
    j_mat = _sym(_inv(c_mat) * mask)
    yv = torch.where(o > 0, tip_data, torch.zeros_like(tip_data))
    lo = loadings[None] * o[:, None, :]
    lot = lo.transpose(-1, -2)
    p_tip = lo @ j_mat @ lot
    jy = _mv(j_mat, yv)
    b_tip = _mv(lo, jy)
    ld = _logdet(j_mat + torch.diag_embed(1.0 - o))
    g_tip = -0.5 * (o.sum(1) * _LOG_2PI - ld + _dot(yv, jy))
    return p_tip, b_tip, g_tip


def canonical_bp_loglikelihood_np(
    p0, b0, g0, parent, children, heights, root, lam_inv,
    root_prior_mean=None, root_prior_sample_size=1.0,
    tip_delta_mask=None, tip_delta_values=None, dtype=None,
):
    """Host-side long-double mirror of canonical_bp_loglikelihood: the
    high-precision oracle of the report and assert path where the tip
    potentials are ill-conditioned (near-singular sampling precisions; the
    f64 propagation carries ~1e-9 of rounding there)."""
    import numpy as np

    ld = dtype or np.longdouble
    n, k = np.shape(b0)
    parent = np.asarray(parent)
    children = np.asarray(children)
    heights = np.asarray(heights, ld)
    m = parent.shape[0]
    P = np.zeros((m, k, k), ld)
    b = np.zeros((m, k), ld)
    g = np.zeros((m,), ld)
    P[:n] = np.asarray(p0, ld)
    b[:n] = np.asarray(b0, ld)
    g[:n] = np.asarray(g0, ld)
    dmask = np.zeros((m, k), ld)
    dvals = np.zeros((m, k), ld)
    if tip_delta_mask is not None:
        dmask[:n] = np.asarray(tip_delta_mask, ld)
        dvals[:n] = np.asarray(tip_delta_values, ld)
    lam_inv = np.asarray(lam_inv, ld)
    eye = np.eye(k, dtype=ld)

    def push(node, t):
        o = dmask[node]
        u = 1.0 - o
        cov = t * lam_inv
        j_mat = np.linalg.inv(cov.astype(float)).astype(ld)
        # refine the f64 inverse by one Newton step in long double
        j_mat = j_mat @ (2 * eye - cov @ j_mat)
        a_mat = P[node] + j_mat
        uu = np.outer(u, u)
        a_uu = a_mat * uu + np.diag(o)
        w = np.linalg.inv(a_uu.astype(float)).astype(ld)
        w = w @ (2 * eye - a_uu @ w)
        w = w * uu
        sign, ld_auu = np.linalg.slogdet(a_uu.astype(float))
        sign2, ld_c = np.linalg.slogdet(cov.astype(float))
        y_o = np.where(o > 0, dvals[node], 0.0)
        c0 = (b[node] - a_mat @ y_o) * u
        ju = j_mat * u[:, None]
        p_out = j_mat - ju.T @ (w @ ju)
        b_out = j_mat @ y_o + ju.T @ (w @ c0)
        g_out = (g[node] - 0.5 * (k * np.log(2 * np.pi) + ld_c)
                 - 0.5 * (y_o @ (a_mat @ y_o)) + b[node] @ y_o
                 + 0.5 * np.sum(u) * np.log(2 * np.pi)
                 - 0.5 * ld_auu + 0.5 * (c0 @ (w @ c0)))
        return p_out, b_out, g_out

    order = [i for i in np.argsort(heights[n:].astype(float)) + n]
    for node in order:
        for c in children[node]:
            t = heights[node] - heights[c]
            pc, bc, gc = push(int(c), t)
            P[node] += pc
            b[node] += bc
            g[node] += gc
    mean0 = (np.zeros(k, ld) if root_prior_mean is None
             else np.asarray(root_prior_mean, ld))
    k0 = ld(root_prior_sample_size)
    dmask[root] = 0.0
    p_r, b_r, g_r = push(int(root), 1.0 / k0)
    return float(g_r - 0.5 * (mean0 @ (p_r @ mean0)) + b_r @ mean0)

"""Continuous multivariate trait evolution on trees (Brownian diffusion,
drift, Ornstein-Uhlenbeck and general affine Gaussian branches).

Counterpart of beast_mcmc_tpu/models/continuous.py, every function of it,
with its names and signatures (ref: src/dr/evomodel/treedatalikelihood/
continuous/ContinuousDataLikelihoodDelegate.java:70 and the CDI
integrators, cdi/SafeMultivariateIntegrator.java): the likelihood of
D-dimensional tip traits, internal node states (and missing tip
dimensions) integrated out by Gaussian belief propagation up the tree, and
the posterior mean and covariance of every node state by a downward pass.

The JAX package walks the height-sorted internal nodes one a step in a
lax.scan. Here each walk goes by levels of depth (ops/peeling.py::
internal_levels, one host copy of the level sizes an evaluation): the
nodes of a level are independent, so each level is one batched step of
[L, D, D] solves, log-determinants and matrix products, and one scatter
into the node arrays; the downward pass goes from the root's level down,
the tips last, all at once. Every node's message is the JAX package's to
round-off; only the order in which the per-node log-normalisers are summed
differs. Each message is pushed through its branch once, at its own level
(`sent`), and read by its parent one level up.

The linear algebra reports failure on the device (solve_ex, inv_ex): a
singular system gives NaN, as JAX's does, and the proposal that led to it
is rejected; nothing is read on the host and nothing raises.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from beast_mcmc_tpu_torch.ops.peeling import internal_levels

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """x as a tensor of like's dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _nan_unless(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """x where a batched linalg `_ex` call succeeded (info 0 over x's
    leading axes), else NaN."""
    return x.masked_fill(
        (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim())),
        math.nan)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x, info = torch.linalg.solve_ex(a, b)
    return _nan_unless(x, info)


def _inv(a: torch.Tensor) -> torch.Tensor:
    x, info = torch.linalg.inv_ex(a)
    return _nan_unless(x, info)


def _logdet(a: torch.Tensor) -> torch.Tensor:
    """log |det a| (jnp.linalg.slogdet's second value)."""
    return torch.linalg.slogdet(a)[1]


def _sym(p: torch.Tensor) -> torch.Tensor:
    return 0.5 * (p + p.transpose(-1, -2))


def _mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product a [..., D, D] @ x [..., D]."""
    return (a @ x[..., None])[..., 0]


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(-1)


def _branch_times(parent, heights) -> torch.Tensor:
    """[M] parent height minus node height, 0 at the root."""
    pidx = torch.clamp_min(parent, 0)
    return torch.where(parent >= 0, heights[pidx] - heights,
                       torch.zeros_like(heights))


def _per_branch(x, m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(_t(x, like), (m,))


def tree_levels(parent, children, n_tips: int):
    """The internal nodes by depth, the root's level first, each with its
    children: [(nodes int64[L], kids int64[L, 2])] on the tree's device,
    from one host copy of the level sizes."""
    ch = torch.as_tensor(children, device=parent.device).long()
    return [(nodes, ch[nodes]) for nodes in internal_levels(parent, n_tips)]


def _index(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for a node index i (int or 0-d tensor) without a host copy."""
    return x[torch.as_tensor(i, device=x.device).long().reshape(1)][0]


def _set_rows(x: torch.Tensor, nodes: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    return x.index_put((nodes,), vals)


def _root_term(d, log_v, logdet_prec, quad_over_v):
    return -0.5 * (d * _LOG_2PI + d * log_v - logdet_prec + quad_over_v)


# ---------------------------------------------------------------------------
# Brownian diffusion with a shared precision and scalar branch variances
# ---------------------------------------------------------------------------


def _scalar_walk(mu, v, bl, levels, precision, logdet_prec, d,
                 transform=None):
    """The scalar-variance recursion of brownian, drift and OU, by levels:
    (mu [M, D], v [M], log-normaliser). transform(mu_c, v_c, nodes) maps a
    child's message to its parent's frame and gives its log-normaliser
    (OU), else the branch adds its variance bl."""
    logrem = torch.zeros((), dtype=mu.dtype, device=mu.device)
    for nodes, kids in reversed(levels):
        left, right = kids[:, 0], kids[:, 1]
        if transform is None:
            mul, mur = mu[left], mu[right]
            vl, vr = v[left] + bl[left], v[right] + bl[right]
            kl = kr = 0.0
        else:
            mul, vl, kl = transform(mu[left], v[left], left)
            mur, vr, kr = transform(mu[right], v[right], right)
        diff = mul - mur
        vs = vl + vr
        quad = _dot(diff @ precision, diff)
        logrem = logrem + torch.sum(
            kl + kr + _root_term(d, torch.log(vs), logdet_prec, quad / vs))
        mu = _set_rows(mu, nodes,
                       (vr[:, None] * mul + vl[:, None] * mur) / vs[:, None])
        v = _set_rows(v, nodes, vl * vr / vs)
    return mu, v, logrem


def _scalar_root(logrem, mu, v, root, extra_v, mean0, precision,
                 logdet_prec, d):
    v_root = _index(v, root) + extra_v
    diff = _index(mu, root) - mean0
    quad = diff @ precision @ diff
    return logrem + _root_term(d, torch.log(v_root), logdet_prec,
                               quad / v_root)


def _start(tip_traits, m, tip_var):
    n, d = tip_traits.shape
    mu = torch.cat([tip_traits, tip_traits.new_zeros((m - n, d))])
    v = torch.cat([torch.full((n,), float(tip_var), dtype=tip_traits.dtype,
                              device=tip_traits.device),
                   torch.full((m - n,), math.inf, dtype=tip_traits.dtype,
                              device=tip_traits.device)])
    return mu, v


def brownian_loglikelihood(
    tip_traits: torch.Tensor,  # [N, D]
    parent: torch.Tensor,
    children: torch.Tensor,
    heights: torch.Tensor,
    root,
    precision: torch.Tensor,  # [D, D] diffusion precision (Lambda)
    branch_rate_scalars=1.0,  # [M] or scalar; variance = t * scalar
    root_prior_mean: Optional[torch.Tensor] = None,  # [D]
    root_prior_sample_size: Optional[float] = None,  # kappa0 (pseudo-obs)
    tip_sampling_variance: float = 0.0,
) -> torch.Tensor:
    """Log-likelihood of tip traits, internal states integrated out.

    root_prior: conjugate N(mean, (kappa0 Lambda)^-1). If None, REML: the
    root state is not penalised (likelihood of contrasts only)."""
    n, d = tip_traits.shape
    m = parent.shape[0]
    bl = _branch_times(parent, heights) * _per_branch(
        branch_rate_scalars, m, heights)
    precision = precision.to(tip_traits.dtype)
    logdet_prec = _logdet(precision)
    mu, v = _start(tip_traits, m, tip_sampling_variance)
    mu, v, logrem = _scalar_walk(mu, v, bl, tree_levels(parent, children, n),
                                 precision, logdet_prec, d)
    if root_prior_sample_size is None:
        return logrem
    mean0 = (tip_traits.new_zeros(d) if root_prior_mean is None
             else _t(root_prior_mean, tip_traits))
    return _scalar_root(logrem, mu, v, root,
                        1.0 / _t(root_prior_sample_size, tip_traits), mean0,
                        precision, logdet_prec, d)


def brownian_tip_covariance(
    parent, children, heights, root, n_taxa: int,
    branch_rate_scalars=1.0, root_prior_sample_size: Optional[float] = None,
):
    """Host-side oracle: the [N, N] shared-path 'phylogenetic' covariance
    (per trait dimension, to be scaled by Lambda^-1): Sigma_ij = variance
    mass from root to MRCA(i, j) (+ 1/kappa0 under the conjugate root
    prior). Used by tests to compare against the dense MVN density."""
    parent = np.asarray(parent)
    heights = np.asarray(heights)
    m = parent.shape[0]
    scal = np.broadcast_to(np.asarray(branch_rate_scalars, np.float64), (m,))
    bl = np.where(parent >= 0, heights[np.maximum(parent, 0)] - heights,
                  0.0) * scal

    def path(i):
        out = []
        while parent[i] >= 0:
            out.append(i)
            i = parent[i]
        return out

    paths = [path(i) for i in range(n_taxa)]
    sigma = np.zeros((n_taxa, n_taxa))
    base = (0.0 if root_prior_sample_size is None
            else 1.0 / root_prior_sample_size)
    for i in range(n_taxa):
        for j in range(n_taxa):
            shared = set(paths[i]) & set(paths[j])
            sigma[i, j] = base + sum(bl[k] for k in shared)
    return sigma


# ---------------------------------------------------------------------------
# drift diffusion (ref: continuous/DriftDiffusionModelDelegate.java)
# ---------------------------------------------------------------------------


def drift_brownian_loglikelihood(
    tip_traits: torch.Tensor,  # [N, D]
    parent: torch.Tensor,
    children: torch.Tensor,
    heights: torch.Tensor,
    root,
    precision: torch.Tensor,  # [D, D]
    drift: torch.Tensor,  # [M, D] or [D] per-branch drift velocity
    branch_rate_scalars=1.0,
    root_prior_mean: Optional[torch.Tensor] = None,
    root_prior_sample_size: Optional[float] = None,
) -> torch.Tensor:
    """Brownian likelihood with x_child ~ N(x_parent + drift_b t_b,
    t_b s_b Lambda^-1): the upward message mean is shifted by the branch's
    accumulated drift, everything else is the Brownian recursion."""
    n, d = tip_traits.shape
    m = parent.shape[0]
    t_raw = _branch_times(parent, heights)
    shift = torch.broadcast_to(_t(drift, tip_traits), (m, d)) * t_raw[:, None]
    bl = t_raw * _per_branch(branch_rate_scalars, m, heights)
    precision = precision.to(tip_traits.dtype)
    logdet_prec = _logdet(precision)
    mu, v = _start(tip_traits, m, 0.0)

    def transform(mu_c, v_c, c):
        return mu_c - shift[c], v_c + bl[c], 0.0

    mu, v, logrem = _scalar_walk(mu, v, bl, tree_levels(parent, children, n),
                                 precision, logdet_prec, d, transform)
    if root_prior_sample_size is None:
        return logrem
    mean0 = (tip_traits.new_zeros(d) if root_prior_mean is None
             else _t(root_prior_mean, tip_traits))
    return _scalar_root(logrem, mu, v, root,
                        1.0 / _t(root_prior_sample_size, tip_traits), mean0,
                        precision, logdet_prec, d)


# ---------------------------------------------------------------------------
# Ornstein-Uhlenbeck diffusion (ref: continuous/OUDiffusionModelDelegate
# .java: mean reversion of strength alpha toward the optimum theta)
# ---------------------------------------------------------------------------


def ou_loglikelihood(
    tip_traits: torch.Tensor,  # [N, D]
    parent: torch.Tensor,
    children: torch.Tensor,
    heights: torch.Tensor,
    root,
    precision: torch.Tensor,  # [D, D] diffusion precision
    alpha,  # scalar mean-reversion strength
    theta: torch.Tensor,  # [D] optimum
    branch_rate_scalars=1.0,
    stationary_root: bool = True,
    root_prior_sample_size: Optional[float] = None,
) -> torch.Tensor:
    """OU trait likelihood by affine Gaussian belief propagation:

      x_c | x_p ~ N(theta + q (x_p - theta), gamma_t s Lambda^-1),
      q = e^{-alpha t}, gamma_t = (1 - e^{-2 alpha t}) / (2 alpha).

    Each branch maps the upward message (mu, v) to (theta + (mu - theta)/q,
    (v + gamma)/q^2) with log-normaliser d alpha t; node combination is the
    Brownian product rule. The root integrates against the stationary
    N(theta, Lambda^-1/(2 alpha)) (default) or a conjugate
    N(theta, (k0 Lambda)^-1)."""
    n, d = tip_traits.shape
    m = parent.shape[0]
    dt = tip_traits.dtype
    a = _t(alpha, tip_traits)
    th = _t(theta, tip_traits)
    t_eff = _branch_times(parent, heights) * _per_branch(
        branch_rate_scalars, m, heights)
    # the attenuation exponent is clamped: beyond it the branch is fully
    # decorrelated, and the unclamped q would underflow to 0 (1/q -> inf)
    cap = 80.0 if dt == torch.float64 else 30.0
    x = torch.clamp_max(a * t_eff, cap)
    q = torch.exp(-x)
    gamma = -torch.expm1(-2.0 * x) / (2.0 * a)
    precision = precision.to(dt)
    logdet_prec = _logdet(precision)
    mu, v = _start(tip_traits, m, 0.0)

    def transform(mu_c, v_c, c):
        qc = q[c]
        return (th + (mu_c - th) / qc[:, None], (v_c + gamma[c]) / (qc * qc),
                -d * torch.log(qc))

    mu, v, logrem = _scalar_walk(mu, v, None, tree_levels(parent, children, n),
                                 precision, logdet_prec, d, transform)
    if stationary_root:
        extra = 1.0 / (2.0 * a)
    elif root_prior_sample_size is not None:
        extra = 1.0 / _t(root_prior_sample_size, tip_traits)
    else:
        return logrem  # REML
    return _scalar_root(logrem, mu, v, root, extra, th, precision,
                        logdet_prec, d)


# ---------------------------------------------------------------------------
# full-precision belief propagation with per-dimension missing tip data
# (the dense generality of the CDI integrator, ref: cdi/
# ContinuousDiffusionIntegrator.java SafeMultivariateIntegrator)
# ---------------------------------------------------------------------------
#
# Messages are canonical Gaussians L(x) = exp(g) exp(-x'Px/2 + b'x), valid
# for singular P (dims with no data below are flat). The branch push uses
# the singularity-safe identities (V = Lambda^-1, A = I + t V P):
# P' = P A^-1, b' = A^-T b, g' = g - log|A|/2 + b'A^-1 tV b/2. Tip messages
# are emitted in the parent frame by conditioning the branch Gaussian on
# the observed dims (delta-function tips).


def _push_lu(a_mat, p, b):
    """(P A^-1 symmetrised, A^-T b, log|det A|, info) from one batched LU
    factorisation of A^T: the push's solve and its log-determinant share
    it."""
    k = p.shape[-1]
    lu, piv, info = torch.linalg.lu_factor_ex(a_mat.mT)
    x = torch.linalg.lu_solve(lu, piv, torch.cat([p.mT, b[..., None]], -1))
    logdet = torch.log(torch.abs(torch.diagonal(lu, dim1=-2, dim2=-1))).sum(-1)
    return _sym(x[..., :k].mT), x[..., k], logdet, info


def _push_canonical(p, b, g, t, lam_inv, eye):
    """Integrate the canonical message (p, b, g) through a Brownian branch
    of time t and covariance t lam_inv. Batched over leading axes of p
    [..., D, D], b [..., D], g [...] and t [...] (or a scalar); a singular
    system gives g NaN."""
    t = torch.as_tensor(t, dtype=p.dtype, device=p.device)
    a_mat = eye + t[..., None, None] * (lam_inv @ p)
    p_new, b_new, logdet, info = _push_lu(a_mat, p, b)
    g_new = g - 0.5 * logdet + 0.5 * t * _dot(b_new, _mv(lam_inv, b))
    return p_new, b_new, _nan_unless(g_new, info)


def _tip_messages(tip_traits, obs, cov, shift=None, q=None, with_g=True):
    """Every tip's message about its parent's state, one batched step:
    N(y_o; (Q x + r)_o, C_oo) as a canonical Gaussian in x (flat on the
    missing dims). cov [N, D, D]; shift r [N, D] and q Q [N, D, D] where
    the branch is affine (None: r = 0, Q = I)."""
    mask = obs[:, :, None] * obs[:, None, :]
    c_mat = cov * mask + torch.diag_embed(1.0 - obs)
    j_mat = _sym(_inv(c_mat) * mask)
    y = tip_traits if shift is None else tip_traits - shift
    y = torch.where(obs > 0, y, torch.zeros_like(y))
    jy = _mv(j_mat, y)
    if q is None:
        p, b = j_mat, jy
    else:
        qt = q.mT
        p = _sym(qt @ j_mat @ q)
        b = _mv(qt, jy)
    if not with_g:
        return p, b, torch.zeros_like(b[:, 0])
    g = -0.5 * (obs.sum(1) * _LOG_2PI + _logdet(c_mat) + _dot(y, jy))
    return p, b, g


def _pack(p, b, g):
    """One [..., D D + D + 1] row a message: each level gathers and
    scatters one array."""
    return torch.cat([p.flatten(-2), b, g[..., None]], -1)


def _unpack(x, d):
    return x[..., :d * d].unflatten(-1, (d, d)), x[..., d * d:-1], x[..., -1]


def _upward(p_tip, b_tip, g_tip, m, levels, push, all_nodes=False):
    """The upward canonical pass by levels from tip messages already in
    their parents' frame. push(p, b, g, nodes) pushes a level's combined
    messages through their branches. Returns (sent [M, K]: each node's
    message in its parent's frame, the tips' their own; node [M, K]: each
    node's combined message before its push, the tips' their own, where
    all_nodes, else None; the root's combined (p, b, g)), rows packed by
    `_pack`."""
    d = b_tip.shape[1]
    tips = _pack(p_tip, b_tip, g_tip)
    sent = torch.cat([tips, tips.new_zeros((m - tips.shape[0],
                                            tips.shape[1]))])
    node = sent if all_nodes else None
    for i, (nodes, kids) in enumerate(reversed(levels)):
        here = sent[kids].sum(1)
        if all_nodes:
            node = _set_rows(node, nodes, here)
        if i == len(levels) - 1:
            # the root alone: integrated against its prior by the caller
            return sent, node, _unpack(here[0], d)
        sent = _set_rows(sent, nodes, _pack(*push(*_unpack(here, d), nodes)))
    raise ValueError("a tree without internal nodes")


def brownian_loglikelihood_missing(
    tip_traits: torch.Tensor,  # [N, D] (missing entries arbitrary)
    tip_missing: torch.Tensor,  # bool[N, D], True where unobserved
    parent: torch.Tensor,
    children: torch.Tensor,
    heights: torch.Tensor,
    root,
    precision: torch.Tensor,  # [D, D]
    branch_rate_scalars=1.0,
    root_prior_mean: Optional[torch.Tensor] = None,
    root_prior_sample_size: float = 1.0,
) -> torch.Tensor:
    """Brownian tip-trait likelihood with per-dimension missing data,
    integrated over internal states AND the missing dims, with a conjugate
    root prior N(mean0, (k0 Lambda)^-1)."""
    n, d = tip_traits.shape
    m = parent.shape[0]
    dt = tip_traits.dtype
    bl = _branch_times(parent, heights) * _per_branch(
        branch_rate_scalars, m, heights)
    lam_inv = _inv(precision.to(dt))
    eye = torch.eye(d, dtype=dt, device=tip_traits.device)
    obs = (~torch.as_tensor(tip_missing, device=tip_traits.device)).to(dt)
    p0, b0, g0 = _tip_messages(tip_traits, obs,
                               bl[:n, None, None] * lam_inv)
    _, _, at_root = _upward(
        p0, b0, g0, m, tree_levels(parent, children, n),
        lambda p, b, g, c: _push_canonical(p, b, g, bl[c], lam_inv, eye))
    # the root integrates against N(mean0, (k0 Lambda)^-1): the same push
    # with t = 1/k0, evaluated at mean0
    k0 = _t(root_prior_sample_size, tip_traits)
    mean0 = (tip_traits.new_zeros(d) if root_prior_mean is None
             else _t(root_prior_mean, tip_traits))
    p_r, b_r, g_r = _push_canonical(*at_root, 1.0 / k0, lam_inv, eye)
    return g_r - 0.5 * (mean0 @ (p_r @ mean0)) + b_r @ mean0


# ---------------------------------------------------------------------------
# general affine-Gaussian tree propagation (ref: cdi/
# SafeMultivariateIntegrator.java, SafeMultivariateActualizedWithDrift
# Integrator.java): every branch is x_child = Q_b x_parent + r_b + eps_b,
# eps_b ~ N(0, Sigma_b) -- Brownian (Q = I, Sigma = t Lambda^-1), drift
# (r = v t) and full-matrix OU (Q = e^{-A t}, r = (I - Q) theta, Sigma the
# integrated stationary noise). Missing tip dimensions integrate out.
# branch_q None stands for Q = I and branch_r None for r = 0 (the
# Brownian channels of config/xml_traits.py), whose products are skipped.
# ---------------------------------------------------------------------------


def _push_canonical_cov(p, b, g, cov):
    """Integrate the canonical message (p, b, g) over x ~ N(m, cov):
    the canonical-in-m triple. Batched over leading axes; a singular
    system gives g NaN."""
    d = p.shape[-1]
    a_mat = torch.eye(d, dtype=p.dtype, device=p.device) + cov @ p
    p_new, b_new, logdet, info = _push_lu(a_mat, p, b)
    g_new = g - 0.5 * logdet + 0.5 * _dot(b_new, _mv(cov, b))
    return p_new, b_new, _nan_unless(g_new, info)


def _affine_push(q, r, sigma, with_g=True):
    """push(p, b, g, nodes): a level's messages through their affine
    branches: integrate x_c ~ N(m, Sigma_c), then substitute m = Q x_p +
    r."""
    def push(p, b, g, c):
        p1, b1, g1 = _push_canonical_cov(p, b, g, sigma[c])
        if r is not None:
            rc = r[c]
            p1r = _mv(p1, rc)
            if with_g:
                g1 = g1 + _dot(b1, rc) - 0.5 * _dot(rc, p1r)
            b1 = b1 - p1r
        if q is None:
            return p1, b1, g1
        qc = q[c]
        qt = qc.mT
        return _sym(qt @ p1 @ qc), _mv(qt, b1), g1

    return push


def affine_gaussian_tree_loglikelihood(
    tip_traits: torch.Tensor,   # [N, D] (missing entries arbitrary)
    tip_missing: torch.Tensor,  # bool [N, D]
    parent: torch.Tensor,
    children: torch.Tensor,
    heights: torch.Tensor,
    root,
    branch_q: Optional[torch.Tensor],      # [M, D, D]; None: identity
    branch_r: Optional[torch.Tensor],      # [M, D]; None: zero
    branch_sigma: torch.Tensor,  # [M, D, D] (root row ignored)
    root_mean: torch.Tensor,     # [D]
    root_cov: torch.Tensor,      # [D, D] prior covariance of the root state
) -> torch.Tensor:
    """Marginal log-likelihood of the tip traits, internal states and
    missing tip dimensions integrated out by canonical-form Gaussian
    belief propagation up the tree."""
    n, d = tip_traits.shape
    m = parent.shape[0]
    dt = tip_traits.dtype
    obs = (~torch.as_tensor(tip_missing, device=tip_traits.device)).to(dt)
    p0, b0, g0 = _tip_messages(
        tip_traits, obs, branch_sigma[:n],
        None if branch_r is None else branch_r[:n],
        None if branch_q is None else branch_q[:n])
    _, _, at_root = _upward(p0, b0, g0, m, tree_levels(parent, children, n),
                            _affine_push(branch_q, branch_r, branch_sigma))
    p_r, b_r, g_r = _push_canonical_cov(*at_root, root_cov.to(dt))
    mu0 = _t(root_mean, tip_traits)
    return g_r - 0.5 * (mu0 @ (p_r @ mu0)) + b_r @ mu0


def affine_gaussian_node_conditionals(
    tip_traits, tip_missing, parent, children, heights, root,
    branch_q, branch_r, branch_sigma, root_mean, root_cov,
):
    """Posterior mean and covariance of EVERY node state given the tips:
    the upward canonical pass, then a downward conditioning pass from the
    root's level down, the tips last (the tree-trait analog of
    AncestralStateBeagleTreeLikelihood, ref: continuous/TreeTraitProvider
    via fullConditionalDensity). Each node keeps its precision and
    information vector beside its mean and covariance, and its children
    read them as the parent's marginal. Returns (means [M, D], covs [M, D,
    D])."""
    n, d = tip_traits.shape
    m = parent.shape[0]
    dt = tip_traits.dtype
    dev = tip_traits.device
    obs = (~torch.as_tensor(tip_missing, device=dev)).to(dt)
    levels = tree_levels(parent, children, n)
    p0, b0, _ = _tip_messages(
        tip_traits, obs, branch_sigma[:n],
        None if branch_r is None else branch_r[:n],
        None if branch_q is None else branch_q[:n], with_g=False)
    zero = torch.zeros(n, dtype=dt, device=dev)
    sent, node, _ = _upward(
        p0, b0, zero, m, levels,
        _affine_push(branch_q, branch_r, branch_sigma, with_g=False),
        all_nodes=True)

    eye = torch.eye(d, dtype=dt, device=dev)
    root_cov = root_cov.to(dt)
    root_mean = _t(root_mean, tip_traits)
    prior_prec = _inv(root_cov)
    (root_nodes, _) = levels[0]
    p_up, b_up, _ = _unpack(node[root_nodes], d)
    p_root = p_up + prior_prec
    b_root = b_up + prior_prec @ root_mean
    cov_root = _inv(p_root)
    # a node's row: its mean, covariance, precision and information vector
    state = torch.zeros((m, 2 * d + 2 * d * d), dtype=dt, device=dev)
    state = _set_rows(state, root_nodes, torch.cat([
        _solve(p_root, b_root[..., None])[..., 0], cov_root.flatten(-2),
        p_root.flatten(-2), b_root], -1))

    big = 1e12
    tips = torch.arange(n, device=dev)
    for c, is_tip in ([(nodes, False) for nodes, _ in levels[1:]]
                      + [(tips, True)]):
        # the parent's marginal with c's own upward contribution removed
        # (else the evidence below c counts twice), pushed down the branch
        par_state = state[parent[c]]
        p_full = par_state[:, d + d * d:-d].unflatten(-1, (d, d))
        b_full = par_state[:, -d:]
        p_sent, b_sent, _ = _unpack(sent[c], d)
        p_ex = _sym(p_full - p_sent) + 1e-10 * eye
        v_ex = _inv(p_ex)
        mu_ex = _mv(v_ex, b_full - b_sent)
        s = branch_sigma[c]
        if branch_q is None:
            mu_d, v_d = mu_ex, v_ex + s
        else:
            q = branch_q[c]
            mu_d, v_d = _mv(q, mu_ex), q @ v_ex @ q.mT + s
        if branch_r is not None:
            mu_d = mu_d + branch_r[c]
        p_d = _inv(_sym(v_d))
        if is_tip:
            # tips condition exactly on their observed dims; the missing
            # dims follow the downward law
            y = torch.where(obs > 0, tip_traits, torch.zeros_like(tip_traits))
            p_below = torch.diag_embed(obs * big)
            b_below = obs * big * y
        else:
            p_below, b_below, _ = _unpack(node[c], d)
        p_node = _sym(p_d + p_below)
        b_node = _mv(p_d, mu_d) + b_below
        v_node = _inv(p_node)
        state = _set_rows(state, c, torch.cat([
            _mv(v_node, b_node), v_node.flatten(-2), p_node.flatten(-2),
            b_node], -1))
    return state[:, :d], state[:, d:d + d * d].unflatten(-1, (d, d))

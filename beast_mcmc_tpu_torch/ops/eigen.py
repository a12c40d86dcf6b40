"""Rate-matrix construction, spectral decomposition and P(t).

Counterpart of beast_mcmc_tpu/ops/eigen.py. A reversible Q is made
symmetric by D = diag(sqrt(pi)), so a real symmetric eigh suffices:
Q = (D^-1 V) W (V^T D). The eigh runs in float64 through
torch.linalg.eigh (the JAX package's f64 route), whatever the input dtype.

Where the JAX package maps these functions over K partitions with jax.vmap,
here the axis is written out: a leading K on the rates and frequencies gives
an EigenSystem with a leading K on every field, from one eigh call (each
call synchronises with the host on a CUDA device).

Gradients of P(t) with respect to the rates and frequencies do not go
through the eigensolver's backward, which divides by eigenvalue gaps: HKY
with purine and pyrimidine frequencies equal has a double eigenvalue at
every kappa, GTR at equal rates a triple one, and that backward gives NaN
or rounding noise there. P(t) = D^-1 exp(A t) D (A the symmetrised Q, D =
diag(sqrt pi)) instead takes the Daleckii-Krein form, exact at any
spectrum: `reversible_eigen` under autograd keeps (A, sqrt pi, its
eigensystem) on the EigenSystem and `transition_probs` differentiates
through `_SymmetricExpm`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class EigenSystem:
    """Q = U diag(values) U_inv; right eigenvectors in U's columns."""

    values: torch.Tensor  # [..., S]
    U: torch.Tensor  # [..., S, S]
    U_inv: torch.Tensor  # [..., S, S]
    # (A, sqrt pi, values, V) of a decomposition made under autograd, for
    # transition_probs' exact gradient; None otherwise
    sym: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                             compare=False)


# whether transition_probs differentiates through _SymmetricExpm (off
# inside ops/peeling.py::autograd_peel, for second derivatives)
_CUSTOM_EXPM_GRAD = True

# below this |x|, sinh(x) / x is 1 + x^2 / 6 to within float64 rounding
_SINHC_SERIES = 1e-4


class _SymmetricExpm(torch.autograd.Function):
    """P = D^-1 exp(A t) D for symmetric A = V diag(w) V^T and D =
    diag(d), batched as transition_probs is. w and v are the caller's
    eigh(A), taken as constants. The backward is the Daleckii-Krein
    formula, grad A = V ((V^T G' V) o Phi) V^T with G' = D G D^-1 and
    Phi_ij = (e^{w_i t} - e^{w_j t}) / (w_i - w_j), t e^{w_i t} where the
    two are equal (written through sinh(x) / x so that close pairs lose
    nothing); no division by an eigenvalue gap."""

    @staticmethod
    def forward(ctx, a, d, t, w, v):
        k_shape = w.shape[:-1]
        s = w.shape[-1]
        ones = (1,) * (t.dim() - len(k_shape))
        w = w.reshape(*k_shape, *ones, s)
        v = v.reshape(*k_shape, *ones, s, s)
        ctx.d_shape = d.shape  # shared by a chain batch's systems
        d = d.expand(*k_shape, s)
        ratio = d.reshape(*k_shape, *ones, 1, s) / d.reshape(
            *k_shape, *ones, s, 1)  # d_j / d_i
        em1 = torch.expm1(w * t[..., None])
        e = em1 + 1.0
        # V V^T = I and ratio_ii = 1: P = I + D^-1 V expm1(wt) V^T D
        # keeps a short branch's off-diagonals to their own precision
        p = (((v * em1[..., None, :]) @ v.transpose(-1, -2)) * ratio
             + torch.eye(s, dtype=v.dtype, device=v.device))
        ctx.save_for_backward(t, w, v, ratio, e, p, d)
        ctx.n_rest = len(ones)
        return p

    @staticmethod
    def backward(ctx, g):
        t, w, v, ratio, e, p, d = ctx.saved_tensors
        rest = tuple(range(-2 - ctx.n_rest, -2))  # t's axes after the batch
        vt = v.transpose(-1, -2)
        m = vt @ (g * ratio) @ v
        tt = t[..., None, None]
        wi, wj = w[..., :, None], w[..., None, :]
        x = 0.5 * (wi - wj) * tt
        close = x.abs() < _SINHC_SERIES
        gap = torch.where(close, 1.0, wi - wj)
        phi = torch.where(close,
                          tt * torch.exp(0.5 * (wi + wj) * tt) * (1 + x * x
                                                                  / 6.0),
                          (e[..., :, None] - e[..., None, :]) / gap)
        ga = v @ (m * phi) @ vt
        ga = torch.sum(ga, dim=rest) if rest else ga
        ga = 0.5 * (ga + ga.transpose(-1, -2))
        gt = torch.sum(torch.diagonal(m, dim1=-2, dim2=-1) * w * e, dim=-1)
        gp = g * p  # P = D^-1 F D: d P_ij / d d_k through the two D's
        gd = torch.sum(gp, dim=-2) - torch.sum(gp, dim=-1)
        gd = torch.sum(gd, dim=tuple(r + 1 for r in rest)) if rest else gd
        return ga, (gd / d).sum_to_size(ctx.d_shape), gt, None, None


def normalized_q(rates_symmetric: torch.Tensor,
                 freqs: torch.Tensor) -> torch.Tensor:
    """Q[i,j] = R[i,j] pi[j] off the diagonal, rows summing to 0, scaled so
    that the mean rate -sum_i pi_i Q[i,i] is 1. R's diagonal is ignored."""
    s = freqs.shape[-1]
    eye = torch.eye(s, dtype=rates_symmetric.dtype, device=freqs.device)
    q = rates_symmetric * freqs[..., None, :]
    q = q - eye * q
    q = q - eye * torch.sum(q, dim=-1, keepdim=True)
    mean_rate = -torch.sum(freqs * torch.diagonal(q, dim1=-2, dim2=-1), dim=-1)
    return q / mean_rate[..., None, None]


def reversible_eigen(rates_symmetric: torch.Tensor,
                     freqs: torch.Tensor) -> EigenSystem:
    """Spectral decomposition of a reversible Q by pi-symmetrisation, in
    float64, cast back to the inputs' dtype. A non-finite input (a
    proposal that left a frequency negative or zero) gives NaN eigenvalues,
    as JAX's eigh does, so that the posterior is NaN and the proposal is
    rejected: torch.linalg.eigh itself would raise on it."""
    out_dt = torch.promote_types(rates_symmetric.dtype, freqs.dtype)
    rates_symmetric = rates_symmetric.to(torch.float64)
    freqs = freqs.to(torch.float64)
    q = normalized_q(rates_symmetric, freqs)
    sqrt_pi = torch.sqrt(freqs)
    a = q * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    a = 0.5 * (a + a.transpose(-1, -2))  # exact symmetry
    bad = ~torch.isfinite(a).all(-1).all(-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    w, v = torch.linalg.eigh(torch.where(bad[..., None, None], eye, a))
    w = torch.where(bad[..., None], torch.full_like(w, math.nan), w)
    u = v / sqrt_pi[..., :, None]
    u_inv = v.transpose(-1, -2) * sqrt_pi[..., None, :]
    sym = None
    if torch.is_grad_enabled() and (a.requires_grad or sqrt_pi.requires_grad):
        sym = (a, sqrt_pi, w.detach(), v.detach())
    return EigenSystem(values=w.to(out_dt), U=u.to(out_dt),
                       U_inv=u_inv.to(out_dt), sym=sym)


def eigen_from_q_reversible(q: torch.Tensor,
                            freqs: torch.Tensor) -> EigenSystem:
    """Spectral decomposition of an already built reversible generator q
    [..., S, S] with stationary frequencies freqs [..., S] (a covarion
    product chain, models/substitution.py::covarion_q), by the same
    pi-symmetrisation as `reversible_eigen`: eigh in float64, cast back to
    the inputs' dtype. q is taken as it is, not normalised again."""
    out_dt = torch.promote_types(q.dtype, freqs.dtype)
    q = q.to(torch.float64)
    sqrt_pi = torch.sqrt(freqs.to(torch.float64))
    a = q * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    w, v = torch.linalg.eigh(0.5 * (a + a.transpose(-1, -2)))
    return EigenSystem(values=w.to(out_dt),
                       U=(v / sqrt_pi[..., :, None]).to(out_dt),
                       U_inv=(v.transpose(-1, -2)
                              * sqrt_pi[..., None, :]).to(out_dt))


def transition_probs(eig: EigenSystem, t: torch.Tensor) -> torch.Tensor:
    """P(t) = I + U expm1(values t) U_inv, batched over t's shape:
    [..., S, S].
    With a batched eigensystem (values [K, S]) t is [K, ...] and row k of t
    goes with system k. Negative round-off entries are clamped to 0. A
    decomposition made under autograd differentiates through
    _SymmetricExpm.

    That is U exp(values t) U_inv, since U U_inv = I; but the exp form
    makes a short branch's off-diagonals, O(t), as
    sums of O(1) terms, so they carry an absolute error of a rounding
    (relative eps / t). At the Makona tree (branch lengths down to 4e-8)
    that moved the node-height gradient by 3.5e-10 of its largest entry
    on the CPU and 5.7e-10 on an H100; this form agrees across the two to
    1.4e-15 (scripts/p_t_forms.py). JAX's ops/eigen.py keeps the exp
    form."""
    if eig.sym is not None and torch.is_grad_enabled() and _CUSTOM_EXPM_GRAD:
        p = _SymmetricExpm.apply(*eig.sym[:2], t.to(torch.float64),
                                 *eig.sym[2:])
        return torch.clamp_min(p.to(eig.values.dtype), 0.0)
    k_shape = eig.values.shape[:-1]
    s = eig.values.shape[-1]
    ones = (1,) * (t.dim() - len(k_shape))  # t's axes after the batch
    values = eig.values.reshape(*k_shape, *ones, s)
    em1 = torch.expm1(values * t[..., None])  # [..., S]
    p = ((eig.U.reshape(*k_shape, *ones, s, s) * em1[..., None, :])
         @ eig.U_inv.reshape(*k_shape, *ones, s, s))
    p = p + torch.eye(s, dtype=p.dtype, device=p.device)
    return torch.clamp_min(p, 0.0)

"""Fixed-iteration special functions and the gamma category quantiles.

Counterpart of beast_mcmc_tpu/ops/special.py.

  gammainc_fixed    regularized lower incomplete gamma P(a, x): the power
                    series below x = a + 1, Lentz's continued fraction
                    above, each a fixed count of elementwise steps
  gamma_quantile    the inverse of P(a, .): a Wilson-Hilferty (or
                    small-shape) start and 25 damped Newton steps in log x

The site model needs the K median quantiles q_i(alpha) at p_i =
(2i+1)/(2K) only: K smooth functions of log(alpha). A degree-80 Chebyshev
fit of log q_i over alpha in [1e-3, 1e3], made once per K on the host with
scipy, evaluates on the device as one cos() vector and one [K, 81] matvec.
"""

from __future__ import annotations

import numpy as np
import torch

_SERIES_ITERS = 120
_CF_ITERS = 120
_NEWTON_ITERS = 25


def gammainc_fixed(a, x) -> torch.Tensor:
    """P(a, x) elementwise (a, x broadcast), both branches evaluated with
    fixed iteration counts and the right one selected: about 1e-14
    relative for a in [1e-3, 1e3] at the x quantiles need."""
    x = torch.as_tensor(x)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    a, x = torch.broadcast_tensors(a, x)
    safe_x = torch.where(x > 0, x, torch.ones_like(x))
    log_prefix = a * torch.log(safe_x) - safe_x - torch.lgamma(a)

    term = total = 1.0 / a  # the series sum_n x^n / (a (a+1) ... (a+n))
    for n in range(1, _SERIES_ITERS):
        term = term * safe_x / (a + n)
        total = total + term
    p_series = torch.exp(log_prefix) * total

    tiny = 1e-30  # Lentz's continued fraction for Q(a, x)
    b0 = safe_x + 1.0 - a
    c = torch.full_like(safe_x, 1.0 / 1e-30)
    d = 1.0 / torch.where(torch.abs(b0) > tiny, b0, torch.full_like(b0, tiny))
    h = d
    for i in range(1, _CF_ITERS):
        an = -i * (i - a)
        b = safe_x + 2.0 * i + 1.0 - a
        d = b + an * d
        d = torch.where(torch.abs(d) > tiny, d, torch.full_like(d, tiny))
        c = b + an / c
        c = torch.where(torch.abs(c) > tiny, c, torch.full_like(c, tiny))
        d = 1.0 / d
        h = h * d * c
    p_cf = 1.0 - torch.exp(log_prefix) * h

    p = torch.where(safe_x < a + 1.0, p_series, p_cf)
    p = torch.where(x <= 0, torch.zeros_like(p), p)
    return torch.clamp(p, 0.0, 1.0)


def _log_gamma_pdf(a, log_x, x):
    return (a - 1.0) * log_x - x - torch.lgamma(a)


def gamma_quantile(p, shape, scale=1.0) -> torch.Tensor:
    """The inverse CDF of Gamma(shape, scale), elementwise over p: the
    Wilson-Hilferty start (shape >= 0.6) or the small-shape asymptote
    exp((log p + log a + lgamma(a)) / a), then damped Newton in u = log x,
    a step clipped to [-2, 2]."""
    p = torch.as_tensor(p)
    a = torch.as_tensor(shape, dtype=p.dtype, device=p.device)
    a, p = torch.broadcast_tensors(a, p)
    z = torch.special.ndtri(p)
    wh = a * (1.0 - 1.0 / (9.0 * a) + z / (3.0 * torch.sqrt(a))) ** 3
    u_wh = torch.log(torch.clamp_min(wh, 1e-30))
    u_small = (torch.log(p) + torch.log(a) + torch.lgamma(a)) / a
    u = torch.where((a >= 0.6) & (wh > 0), u_wh, u_small)
    for _ in range(_NEWTON_ITERS):
        x = torch.exp(u)
        f = gammainc_fixed(a, x) - p
        dfdu = torch.exp(_log_gamma_pdf(a, u, x) + u)  # dP/du = pdf(x) x
        step = torch.clamp(f / torch.clamp_min(dfdu, 1e-300), -2.0, 2.0)
        u_new = u - step
        u = torch.where(torch.isfinite(u_new), u_new, u)
    return torch.exp(u) * scale

_CHEB_LO, _CHEB_HI = -3.0 * 2.302585092994046, 3.0 * 2.302585092994046
_CHEB_DEG = 80
_cheb_cache: dict = {}


def _fit_category_quantile_coeffs(k: int) -> np.ndarray:
    from scipy.special import gammaincinv, gammaln

    deg = _CHEB_DEG
    ps = (2.0 * np.arange(k) + 1.0) / (2.0 * k)
    xc = np.cos(np.pi * (np.arange(deg + 1) + 0.5) / (deg + 1))
    la = 0.5 * (xc + 1.0) * (_CHEB_HI - _CHEB_LO) + _CHEB_LO
    a = np.exp(la)

    def lq(aa, p):
        q = gammaincinv(aa, p)
        # where the quantile underflows, its small-q asymptote in log space
        asym = (np.log(p) + gammaln(aa + 1.0)) / aa
        return np.where(q < 1e-250, asym, np.log(np.maximum(q, 1e-300)))

    return np.stack([
        np.polynomial.chebyshev.chebfit(xc, lq(a, p), deg) for p in ps
    ])  # [K, deg+1]


def log_gamma_category_quantiles(alpha: torch.Tensor,
                                 n_categories: int) -> torch.Tensor:
    """log q_i(alpha), scale 1, [K]; alpha [B] (a chain batch) gives [B, K],
    each row as that chain's alone would be at any batch size.
    alpha is clamped to the fitted range [1e-3, 1e3]."""
    dt, dev = alpha.dtype, alpha.device
    # cached per device: a host-to-device copy on every call would stall
    # the chain
    key = (n_categories, dt, str(dev))
    if key not in _cheb_cache:
        _cheb_cache[key] = torch.as_tensor(
            _fit_category_quantile_coeffs(n_categories), dtype=dt, device=dev)
    coeffs = _cheb_cache[key]
    la = torch.log(torch.clamp(alpha, float(np.exp(_CHEB_LO)),
                               float(np.exp(_CHEB_HI))))
    x = torch.clamp(2.0 * (la - _CHEB_LO) / (_CHEB_HI - _CHEB_LO) - 1.0,
                    -1.0, 1.0)
    theta = torch.arccos(x)
    basis = torch.cos(torch.arange(_CHEB_DEG + 1, dtype=dt, device=dev)
                      * theta[..., None])
    if theta.dim() == 0:
        return coeffs @ basis
    # a product and a sum of the last axis: each chain's row is computed
    # alone, so a chain's rates do not depend on the batch around it (a
    # matrix product's blocking does)
    return torch.sum(basis[..., None, :] * coeffs, dim=-1)

"""Gamma category quantiles for the discrete-gamma site model.

Counterpart of beast_mcmc_tpu/ops/special.py:135-184. The site model needs
the K median quantiles q_i(alpha) at p_i = (2i+1)/(2K) only: K smooth
functions of log(alpha). A degree-80 Chebyshev fit of log q_i over alpha in
[1e-3, 1e3], made once per K on the host with scipy, evaluates on the
device as one cos() vector and one [K, 81] matvec.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """log q_i(alpha), scale 1, [K]; alpha [B] (a chain batch) gives [B, K].
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
    return coeffs @ basis if theta.dim() == 0 else basis @ coeffs.T

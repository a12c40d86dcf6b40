"""Generalized linear model likelihoods.

Counterpart of beast_mcmc_tpu/models/regression.py
(GeneralizedLinearModel.java:49, LinearRegression.java:53-66,
LogisticRegression.java:64-77, LogLinearModel.java, and the
self-controlled case series of the BSCCS library that
RegressionJNIWrapper.java:40-110 wraps). Each likelihood is one
matrix-vector product and an elementwise reduction, differentiable in
beta by autograd (getLogLikelihoodGradient). Random effects enter as an
additive offset.
"""

from __future__ import annotations

import torch

LOG_2PI = 1.8378770664093453

def xbeta(design: torch.Tensor, beta: torch.Tensor,
          offset=0.0) -> torch.Tensor:
    """The linear predictor X beta + offset; design [N, P]."""
    return design @ beta + offset

def linear_regression_loglik(y, design, beta, precision, offset=0.0,
                             log_transform: bool = False) -> torch.Tensor:
    """Gaussian linear regression (LinearRegression.java:53-66): precision
    a scalar or [N]; with log_transform the response enters as log(y)
    with the Jacobian -sum log y."""
    y = torch.as_tensor(y, dtype=design.dtype, device=design.device)
    prec = torch.as_tensor(precision, dtype=y.dtype,
                           device=y.device).expand(y.shape)
    jac = 0.0
    if log_transform:
        jac = -torch.sum(torch.log(y))
        y = torch.log(y)
    r = y - xbeta(design, beta, offset)
    return (jac + 0.5 * torch.sum(torch.log(prec))
            - 0.5 * torch.sum(r * r * prec) - 0.5 * y.shape[-1] * LOG_2PI)

def logistic_regression_loglik(y, design, beta, offset=0.0) -> torch.Tensor:
    """Bernoulli regression with the logit link (LogisticRegression.java
    :64-77): sum y eta - log(1 + e^eta)."""
    eta = xbeta(design, beta, offset)
    return torch.sum(y * eta - torch.nn.functional.softplus(eta))

def log_linear_loglik(y, design, beta, offset=0.0) -> torch.Tensor:
    """Poisson regression with the log link (LogLinearModel.java)."""
    eta = xbeta(design, beta, offset)
    y = torch.as_tensor(y, dtype=eta.dtype, device=eta.device)
    return torch.sum(y * eta - torch.exp(eta) - torch.lgamma(y + 1.0))

def sccs_conditional_loglik(counts, design, beta,
                            log_exposure) -> torch.Tensor:
    """The self-controlled case series conditional Poisson likelihood:
    sum_ij y_ij eta_ij - sum_i n_i logsumexp_j(eta_ij), eta_ij = log
    tau_ij + x_ij beta. counts [I, J] (J padded, the pads' log_exposure
    -inf), design [I, J, P]."""
    eta = torch.einsum("ijp,p->ij", design, beta) + log_exposure
    counts = torch.as_tensor(counts, dtype=eta.dtype, device=eta.device)
    n_i = torch.sum(counts, dim=1)
    lse = torch.logsumexp(eta, dim=1)
    finite = torch.where(torch.isfinite(eta), eta, torch.zeros_like(eta))
    return torch.sum(counts * finite) - torch.sum(n_i * lse)

def glm_loglik(kind: str, y, design, beta, scale=None, offset=0.0,
               log_transform: bool = False) -> torch.Tensor:
    """The GLM family of the glmModel `family` attribute."""
    if kind in ("normal", "linear", "gaussian"):
        return linear_regression_loglik(y, design, beta, precision=scale,
                                        offset=offset,
                                        log_transform=log_transform)
    if kind in ("logistic", "bernoulli", "binomial"):
        return logistic_regression_loglik(y, design, beta, offset)
    if kind in ("poisson", "logLinear"):
        return log_linear_loglik(y, design, beta, offset)
    raise ValueError(f"unknown GLM family '{kind}'")

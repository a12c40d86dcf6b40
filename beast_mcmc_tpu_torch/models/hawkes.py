"""The spatiotemporal Hawkes (self-exciting point process) likelihood.

Counterpart of beast_mcmc_tpu/models/hawkes.py (HawkesLikelihood.java
:47-120 with the native hph_jni core, NativeHPHSingleton.java:107;
Holbrook et al. 2022). For events (x_i, t_i) in D dimensions:

  lambda(x, t) = mu0 / N sum_j phi(x - x_j; tauX^-1) psi(t - t_j; tauT^-1)
               + theta sum_{t_j < t} omega e^{-omega (t - t_j)}
                 phi(x - x_j; sigmaX^-1),
  log L = sum_i log lambda(x_i, t_i) - Lambda(T),
  Lambda(T) = mu0 (t_max - t_min) + theta sum_j (1 - e^{-omega (T - t_j)}),

phi and psi Gaussian kernels. The kernel sums are dense [N, N] on the
device (10,000 events: 0.8 GB a matrix in float64); the gradients come
from autograd.
"""

from __future__ import annotations

import math

import torch


def _gauss_kernel(sq_dist, prec, d):
    return (prec / (2 * math.pi)) ** (d / 2.0) * torch.exp(-0.5 * prec
                                                           * sq_dist)


def _kernels(locations, times, tau_x_prec, tau_t_prec, sigma_x_prec, omega,
             theta, mu0):
    """(background, excitation) [N] of every event."""
    n, d = locations.shape
    dt, dev = locations.dtype, locations.device
    c = lambda v: torch.as_tensor(v, dtype=dt, device=dev)  # noqa: E731
    diff = locations[:, None, :] - locations[None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    dt_mat = times[:, None] - times[None, :]
    not_self = ~torch.eye(n, dtype=torch.bool, device=dev)
    bg = (_gauss_kernel(sq, c(tau_x_prec), d)
          * _gauss_kernel(dt_mat * dt_mat, c(tau_t_prec), 1))
    background = c(mu0) / n * torch.sum(
        torch.where(not_self, bg, torch.zeros_like(bg)), dim=1)
    om = c(omega)
    trig = (c(theta) * om * torch.exp(-om * dt_mat)
            * _gauss_kernel(sq, c(sigma_x_prec), d))
    excitation = torch.sum(torch.where(dt_mat > 0, trig,
                                       torch.zeros_like(trig)), dim=1)
    return background, excitation


def hawkes_loglikelihood(locations: torch.Tensor, times: torch.Tensor,
                         sigma_x_prec, tau_x_prec, tau_t_prec, omega, theta,
                         mu0) -> torch.Tensor:
    """log L of events at locations [N, D] and ascending times [N]:
    sigma_x_prec the triggering kernel's spatial precision, tau_x_prec and
    tau_t_prec the background KDE's, omega the triggering decay, theta its
    weight, mu0 the background intensity."""
    dt, dev = locations.dtype, locations.device
    background, excitation = _kernels(locations, times, tau_x_prec,
                                      tau_t_prec, sigma_x_prec, omega,
                                      theta, mu0)
    log_rates = torch.sum(torch.log(torch.clamp_min(background + excitation,
                                                    1e-300)))
    om = torch.as_tensor(omega, dtype=dt, device=dev)
    compensator = (torch.as_tensor(mu0, dtype=dt, device=dev)
                   * (times[-1] - times[0])
                   + torch.as_tensor(theta, dtype=dt, device=dev)
                   * torch.sum(-torch.expm1(-om * (times[-1] - times))))
    return log_rates - compensator


def hawkes_event_rates(locations, times, sigma_x_prec, tau_x_prec,
                       tau_t_prec, omega, theta, mu0):
    """Each event's intensity as (background, excitation) [N], the rate
    provider's diagnostic surface."""
    return _kernels(locations, times, tau_x_prec, tau_t_prec, sigma_x_prec,
                    omega, theta, mu0)

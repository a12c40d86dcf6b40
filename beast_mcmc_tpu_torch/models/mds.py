"""Bayesian multidimensional scaling (antigenic cartography).

Counterpart of beast_mcmc_tpu/models/mds.py
(MultiDimensionalScalingLikelihood.java:46 with the native mds_jni core,
NativeMDSSingleton.java:107; AntigenicLikelihood.java:520-660,
NewAntigenicLikelihood.java:53). Observed pairwise distances are
(optionally zero-truncated) normals about the latent locations'
distances with one precision. The distance matrix is one dense [N, N]
broadcast on the device; missing observations are a mask; the location
gradient for HMC comes from autograd (the native gradient's role).
"""

from __future__ import annotations

import math

import torch

MEASUREMENT_POINT = 0
MEASUREMENT_LOWER_THRESHOLD = 1
MEASUREMENT_UPPER_THRESHOLD = 2
MEASUREMENT_INTERVAL = 3


def pairwise_distances(locations: torch.Tensor,
                       eps: float = 1e-12) -> torch.Tensor:
    """[N, N] Euclidean distances of the locations [N, D], sqrt-safe on
    the diagonal for gradients."""
    diff = locations[:, None, :] - locations[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)


def mds_loglikelihood(observed: torch.Tensor, mask: torch.Tensor,
                      locations: torch.Tensor, precision,
                      truncated: bool = True) -> torch.Tensor:
    """The sum over observed pairs of log N(delta; d, 1 / prec), less the
    zero truncation's log Phi(d sqrt(prec)) where truncated
    (ObservationType.POINT with mdsTruncation)."""
    prec = torch.as_tensor(precision, dtype=locations.dtype,
                           device=locations.device)
    d = pairwise_distances(locations)
    resid = observed - d
    ll = (0.5 * (torch.log(prec) - math.log(2 * math.pi))
          - 0.5 * prec * resid * resid)
    if truncated:
        ll = ll - torch.special.log_ndtr(d * torch.sqrt(prec))
    return torch.sum(torch.where(mask, ll, torch.zeros_like(ll)))


def mds_location_gradient(observed, mask, locations, precision,
                          truncated: bool = True) -> torch.Tensor:
    """The gradient in the locations (the native getLocationGradient), by
    autograd."""
    with torch.enable_grad():
        x = locations.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            mds_loglikelihood(observed, mask, x, precision, truncated), x)
    return g


def antigenic_distance(virus_locations: torch.Tensor,
                       serum_locations: torch.Tensor,
                       virus_idx: torch.Tensor, serum_idx: torch.Tensor,
                       location_drift=None, virus_offsets=None,
                       serum_offsets=None) -> torch.Tensor:
    """Each measurement's antigenic distance [M], the first map dimension
    shifted by offset x drift (AntigenicLikelihood.java:578-600)."""
    v = virus_locations[virus_idx.long()]
    s = serum_locations[serum_idx.long()]
    if location_drift is not None:
        shift = torch.zeros_like(v)
        shift[:, 0] = location_drift * virus_offsets[virus_idx.long()]
        v = v + shift
        shift = torch.zeros_like(s)
        shift[:, 0] = location_drift * serum_offsets[serum_idx.long()]
        s = s + shift
    d = v - s
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)


def antigenic_loglikelihood(log2_titres: torch.Tensor,
                            measurement_types: torch.Tensor,
                            virus_idx: torch.Tensor, serum_idx: torch.Tensor,
                            virus_locations: torch.Tensor,
                            serum_locations: torch.Tensor,
                            serum_potencies: torch.Tensor, mds_precision,
                            virus_avidities=None, location_drift=None,
                            virus_offsets=None, serum_offsets=None,
                            interval_width: float = 1.0) -> torch.Tensor:
    """The HI-assay likelihood (AntigenicLikelihood.java:520-545): the
    expectation is the serum's potency (plus the virus's avidity) less
    the distance; a point measurement's normal density, a threshold's
    lower or upper tail, an interval's cdf difference, by type."""
    dt = virus_locations.dtype
    sd = 1.0 / torch.sqrt(torch.as_tensor(mds_precision, dtype=dt,
                                          device=virus_locations.device))
    dist = antigenic_distance(virus_locations, serum_locations, virus_idx,
                              serum_idx, location_drift, virus_offsets,
                              serum_offsets)
    expect = serum_potencies[serum_idx.long()] - dist
    if virus_avidities is not None:
        expect = expect + virus_avidities[virus_idx.long()]
    y = log2_titres
    z = (y - expect) / sd
    point = -0.5 * z * z - torch.log(sd) - 0.5 * math.log(2 * math.pi)
    lower = torch.special.log_ndtr(z)
    upper = torch.special.log_ndtr(-z)
    hi = torch.special.ndtr((y + interval_width - expect) / sd)
    interval = torch.log(torch.clamp_min(hi - torch.special.ndtr(z), 1e-300))
    t = measurement_types
    ll = torch.where(t == MEASUREMENT_POINT, point,
                     torch.where(t == MEASUREMENT_LOWER_THRESHOLD, lower,
                                 torch.where(t == MEASUREMENT_UPPER_THRESHOLD,
                                             upper, interval)))
    return torch.sum(ll)


def antigenic_drift_prior(locations: torch.Tensor, offsets: torch.Tensor,
                          drift_rate, precision) -> torch.Tensor:
    """The diffusion prior tying the locations to a mean drifting along
    dimension 0: x_i ~ N(drift offset_i e_1, I / prec) (Bedford et al.
    2014)."""
    prec = torch.as_tensor(precision, dtype=locations.dtype,
                           device=locations.device)
    mean = torch.zeros_like(locations)
    mean[:, 0] = drift_rate * offsets
    d = locations - mean
    return (0.5 * locations.numel() * (torch.log(prec) - math.log(2 * math.pi))
            - 0.5 * prec * torch.sum(d * d))

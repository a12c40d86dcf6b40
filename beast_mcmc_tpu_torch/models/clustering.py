"""Bayesian nonparametric clustering: the CRP, the distance-dependent CRP
and the hierarchical DP priors, with their Gibbs moves.

Counterpart of beast_mcmc_tpu/models/clustering.py
(NPAntigenicLikelihood.java, DirichletProcessGibbsOperator.java,
ClusterSingleMoveOperator.java, DistanceDependentCRPGibbsOperator.java,
HDPPolyaUrn.java, AntigenicDriftPrior.java). A partition is a
fixed-capacity assignment vector (at most K clusters), every cluster sum
a masked reduction, and the DP Gibbs sweep a sequence of categorical
draws over the K seats. Each draw inverts the CDF of one uniform where
the JAX package draws from its key: the law is the same, the stream is
not; given the uniforms, a sweep is deterministic.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference.tree_operators import categorical_pick


def cluster_sizes(assignments: torch.Tensor, max_k: int) -> torch.Tensor:
    """int64[K]: the occupancy of each label in [0, K)."""
    a = assignments.long()
    return torch.zeros(max_k + 1, dtype=torch.long, device=a.device) \
        .scatter_add_(0, torch.where((a >= 0) & (a < max_k), a, max_k),
                      torch.ones_like(a))[:max_k]


def crp_log_prior(assignments: torch.Tensor, concentration,
                  max_k: int) -> torch.Tensor:
    """The Chinese restaurant process partition probability:
    K log(alpha) + sum_k lgamma(n_k) - sum_{i<n} log(alpha + i), over
    the occupied labels (NPAntigenicLikelihood's CRP term)."""
    n = assignments.shape[0]
    alpha = torch.as_tensor(concentration, dtype=torch.float64,
                            device=assignments.device)
    sizes = cluster_sizes(assignments, max_k).to(alpha.dtype)
    occupied = sizes > 0
    num = torch.sum(occupied) * torch.log(alpha) + torch.sum(torch.where(
        occupied, torch.lgamma(torch.clamp_min(sizes, 1.0)),
        torch.zeros_like(sizes)))
    i = torch.arange(n, dtype=alpha.dtype, device=alpha.device)
    return num - torch.sum(torch.log(alpha + i))


def ddcrp_log_prior(links: torch.Tensor, distances: torch.Tensor,
                    concentration, decay) -> torch.Tensor:
    """The distance-dependent CRP's log prior of a link configuration
    (DistanceDependentCRPGibbsOperator.java): customer i links to j != i
    with weight exp(-d_ij / decay), to itself with alpha."""
    n = links.shape[0]
    dt, dev = distances.dtype, distances.device
    alpha = torch.as_tensor(concentration, dtype=dt, device=dev)
    f = torch.exp(-distances / torch.as_tensor(decay, dtype=dt, device=dev))
    f = f * (1.0 - torch.eye(n, dtype=dt, device=dev))
    denom = alpha + torch.sum(f, dim=1)
    ar = torch.arange(n, device=dev)
    w = torch.where(links == ar, alpha, f[ar, links.long()])
    return torch.sum(torch.log(w) - torch.log(denom))


def hdp_log_prior(counts: torch.Tensor, base_weights: torch.Tensor,
                  group_concentration, base_concentration) -> torch.Tensor:
    """The collapsed hierarchical-DP marginal of group x category counts
    given the truncated base measure beta (HDPPolyaUrn.java's role): a
    Dirichlet-multinomial per group with base alpha beta, plus the finite
    Dirichlet(gamma / K) approximation of GEM(gamma) for beta."""
    beta = base_weights
    a = torch.as_tensor(group_concentration, dtype=beta.dtype,
                        device=beta.device)
    g = torch.as_tensor(base_concentration, dtype=beta.dtype,
                        device=beta.device)
    k = beta.shape[0]
    counts = counts.to(beta.dtype)
    n_g = torch.sum(counts, dim=1)
    base = a * beta
    per_group = (torch.lgamma(a) - torch.lgamma(a + n_g)
                 + torch.sum(torch.lgamma(base[None, :] + counts)
                             - torch.lgamma(base), dim=1))
    conc = g / k
    lp_beta = (torch.lgamma(g) - k * torch.lgamma(conc)
               + torch.sum((conc - 1.0) * torch.log(beta)))
    return torch.sum(per_group) + lp_beta


def dp_gibbs_sweep(generator: torch.Generator, assignments: torch.Tensor,
                   item_loglik_fn, concentration, max_k: int,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sequential Gibbs sweep of a collapsed DP mixture
    (DirichletProcessGibbsOperator.java): item i is reseated at an
    occupied label with weight n_{-i,k} L(i | k), or at the first empty
    label (a new cluster) with weight alpha L(i | new).
    item_loglik_fn(i, k, assignments) is the collapsed predictive of item
    i in label k given the others (i's own entry -1); it is vmapped over
    the K labels, as the JAX package's is. uniforms [n], one a reseating,
    come from the generator unless given."""
    n = assignments.shape[0]
    dev = assignments.device
    if uniforms is None:
        uniforms = torch.rand(n, generator=generator, dtype=torch.float64,
                              device=dev)
    labels = torch.arange(max_k, device=dev)
    for i in range(n):
        a_wo = assignments.clone()
        a_wo[i] = -1
        sizes = cluster_sizes(a_wo, max_k)
        first_empty = torch.argmax((sizes == 0).long())
        ll = torch.func.vmap(lambda k: item_loglik_fn(i, k, a_wo))(labels)
        logw = torch.where(sizes > 0, torch.log(sizes.to(ll.dtype)) + ll,
                           torch.full_like(ll, -math.inf))
        alpha = torch.as_tensor(concentration, dtype=ll.dtype, device=dev)
        logw = torch.where(labels == first_empty, torch.log(alpha) + ll, logw)
        choice = categorical_pick(uniforms[i], logw)
        assignments = assignments.index_put(
            (torch.tensor([i], device=dev),), choice.to(assignments.dtype))
    return assignments


def antigenic_drift_prior(locations: torch.Tensor, dates: torch.Tensor,
                          drift, precision) -> torch.Tensor:
    """Antigenic locations drift along the first map dimension with time
    (AntigenicDriftPrior.java): dimension 0 of each location ~ N(drift
    date, 1 / precision), the others ~ N(0, 1 / precision)."""
    tau = torch.as_tensor(precision, dtype=locations.dtype,
                          device=locations.device)
    d0 = locations[:, 0] - drift * dates
    rest = locations[:, 1:]
    lp = 0.5 * torch.log(tau / (2 * math.pi)) * locations.numel()
    return lp - 0.5 * tau * (torch.sum(d0 * d0) + torch.sum(rest * rest))


def cluster_single_move(generator: torch.Generator,
                        assignments: torch.Tensor, max_k: int):
    """One uniform item to a uniform label (ClusterSingleMoveOperator
    .java): (assignments', log Hastings 0), symmetric."""
    dev = assignments.device
    i = ops._randint(generator, 0, assignments.shape[0], dev)
    label = ops._randint(generator, 0, max_k, dev).to(assignments.dtype)
    return (assignments.index_put((i,), label),
            torch.zeros((), dtype=torch.float64, device=dev))

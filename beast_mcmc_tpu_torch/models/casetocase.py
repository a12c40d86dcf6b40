"""Case-to-case transmission-tree inference (the casetocase subsystem).

Counterpart of beast_mcmc_tpu/models/casetocase.py
(CaseToCaseTransmissionLikelihood.java:475-560; CaseToCaseTreeLikelihood
.java:576-615). The transmission tree is a per-node painting with cases
over the flat arrays (the reference's branchMap); validity, infection
times, infectors and every density term are masks and scatter reductions,
and the painting moves under MCMC by a node repaint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference.operators import NEG_INF, Operator, _zero
from beast_mcmc_tpu_torch.models.priors import gamma_logpdf


def painting_is_valid(children: torch.Tensor, painting: torch.Tensor,
                      n_taxa: int) -> torch.Tensor:
    """A painting (node -> case, each tip its own case) is a transmission
    tree iff every internal node carries the case of one of its children
    (the branchMap consistency of CaseToCaseTreeLikelihood)."""
    m = painting.shape[0]
    internal = torch.arange(m, device=painting.device) >= n_taxa
    kids = children.clamp_min(0).long()
    ok = ((painting == painting[kids[:, 0]])
          | (painting == painting[kids[:, 1]]))
    return torch.all(ok | ~internal)


def infection_events(parent: torch.Tensor, painting: torch.Tensor,
                     heights: torch.Tensor, root, n_cases: int,
                     branch_fractions: torch.Tensor):
    """(infection time, infector, subtree root) of each case [n_cases].
    A case's subtree root is its highest node, and the infection happens
    on the branch above it at branch_fractions of the way to the parent
    (CaseToCaseTreeLikelihood.getInfectionTime:604-608, the reference's
    uniform draw an explicit (0, 1) parameter); the index case is
    infected above the root, its infector -1."""
    m = parent.shape[0]
    dev = parent.device
    ar = torch.arange(m, device=dev)
    root = torch.as_tensor(root, device=dev).long()
    painting = painting.long()
    is_case_root = (painting != painting[parent.clamp_min(0)]) | (ar == root)
    case_root = torch.full((n_cases,), -1, dtype=torch.long, device=dev)
    case_root = case_root.scatter_reduce(
        0, painting, torch.where(is_case_root, ar, torch.full_like(ar, -1)),
        "amax")
    node_h = heights[case_root]
    h_root = heights[root]
    par_h = torch.where(case_root == root,
                        h_root + (h_root - torch.min(heights)) * 0.5 + 1e-6,
                        heights[parent[case_root].clamp_min(0)])
    t_inf = node_h + branch_fractions * (par_h - node_h)
    infector = torch.where(case_root == root, torch.full_like(case_root, -1),
                           painting[parent[case_root].clamp_min(0)])
    return t_inf, infector, case_root


def case_to_case_loglik(parent, children, heights, root,
                        painting: torch.Tensor, n_taxa: int,
                        sample_heights: torch.Tensor,
                        branch_fractions: torch.Tensor, inf_period_shape,
                        inf_period_scale, transmission_rate,
                        case_distances: Optional[torch.Tensor] = None,
                        kernel_alpha=None) -> torch.Tensor:
    """The joint epidemiological density (CaseToCaseTransmissionLikelihood
    .java:475-520): the Gamma log density of each case's infectious
    period (infection less sampling time), log rate for each
    transmission, an exponential spatial kernel over case_distances [n,
    n] where given; -inf for an invalid painting or a period <= 0."""
    n_cases = sample_heights.shape[0]
    dt = heights.dtype
    valid = painting_is_valid(children, painting, n_taxa)
    t_inf, infector, _ = infection_events(parent, painting, heights, root,
                                          n_cases, branch_fractions)
    period = t_inf - sample_heights
    ll = gamma_logpdf(torch.clamp_min(period, 1e-12), inf_period_shape,
                      inf_period_scale)
    ll = ll + torch.where(period.min() <= 0, NEG_INF, 0.0)
    ll = ll + (n_cases - 1) * torch.log(torch.as_tensor(
        transmission_rate, dtype=dt, device=heights.device))
    if case_distances is not None:
        d = case_distances[infector.clamp_min(0),
                           torch.arange(n_cases, device=heights.device)]
        k = -torch.as_tensor(kernel_alpha, dtype=dt,
                             device=heights.device) * d
        ll = ll + torch.sum(torch.where(infector >= 0, k,
                                        torch.zeros_like(k)))
    return torch.where(valid, ll, torch.full_like(ll, NEG_INF))


@dataclasses.dataclass
class PaintingRepaintOperator(Operator):
    """Repaint a uniform internal node with the case of a uniform one of
    its children (InfectionBranchMovementOperator.java's role); symmetric,
    an invalid painting rejected by the density."""

    painting_param: str = "painting"
    modifies_params = None

    def modified_params(self):
        return (self.painting_param,)

    def propose(self, params, tree, gen, tuning):
        painting = params[self.painting_param]
        m = painting.shape[0]
        n_taxa = (m + 1) // 2
        node = ops._randint(gen, n_taxa, m, painting.device)
        side = ops._randint(gen, 0, 2, painting.device)
        new_case = painting[tree.children[node, side]]
        return ({**params, self.painting_param:
                 painting.index_put((node,), new_case)}, tree, _zero(tree))


def initial_painting(parent: np.ndarray, children: np.ndarray, root: int,
                     n_taxa: int) -> np.ndarray:
    """A valid starting painting (numpy): every internal node takes its
    first child's case, bottom-up."""
    painting = np.arange(parent.shape[0], dtype=np.int32)
    order, stack = [], [int(root)]
    while stack:
        n = stack.pop()
        order.append(n)
        stack.extend(int(c) for c in children[n] if c >= 0)
    for n in reversed(order):
        if n >= n_taxa:
            painting[n] = painting[int(children[n, 0])]
    return painting


# ---------------------------------------------------------------------------
# infectious-period priors (casetocase/periodpriors/*)
# ---------------------------------------------------------------------------


def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def normal_period_prior_loglik(periods, mu0, lambda0, alpha0,
                               beta0) -> torch.Tensor:
    """The marginal likelihood of iid normal periods under a
    normal-gamma (mu, tau) hyperprior, both integrated out
    (NormalPeriodPriorDistribution.java:158-199)."""
    x = periods.reshape(-1)
    n = x.shape[0]
    lam_n = lambda0 + n
    alpha_n = alpha0 + n / 2
    mean = torch.mean(x)
    ssd = torch.sum((x - mean) ** 2)
    beta_n = (beta0 + 0.5 * ssd
              + lambda0 * n * (mean - mu0) ** 2 / (2.0 * (lambda0 + n)))
    return (torch.lgamma(_t(alpha_n, x)) - torch.lgamma(_t(alpha0, x))
            + alpha0 * torch.log(_t(beta0, x)) - alpha_n * torch.log(beta_n)
            + 0.5 * torch.log(_t(lambda0, x)) - 0.5 * torch.log(_t(lam_n, x))
            - (n / 2) * torch.log(_t(2 * math.pi, x)))


def known_variance_normal_period_prior_loglik(periods, sigma, mu0,
                                              sigma0) -> torch.Tensor:
    """The marginal likelihood of iid normal(mu, sigma^2) periods with
    sigma known and a normal(mu0, sigma0^2) prior on mu integrated out
    (KnownVarianceNormalPeriodPriorDistribution.java:114-142, term for
    term)."""
    x = periods.reshape(-1)
    n = x.shape[0]
    var, var0 = sigma ** 2, sigma0 ** 2
    mean = torch.sum(x) / n
    return (torch.log(_t(sigma, x))
            - n * torch.log(torch.sqrt(_t(2 * math.pi, x)) * sigma)
            - torch.log(torch.sqrt(_t(n * var0 + var, x)))
            - torch.sum(x * x) / (2 * var) - mu0 ** 2 / (2 * var0)
            + ((sigma0 * n * mean / sigma) ** 2 + (sigma * mu0 / sigma0) ** 2
               + 2 * n * mean * mu0) / (2 * (n * var0 + var)))


def one_over_stdev_period_prior_loglik(periods) -> torch.Tensor:
    """-log sd(periods), the sample sd (OneOverStDevPeriodPriorDistribution
    .java:34-41)."""
    x = periods.reshape(-1)
    n = x.shape[0]
    return -torch.log(torch.sqrt(torch.sum((x - torch.mean(x)) ** 2)
                                 / (n - 1)))


def individual_period_prior_loglik(periods, logpdf_fn) -> torch.Tensor:
    """Independent per-case period densities (IndividualPrior.java)."""
    return torch.sum(logpdf_fn(periods.reshape(-1)))

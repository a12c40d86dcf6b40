"""Speciation (birth-death) tree priors: the Gernhard (2008) conditioned
reconstructed process and its pure-birth case, the serially sampled
birth-death models (Stadler 2010) and calibrated speciation.

Counterpart of beast_mcmc_tpu/models/speciation.py, every function of it
(:26-72 below
(Gernhard08BirthDeathModel.java:220-260 logTreeProbability /
logNodeProbability; YuleModel.java), parameterised as the reference does:

  r   = lambda - mu        (birth diff rate)
  a   = mu / lambda        (relative death rate; 0 => Yule)
  rho = sampling probability

density over internal-node heights x (unconditioned on the root):
  logL = (n-1) log(r rho) + n log(1-a)
       + sum_internal [ -2 log(rho + ((1-rho)-a) e^{-r h}) - r h ]
       + extra root term [ -r h_root - log(rho + ((1-rho)-a) e^{-r h_root}) ]

The episodic model's lax.scan over its grid intervals is a Python loop
over tensors, and its jax.vmap calls broadcast. The MRCA is found by
pointer doubling on the device, no host walk of the tree.
"""

from __future__ import annotations

import math

import torch

from beast_mcmc_tpu_torch.utils.accum import prefix_sum


def birth_death_loglik(heights: torch.Tensor, n_taxa: int, root,
                       birth_diff_rate, relative_death_rate=0.0,
                       sample_probability=1.0,
                       labeled: bool = True) -> torch.Tensor:
    """Gernhard08 birth-death density on an ultrametric tree's node
    heights; 0-d. labeled=True adds the LABELED coefficient 2^(n-1)/(n-1)!
    of the reference's default <birthDeathModel> (logCoeff). A chain
    batch, heights [B, M] and root [B] with the rates 0-d or [B], gives
    [B]."""
    dt, dev = heights.dtype, heights.device
    chains = heights.dim() == 2
    r, a, rho = (torch.as_tensor(v, dtype=dt, device=dev)
                 for v in (birth_diff_rate, relative_death_rate,
                           sample_probability))
    n = n_taxa
    m = heights.shape[-1]
    internal = torch.arange(m, device=dev) >= n

    def col(v):  # a chain's rate beside its row of heights
        return v[..., None] if chains and v.dim() == 1 else v

    mrh = -col(r) * heights
    z = torch.log(col(rho) + ((1.0 - col(rho)) - col(a)) * torch.exp(mrh))
    node_terms = torch.where(internal, -2.0 * z + mrh, torch.zeros_like(z))
    root = torch.as_tensor(root, device=dev)
    if chains:
        root = root.reshape(-1, 1)
        root_term = (torch.gather(mrh, -1, root)
                     - torch.gather(z, -1, root)).reshape(-1)
    else:
        root = root.reshape(1)
        root_term = (mrh[root] - z[root]).reshape(())
    c1 = (n - 1) * torch.log(r * rho) + n * torch.log1p(-a)
    if labeled:
        c1 = c1 + (n - 1) * math.log(2.0) - math.lgamma(n)
    return c1 + torch.sum(node_terms, dim=-1) + root_term


def yule_loglik(heights: torch.Tensor, n_taxa: int, root, birth_rate,
                labeled: bool = True) -> torch.Tensor:
    """The pure-birth case (YuleModel.java; a = 0, rho = 1)."""
    return birth_death_loglik(heights, n_taxa, root, birth_rate, 0.0, 1.0,
                              labeled=labeled)



# ---------------------------------------------------------------------------
# Serially sampled birth-death (Stadler 2010;
# BirthDeathSerialSamplingModel.java:192-365: p0 and log q in closed form,
# the origin-conditioned tree density)
# ---------------------------------------------------------------------------

def _bdss_c1(b, d, psi):
    return torch.sqrt((b - d - psi) ** 2 + 4.0 * b * psi)


def _bdss_c2(b, d, p, psi):
    return -(b - d - 2.0 * b * p - psi) / _bdss_c1(b, d, psi)


def bdss_log_q(b, d, p, psi, t):
    """log q(t), in log space as the reference computes it
    (BirthDeathSerialSamplingModel.java:202-206)."""
    c1 = _bdss_c1(b, d, psi)
    c2 = _bdss_c2(b, d, p, psi)
    return c1 * t + 2.0 * torch.log(torch.exp(-c1 * t) * (1.0 - c2)
                                    + (1.0 + c2))


def bdss_p0(b, d, p, psi, t):
    """The probability of no sampled descendants after time t
    (BirthDeathSerialSamplingModel.java:192-200)."""
    c1 = _bdss_c1(b, d, psi)
    c2 = _bdss_c2(b, d, p, psi)
    e = torch.exp(-c1 * t) * (1.0 - c2)
    return (b + d + psi + c1 * (e - (1.0 + c2)) / (e + (1.0 + c2))) / (2.0 * b)


def serial_birth_death_loglik(heights: torch.Tensor, n_taxa: int,
                              birth_rate, death_rate, psi, origin,
                              sampling_prob=0.0,
                              has_final_sample: bool = False
                              ) -> torch.Tensor:
    """Origin-conditioned serially sampled birth-death tree density
    (BirthDeathSerialSamplingModel.calculateTreeLogLikelihood:295-365):
      logL = -logq(x0) [+ n log(4p) with a final sample]
             + sum_internal [log b - logq(x_i)]
             + sum_{psi-sampled tips} [log psi + logq(y_j)]
    Tips at height 0 are the final sample where has_final_sample, else
    psi-sampled like the rest. -inf where the origin is below the root."""
    dt, dev = heights.dtype, heights.device

    def c(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    b, d, s, x0 = c(birth_rate), c(death_rate), c(psi), c(origin)
    p = c(sampling_prob) if has_final_sample else c(0.0)
    tip_h, int_h = heights[:n_taxa], heights[n_taxa:]
    at_present = tip_h <= 1e-12
    logl = -bdss_log_q(b, d, p, s, x0)
    if has_final_sample:
        logl = logl + torch.sum(at_present) * torch.log(4.0 * p)
    logl = logl + torch.sum(torch.log(b) - bdss_log_q(b, d, p, s, int_h))
    tip_term = torch.log(s) + bdss_log_q(b, d, p, s, tip_h)
    if has_final_sample:
        tip_term = torch.where(at_present, torch.zeros_like(tip_term),
                               tip_term)
    logl = logl + torch.sum(tip_term)
    root_h = torch.max(int_h)
    return torch.where(x0 >= root_h, logl, torch.full_like(logl, -math.inf))


# ---------------------------------------------------------------------------
# Episodic (skyline) serially sampled birth-death
# ---------------------------------------------------------------------------

def episodic_serial_birth_death_loglik(heights: torch.Tensor, n_taxa: int,
                                       origin, birth_rates, death_rates,
                                       sampling_rates, treatment_probs=1.0,
                                       rho_present=0.0, grid_end=None,
                                       num_intervals: int = 1
                                       ) -> torch.Tensor:
    """Episodic (piecewise-constant-rate) serially sampled birth-death
    prior, the BDSKY family (BirthDeathEpisodicSeriallySampledModel.java:
    Ai/Bi/p/logq :225-279, the B recursion :334-354, the event terms
    :400-444): K equal intervals of [0, grid_end] back from the present,
    one rate of each kind per interval. As in the JAX package the per-event
    dispatch is a cumulative log q, cumlogq(t) = prefix_sum(logq_j(t_j)) +
    logq_idx(t), so each branch contributes cumlogq(t_parent) -
    cumlogq(t_child). With K = 1 and r = 1 it is
    serial_birth_death_loglik."""
    dt, dev = heights.dtype, heights.device
    k = num_intervals

    def vec(v):
        return torch.as_tensor(v, dtype=dt, device=dev).reshape(-1).expand(k)

    lam, mu, psi, r = (vec(v) for v in (birth_rates, death_rates,
                                        sampling_rates, treatment_probs))
    rho_c = torch.as_tensor(rho_present, dtype=dt, device=dev)
    rho = torch.cat([rho_c.reshape(1), torch.zeros(k - 1, dtype=dt,
                                                   device=dev)])
    x0 = torch.as_tensor(origin, dtype=dt, device=dev)
    width = torch.as_tensor(grid_end, dtype=dt, device=dev) / k
    a = torch.sqrt((lam - mu - psi) ** 2 + 4.0 * lam * psi)

    def p_at(i_lam, i_mu, i_psi, i_a, i_b, t_rel):
        e = torch.exp(i_a * t_rel)
        one_minus = e * (1.0 + i_b) - (1.0 - i_b)
        one_plus = e * (1.0 + i_b) + (1.0 - i_b)
        return (i_lam + i_mu + i_psi - i_a * one_minus / one_plus) / (
            2.0 * i_lam)

    # B_i needs p_{i-1}(t_{i-1}) (ref :348-354): the JAX scan as a loop
    p_prev = torch.ones((), dtype=dt, device=dev)
    bs = []
    for i in range(k):
        b_i = ((1.0 - 2.0 * (1.0 - rho[i]) * p_prev) * lam[i] + mu[i]
               + psi[i]) / a[i]
        p_prev = p_at(lam[i], mu[i], psi[i], a[i], b_i, width)
        bs.append(b_i)
    b = torch.stack(bs)

    def logq(i, t):
        """logq_i(t) within interval i (ref logq :271-279)."""
        at = a[i] * (t - i.to(dt) * width)
        denom = torch.exp(at) * (1.0 + b[i]) + (1.0 - b[i])
        return at + math.log(4.0) - 2.0 * torch.log(denom)

    ar = torch.arange(k, device=dev)
    prefix = torch.cat([torch.zeros(1, dtype=dt, device=dev),
                        prefix_sum(logq(ar, (ar + 1).to(dt) * width))])

    def idx_of(t):
        return torch.clamp((t / width).to(torch.int64), 0, k - 1)

    def cumlogq(t):
        i = idx_of(t)
        return prefix[i] + logq(i, t)

    tip_h, int_h = heights[:n_taxa], heights[n_taxa:]
    root_h = torch.max(int_h)
    # one net +cumlogq per internal node, +cumlogq(origin) for the stem,
    # -cumlogq per tip
    ll = (cumlogq(x0) + torch.sum(cumlogq(int_h)) - torch.sum(cumlogq(tip_h))
          + torch.sum(torch.log(lam[idx_of(int_h)])))
    i_tip = idx_of(tip_h)
    p_tip = p_at(lam[i_tip], mu[i_tip], psi[i_tip], a[i_tip], b[i_tip],
                 tip_h - i_tip.to(dt) * width)
    serial_term = torch.log(psi[i_tip]) + torch.log(
        r[i_tip] + (1.0 - r[i_tip]) * p_tip)
    at_present = tip_h <= 1e-12
    tip_term = torch.where(at_present & (rho_c > 0.0),
                           torch.log(torch.clamp_min(rho_c, 1e-300)),
                           serial_term)
    ll = ll + torch.sum(tip_term)
    # past the last grid point the last interval's rates run on to the
    # origin (idx_of clips; setupTimeline)
    return torch.where(x0 >= root_h, ll, torch.full_like(ll, -math.inf))


# ---------------------------------------------------------------------------
# Calibrated speciation
# ---------------------------------------------------------------------------

def mrca_node(parent: torch.Tensor, heights: torch.Tensor,
              tip_set: torch.Tensor) -> torch.Tensor:
    """Index of the MRCA of a boolean tip set [M] (TMRCAStatistic,
    TreeUtils.getCommonAncestorNode), a 0-d device tensor: ancestor-or-self
    reachability [M, M] by pointer doubling, then the lowest node whose
    subtree covers the set."""
    m = parent.shape[0]
    ar = torch.arange(m, device=parent.device)
    jump = torch.where(parent < 0, ar, parent)
    anc = torch.eye(m, dtype=torch.bool, device=parent.device)
    steps = 1
    while (1 << steps) < m:
        steps += 1
    for _ in range(steps):
        anc = anc | anc[jump]
        jump = jump[jump]
    tip_set = torch.as_tensor(tip_set, device=parent.device)
    covers = torch.all(~tip_set[:, None] | anc, dim=0)
    h = torch.where(covers, heights, torch.full_like(heights, math.inf))
    return torch.argmin(h)


def calibrated_speciation_loglik(speciation_loglik, parent: torch.Tensor,
                                 heights: torch.Tensor,
                                 calibrations) -> torch.Tensor:
    """The speciation prior plus each calibration density at its clade's
    MRCA age (CalibratedSpeciationLikelihood.java:94-100); calibrations is
    [(tip_set bool [M], logpdf(height) -> 0-d)]."""
    ll = torch.as_tensor(speciation_loglik)
    for tip_set, logpdf_fn in calibrations:
        node = mrca_node(parent, heights, tip_set)
        ll = ll + logpdf_fn(heights[node])
    return ll

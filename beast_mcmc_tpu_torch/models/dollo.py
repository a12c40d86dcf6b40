"""Stochastic Dollo (MSSD) likelihood: binary presence/absence traits
gained once, lost at rate delta.

Counterpart of beast_mcmc_tpu/models/dollo.py, the role of the reference's
MSSD package (src/dr/evomodel/MSSD/ALSBeagleTreeLikelihood.java +
AbstractObservationProcess; the mutation-death model of Alekseyenko, Lee &
Suchard 2008). A character is gained once somewhere on the tree
(uniform-over-branch-length origin, rate lambda) and evolves by pure death
(loss) below the origin.

  L(pattern) = sum_{v in anc-or-self(MRCA(present tips))}
                   w_v * post_v[present],
  w_v = integral of survival-to-v over the branch above v
      = (1 - e^{-delta t_v}) / delta   (root: immortal-origin weight),

with post computed by peeling under the death transition matrix
P(t) = [[1, 0], [1 - e^{-delta t}, e^{-delta t}]] (states 0 = absent,
1 = present). Patterns with presence outside subtree(v) contribute 0 for
that v automatically.

The JAX package peels node by node in a scan; here the peel goes by
levels of depth, deepest first (ops/peeling.py::internal_levels), one
batched product a level; the ancestor-or-self incidence is the same
pointer doubling.
"""

from __future__ import annotations

import math

import torch

from beast_mcmc_tpu_torch.ops.peeling import internal_levels


def _death_p(delta, t):
    """[..., 2, 2] death-model transition matrix over time t."""
    e = torch.exp(-delta * t)
    zeros = torch.zeros_like(e)
    ones = torch.ones_like(e)
    return torch.stack([torch.stack([ones, zeros], -1),
                        torch.stack([1.0 - e, e], -1)], -2)


def _branch_lengths(parent, heights, branch_rates):
    m = parent.shape[0]
    pidx = parent.clamp_min(0)
    bl = torch.where(parent >= 0, heights[pidx] - heights,
                     torch.zeros_like(heights))
    br = torch.as_tensor(branch_rates, dtype=heights.dtype,
                         device=heights.device)
    return bl * torch.broadcast_to(br, (m,))


def stochastic_dollo_site_likelihoods(tip_presence: torch.Tensor,
                                      parent: torch.Tensor,
                                      children: torch.Tensor,
                                      heights: torch.Tensor, death_rate,
                                      branch_rates=1.0) -> torch.Tensor:
    """Per-pattern likelihood [P] (unnormalised over the gain rate; see
    stochastic_dollo_loglik). tip_presence bool/int [N, P]."""
    n, p = tip_presence.shape
    m = parent.shape[0]
    dt, dev = heights.dtype, heights.device
    delta = torch.as_tensor(death_rate, dtype=dt, device=dev)
    bl = _branch_lengths(parent, heights, branch_rates)
    pmat = _death_p(delta, bl)  # [M, 2, 2]

    pres = tip_presence.to(device=dev, dtype=dt)
    post = torch.zeros((m, 2, p), dtype=dt, device=dev)
    post[:n] = torch.stack([1.0 - pres, pres], dim=1)
    ch = children.long()
    for nodes in reversed(internal_levels(parent, n)):
        l, r = ch[nodes, 0], ch[nodes, 1]
        post[nodes] = (pmat[l] @ post[l]) * (pmat[r] @ post[r])

    # ancestor-or-self incidence over tips: anc[v, tip]
    idx = torch.arange(m, device=dev)
    q = torch.where(parent < 0, idx, parent)
    anc = torch.eye(m, dtype=torch.bool, device=dev)
    for _ in range(int(math.ceil(math.log2(max(m, 2)))) + 1):
        anc = anc | anc[:, q]
        q = q[q]
    covers_tips = anc[:, :n]  # [M, N]
    misses = (~covers_tips).to(dt) @ (tip_presence.to(dev) != 0).to(dt)
    valid = misses == 0  # [M, P]

    # origin weights: survival opportunity on the branch above v; the
    # root's "branch" is the immortal origin above, weight 1/delta
    w = -torch.expm1(-delta * bl) / delta
    w = torch.where(parent >= 0, w, 1.0 / delta)
    return torch.sum(torch.where(valid, post[:, 1, :],
                                 torch.zeros_like(post[:, 1, :]))
                     * w[:, None], dim=0)


def stochastic_dollo_loglik(tip_presence: torch.Tensor, parent: torch.Tensor,
                            children: torch.Tensor, heights: torch.Tensor,
                            death_rate, gain_rate=1.0, branch_rates=1.0,
                            pattern_weights=None,
                            condition_on_observed: bool = True
                            ) -> torch.Tensor:
    """Total log-likelihood with gain-rate scaling and the conditioning on
    the character being observable (present in >= 1 tip), the reference's
    AnyTipObservationProcess."""
    n, p = tip_presence.shape
    dt, dev = heights.dtype, heights.device
    lam = torch.as_tensor(gain_rate, dtype=dt, device=dev)
    site_lik = stochastic_dollo_site_likelihoods(
        tip_presence, parent, children, heights, death_rate,
        branch_rates) * lam
    if condition_on_observed:
        # P(observable) = lambda * (total weight) - P(all-absent pattern)
        all_absent = torch.zeros((n, 1), dtype=torch.int8, device=dev)
        p_unobs = stochastic_dollo_site_likelihoods(
            all_absent, parent, children, heights, death_rate,
            branch_rates)[0] * lam
        bl = _branch_lengths(parent, heights, branch_rates)
        delta = torch.as_tensor(death_rate, dtype=dt, device=dev)
        total_w = torch.sum(-torch.expm1(-delta * bl) / delta) + 1.0 / delta
        site_logl = torch.log(site_lik) - torch.log(lam * total_w - p_unobs)
    else:
        site_logl = torch.log(site_lik)
    if pattern_weights is None:
        pattern_weights = torch.ones((p,), dtype=dt, device=dev)
    return torch.dot(torch.as_tensor(pattern_weights, dtype=dt, device=dev),
                     site_logl)

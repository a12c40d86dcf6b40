"""BASTA structured coalescent over discrete demes.

Counterpart of beast_mcmc_tpu/models/basta.py (the reference's
GenericBastaLikelihoodDelegate.java:813-1008: peelPartials,
reduceWithinInterval, reduceAcrossIntervals). Each lineage carries a
probability vector p over K demes; along a coalescent interval of length L
it is transported by the backward migration process, p_end = exp(Lam^T L)
p, and the probability of no coalescence takes the trapezoid of the
expected pairwise rate,

  logL -= L/4 * sum_k [(e_k^2 - f_k) + (g_k^2 - h_k)] / N_k,

with e, f (g, h) the active lineages' sums of p_k and p_k^2 at the
interval's start (end); a coalescence of lineages a, b adds
log sum_k p_a(k) p_b(k) / N_k and starts the parent at the normalised
product.

JAX walks the height-sorted events in one lax.scan. Here the event order
is read to the host once (it depends on the heights' order only), every
interval's K x K matrix exponential is one batched torch.linalg.matrix_exp
before the walk, and the walk is a plain loop of a few small ops an event
over an [M, K] tensor that holds exactly the active lineages' rows (a
row is zeroed when its lineage coalesces). Differentiable in the heights,
the migration matrix and the population sizes.
"""

from __future__ import annotations

import numpy as np
import torch


def migration_rate_matrix(rates: torch.Tensor, k: int) -> torch.Tensor:
    """The backward migration rate matrix [K, K] from the K(K-1)
    off-diagonal rates (row-major, skipping the diagonal), rows summing to
    0."""
    rates = torch.as_tensor(rates)
    rows, cols = np.where(~np.eye(k, dtype=bool))
    q = torch.zeros((k, k), dtype=rates.dtype, device=rates.device)
    q = q.index_put((torch.as_tensor(rows, device=rates.device),
                     torch.as_tensor(cols, device=rates.device)), rates)
    return q - torch.diag(torch.sum(q, dim=1))


def _walk(tip_demes, children, heights, migration, pop_sizes,
          with_loglik: bool):
    """(logL or None, final [M, K] partials, root) of the event walk."""
    m = heights.shape[0]
    n_taxa = (m + 1) // 2
    k = pop_sizes.shape[0]
    dt, dev = heights.dtype, heights.device
    if tip_demes.dim() == 1:
        tip_p = torch.nn.functional.one_hot(tip_demes.long(), k).to(dt)
    else:
        tip_p = tip_demes.to(dt)
    inv_n = 1.0 / pop_sizes.to(dt)

    # the height-sorted event order, tips before coalescences at equal
    # height (JAX's lexsort((-delta, heights)))
    h_np = heights.detach().cpu().numpy()
    delta = np.where(np.arange(m) < n_taxa, 1, -1)
    order = np.lexsort((-delta, h_np))
    ch_np = children.detach().cpu().numpy()
    order_t = torch.as_tensor(order, device=dev)
    times = heights[order_t]
    lengths = times[1:] - times[:-1]
    # every interval's transport at once: trans[j] = exp(Lam^T L_j)
    qt = migration.to(dt).T
    trans = torch.linalg.matrix_exp(qt[None] * lengths[:, None, None])
    trans_t = trans.transpose(1, 2)  # p_end = p @ trans[j]^T
    idx = torch.arange(m, device=dev)
    # (node, child, child) of each node, sliced on the device a coalescence
    trio = torch.as_tensor(
        np.concatenate([np.arange(m)[:, None], ch_np], 1), device=dev)
    zero_row = torch.zeros((1, k), dtype=dt, device=dev)

    first = int(order[0])
    p_arr = torch.zeros((m, k), dtype=dt, device=dev).index_copy(
        0, idx[first:first + 1], tip_p[min(first, n_taxa - 1)][None])
    logl = None
    interval_terms, coal_probs = [], []
    for j in range(1, m):
        p_end = p_arr @ trans_t[j - 1]
        if with_loglik:
            e, f = p_arr.sum(0), (p_arr * p_arr).sum(0)
            g, h = p_end.sum(0), (p_end * p_end).sum(0)
            interval_terms.append(torch.sum((e * e - f + g * g - h)
                                            * inv_n))
        p_arr = p_end
        node = int(order[j])
        if node < n_taxa:
            p_arr = p_arr.index_copy(0, idx[node:node + 1],
                                     tip_p[node][None])
            continue
        c1, c2 = int(ch_np[node, 0]), int(ch_np[node, 1])
        entry = p_arr[c1] * p_arr[c2] * inv_n
        prob = torch.sum(entry)
        ok = prob > 0
        prob_safe = torch.where(ok, prob, torch.ones_like(prob))
        coal_probs.append(torch.where(ok, torch.log(prob_safe),
                                      torch.full_like(prob, -np.inf)))
        rows = torch.cat([(entry / prob_safe)[None], zero_row, zero_row])
        p_arr = p_arr.index_copy(0, trio[node], rows)
    if with_loglik:
        logl = (torch.sum(torch.stack(coal_probs))
                - torch.sum(lengths / 4.0 * torch.stack(interval_terms)))
    return logl, p_arr, int(order[-1])


def basta_loglikelihood(tip_demes, parent, children, heights, migration,
                        pop_sizes) -> torch.Tensor:
    """The BASTA approximate structured-coalescent log density of the tree
    and its tip demes (int [N] demes, or float [N, K] probabilities) given
    the backward migration matrix [K, K] (rows summing to 0) and the deme
    population sizes [K]."""
    return _walk(tip_demes, children, heights, migration, pop_sizes,
                 True)[0]


def basta_root_deme_distribution(tip_demes, parent, children, heights,
                                 migration, pop_sizes) -> torch.Tensor:
    """The root's deme distribution after the walk (the reference's
    ancestral reconstruction surface for structured trees)."""
    _, p_arr, root = _walk(tip_demes, children, heights, migration,
                           pop_sizes, False)
    return p_arr[root]

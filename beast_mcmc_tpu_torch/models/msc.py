"""The multispecies coalescent: gene trees embedded in a species tree.

Counterpart of beast_mcmc_tpu/models/msc.py (MultiSpeciesCoalescent.java,
Rannala & Yang 2003; *BEAST's SpeciesBindings and SpeciesTreeModel). The
occupancy of species branches by gene lineages is a masked tensor
computation: each gene node's base species is the species-tree MRCA of
its tips' species; a lineage may occupy species branch B where B is an
ancestor-or-self of its base; the density integrates C(k, 2) / N_B over
the sorted grid of gene and species event times, with -log N_B at each
coalescence. An embedding with a gene coalescence younger than the
species divergence of its tips gives -inf. The [M, M] ancestor matrices
and the [T, G] occupancy are dense on the device.
"""

from __future__ import annotations

import math

import torch


def _ancestor_matrix(parent: torch.Tensor) -> torch.Tensor:
    """bool[M, M]: anc[a, d] iff a is an ancestor-or-self of d, by pointer
    doubling (ceil(log2 M) + 1 rounds)."""
    m = parent.shape[0]
    idx = torch.arange(m, device=parent.device)
    q = torch.where(parent < 0, idx, parent.long())
    anc = torch.eye(m, dtype=torch.bool, device=parent.device)
    for _ in range(math.ceil(math.log2(max(m, 2))) + 1):
        anc = anc | anc[:, q]
        q = q[q]
    return anc


def multispecies_coalescent_loglik(gene_parent: torch.Tensor,
                                   gene_children: torch.Tensor,
                                   gene_heights: torch.Tensor,
                                   tip_species: torch.Tensor,
                                   sp_parent: torch.Tensor,
                                   sp_heights: torch.Tensor,
                                   pop_sizes: torch.Tensor) -> torch.Tensor:
    """The log density of one gene tree (G nodes, tips first) given the
    species tree (S nodes, tips first) and each species branch's
    population size [S]; tip_species [n_gene_tips] maps each gene tip to
    its species tip. Species branch s spans [h_s, h_parent(s)) (the root's
    to infinity)."""
    g = gene_parent.shape[0]
    n_tips = (g + 1) // 2
    s = sp_parent.shape[0]
    n_sp_tips = (s + 1) // 2
    dt = gene_heights.dtype
    inf = torch.full((), math.inf, dtype=dt, device=gene_heights.device)

    sp_anc = _ancestor_matrix(sp_parent)  # [S, S]
    gene_anc = _ancestor_matrix(gene_parent)[:, :n_tips]  # [G, n_tips]
    tip_onehot = torch.nn.functional.one_hot(tip_species.long(), s).to(dt)
    under = (gene_anc.to(dt) @ tip_onehot) > 0  # [G, S] species present
    # species node a covers gene node v where every species tip under v
    # descends from a; the base is the lowest cover
    covers = ~torch.any(under[:, None, :n_sp_tips]
                        & ~sp_anc[None, :, :n_sp_tips], dim=-1)  # [G, S]
    base = torch.argmin(torch.where(covers, sp_heights[None, :], inf), dim=1)
    compatible = torch.all(gene_heights >= sp_heights[base] - 1e-12)

    occ_sp = sp_anc[:, base].T  # [G, S]: lineage v may occupy branch B
    sp_hi = torch.where(sp_parent >= 0, sp_heights[sp_parent.clamp_min(0)],
                        inf)
    g_hi = torch.where(gene_parent >= 0,
                       gene_heights[gene_parent.clamp_min(0)], inf)

    times = torch.sort(torch.cat([gene_heights, sp_heights])).values
    t0, t1 = times[:-1], times[1:]
    mid = 0.5 * (t0 + t1)
    in_lineage = ((mid[:, None] >= gene_heights[None, :])
                  & (mid[:, None] < g_hi[None, :]))  # [T, G]
    in_branch = ((mid[:, None] >= sp_heights[None, :])
                 & (mid[:, None] < sp_hi[None, :]))  # [T, S]
    k = (in_lineage.to(dt) @ occ_sp.to(dt)) * in_branch.to(dt)  # [T, S]
    choose2 = k * (k - 1.0) / 2.0
    interval_term = -torch.sum(choose2 * (t1 - t0)[:, None]
                               / pop_sizes[None, :])

    internal = torch.arange(g, device=gene_heights.device) >= n_tips
    in_b = ((gene_heights[:, None] >= sp_heights[None, :])
            & (gene_heights[:, None] < sp_hi[None, :]) & occ_sp)  # [G, S]
    event_n = in_b.to(dt) @ torch.log(pop_sizes)
    event_term = -torch.sum(torch.where(internal, event_n,
                                        torch.zeros_like(event_n)))
    return torch.where(compatible, interval_term + event_term, -inf)

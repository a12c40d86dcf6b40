"""AlloppNet: allopolyploid species-network inference.

Counterpart of beast_mcmc_tpu/models/alloppnet.py (AlloppSpeciesNetworkModel
.java, AlloppMulLabTree.java, AlloppDiploidHistory.java; Jones, Sagitov &
Oxelman 2013). A tetraploid clade arises by hybridisation of two diploid
lineages (legs) at a hybridisation time; each sub-genome's gene trees
follow the multispecies coalescent on the induced MUL-tree, in which the
tetraploid subtree appears twice, each copy spliced into one leg. The
MUL-tree is built by fixed-shape index surgery on the device and its
density is models/msc.py::multispecies_coalescent_loglik.

One tetraploid subtree with two distinct legs. The MUL-tree's layout with
d diploid and k tetraploid tips: tips [0, d) diploid, [d, d + k) copy A,
[d + k, d + 2k) copy B; then the diploid internals, copy A's, copy B's,
and the two splice nodes last.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from beast_mcmc_tpu_torch.models.msc import multispecies_coalescent_loglik


class AlloppNetwork(NamedTuple):
    dip_parent: torch.Tensor  # int64 [2d - 1]
    dip_children: torch.Tensor  # int64 [2d - 1, 2]
    dip_heights: torch.Tensor  # [2d - 1]
    dip_root: torch.Tensor  # int64
    tet_parent: torch.Tensor  # int64 [2k - 1]
    tet_children: torch.Tensor  # int64 [2k - 1, 2]
    tet_heights: torch.Tensor  # [2k - 1]
    tet_root: torch.Tensor  # int64
    leg_a: torch.Tensor  # int64: diploid node whose parent edge hosts copy A
    leg_b: torch.Tensor  # int64: likewise for copy B
    hyb_height: torch.Tensor  # [] the hybridisation time


def mul_tree(net: AlloppNetwork):
    """(parent, children, heights, root, valid) of the MUL-tree. valid is
    false where a leg edge does not span the hybridisation height, the
    legs coincide, or the tetraploid root is older than the
    hybridisation (states the density rejects)."""
    d = (net.dip_parent.shape[0] + 1) // 2
    k = (net.tet_parent.shape[0] + 1) // 2
    n = d + 2 * k
    m = 2 * n - 1
    dev = net.dip_heights.device
    dt = net.dip_heights.dtype

    def dip_map(i):
        return torch.where(i < d, i, i + 2 * k)

    def tet_map(i, copy):  # copy 0 is A, 1 is B
        return torch.where(i < k, d + copy * k + i,
                           (2 * d - 1 + 2 * k) + copy * (k - 1) + (i - k))

    def mapped(x, fn, fill):
        return torch.where(x >= 0, fn(x.clamp_min(0)),
                           torch.full_like(x, fill))

    splice = (m - 2, m - 1)
    parent = torch.full((m,), -1, dtype=torch.long, device=dev)
    children = torch.full((m, 2), -1, dtype=torch.long, device=dev)
    heights = torch.zeros(m, dtype=dt, device=dev)

    dm = dip_map(torch.arange(net.dip_parent.shape[0], device=dev))
    parent[dm] = mapped(net.dip_parent.long(), dip_map, -1)
    children[dm] = mapped(net.dip_children.long(), dip_map, -1)
    heights[dm] = net.dip_heights
    ti = torch.arange(net.tet_parent.shape[0], device=dev)
    for copy in (0, 1):
        tm = tet_map(ti, copy)
        parent[tm] = mapped(net.tet_parent.long(),
                            lambda x: tet_map(x, copy), splice[copy])
        children[tm] = mapped(net.tet_children.long(),
                              lambda x: tet_map(x, copy), -1)
        heights[tm] = net.tet_heights

    legs = [dip_map(torch.as_tensor(x, device=dev).long().reshape(1))
            for x in (net.leg_a, net.leg_b)]
    old_parents = [parent[leg] for leg in legs]
    troot = torch.as_tensor(net.tet_root, device=dev).long().reshape(1)
    for copy, (leg, old_par) in enumerate(zip(legs, old_parents)):
        node = torch.tensor([splice[copy]], device=dev)
        children[node] = torch.stack([leg, tet_map(troot, copy)], dim=-1)
        # `node` replaces `leg` among old_par's children (none at the root)
        safe = old_par.clamp_min(0)
        row = children[safe]
        row = torch.where(row == leg[:, None], node[:, None], row)
        children[safe] = torch.where(old_par[:, None] >= 0, row,
                                     children[safe])
        parent[node] = old_par
        parent[leg] = node
        parent[tet_map(troot, copy)] = node
    heights[list(splice)] = net.hyb_height.to(dt)

    dip_root = torch.as_tensor(net.dip_root, device=dev).long()
    root = torch.where(dip_root == net.leg_a, torch.tensor(splice[0],
                                                           device=dev),
                       torch.where(dip_root == net.leg_b,
                                   torch.tensor(splice[1], device=dev),
                                   dip_map(dip_root)))
    h = net.hyb_height

    def spans(leg):
        leg = torch.as_tensor(leg, device=dev).long()
        p = net.dip_parent[leg]
        above = torch.where(p >= 0, net.dip_heights[p.clamp_min(0)],
                            torch.full((), math.inf, dtype=dt, device=dev))
        return (net.dip_heights[leg] < h) & (h < above)

    valid = (spans(net.leg_a) & spans(net.leg_b)
             & (torch.as_tensor(net.leg_a) != torch.as_tensor(net.leg_b)
                ).to(dev)
             & (net.tet_heights[torch.as_tensor(net.tet_root,
                                                device=dev).long()] < h))
    return parent, children, heights, root, valid


def alloppnet_gene_tree_loglik(gene_parent, gene_children, gene_heights,
                               tip_species: torch.Tensor,
                               net: AlloppNetwork,
                               pop_sizes: torch.Tensor) -> torch.Tensor:
    """The MSC log density of one gene tree in the network's MUL-tree:
    tip_species [n_gene_tips] are MUL-tree tips, a tetraploid sequence
    pointing at its copy A or copy B tip (its sub-genome); pop_sizes
    [2 (d + 2k) - 1], one a MUL branch."""
    parent, _, heights, _, valid = mul_tree(net)
    ll = multispecies_coalescent_loglik(gene_parent, gene_children,
                                        gene_heights, tip_species, parent,
                                        heights, pop_sizes)
    return torch.where(valid, ll, torch.full_like(ll, -math.inf))


def flip_assignment(tip_species: torch.Tensor, seq_idx, pair_idx, d: int,
                    k: int) -> torch.Tensor:
    """Swap one sequence pair between the sub-genome copies A and B
    (AlloppSequenceReassignment): a tetraploid individual's two sequences
    exchange their MUL tips."""
    seq_idx = torch.as_tensor(seq_idx, device=tip_species.device).reshape(1)
    pair_idx = torch.as_tensor(pair_idx,
                               device=tip_species.device).reshape(1)
    a, b = tip_species[seq_idx], tip_species[pair_idx]
    return tip_species.index_put((seq_idx,), b).index_put((pair_idx,), a)

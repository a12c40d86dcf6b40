"""Sequence simulation down a tree, and site-pattern compression.

Counterpart of <beagleSequenceSimulator> (beast_mcmc_tpu/config/
xml_geo.py:598-739): each site draws its rate category from the category
weights and its root state from the root frequencies; every other node's
state is drawn from the row of its branch's transition matrix P(t r_b r_c)
at its parent's state (t the branch's time length, r_b its clock rate, r_c
the site's category rate), negative round-off clipped and each row
renormalised. The nodes go by levels of depth from the root, one batched
draw a level, on the tree's device and from a torch.Generator, so the full
Makona alignment (1,610 taxa x 18,996 sites) is made on the card. The law
is the JAX package's; the draws are not.
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops.peeling import node_depths

# [nodes x sites x states] entries drawn at once, to bound the scratch
_CHUNK = 1 << 24


def simulate_states(parent: torch.Tensor, p_mats: torch.Tensor,
                    cat_weights: torch.Tensor, root_freqs: torch.Tensor,
                    n_sites: int, generator: torch.Generator) -> torch.Tensor:
    """int64[M, n_sites] states of every node: parent int64[M] (-1 at the
    root), p_mats [M, C, S, S] of each node's parent branch."""
    dev = p_mats.device
    m, _, s, _ = p_mats.shape
    p = torch.clamp_min(p_mats.to(torch.float64), 0.0)
    cdf = torch.cumsum(p / p.sum(-1, keepdim=True), dim=-1)
    cats = torch.multinomial(cat_weights.to(torch.float64), n_sites,
                             replacement=True, generator=generator)
    states = torch.empty((m, n_sites), dtype=torch.long, device=dev)
    root = torch.nonzero(parent < 0).reshape(-1)
    states[root] = torch.multinomial(root_freqs.to(torch.float64), n_sites,
                                     replacement=True,
                                     generator=generator)[None]
    depth = node_depths(parent)
    by_depth = torch.sort(depth, stable=True).indices
    sizes = torch.bincount(depth).tolist()  # one copy to the host
    levels = torch.split(by_depth, sizes)[1:]
    step = max(1, _CHUNK // (n_sites * s))
    for nodes in levels:
        for a in range(0, nodes.shape[0], step):
            sub = nodes[a:a + step]
            rows = cdf[sub[:, None], cats[None, :], states[parent[sub]]]
            u = torch.rand(rows.shape[:2], generator=generator,
                           dtype=torch.float64, device=dev)
            states[sub] = torch.clamp((u[..., None] > rows).sum(-1),
                                      max=s - 1)
    return states


def compress_patterns(states: torch.Tensor):
    """(pattern states int64[N, P], weights float64[P]) of the columns of
    states [N, L]: the unique columns in order of first occurrence (as
    data/alignment.py::SitePatterns.from_alignment), on the tensor's
    device."""
    uniq, inverse, counts = torch.unique(states, dim=1, return_inverse=True,
                                         return_counts=True)
    n_sites = states.shape[1]
    first = torch.full((uniq.shape[1],), n_sites, dtype=torch.long,
                       device=states.device)
    first = first.scatter_reduce(0, inverse, torch.arange(
        n_sites, device=states.device), reduce="amin")
    order = torch.argsort(first)
    return uniq[:, order], counts[order].to(torch.float64)


def one_hot_tips(pattern_states: torch.Tensor, n_states: int,
                 dtype=torch.float64) -> torch.Tensor:
    """[N, S, P] tip partials of unambiguous states [N, P]."""
    return torch.nn.functional.one_hot(pattern_states, n_states).to(
        dtype).transpose(1, 2).contiguous()

"""Node heights <-> ratios, the change of variables of node-height HMC.

Counterpart of beast_mcmc_tpu/tree/transforms.py (the reference's
NodeHeightTransform and its ratios delegate). An internal node's height is

    h(node) = anchor(node) + ratio(node) * (h(parent(node)) - anchor(node))

where anchor(node) is the largest tip height under the node, so the order
constraints become ratio in (0, 1); the root height stays free above the
global anchor. The map ratios -> heights is triangular, so

    log|J| = sum over internal non-root nodes of log(h(parent) - anchor).

The JAX package scans the internal nodes one by one. Here the nodes of one
depth are independent (a parent is one level shallower than its children),
so the anchors go bottom-up and the heights top-down one batched step a
level of depth (`internal_levels`: one host copy of the depths, which a
caller on a fixed topology makes once). The values are the same, exactly.

A chain batch (parent [B, M], children [B, M, 2], heights [B, M], root
[B]) is one forest on a flat node axis, row b M + node (`flat_forest`):
the l-th level below every chain's root is one step, and the log-Jacobian
is [B], each chain's own.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from beast_mcmc_tpu_torch.ops.peeling import internal_levels, node_depths

__all__ = ["node_depths", "internal_levels", "subtree_anchors",
           "heights_to_ratios", "ratios_to_heights", "flat_forest"]


def flat_forest(parent, children):
    """(parent, children) of a tree, or of B chains' trees as one forest of
    rows b M + node ([B M], [B M, 2]; -1 stays -1)."""
    if parent.dim() == 1:
        return parent, children
    m = parent.shape[-1]
    off = m * torch.arange(parent.shape[0], device=parent.device)[:, None]
    return (torch.where(parent >= 0, parent + off, parent).reshape(-1),
            torch.where(children >= 0, children + off[..., None],
                        children).reshape(-1, 2))


def _internal_orders(parent: torch.Tensor, n_taxa: int):
    """(top_down, bottom_up) orders over the internal nodes: by depth from
    the root, ties by node index."""
    depth = node_depths(parent)
    top_down = n_taxa + torch.sort(depth[n_taxa:], stable=True).indices
    return top_down, top_down.flip(0)


def _with_internal(tip_values, n_internal: int, fill: float):
    """[..., M]: the tips' values, then `fill` for the internal nodes."""
    return torch.cat([tip_values, tip_values.new_full(
        (*tip_values.shape[:-1], n_internal), fill)], -1)


def subtree_anchors(parent, children, tip_heights, n_taxa: int,
                    levels: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """anchor[node] = the largest tip height in node's subtree (a tip's own
    height), bottom-up a level at a time; [B, M] for a chain batch."""
    levels = levels if levels is not None else internal_levels(parent, n_taxa)
    m = parent.shape[-1]
    anchors = _with_internal(tip_heights, m - n_taxa,
                             -float("inf")).reshape(-1)
    ch = flat_forest(parent, children)[1].long()
    for nodes in reversed(levels):
        anchors = anchors.index_put((nodes,), torch.maximum(
            anchors[ch[nodes, 0]], anchors[ch[nodes, 1]]))
    return anchors.reshape(parent.shape)


def _root_column(root, lead, device):
    return torch.as_tensor(root, device=device).reshape(*lead, 1)


def heights_to_ratios(parent, children, heights, root, n_taxa: int,
                      levels: Optional[List[torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ratios [n_internal] in node-index order, the root's set to 1,
    root height as a 0-d tensor); [B, n_internal] and [B] for a chain
    batch."""
    anchors = subtree_anchors(parent, children, heights[..., :n_taxa],
                              n_taxa, levels)
    m = parent.shape[-1]
    lead = parent.shape[:-1]
    internal = torch.arange(n_taxa, m, device=heights.device)
    span = (torch.gather(heights, -1, parent[..., n_taxa:].clamp_min(0))
            - anchors[..., n_taxa:])
    r = (heights[..., n_taxa:] - anchors[..., n_taxa:]) / torch.where(
        span > 0, span, torch.ones_like(span))
    root1 = _root_column(root, lead, heights.device)
    return (torch.where(internal == root1, torch.ones_like(r), r),
            torch.gather(heights, -1, root1)[..., 0])


def ratios_to_heights(parent, children, tip_heights, ratios, root_height,
                      root, n_taxa: int,
                      levels: Optional[List[torch.Tensor]] = None,
                      anchors: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (heights [n_nodes], log|J| of the ratios -> heights map); [B, M]
    and [B] for a chain batch. `levels` and `anchors` may be passed where
    the caller has them for this topology and these tip heights."""
    levels = levels if levels is not None else internal_levels(parent, n_taxa)
    if anchors is None:
        anchors = subtree_anchors(parent, children, tip_heights, n_taxa,
                                  levels)
    m = parent.shape[-1]
    lead = parent.shape[:-1]
    par = flat_forest(parent, children)[0]
    anchors = anchors.reshape(-1)
    root1 = _root_column(root, lead, tip_heights.device)
    heights = _with_internal(tip_heights, m - n_taxa, 0.0).scatter(
        -1, root1, torch.as_tensor(root_height, dtype=tip_heights.dtype,
                                   device=tip_heights.device).reshape(
                                       *lead, 1)).reshape(-1)
    r = torch.cat([tip_heights.new_zeros((*lead, n_taxa)), ratios],
                  -1).reshape(-1)
    log_span = torch.zeros_like(heights)
    # levels[0] is the roots': their heights are given
    for nodes in levels[1:]:
        span = heights[par[nodes]] - anchors[nodes]
        heights = heights.index_put((nodes,), anchors[nodes] + r[nodes] * span)
        log_span = log_span.index_put((nodes,), torch.log(span))
    return (heights.reshape(parent.shape),
            log_span.reshape(parent.shape).sum(-1))

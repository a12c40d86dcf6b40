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
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from beast_mcmc_tpu_torch.ops.peeling import internal_levels, node_depths

__all__ = ["node_depths", "internal_levels", "subtree_anchors",
           "heights_to_ratios", "ratios_to_heights"]


def _internal_orders(parent: torch.Tensor, n_taxa: int):
    """(top_down, bottom_up) orders over the internal nodes: by depth from
    the root, ties by node index."""
    depth = node_depths(parent)
    top_down = n_taxa + torch.sort(depth[n_taxa:], stable=True).indices
    return top_down, top_down.flip(0)


def subtree_anchors(parent, children, tip_heights, n_taxa: int,
                    levels: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """anchor[node] = the largest tip height in node's subtree (a tip's own
    height), bottom-up a level at a time."""
    levels = levels if levels is not None else internal_levels(parent, n_taxa)
    m = parent.shape[0]
    anchors = torch.cat([tip_heights, tip_heights.new_full(
        (m - n_taxa,), -float("inf"))])
    ch = children.long()
    for nodes in reversed(levels):
        anchors = anchors.index_put((nodes,), torch.maximum(
            anchors[ch[nodes, 0]], anchors[ch[nodes, 1]]))
    return anchors


def heights_to_ratios(parent, children, heights, root, n_taxa: int,
                      levels: Optional[List[torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ratios [n_internal] in node-index order, the root's set to 1,
    root height as a 0-d tensor)."""
    anchors = subtree_anchors(parent, children, heights[:n_taxa], n_taxa,
                              levels)
    m = parent.shape[0]
    internal = torch.arange(n_taxa, m, device=heights.device)
    span = heights[parent[internal].clamp_min(0)] - anchors[internal]
    r = (heights[internal] - anchors[internal]) / torch.where(
        span > 0, span, torch.ones_like(span))
    root1 = torch.as_tensor(root, device=heights.device).reshape(1)
    return (torch.where(internal == root1, torch.ones_like(r), r),
            heights[root1][0])


def ratios_to_heights(parent, children, tip_heights, ratios, root_height,
                      root, n_taxa: int,
                      levels: Optional[List[torch.Tensor]] = None,
                      anchors: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (heights [n_nodes], log|J| of the ratios -> heights map). `levels`
    and `anchors` may be passed where the caller has them for this
    topology and these tip heights."""
    levels = levels if levels is not None else internal_levels(parent, n_taxa)
    if anchors is None:
        anchors = subtree_anchors(parent, children, tip_heights, n_taxa,
                                  levels)
    m = parent.shape[0]
    root1 = torch.as_tensor(root, device=tip_heights.device).reshape(1)
    heights = torch.cat([tip_heights, tip_heights.new_zeros(m - n_taxa)])
    heights = heights.index_put((root1,), torch.as_tensor(
        root_height, dtype=heights.dtype, device=heights.device).reshape(1))
    logj = tip_heights.new_zeros(())
    # levels[0] is the root's alone: its height is given
    for nodes in levels[1:]:
        span = heights[parent[nodes]] - anchors[nodes]
        heights = heights.index_put(
            (nodes,), anchors[nodes] + ratios[nodes - n_taxa] * span)
        logj = logj + torch.sum(torch.log(span))
    return heights, logj

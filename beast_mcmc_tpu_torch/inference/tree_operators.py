"""The subtree slide, a prune-and-regraft move by node height.

Counterpart of beast_mcmc_tpu/inference/tree_operators.py:42-190
(SubtreeSlideOperator.java:89-330): the parent of a random node slides up
or down by delta; where the new height crosses other edges the subtree is
regrafted onto one of them, and the Hastings ratio is the ratio of the
counts of intersected edges. The reference's recursive tree walks are masks
over the flat node arrays, built by pointer doubling (ceil(log2 M) + 1
rounds of gathers or scatters), so no step reads a value on the host; each
of the four cases (no topology change, slide up, slide down, invalid) is
computed and the drawn one selected with torch.where.

On dated tips a slide never puts a node below a child or a tip below its
date: a slide down below the node i is invalid, and a regraft goes only
onto an edge whose lower end lies below the new height.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beast_mcmc_tpu_torch.inference.operators import (
    NEG_INF,
    Operator,
    _uniform,
    other_child,
    replace_child,
    sample_excluding,
)
from beast_mcmc_tpu_torch.tree.topology import TreeState


def _rounds(m: int) -> int:
    return math.ceil(math.log2(max(m, 2))) + 1


def _jumps(parent: torch.Tensor) -> torch.Tensor:
    """parent with a self-loop at the root."""
    ar = torch.arange(parent.shape[0], device=parent.device)
    return torch.where(parent < 0, ar, parent)


def subtree_mask(parent: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """bool[M]: the nodes of the subtree rooted at `top` (int64[1]),
    itself included."""
    q = _jumps(parent)
    reach = torch.arange(parent.shape[0], device=parent.device) == top
    for _ in range(_rounds(parent.shape[0])):
        reach = reach | reach[q]
        q = q[q]
    return reach


def ancestor_mask(parent: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """bool[M]: `node` (int64[1]) and its ancestors up to the root: the
    set is mapped through the 2^k-th ancestor, by scatter, each round."""
    q = _jumps(parent)
    anc = torch.arange(parent.shape[0], device=parent.device) == node
    for _ in range(_rounds(parent.shape[0])):
        hit = torch.zeros_like(q).scatter_add_(0, q, anc.long())
        anc = anc | (hit > 0)
        q = q[q]
    return anc


def intersecting_edges(parent: torch.Tensor, heights: torch.Tensor,
                       smask: torch.Tensor, h) -> torch.Tensor:
    """bool[M]: the edges (parent[n], n) of `smask` that span height h,
    heights[n] < h < heights[parent[n]] (the reference's intersectingEdges,
    SubtreeSlideOperator.java:334-356)."""
    above = torch.where(parent < 0, torch.full_like(heights, math.inf),
                        heights[parent.clamp_min(0)])
    return smask & (heights < h) & (above > h)


def sample_masked(u: torch.Tensor, mask: torch.Tensor):
    """(index int64[1] of the floor(u * count)-th True entry of mask, count)
    for u uniform in [0, 1): uniform over the mask. The index is 0 where
    count is 0; callers gate on count."""
    c = torch.cumsum(mask.long(), 0)
    count = c[-1]
    k = torch.clamp(torch.floor(u * count).long(), max=count - 1)
    return torch.argmax((c == k + 1).long()).reshape(1), count


@dataclasses.dataclass
class SubtreeSlideOperator(Operator):
    """SubtreeSlideOperator.java: delta ~ N(0, size) (gaussian) or
    U(-size/2, size/2); tuning size, adapt value log(size). A tree-only
    proposal."""

    size: float = 1.0
    gaussian: bool = True
    adaptable: bool = True

    modifies_params = ()

    def initial_adapt(self) -> float:
        return math.log(self.size)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        m = tree.parent.shape[0]
        h = tree.heights
        i = sample_excluding(gen, m, tree.root.reshape(1))
        if self.gaussian:
            delta = torch.randn((), generator=gen, dtype=h.dtype,
                                device=h.device) * tuning
        else:
            delta = (_uniform(gen, h) - 0.5) * tuning
        return params, *slide(tree, i, delta.to(h.dtype), _uniform(gen, h))


def slide(tree: TreeState, i: torch.Tensor, delta: torch.Tensor,
          u: torch.Tensor):
    """(tree', log Hastings) of sliding the parent of node i (int64[1]) by
    delta; u picks the edge of a slide down (`sample_masked`). The same
    move and ratio as the JAX package's SubtreeSlideOperator.propose for
    the same i, delta and pick."""
    parent, children, heights, root = (tree.parent, tree.children,
                                       tree.heights, tree.root)
    fdt = heights.dtype
    ip = parent[i]
    cip = other_child(children, ip, i)
    pip = parent[ip]  # -1 where ip is the root
    pip_c = pip.clamp_min(0)
    old_h = heights[ip]
    new_h = old_h + delta
    up = delta > 0
    topo_up = up & (pip >= 0) & (heights[pip_c] < new_h)
    down_invalid = ~up & (new_h < heights[i])
    topo_down = ~up & ~down_invalid & (heights[cip] > new_h)
    h_new = heights.index_put((ip,), new_h)
    zero = torch.zeros((), dtype=fdt, device=heights.device)

    # slide up: the new edge is (parent, child) of the highest ancestor of
    # ip below the new height
    anc = ancestor_mask(parent, ip) & (heights < new_h)
    new_child = torch.argmax(torch.where(anc, heights, -math.inf)).reshape(1)
    new_parent = parent[new_child]
    is_new_root = new_parent < 0
    ch = replace_child(children, ip, cip, new_child)
    ch = replace_child(ch, pip, ip, cip)
    par = parent.index_put((cip,), pip).index_put((new_child,), ip)
    ch_up = torch.where(is_new_root, ch,
                        replace_child(ch, new_parent, new_child, ip))
    par_up = par.index_put((ip,), torch.where(is_new_root, -1, new_parent))
    root_up = torch.where(is_new_root, ip, root).reshape(())
    n_src = torch.sum(intersecting_edges(
        par_up, h_new, subtree_mask(par_up, new_child), old_h))
    logq_up = -torch.log(n_src.to(fdt))

    # slide down: a random edge of cip's subtree that spans the new height
    emask = intersecting_edges(parent, heights, subtree_mask(parent, cip),
                               new_h)
    down_child, count = sample_masked(u, emask)
    new_gp = parent[down_child]
    was_root = pip < 0
    ch = replace_child(children, ip, cip, down_child)
    ch = torch.where(was_root, ch, replace_child(ch, pip, ip, cip))
    ch_down = replace_child(ch, new_gp, down_child, ip)
    par_down = (parent.index_put((cip,), pip).index_put((down_child,), ip)
                .index_put((ip,), new_gp))
    root_down = torch.where(was_root, cip, root).reshape(())
    logq_down = torch.where(count > 0, torch.log(count.to(fdt)),
                            zero + NEG_INF)

    def pick(no_topo, up_v, down_v, invalid):
        out = torch.where(topo_down, down_v, no_topo)
        out = torch.where(topo_up, up_v, out)
        return torch.where(down_invalid, invalid, out)

    new_tree = tree.replace(
        parent=pick(parent, par_up, par_down, parent),
        children=pick(children, ch_up, ch_down, children),
        heights=pick(h_new, h_new, h_new, heights),
        root=pick(root, root_up, root_down, root).reshape(()))
    logq = pick(zero, logq_up, logq_down, zero + NEG_INF).reshape(())
    return new_tree, logq

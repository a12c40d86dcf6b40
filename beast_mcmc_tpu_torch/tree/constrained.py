"""Constrained trees for Thorney BEAST at 10^4 tips and more.

Counterpart of beast_mcmc_tpu/tree/constrained.py
(ConstrainedTreeModel.java:45): a binary time tree whose topology may vary
only inside the polytomies of a multifurcating constraints tree; the
backbone is fixed and every divergence time free. The constraint is a
per-node group label over the flat arrays: the internal nodes that
resolve one polytomy share its group, and a topology move is legal
exactly where the edges it rewires lie inside one group. The host-side
construction (numpy, a numpy Generator) is the JAX package's, number for
number. The operators follow inference/tree_operators.py: a node is
picked by inverting the CDF of one uniform over the eligible nodes (the
JAX package takes the Gumbel-max), the Hastings ratio is |eligible_fwd| /
|eligible_rev|, an invalid move returns the tree it was given, and no
proposal reads a value on the host, so each vmaps over a chain batch.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference.operators import (
    Operator,
    _valid_or_reject,
    other_child,
    replace_child,
)
from beast_mcmc_tpu_torch.inference.tree_operators import (
    _keep_if,
    sample_masked,
)

# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------


def parse_multifurcating_newick(text: str):
    """A minimal multifurcating Newick parser: (names, kids, root), kids a
    list of child lists of the internal nodes in postorder (node n_tips +
    i is kids[i]), tips first in reading order, the root last."""
    text = text.strip().rstrip(";")
    names: List[str] = []
    internal_kids: List[list] = []
    pos = 0

    def parse():
        nonlocal pos
        if text[pos] == "(":
            pos += 1
            ch = [parse()]
            while text[pos] == ",":
                pos += 1
                ch.append(parse())
            if text[pos] != ")":
                raise ValueError(f"expected ) at {pos}")
            pos += 1
            while pos < len(text) and text[pos] not in ",()":
                pos += 1  # an internal label or branch length
            internal_kids.append(ch)
            return ("i", len(internal_kids) - 1)
        start = pos
        while pos < len(text) and text[pos] not in ",():":
            pos += 1
        name = text[start:pos]
        while pos < len(text) and text[pos] not in ",()":
            pos += 1
        names.append(name)
        return ("t", len(names) - 1)

    root = parse()
    n = len(names)
    mapped = [[c[1] if c[0] == "t" else n + c[1] for c in ch]
              for ch in internal_kids]
    return names, mapped, (root[1] if root[0] == "t" else n + root[1])


def build_constrained_tree(newick: str, rng: np.random.Generator,
                           root_height: float = 1.0):
    """A random binary resolution of a multifurcating constraints tree:
    (parent, children, heights, root, groups, names), numpy. groups[node]
    is the group of the polytomy whose resolution made the node (a unique
    group for a tip), so an NNI at node i is legal iff
    groups[parent(i)] == groups[grandparent(i)]. A polytomy is resolved by
    random sequential coalescence of its children at sorted uniform
    heights between its oldest child and its top; each level's top is 0.9
    of its parent's."""
    names, kids, croot = parse_multifurcating_newick(newick)
    n_tips = len(names)
    m = 2 * n_tips - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m)
    groups = np.zeros(m, np.int32)
    next_internal = [n_tips]
    next_group = [0]
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 200000))

    def build(idx, top_height):
        if idx < n_tips:
            groups[idx] = next_group[0]
            next_group[0] += 1
            return idx, 0.0
        ch = kids[idx - n_tips]
        gid = next_group[0]
        next_group[0] += 1
        built = [build(c, top_height * 0.9) for c in ch]
        lo = max(h for _, h in built)
        levels = np.sort(rng.uniform(lo + 1e-9, top_height,
                                     size=len(built) - 1))
        active = list(built)
        for k in range(len(built) - 1):
            i, j = rng.choice(len(active), size=2, replace=False)
            a, b = active[i], active[j]
            node = next_internal[0]
            next_internal[0] += 1
            heights[node] = float(levels[k])
            groups[node] = gid
            children[node] = (a[0], b[0])
            parent[a[0]] = node
            parent[b[0]] = node
            active = [x for t, x in enumerate(active) if t not in (i, j)]
            active.append((node, float(levels[k])))
        return active[0]

    root_id, _ = build(croot, root_height)
    return parent, children, heights, int(root_id), groups, names


def clades_of_constraints(newick: str):
    """The tip-name frozensets of every internal node of the constraints
    tree: what a constrained chain must keep monophyletic."""
    names, kids, _ = parse_multifurcating_newick(newick)
    n_tips = len(names)
    below = {}

    def tips_below(idx):
        if idx < n_tips:
            return frozenset([names[idx]])
        if idx not in below:
            below[idx] = frozenset().union(
                *(tips_below(c) for c in kids[idx - n_tips]))
        return below[idx]

    return [tips_below(n_tips + i) for i in range(len(kids))]


# ---------------------------------------------------------------------------
# constrained operators
# ---------------------------------------------------------------------------


def _eligible_nni_mask(parent: torch.Tensor,
                       groups: torch.Tensor) -> torch.Tensor:
    """bool[M]: node i has a parent and a grandparent of one group (an NNI
    at i rewires only edges inside one polytomy)."""
    ip = parent.clamp_min(0)
    igp = parent[ip]
    return ((parent >= 0) & (igp >= 0)
            & (groups[ip] == groups[igp.clamp_min(0)]))


def _groups_on(op, like: torch.Tensor) -> torch.Tensor:
    """op.groups as int64 on like's device, copied there once."""
    cache = op.__dict__.setdefault("_groups_by_device", {})
    key = str(like.device)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(op.groups), dtype=torch.long,
                                     device=like.device)
    return cache[key]


@dataclasses.dataclass
class ConstrainedNNIOperator(Operator):
    """NNI inside the polytomy-resolution groups (ConstrainedTreeOperator
    .java with UniformSubtreePruneRegraft.java: the same stationary law
    over the constraint-respecting trees): node i uniform over the
    eligible set, swapped with its uncle; Hastings |eligible_fwd| /
    |eligible_rev|; -inf and the tree kept where the uncle is not below
    i's parent or i not below its grandparent."""

    groups: np.ndarray = None
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        groups = _groups_on(self, tree.parent)
        h = tree.heights
        mask = _eligible_nni_mask(tree.parent, groups)
        i, n_fwd = sample_masked(ops._uniform(gen, h), mask)
        ip = tree.parent[i]
        igp = tree.parent[ip]
        uncle = other_child(tree.children, igp, ip)
        valid = (n_fwd > 0) & (h[uncle] < h[ip]) & (h[i] < h[igp])
        parent = tree.parent.index_put((i,), igp).index_put((uncle,), ip)
        children = replace_child(tree.children, ip, i, uncle)
        children = replace_child(children, igp, uncle, i)
        new = tree.replace(parent=parent, children=children)
        n_rev = torch.sum(_eligible_nni_mask(parent, groups))
        logh = (torch.log(n_fwd.to(h.dtype))
                - torch.log(n_rev.clamp_min(1).to(h.dtype)))
        return (params, _keep_if(valid, new, tree),
                _valid_or_reject(valid & (n_rev > 0), logh))


@dataclasses.dataclass
class ConstrainedUniformSPROperator(Operator):
    """Uniform subtree prune and regraft over the branch-length measure
    inside the polytomy-resolution groups (thorney
    UniformSubtreePruneRegraft.java:68-190 with ConstrainedTreeOperator
    .java): node i uniform among those whose parent and grandparent share
    a group; i's parent edge is pruned and regrafted at a uniform point of
    the total length above h_i of the edges whose parent carries that
    group, the point its new height. The pruned tree, i and the group are
    the reverse move's, so the attachment density cancels and the
    Hastings ratio is |eligible_fwd| / |eligible_rev|. All groups equal is
    the unconstrained move."""

    groups: np.ndarray = None
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        groups = _groups_on(self, tree.parent)
        h = tree.heights
        mask_i = _eligible_nni_mask(tree.parent, groups)
        i, n_fwd = sample_masked(ops._uniform(gen, h), mask_i)
        u2 = ops._uniform(gen, h)
        ip = tree.parent[i]
        sib = other_child(tree.children, ip, i)
        gp = tree.parent[ip]
        g = groups[ip.clamp_min(0)]

        # the pruned tree: sib bridged to gp
        p_parent = tree.parent.index_put((sib,), gp)
        p_children = replace_child(tree.children, gp, ip, sib)

        # the segments above h_i on the edges whose parent is in group g,
        # the pruned pair {i, ip} not among them
        px = p_parent.clamp_min(0)
        hp = torch.where(p_parent < 0, torch.full_like(h, -torch.inf), h[px])
        seg_lo = torch.maximum(h[i], h)
        seg = torch.clamp_min(hp - seg_lo, 0.0)
        eligible = (p_parent >= 0) & (groups[px] == g)
        off = torch.zeros_like(i, dtype=torch.bool)
        eligible = eligible.index_put((ip,), off).index_put((i,), off)
        seg = torch.where(eligible, seg, torch.zeros_like(seg))
        total = torch.sum(seg)

        # a uniform point of the total length
        u = u2 * total
        cum = torch.cumsum(seg, 0)
        j = torch.argmax((cum > u).long()).reshape(1)
        new_height = seg_lo[j] + (u - (cum[j] - seg[j]))
        jp = p_parent[j]

        # splice ip into the edge (jp, j) at the new height
        children = replace_child(p_children, jp, j, ip)
        children = replace_child(children, ip, sib, j)
        parent = p_parent.index_put((ip,), jp).index_put((j,), ip)
        heights = h.index_put((ip,), new_height)
        valid = (total > 0) & (n_fwd > 0)
        out = _keep_if(valid, tree.replace(parent=parent, children=children,
                                           heights=heights), tree)
        n_rev = torch.sum(_eligible_nni_mask(out.parent, groups))
        logq = (torch.log(n_fwd.clamp_min(1).to(h.dtype))
                - torch.log(n_rev.clamp_min(1).to(h.dtype)))
        return params, out, _valid_or_reject(valid & (n_rev > 0), logq)

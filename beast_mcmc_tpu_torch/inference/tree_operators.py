"""Tree operators: the subtree slide, leap and jump, fixed-height prune
and regraft, NNI, the node- and tip-height moves and the Gibbs tree moves.

Counterpart of beast_mcmc_tpu/inference/tree_operators.py, every class of
it. The subtree slide (SubtreeSlideOperator.java:89-330): the parent of a
random node slides up or down by delta; where the new height crosses other
edges the subtree is regrafted onto one of them, and the Hastings ratio is
the ratio of the counts of intersected edges. The reference's recursive
tree walks are masks over the flat node arrays, built by pointer doubling
(ceil(log2 M) + 1 rounds of gathers or scatters), so no step reads a value
on the host; each of the four cases (no topology change, slide up, slide
down, invalid) is computed and the drawn one selected with torch.where.
JAX's other walks (the leap's destinations, the jump's MRCA heights) are
pointer doubling too (`lowest_on_chain`), and every move but the Gibbs ones
vmaps over a chain batch. A move that is invalid returns the tree it was
given, so a rejected proposal never hands the posterior a cycle.

On dated tips a slide never puts a node below a child or a tip below its
date: a slide down below the node i is invalid, and a regraft goes only
onto an edge whose lower end lies below the new height.

The Gibbs moves score every candidate tree by the posterior: one
chain-axis posterior call a chunk of candidate trees (one peel launch a
partition on the card), after one host read of the candidate count
(`_GibbsTreeMove`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from beast_mcmc_tpu_torch.inference.mcmc import map_tensors
from beast_mcmc_tpu_torch.inference.operators import (
    NEG_INF,
    Operator,
    _normal,
    _randint,
    _scale_draw,
    _ScaleTuned,
    _uniform,
    _valid_or_reject,
    _zero,
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


# ---------------------------------------------------------------------------
# node and tip heights
# ---------------------------------------------------------------------------


def _internal_non_root(gen, tree: TreeState) -> torch.Tensor:
    """A uniform internal node other than the root, int64[1]."""
    m = tree.parent.shape[0]
    n_taxa = (m + 1) // 2
    r = _randint(gen, 0, m - n_taxa - 1, tree.parent.device) + n_taxa
    return r + (r >= tree.root).long()


@dataclasses.dataclass
class ScaleNodeHeightOperator(_ScaleTuned, Operator):
    """ScaleNodeHeightOperator.java (SCALEALL false): one random internal
    node other than the root scaled by s, inside its (oldest child,
    parent) window; logq = -log s."""

    scale_factor: float = 0.9
    adaptable: bool = True
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        node = _internal_non_root(gen, tree)
        s = _scale_draw(gen, tuning.to(h.dtype))
        new_h = h[node] * s
        lo = torch.amax(h[tree.children[node]], dim=1)
        ok = (new_h > lo) & (new_h < h[tree.parent[node]])
        return (params, tree.replace(heights=h.index_put((node,), new_h)),
                _valid_or_reject(ok, -torch.log(s)))


@dataclasses.dataclass
class RandomWalkNodeHeightOperator(Operator):
    """RandomWalkNodeHeightOperator.java: one random internal node other
    than the root moved by U(-w, w); symmetric, rejected outside its
    (oldest child, parent) window."""

    window: float = 1.0
    adaptable: bool = True
    modifies_params = ()

    def initial_adapt(self) -> float:
        return math.log(self.window)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        node = _internal_non_root(gen, tree)
        new_h = h[node] + (_uniform(gen, h) * 2 - 1) * tuning
        lo = torch.amax(h[tree.children[node]], dim=1)
        ok = (new_h > lo) & (new_h < h[tree.parent[node]])
        return (params, tree.replace(heights=h.index_put((node,), new_h)),
                _valid_or_reject(ok, _zero(tree)))


@dataclasses.dataclass
class TipHeightRandomWalkOperator(Operator):
    """A sampled tip's height (a <leafHeight> parameter) moved by
    U(-w, w); symmetric; rejected, and left as it was, below 0 or at or
    above its parent."""

    tip: int = 0
    window: float = 1.0
    adaptable: bool = True
    modifies_params = ()

    def initial_adapt(self) -> float:
        return math.log(self.window)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        tip = torch.tensor([self.tip], device=h.device)
        h1 = h[tip] + (-tuning + _uniform(gen, h) * (2 * tuning))
        ok = (h1 >= 0.0) & (h1 < h[tree.parent[tip]])
        heights = h.index_put((tip,), torch.where(ok, h1, h[tip]))
        return (params, tree.replace(heights=heights),
                _valid_or_reject(ok, _zero(tree)))


@dataclasses.dataclass
class TipHeightUniformOperator(Operator):
    """A sampled tip's height drawn uniformly on [0, parent height); the
    range depends on the unchanged parent only, so symmetric."""

    tip: int = 0
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        tip = torch.tensor([self.tip], device=h.device)
        h1 = _uniform(gen, h) * h[tree.parent[tip]]
        return (params, tree.replace(heights=h.index_put((tip,), h1)),
                _zero(tree))


@dataclasses.dataclass
class TipHeightScaleOperator(_ScaleTuned, Operator):
    """A sampled tip's height scaled by the BEAST draw s; logq = -log s;
    rejected, and left as it was, at or above its parent."""

    tip: int = 0
    scale_factor: float = 0.75
    adaptable: bool = True
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        tip = torch.tensor([self.tip], device=h.device)
        s = _scale_draw(gen, tuning.to(h.dtype))
        h1 = h[tip] * s
        ok = h1 < h[tree.parent[tip]]
        heights = h.index_put((tip,), torch.where(ok, h1, h[tip]))
        return (params, tree.replace(heights=heights),
                _valid_or_reject(ok, -torch.log(s)))


# ---------------------------------------------------------------------------
# fixed-height prune and regraft
# ---------------------------------------------------------------------------


def _keep_if(valid: torch.Tensor, new: TreeState, old: TreeState) -> TreeState:
    """`new` where the move is valid, else `old`: a rejected move never
    hands the posterior a tree with a cycle."""
    return TreeState(*(torch.where(valid, getattr(new, f),
                                   getattr(old, f)).reshape(
                                       getattr(old, f).shape)
                       for f in ("parent", "children", "heights", "root")))


def _below_root_children(gen, tree: TreeState) -> torch.Tensor:
    """A uniform node other than the root and its two children, int64[1]."""
    root = tree.root.reshape(1)
    return sample_excluding(gen, tree.parent.shape[0],
                            torch.cat([root, tree.children[root][0]]))


def _splice(tree: TreeState, ip, cip, pip, j) -> TreeState:
    """Detach ip (bridging cip to pip) and splice it into the edge
    (parent[j], j), at its own height (FixedHeightSubtreePruneRegraft)."""
    jp = tree.parent[j]
    children = replace_child(tree.children, pip, ip, cip)
    children = replace_child(children, jp, j, ip)
    children = replace_child(children, ip, cip, j)
    parent = (tree.parent.index_put((cip,), pip).index_put((ip,), jp)
              .index_put((j,), ip))
    return tree.replace(parent=parent, children=children)


def _fixed_height_candidates(tree: TreeState, i, ip, cip) -> torch.Tensor:
    """bool[M]: the edges spanning ip's height other than i's and cip's."""
    cand = intersecting_edges(tree.parent, tree.heights,
                              torch.ones_like(tree.parent, dtype=torch.bool),
                              tree.heights[ip])
    return cand.index_put((i,), torch.zeros_like(i, dtype=torch.bool)) \
        .index_put((cip,), torch.zeros_like(cip, dtype=torch.bool))


@dataclasses.dataclass
class FNPROperator(Operator):
    """FNPR.java:63-120: prune the parent of a random node i and regraft it
    at its own height onto a uniformly drawn node's edge where that edge
    spans the height; symmetric, -inf (and the tree kept) where the drawn
    edge does not span it (the reference's retry loop)."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        m = tree.parent.shape[0]
        parent, children, h = tree.parent, tree.children, tree.heights
        root = tree.root.reshape(1)
        i = sample_excluding(gen, m, root)
        ifa = parent[i]
        igf = parent[ifa]
        ibro = other_child(children, ifa, i)
        new_child = _randint(gen, 0, m, h.device)
        ngf = parent[new_child]
        valid = ((ifa != root) & (new_child != root)
                 & (h[new_child] < h[ifa]) & (h[ngf.clamp_min(0)] > h[ifa])
                 & (new_child != ifa) & (ngf != ifa))
        ch = replace_child(children, ifa, ibro, new_child)
        ch = replace_child(ch, igf, ifa, ibro)
        ch = replace_child(ch, ngf, new_child, ifa)
        par = (parent.index_put((ibro,), igf).index_put((new_child,), ifa)
               .index_put((ifa,), ngf))
        new = _keep_if(valid, tree.replace(parent=par, children=ch), tree)
        return params, new, _valid_or_reject(valid, _zero(tree))


@dataclasses.dataclass
class NNIOperator(Operator):
    """NNI.java: a random node whose parent is not the root swaps with its
    uncle; symmetric; invalid where the uncle is not below the node's
    parent or the node not below its grandparent."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        i = _below_root_children(gen, tree)
        ip = tree.parent[i]
        igp = tree.parent[ip]
        uncle = other_child(tree.children, igp, ip)
        valid = (h[uncle] < h[ip]) & (h[i] < h[igp])
        parent = tree.parent.index_put((i,), igp).index_put((uncle,), ip)
        children = replace_child(tree.children, ip, i, uncle)
        children = replace_child(children, igp, uncle, i)
        return (params, tree.replace(parent=parent, children=children),
                _valid_or_reject(valid, _zero(tree)))


@dataclasses.dataclass
class FixedHeightSPROperator(Operator):
    """FixedHeightSubtreePruneRegraftOperator.java:66-133: prune the parent
    edge of a random node i (not the root or its children) and regraft it,
    at its own height, onto a uniform edge spanning that height. The count
    of such edges is kept by the move: symmetric."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        i = _below_root_children(gen, tree)
        return params, *fixed_height_spr(tree, i, _uniform(gen, tree.heights))


def fixed_height_spr(tree: TreeState, i: torch.Tensor, u: torch.Tensor):
    """(tree', log Hastings) of FixedHeightSPROperator for node i and the
    edge pick u (`sample_masked`)."""
    ip = tree.parent[i]
    cip = other_child(tree.children, ip, i)
    pip = tree.parent[ip]
    j, count = sample_masked(u, _fixed_height_candidates(tree, i, ip, cip))
    valid = count > 0
    return (_keep_if(valid, _splice(tree, ip, cip, pip, j), tree),
            _valid_or_reject(valid, _zero(tree)))


# ---------------------------------------------------------------------------
# leaps and jumps
# ---------------------------------------------------------------------------


def lowest_on_chain(parent: torch.Tensor, chain: torch.Tensor) -> torch.Tensor:
    """int64[M]: each node itself where `chain` (bool[M], closed upwards,
    the root in it) holds it, else its lowest ancestor in `chain`, by
    pointer doubling: chain nodes point at themselves, the others at their
    parent, and each round follows the pointer twice."""
    ar = torch.arange(parent.shape[0], device=parent.device)
    ptr = torch.where(chain, ar, _jumps(parent))
    for _ in range(_rounds(parent.shape[0])):
        ptr = ptr[ptr]
    return ptr


def _get_destinations(parent: torch.Tensor, heights: torch.Tensor,
                      node: torch.Tensor, par: torch.Tensor,
                      sib: torch.Tensor, delta: torch.Tensor):
    """SubtreeLeapOperator.java:295-362: the edges at patristic distance
    delta from par = parent(node), as (mask bool[M], insertion height
    [M]). JAX's walk up from par (a while_loop) is a mask here: the
    ancestors of par below h[par] + delta are crossed, a prefix of par's
    ancestor chain, and the walk ends on the highest of them (or par)
    with the height h[par] + delta. Below a crossed ancestor a the walk
    mirrors down a's other side at 2 h[a] - h[par] - delta; a node off
    the chain lies on exactly one such side, that of its lowest ancestor
    on the chain (`lowest_on_chain`). sib's side takes h[par] - delta.
    A destination lies above the node."""
    h = heights
    ar = torch.arange(parent.shape[0], device=parent.device)
    h_above = h[par] + delta
    chain = ancestor_mask(parent, par)
    low = lowest_on_chain(parent, chain)
    crossed = chain & (h < h_above) & (ar != par)
    h_mirror = torch.where(low == par, h[par] - delta, 2.0 * h[low] - h_above)
    side = subtree_mask(parent, sib) | (~chain & crossed[low])
    above = torch.where(parent < 0, torch.full_like(h, math.inf),
                        h[parent.clamp_min(0)])
    mask = side & (h < h_mirror) & (above > h_mirror) & (h_mirror > h[node])
    dest_h = torch.where(mask, h_mirror, torch.zeros_like(h))
    end = torch.argmax(torch.where(crossed | (ar == par), h,
                                   -math.inf)).reshape(1)
    mask = mask.index_put((end,), torch.ones_like(end, dtype=torch.bool))
    return mask, dest_h.index_put((end,), h_above)


def mrca_heights_from(parent: torch.Tensor, heights: torch.Tensor,
                      a: torch.Tensor) -> torch.Tensor:
    """heights[MRCA(a, x)] for every node x (a int64[1]): x itself on a's
    ancestor chain, else x's lowest ancestor on it. JAX walks the chain in
    M sequential steps (a fori_loop); here it is `ancestor_mask` and
    `lowest_on_chain`, ceil(log2 M) + 1 rounds each, with the same
    result."""
    return heights[lowest_on_chain(parent, ancestor_mask(parent, a))]


def leap(tree: TreeState, node: torch.Tensor, delta: torch.Tensor,
         u: torch.Tensor, tip: bool = False):
    """(tree', log Hastings) of SubtreeLeapOperator (TipLeapOperator with
    `tip`: the new parent height above the tip) for node (int64[1]), the
    distance delta and the destination pick u (`sample_masked`); the same
    move and ratio as the JAX package's for the same node, delta and
    pick."""
    parent, children, heights, root = (tree.parent, tree.children,
                                       tree.heights, tree.root)
    par = parent[node]
    sib = other_child(children, par, node)
    gp = parent[par]  # -1 where par is the root
    dmask, dh = _get_destinations(parent, heights, node, par, sib, delta)
    if tip:
        dmask = dmask & (dh > heights[node])
    j, count = sample_masked(u, dmask)
    new_h = dh[j]
    jp = parent[j]
    no_topo = (j == par) | (jp == par)
    # detach: sib takes par's place (or becomes the root); attach par on the
    # edge (jp, j), or above the root where j is the root
    ch = replace_child(children, gp, par, sib)
    ch = replace_child(ch, par, sib, j)
    ch = replace_child(ch, jp, j, par)
    par_arr = (parent.index_put((sib,), gp).index_put((j,), par)
               .index_put((par,), jp))
    rt = torch.where(jp < 0, par, torch.where(gp < 0, sib, root)).reshape(())
    valid = count > 0
    if tip:
        valid = valid & (new_h > heights[node]).reshape(())
        new_h = torch.maximum(new_h, heights[node])
    keep = no_topo | ~valid
    moved = tree.replace(
        parent=torch.where(keep, parent, par_arr),
        children=torch.where(keep, children, ch),
        heights=heights.index_put((par,), new_h),
        root=torch.where(keep, root, rt).reshape(()))
    new_tree = _keep_if(valid, moved, tree)
    sib_new = other_child(new_tree.children, par, node)
    rmask, rh = _get_destinations(new_tree.parent, new_tree.heights, node, par,
                                  sib_new, delta)
    if tip:
        rmask = rmask & (rh > new_tree.heights[node])
    rcount = torch.sum(rmask)
    fdt = heights.dtype
    logq = torch.log(count.to(fdt)) - torch.log(rcount.to(fdt))
    return new_tree, torch.where(valid, logq, logq.new_full((), NEG_INF))


@dataclasses.dataclass
class SubtreeLeapOperator(Operator):
    """SubtreeLeapOperator.java: prune parent(node) and regraft it at
    patristic distance delta = |N(0, size)|, uniformly among the
    destination edges; Hastings |D| / |D'|. Adapt value log(size)."""

    size: float = 1.0
    adaptable: bool = True
    target_acceptance: float = 0.225
    modifies_params = ()

    def initial_adapt(self) -> float:
        return math.log(self.size)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        delta = torch.abs(_normal(gen, h)) * tuning
        node = sample_excluding(gen, tree.parent.shape[0],
                                tree.root.reshape(1))
        return params, *leap(tree, node, delta.to(h.dtype), _uniform(gen, h))


@dataclasses.dataclass
class TipLeapOperator(Operator):
    """TipLeapOperatorParser: the subtree leap of a tip drawn from `tips`
    (all n_tips tips where empty), its new parent above it."""

    size: float = 1.0
    tips: tuple = ()
    n_tips: int = 0
    adaptable: bool = True
    target_acceptance: float = 0.225
    modifies_params = ()

    def initial_adapt(self) -> float:
        return math.log(self.size)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        delta = torch.abs(_normal(gen, h)) * tuning
        pool = torch.tensor(list(self.tips) or list(range(self.n_tips)),
                            device=h.device)
        node = pool[_randint(gen, 0, pool.shape[0], h.device)]
        return params, *leap(tree, node, delta.to(h.dtype), _uniform(gen, h),
                             tip=True)


def categorical_pick(u: torch.Tensor, logw: torch.Tensor) -> torch.Tensor:
    """int64[1]: the index whose share of softmax(logw) holds u (uniform in
    [0, 1)) by the inverse CDF; 0 where every weight is 0."""
    w = torch.exp(logw - torch.amax(logw))
    c = torch.cumsum(torch.nan_to_num(w), 0)
    return torch.argmax((c > u * c[-1]).long()).reshape(1)


@dataclasses.dataclass
class SubtreeJumpOperator(Operator):
    """SubtreeJumpOperator.java:82-175: prune the parent edge of node i
    (not the root or its children) and regraft it at its own height onto
    an edge spanning that height, drawn with weight Cauchy(h_MRCA(iP, j) -
    h_iP; scale size) (`uniform`: equal weights); Hastings log P(reverse
    pick = old sibling) - log P(forward pick). As in the JAX package the
    Cauchy weights are the intended ones (the reference normalises a
    zero-filled array)."""

    size: float = 1.0
    uniform: bool = False
    adaptable: bool = True
    modifies_params = ()

    def initial_adapt(self) -> float:
        return math.log(self.size)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def _log_weights(self, parent, heights, ip, height, cand, size):
        if self.uniform:
            logw = torch.zeros_like(heights)
        else:
            d = mrca_heights_from(parent, heights, ip) - height
            logw = -torch.log1p(torch.square(d / size))
        return torch.where(cand, logw, torch.full_like(logw, NEG_INF))

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        size = (tuning if self.adaptable
                else torch.tensor(self.size, dtype=h.dtype, device=h.device))
        i = _below_root_children(gen, tree)
        return params, *self.jump(tree, i, _uniform(gen, h), size)

    def jump(self, tree: TreeState, i: torch.Tensor, u: torch.Tensor, size):
        """(tree', log Hastings) for node i and the edge pick u
        (`categorical_pick`)."""
        h = tree.heights
        ip = tree.parent[i]
        cip = other_child(tree.children, ip, i)
        pip = tree.parent[ip]
        height = h[ip]
        cand = _fixed_height_candidates(tree, i, ip, cip)
        logw = self._log_weights(tree.parent, h, ip, height, cand, size)
        j = categorical_pick(u, logw)
        log_forward = torch.log_softmax(logw, 0)[j]
        valid = torch.any(cand)
        new_tree = _keep_if(valid, _splice(tree, ip, cip, pip, j), tree)
        # reverse: the same height in the new tree, the pick the old sibling
        cand2 = _fixed_height_candidates(new_tree, i, ip, j)
        logw2 = self._log_weights(new_tree.parent, h, ip, height, cand2, size)
        log_reverse = torch.log_softmax(logw2, 0)[cip]
        logq = (log_reverse - log_forward).reshape(())
        return new_tree, torch.where(valid, logq, logq.new_full((), NEG_INF))


# ---------------------------------------------------------------------------
# Gibbs tree moves: every candidate tree scored by the posterior
# ---------------------------------------------------------------------------

# A chunk of candidate trees is scored in one chain-axis posterior call (one
# peel launch a partition on the card). On the card a chunk is the largest
# count of trees whose footprint fits CHUNK_MEMORY_SHARE of the card's
# memory: the footprint of a tree is read from the allocator's peak while
# the current trees are scored (at Makona mostly the peel's partials
# scratch, 1,609 x 4 x 4 x 2,048 x 8 B = 422 MB a tree). On the CPU a chunk
# is CPU_CHUNK trees.
CHUNK_MEMORY_SHARE = 0.25
CPU_CHUNK = 3


def _rows_replace_child(children, rows, node, old, new):
    """replace_child on row r of a tree batch children [K, M, 2], each row
    at its own node, old and new ([K] each)."""
    row = children[rows, node]
    row = torch.where(row == old[:, None], new[:, None], row)
    return children.index_put((rows, node), row)


def _rows_regraft(parent, children, ip, cip, pip, j):
    """`_splice` on each row of a tree batch ([K, M], [K, M, 2]; the nodes
    [K])."""
    rows = torch.arange(parent.shape[0], device=parent.device)
    jp = parent[rows, j]
    children = _rows_replace_child(children, rows, pip, ip, cip)
    children = _rows_replace_child(children, rows, jp, j, ip)
    children = _rows_replace_child(children, rows, ip, cip, j)
    parent = (parent.index_put((rows, cip), pip).index_put((rows, ip), jp)
              .index_put((rows, j), ip))
    return parent, children


def _rows_swap(parent, children, a, b):
    """Swap the subtrees a and b ([K]) in each row of a tree batch."""
    rows = torch.arange(parent.shape[0], device=parent.device)
    ap, bp = parent[rows, a], parent[rows, b]
    parent = parent.index_put((rows, a), bp).index_put((rows, b), ap)
    children = _rows_replace_child(children, rows, ap, a, b)
    children = _rows_replace_child(children, rows, bp, b, a)
    return parent, children


def _gather_nodes(x, nodes):
    """x [B, M] at one node a row (nodes [B]): [B]."""
    return torch.gather(x, 1, nodes[:, None])[:, 0]


def _chain_randint(gen, high: int, b_n: int, device) -> torch.Tensor:
    """int64[B] uniform in [0, high): one draw a chain."""
    return torch.randint(0, high, (b_n,), generator=gen, device=device)


def _sample_excluding_rows(gen, m: int, ex: torch.Tensor) -> torch.Tensor:
    """sample_excluding for each row of ex [B, k]: int64[B]."""
    r = _chain_randint(gen, m - ex.shape[1], ex.shape[0], ex.device)
    ex = torch.sort(ex, dim=1).values
    for k in range(ex.shape[1]):
        r = r + (r >= ex[:, k]).long()
    return r


def _chain_uniforms(gen, like: torch.Tensor, b_n: int) -> torch.Tensor:
    """[B] uniform in [0, 1): one draw a chain."""
    return torch.rand(b_n, generator=gen, dtype=like.dtype, device=like.device)


def _log_probs(scores: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """log softmax of each row of scores [B, M] (-inf off the candidates)
    at its own column j [B]."""
    return _gather_nodes(scores, j) - torch.logsumexp(scores, dim=1)


def _pick_rows(scores: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """`categorical_pick` on each row of scores [B, M]: int64[B]."""
    w = torch.exp(scores - torch.amax(scores, dim=1, keepdim=True))
    c = torch.cumsum(torch.nan_to_num(w), 1)
    return torch.argmax((c > u[:, None] * c[:, -1:]).long(), dim=1)


def _device_key(device: torch.device) -> str:
    """The device's name with its index ("cuda" is the current card)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


class _GibbsTreeMove:
    """A tree move that scores its candidate trees by the posterior, bound
    as the samplers of inference/hmc.py are: the proposal is written once
    over a chain batch (`_propose(lp_chains, params, tree, gen)`, params
    and tree with a leading chain axis). `propose` runs it on the batch of
    one and `propose_chains` on the batch. Every tree is scored by a
    chain-axis posterior: the one `make_multichain_step` binds
    (bind_log_posterior_chains), or for one chain `log_posterior_chains`
    given at construction (`Analysis.log_posterior_chains`,
    build_analysis's aux["log_post_chains"]).

    A proposal first scores the current trees of its chains, one batch,
    then each enumeration's candidates, read on the host once to size the
    batch, as flat (chain, candidate) pairs in chunks (`_score`). Only the
    candidates are scored; JAX scores all M nodes and weighs the others 0.
    `last_calls` holds the posterior calls of the last proposal and
    `total_calls` those since construction, `last_candidates` each
    enumeration's count and `last_scores` each enumeration's scores [B, M]
    (-inf off its candidates); `candidate_tree(e, b, j)` rebuilds the tree
    that enumeration e of the last proposal scored for chain b at node j."""

    modifies_params = ()
    _log_posterior_chains = None
    _chunks = None
    last_candidates = ()
    last_scores = ()
    last_calls = 0
    total_calls = 0
    _enumerations = ()

    def bind_log_posterior(self, log_posterior):
        """make_mcmc_step's binding of the one-chain posterior, which the
        scoring does not use: it needs a chain-axis one."""

    def bind_log_posterior_chains(self, log_posterior_chains):
        self._log_posterior_chains = log_posterior_chains

    def chunk(self, device) -> int:
        """Trees a posterior call of this operator scores on `device` (on
        the card known after its first proposal there)."""
        device = torch.device(device)
        if device.type != "cuda":
            return CPU_CHUNK
        return (self._chunks or {})[_device_key(device)]

    def propose(self, params, tree, gen, tuning):
        lp = self.log_posterior_chains or self._log_posterior_chains
        if lp is None:
            raise ValueError(f"{type(self).__name__} scores its candidates "
                             "with a chain-axis posterior: give "
                             "log_posterior_chains")
        one = map_tensors(lambda t: t[None], (params, tree))
        out = self._propose(lp, *one, gen)
        return map_tensors(lambda t: t[0], out)

    def propose_chains(self, params, tree, gen, tuning):
        lp = self._log_posterior_chains
        assert lp is not None, f"{type(self).__name__} not bound"
        return self._propose(lp, params, tree, gen)

    def _current(self, lp, params, tree):
        """The posterior of the current trees [B]; on the card the first
        call also reads the footprint of a tree off the allocator's peak
        and sets this device's chunk from it."""
        dev = tree.heights.device
        self.last_calls, self.last_candidates, self.last_scores = 1, [], []
        self._enumerations = []
        self.total_calls += 1
        if dev.type != "cuda" or _device_key(dev) in (self._chunks or {}):
            return lp(params, tree)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = lp(params, tree)
        per_tree = max(torch.cuda.max_memory_allocated(dev) - base, 1) \
            / tree.parent.shape[0]
        total = torch.cuda.get_device_properties(dev).total_memory
        self._chunks = {**(self._chunks or {}), _device_key(dev): max(
            1, int(CHUNK_MEMORY_SHARE * total // per_tree))}
        return out

    def _score(self, lp, params, tree, cand, surgery):
        """scores [B, M]: the posterior of each candidate tree at its node,
        -inf elsewhere. cand [B, M] marks the candidates (read on the host
        once); surgery(parent [K, M], children [K, M, 2], rows [K], j [K])
        -> (parent, children) makes the candidate trees of chains `rows`
        at nodes j. The pairs go in chunks of `chunk` trees, each one
        posterior call with each tree's chain's params."""
        pairs = torch.nonzero(cand)
        self.last_candidates.append(pairs.shape[0])
        self._enumerations.append((tree, surgery))
        size = self.chunk(tree.heights.device)
        scores = []
        for s in range(0, pairs.shape[0], size):
            rows, j = pairs[s:s + size, 0], pairs[s:s + size, 1]
            parent, children = surgery(tree.parent[rows], tree.children[rows],
                                       rows, j)
            trees = TreeState(parent, children, tree.heights[rows],
                              tree.root[rows])
            scores.append(lp(map_tensors(lambda v: v[rows], params), trees))
            self.last_calls += 1
            self.total_calls += 1
        out = torch.full(cand.shape, NEG_INF, dtype=tree.heights.dtype,
                         device=tree.heights.device)
        if scores:
            out = out.index_put((pairs[:, 0], pairs[:, 1]),
                                torch.cat(scores).to(out.dtype))
        self.last_scores.append(out)
        return out

    def candidate_tree(self, e: int, b: int, j: int) -> TreeState:
        """The tree enumeration e of the last proposal scored for chain b
        at node j (one tree, no chain axis)."""
        tree, surgery = self._enumerations[e]
        rows = torch.tensor([b], device=tree.parent.device)
        parent, children = surgery(tree.parent[rows], tree.children[rows],
                                   rows, torch.tensor([j], device=rows.device))
        return TreeState(parent[0], children[0], tree.heights[b],
                         tree.root[b])


@dataclasses.dataclass
class GibbsPruneAndRegraftOperator(_GibbsTreeMove, Operator):
    """GibbsPruneAndRegraft.java:81-158: prune the parent edge of node i
    (not the root or its children) and regraft it at its own height onto
    an edge j spanning that height, drawn with probability proportional to
    the posterior of the regrafted tree. Hastings (:148-155)
      log( (back / (sum - fwd + back)) / (fwd / sum) ),
    back the current tree's posterior, here in log space."""

    log_posterior_chains: Optional[Callable] = None

    def _propose(self, lp, params, tree, gen):
        b_n = tree.parent.shape[0]
        rows = torch.arange(b_n, device=tree.parent.device)
        ex = torch.cat([tree.root[:, None], tree.children[rows, tree.root]],
                       1)
        i = _sample_excluding_rows(gen, tree.parent.shape[1], ex)
        u = _chain_uniforms(gen, tree.heights, b_n)
        ip = _gather_nodes(tree.parent, i)
        cip = torch.where(tree.children[rows, ip, 0] == i,
                          tree.children[rows, ip, 1],
                          tree.children[rows, ip, 0])
        pip = _gather_nodes(tree.parent, ip)
        back = self._current(lp, params, tree).to(tree.heights.dtype)
        return (params, *self.regraft(lp, params, tree, i, ip, cip, pip, u,
                                      back))

    def regraft(self, lp, params, tree, i, ip, cip, pip, u, back):
        """(tree', log Hastings [B]) for nodes i [B], the pick u [B] and
        the current trees' posterior back [B]."""
        h = tree.heights
        height = _gather_nodes(h, ip)
        above = torch.where(tree.parent < 0, torch.full_like(h, math.inf),
                            torch.gather(h, 1, tree.parent.clamp_min(0)))
        cand = (h < height[:, None]) & (above > height[:, None])
        rows = torch.arange(h.shape[0], device=h.device)
        cand = cand.index_put((rows, i), torch.zeros_like(i, dtype=torch.bool))
        cand = cand.index_put((rows, cip),
                              torch.zeros_like(i, dtype=torch.bool))
        scores = self._score(
            lp, params, tree, cand,
            lambda par, ch, r, j: _rows_regraft(par, ch, ip[r], cip[r],
                                                pip[r], j))
        j = _pick_rows(scores, u)
        offset = torch.amax(scores, dim=1)
        fwd = torch.exp(_gather_nodes(scores, j) - offset)
        total = torch.sum(torch.exp(scores - offset[:, None]), dim=1)
        log_fwd = torch.log(fwd) - torch.log(total)
        log_back = back - torch.logaddexp(offset + torch.log(total - fwd),
                                          back)
        valid = torch.any(cand, dim=1)
        parent, children = _rows_regraft(tree.parent, tree.children, ip, cip,
                                         pip, j)
        new = TreeState(torch.where(valid[:, None], parent, tree.parent),
                        torch.where(valid[:, None, None], children,
                                    tree.children), h, tree.root)
        logq = torch.where(valid, log_back - log_fwd,
                           torch.full_like(back, NEG_INF))
        return new, logq


def _partner_mask(parent, heights, a, root):
    """bool [B, M]: the swap partners of node a [B] in each tree
    (GibbsSubtreeSwap.java `wide`): distinct parents, neither the other's
    parent, each below the other's parent; not a, not the root."""
    ar = torch.arange(parent.shape[1], device=parent.device)[None]
    apar = _gather_nodes(parent, a)[:, None]
    h = heights
    h_jp = torch.gather(h, 1, parent.clamp_min(0))
    return ((ar != a[:, None]) & (ar != root[:, None]) & (parent != apar)
            & (ar != apar) & (parent != a[:, None])
            & (h < torch.gather(h, 1, apar))
            & (_gather_nodes(h, a)[:, None] < h_jp))


@dataclasses.dataclass
class GibbsSubtreeSwapOperator(_GibbsTreeMove, Operator):
    """GibbsSubtreeSwap.java:96-160 `wide`: node i (not the root) swaps
    with a partner j drawn with probability proportional to the posterior
    of the swapped tree; Hastings the ratio of the reverse pick's (j again,
    among i's partners in the new tree) and the forward pick's Gibbs
    probabilities. The reverse enumeration's tree at j is the current one:
    its score is the current trees' and the others are scored."""

    log_posterior_chains: Optional[Callable] = None

    def _propose(self, lp, params, tree, gen):
        b_n, m = tree.parent.shape
        i = _sample_excluding_rows(gen, m, tree.root[:, None])
        u = _chain_uniforms(gen, tree.heights, b_n)
        current = self._current(lp, params, tree).to(tree.heights.dtype)
        return (params, *self.swap(lp, params, tree, i, u, current))

    def swap(self, lp, params, tree, i, u, current):
        """(tree', log Hastings [B]) for nodes i [B], the pick u [B] and
        the current trees' posterior [B]."""
        rows = torch.arange(tree.parent.shape[0], device=tree.parent.device)

        def swapped(par, ch, r, j):
            return _rows_swap(par, ch, i[r], j)

        cand = _partner_mask(tree.parent, tree.heights, i, tree.root)
        scores = self._score(lp, params, tree, cand, swapped)
        j = _pick_rows(scores, u)
        valid = torch.any(cand, dim=1)
        parent, children = _rows_swap(tree.parent, tree.children, i, j)
        new = TreeState(torch.where(valid[:, None], parent, tree.parent),
                        torch.where(valid[:, None, None], children,
                                    tree.children), tree.heights, tree.root)
        cand_b = _partner_mask(new.parent, new.heights, i, tree.root)
        cand_b = cand_b.index_put((rows, j),
                                  torch.zeros_like(j, dtype=torch.bool))
        scores_b = self._score(lp, params, new, cand_b, swapped)
        scores_b = scores_b.index_put((rows, j), current)
        self.last_scores[-1] = scores_b
        logq = _log_probs(scores_b, j) - _log_probs(scores, j)
        return new, torch.where(valid, logq, torch.full_like(logq, NEG_INF))

"""Ancestral recombination graph (ARG) models.

Counterpart of beast_mcmc_tpu/models/arg.py (ARGModel.java, ARGTree.java,
likelihood/ARGLikelihood.java, coalescent/ARGCoalescentLikelihood.java
:220-253). The ARG is flat arrays of fixed capacity (n tips, n - 1 + 2R
internal slots for at most R reassortment events) with an `active` mask,
two parents for each reassortment node and a side bit for each partition.

A partition's likelihood peels the whole graph: each node's effective
parent for partition p picks its left or right parent by the side bit,
and a node with one effective child (a reassortment, a pass-through
coalescence) or none (an inactive slot) peels against an all-ones dummy
child: P 1 = 1 for a row-stochastic P, so these are exact no-ops, and the
root frequencies being stationary, the grand root's likelihood is the
marginal root's. The dummies are tips: 2R of them after the real tips
(one would do; 2R make the graph's node count 2 N - 1 of a binary tree,
N = n + 2R, which the peel kernels take), the internal slots after
them.

On a CUDA device the peel goes through the kernels
(ops/cuda_peeling.py::peel_site_loglik_auto, the deep one where
peel_route says so) by levels from `schedule_from_levels`: the active
internal nodes at their depth from the grand root by the effective
parents (each child one level below its parent), the inactive slots, whose
children are dummies alone, in the deepest level, so that the grand root
is alone in the last. On the CPU it is the node-by-node plain peel, the
active internal nodes by height after the inactive slots (the JAX package
peels those last; the plain peel here reads the root's partials at the
last node); `levels=True` takes the level route there too (its plain
version).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference.tree_operators import sample_masked
from beast_mcmc_tpu_torch.ops import peeling
from beast_mcmc_tpu_torch.ops.cuda_peeling import (
    peel_route,
    peel_site_loglik_auto,
)
from beast_mcmc_tpu_torch.ops.cuda_stream import schedule_from_levels
from beast_mcmc_tpu_torch.ops.cuda_stream2 import peel_site_loglik_deep
from beast_mcmc_tpu_torch.ops.peeling import node_depths, peel_site_loglik


@dataclasses.dataclass(frozen=True)
class ARGState:
    """A fixed-capacity ARG, M = n + (n - 1) + 2 max_reassort slots.

    parent_left  int64[M]: the primary parent (-1 at the grand root and
                 the inactive slots)
    parent_right int64[M]: a reassortment node's second parent;
                 parent_left elsewhere
    children     int64[M, 2]: the structural children (-1 padded; a
                 reassortment node has one)
    heights      [M]
    side         bool[M, P]: a reassortment node routes partition p to
                 parent_right iff side[i, p]
    is_reassort  bool[M]
    active       bool[M]
    root         int64 0-d
    """

    parent_left: torch.Tensor
    parent_right: torch.Tensor
    children: torch.Tensor
    heights: torch.Tensor
    side: torch.Tensor
    is_reassort: torch.Tensor
    active: torch.Tensor
    root: torch.Tensor

    def replace(self, **kw) -> "ARGState":
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.parent_left.shape[0]


def arg_from_tree(parent: torch.Tensor, children: torch.Tensor,
                  heights: torch.Tensor, root, n_partitions: int,
                  max_reassort: int) -> ARGState:
    """A binary tree (2n - 1 nodes) in ARG arrays with max_reassort
    events' inactive spare slots (two an event)."""
    dev = heights.device
    m0 = parent.shape[0]
    extra = 2 * max_reassort
    m = m0 + extra
    pl = torch.cat([parent.long(), torch.full((extra,), -1, device=dev)])
    return ARGState(
        parent_left=pl, parent_right=pl.clone(),
        children=torch.cat([children.long(),
                            torch.full((extra, 2), -1, device=dev)]),
        heights=torch.cat([heights, torch.zeros(extra, dtype=heights.dtype,
                                                device=dev)]),
        side=torch.zeros((m, n_partitions), dtype=torch.bool, device=dev),
        is_reassort=torch.zeros(m, dtype=torch.bool, device=dev),
        active=torch.cat([torch.ones(m0, dtype=torch.bool, device=dev),
                          torch.zeros(extra, dtype=torch.bool, device=dev)]),
        root=torch.as_tensor(root, device=dev).long().reshape(()))


def effective_parent(arg: ARGState, partition: int) -> torch.Tensor:
    """int64[M]: each node's parent on partition p's marginal genealogy;
    -1 at the grand root and the inactive slots."""
    p = torch.where(arg.is_reassort & arg.side[:, partition],
                    arg.parent_right, arg.parent_left)
    return torch.where(arg.active, p, torch.full_like(p, -1))


def _children_from_parents(eff_parent: torch.Tensor,
                           dummy: int) -> torch.Tensor:
    """int64[M + 1, 2] children from an effective-parent vector, the
    children of a node in index order: parentless nodes scatter into a
    trash row M, and a missing child slot holds the dummy."""
    m = eff_parent.shape[0]
    par = torch.where(eff_parent >= 0, eff_parent, m)
    srt = torch.sort(par, stable=True)
    first = torch.searchsorted(srt.values, srt.values, side="left")
    slot = torch.clamp(torch.arange(m, device=par.device) - first, 0, 1)
    children = torch.full((m + 1, 2), dummy, dtype=torch.long,
                          device=par.device)
    return children.index_put((srt.values, slot), srt.indices)


def _partition_graph(arg: ARGState, partition: int, n_tips: int):
    """The peel's graph of partition p: (parent, children, remap) over
    the n tips, the 2R dummies and the M - n internal slots; remap maps
    an ARG node to its index there."""
    m = arg.capacity
    n_dummy = m - (2 * n_tips - 1)
    dev = arg.heights.device
    ar = torch.arange(m, device=dev)
    remap = ar + torch.where(ar >= n_tips, n_dummy, 0)
    eff = effective_parent(arg, partition)
    parent = torch.full((m + n_dummy,), -1, dtype=torch.long, device=dev)
    parent[remap] = torch.where(eff >= 0, remap[eff.clamp_min(0)], eff)
    children = _children_from_parents(parent, n_tips)[:m + n_dummy]
    return eff, parent, children, remap


def arg_partition_site_loglik(arg: ARGState, partition: int,
                              tip_partials: torch.Tensor, transition_fn,
                              freqs: torch.Tensor,
                              category_weights: torch.Tensor,
                              levels: Optional[bool] = None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] of partition p's marginal
    genealogy, by peeling the whole graph with all-ones dummies (the
    module docstring; ARGLikelihood.java over ARGTree(partition)).
    tip_partials [n, S, P]; transition_fn maps the branch lengths [M] to
    matrices [M, C, S, S]; freqs must be stationary. `levels` (default:
    a CUDA tensor, outside ops/peeling.py::autograd_peel) takes the
    kernels' level route."""
    n_tips, s, npat = tip_partials.shape
    m = arg.capacity
    n_dummy = m - (2 * n_tips - 1)
    dev = tip_partials.device
    eff, parent, children, remap = _partition_graph(arg, partition, n_tips)
    t = torch.where(eff >= 0, arg.heights[eff.clamp_min(0)] - arg.heights,
                    torch.zeros_like(arg.heights)).clamp_min(0.0)
    p_mats = transition_fn(t)  # [M, C, S, S]
    c = p_mats.shape[1]
    p_new = torch.eye(s, dtype=p_mats.dtype, device=dev).expand(
        m + n_dummy, c, s, s).clone()
    p_new[remap] = p_mats
    tips = torch.cat([tip_partials, torch.ones(
        (n_dummy, s, npat), dtype=tip_partials.dtype, device=dev)])
    root = remap[arg.root.reshape(1)][0]
    n_all = n_tips + n_dummy
    active = torch.zeros(m + n_dummy, dtype=torch.bool, device=dev)
    active[remap] = arg.active
    if levels is None:
        levels = tip_partials.is_cuda and peeling._ADJOINT_PEEL
    if not levels:
        # the inactive slots first: the plain peel's root is its last node
        heights = torch.full((m + n_dummy,), -math.inf,
                             dtype=arg.heights.dtype, device=dev)
        heights[remap] = torch.where(arg.active, arg.heights,
                                     torch.full_like(arg.heights, -math.inf))
        order = torch.sort(heights[n_all:], stable=True).indices + n_all
        return peel_site_loglik(tips, children, order, root, p_new, freqs,
                                category_weights)
    act = active[n_all:]
    d = node_depths(parent)[n_all:]
    top = torch.amax(torch.where(act, d, torch.zeros_like(d)))
    lvl = torch.where(act, top - d, torch.zeros_like(d))
    schedule = schedule_from_levels(children, n_all, lvl)
    if peel_route(m + n_dummy, c, s, p_new.element_size()) == "deep":
        return peel_site_loglik_deep(tips, children, None, root, p_new, freqs,
                                     category_weights, schedule)
    return peel_site_loglik_auto(tips, children, schedule[0], root, p_new,
                                 freqs, category_weights, schedule)


def arg_loglikelihood(arg: ARGState, tip_partials_per_partition,
                      pattern_weights_per_partition, transition_fn, freqs,
                      category_weights,
                      levels: Optional[bool] = None) -> torch.Tensor:
    """The ARG's data log-likelihood: the sum over partitions of each
    marginal genealogy's, pattern-weighted in float64 (one ARGLikelihood
    a partition in a CompoundLikelihood)."""
    total = torch.zeros((), dtype=torch.float64, device=arg.heights.device)
    for p, (tips, w) in enumerate(zip(tip_partials_per_partition,
                                      pattern_weights_per_partition)):
        site = arg_partition_site_loglik(arg, p, tips, transition_fn, freqs,
                                         category_weights, levels)
        total = total + torch.dot(w.to(torch.float64),
                                  site.to(torch.float64))
    return total


# ---------------------------------------------------------------------------
# the coalescent with recombination
# ---------------------------------------------------------------------------


def arg_coalescent_loglik(arg: ARGState, n_taxa: int, pop_size,
                          recombination_rate) -> torch.Tensor:
    """The interval density of the coalescent with recombination
    (ARGCoalescentLikelihood.calculateLogLikelihood:220-253): with k
    lineages the event rate is k (k - 1 + rho) / (2 N); a coalescence
    multiplies by (k - 1) / (k - 1 + rho) / C(k, 2) and removes a lineage,
    a reassortment by rho / (k - 1 + rho) / k and adds one; -inf unless
    one lineage is left. The events in height order, k before each the
    cumulative sum of the lineage changes (JAX scans them)."""
    dt = arg.heights.dtype
    dev = arg.heights.device
    rho = torch.as_tensor(recombination_rate, dtype=dt, device=dev)
    n0 = torch.as_tensor(pop_size, dtype=dt, device=dev)
    m = arg.capacity
    is_tip = torch.arange(m, device=dev) < n_taxa
    ev = arg.active
    delta = torch.where(is_tip | arg.is_reassort, 1, -1)
    h = torch.where(ev, arg.heights, torch.full_like(arg.heights, math.inf))
    srt = torch.sort(h, stable=True)
    t, order = srt.values, srt.indices
    ev_s = ev[order]
    d_s = torch.where(ev_s, delta[order], 0)
    typ = torch.where(~ev_s, 0, torch.where(is_tip[order], 1, torch.where(
        arg.is_reassort[order], 2, 3)))
    k = torch.cumsum(d_s, 0) - d_s  # lineages before each event
    kf = k.to(dt)
    fin = torch.isfinite(t)
    t_prev = torch.cat([torch.zeros(1, dtype=dt, device=dev), t[:-1]])
    length = torch.where(fin, t - t_prev, torch.zeros_like(t))
    rate = kf * (kf - 1.0 + rho) / (2.0 * n0)
    zero = torch.zeros_like(rate)
    ll = torch.where((typ > 0) & (k > 0), -rate * length, zero)
    # the event terms; the masked-out entries take safe arguments
    kc = torch.where(typ >= 2, kf, torch.full_like(kf, 2.0))
    ratec = kc * (kc - 1.0 + rho) / (2.0 * n0)
    ll = ll + torch.where(typ >= 2, torch.log(ratec), zero)
    ll = ll + torch.where(typ == 3, torch.log((kc - 1.0) / (kc - 1.0 + rho))
                          - torch.log(kc * (kc - 1.0) / 2.0), zero)
    ll = ll + torch.where(typ == 2, torch.log(rho / (kc - 1.0 + rho))
                          - torch.log(kc), zero)
    total = torch.sum(ll)
    return torch.where(torch.sum(d_s) == 1, total,
                       torch.full_like(total, -math.inf))


# ---------------------------------------------------------------------------
# fixed-dimension moves: reassortment heights and partition routing. Each
# pick inverts the CDF of one uniform (operators._uniform, _randint) where
# the JAX package draws from its key.
# ---------------------------------------------------------------------------


def reassort_height_move(arg: ARGState, generator: torch.Generator,
                         window) -> Tuple[ARGState, torch.Tensor]:
    """A random walk of a uniform active reassortment node's height inside
    (its child's height, its lower parent's); symmetric, -inf where it
    leaves that interval or there is no reassortment."""
    h = arg.heights
    node, count = sample_masked(ops._uniform(generator, h),
                                arg.active & arg.is_reassort)
    lo = h[arg.children[node, 0].clamp_min(0)]
    hi = torch.minimum(h[arg.parent_left[node].clamp_min(0)],
                       h[arg.parent_right[node].clamp_min(0)])
    new_h = h[node] + (ops._uniform(generator, h) * 2 - 1) * window
    ok = (count > 0) & (new_h > lo) & (new_h < hi)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    return (arg.replace(heights=h.index_put((node,), new_h)),
            torch.where(ok, zero, zero - math.inf).reshape(()))


def partition_flip_move(arg: ARGState, generator: torch.Generator
                        ) -> Tuple[ARGState, torch.Tensor]:
    """Flip one uniform partition's routing bit on a uniform active
    reassortment node (the reference's partition operator); symmetric,
    -inf where there is no reassortment."""
    h = arg.heights
    node, count = sample_masked(ops._uniform(generator, h),
                                arg.active & arg.is_reassort)
    p = ops._randint(generator, 0, arg.side.shape[1], h.device)
    side = arg.side.index_put((node, p), ~arg.side[node, p])
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    return (arg.replace(side=side),
            torch.where(count > 0, zero, zero - math.inf))

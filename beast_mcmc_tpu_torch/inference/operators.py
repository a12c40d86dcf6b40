"""MCMC proposal operators of the main path.

Counterpart of beast_mcmc_tpu/inference/operators.py, with the same
proposal laws and Hastings ratios. Every operator is

    propose(params, tree, gen, tuning) -> (params', tree', log_hastings)
                                       or (params', tree', log_hastings,
                                           acc_stat)

where `gen` is the state's device generator and log_hastings a 0-d tensor,
-inf for an invalid proposal, +inf for a Gibbs-style move that is always
accepted (NUTS, the PDMPs, the slice samplers). acc_stat, where given, is
the operator's own acceptance statistic for the step-size adaptation
(NaN: adapt on the Metropolis probability). Tree moves are index rewires
on the tree's tensors. Node indices are kept as shape-[1] int64 tensors on the device:
indexing with them never copies to the host (a 0-d integer tensor used as
an index would), so a proposal never waits on the device.

Selection with exclusion draws in [0, M - #excluded) and shifts past the
sorted excluded indices: exactly uniform over the eligible set, no loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from beast_mcmc_tpu_torch.tree.topology import TreeState

NEG_INF = -math.inf
TREE_HEIGHTS = "__tree_heights__"  # sentinel target for up/down on the tree


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _randint(gen: torch.Generator, low: int, high: int, device) -> torch.Tensor:
    """Uniform int64[1] in [low, high)."""
    return torch.randint(low, high, (1,), generator=gen, device=device)


def _uniform(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) 0-d tensor of `like`'s dtype and device."""
    return torch.rand((), generator=gen, dtype=like.dtype, device=like.device)


def sample_excluding(gen: torch.Generator, m: int,
                     exclusions: torch.Tensor) -> torch.Tensor:
    """Uniform int64[1] draw from [0, m) excluding the given distinct
    indices (int64[k])."""
    k = exclusions.shape[0]
    r = _randint(gen, 0, m - k, exclusions.device)
    ex = torch.sort(exclusions).values
    for j in range(k):
        r = r + (r >= ex[j:j + 1]).long()
    return r


def replace_child(children: torch.Tensor, node: torch.Tensor,
                  old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """children with `old` replaced by `new` in row `node` (int64[1] each).
    A negative `node` (no such parent) leaves every row unchanged."""
    node = node.clamp_min(0)  # row 0 is a tip, whose [-1, -1] never matches
    row = children[node]
    row = torch.where(row == old[:, None], new[:, None], row)
    return children.index_put((node,), row)


def other_child(children: torch.Tensor, node: torch.Tensor,
                child: torch.Tensor) -> torch.Tensor:
    row = children[node]  # [1, 2]
    return torch.where(row[:, 0] == child, row[:, 1], row[:, 0])


def _scale_draw(gen: torch.Generator, scale_factor: torch.Tensor) -> torch.Tensor:
    """BEAST scale draw: uniform on [sf, 1/sf] (ScaleOperator.java)."""
    u = _uniform(gen, scale_factor)
    return scale_factor + u * (1.0 / scale_factor - scale_factor)


def _in_bounds(x: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    return torch.all((x >= lower) & (x <= upper))


def _valid_or_reject(valid: torch.Tensor, logh: torch.Tensor) -> torch.Tensor:
    logh = torch.as_tensor(logh)
    return torch.where(valid, logh, torch.full_like(logh, NEG_INF)).reshape(())


# ---------------------------------------------------------------------------
# operator specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Operator:
    """Base spec. weight: schedule weight (operators are drawn with
    probability proportional to weight)."""

    weight: float = 1.0
    target_acceptance: float = 0.234
    adaptable: bool = False
    # names of `params` entries the operator can change; () = tree only;
    # None = from the parameter/up/down attributes, else unknown (derived
    # caches are then rebuilt conservatively)
    modifies_params = None

    def modified_params(self):
        if self.modifies_params is not None:
            return tuple(self.modifies_params)
        names = []
        if getattr(self, "parameter", None):
            names.append(self.parameter)
        for attr in ("up", "down", "parameters"):
            names.extend(n for n in getattr(self, attr, ()) or ()
                         if isinstance(n, str))
        names = [n for n in names if n != TREE_HEIGHTS]
        return tuple(names) if names else None

    def initial_adapt(self) -> float:
        return 0.0

    def tuning(self, adapt_value):
        return None

    def propose(self, params, tree: TreeState, gen, tuning):
        raise NotImplementedError


class _ScaleTuned:
    """Adaptable scale factor: adapt value log(1/sf - 1)."""

    def initial_adapt(self) -> float:
        return math.log(1.0 / self.scale_factor - 1.0)

    def tuning(self, adapt_value):
        return 1.0 / (torch.exp(adapt_value) + 1.0)


@dataclasses.dataclass
class ScaleOperator(_ScaleTuned, Operator):
    """ScaleOperator.java. mode "random": one random dimension, x_i *= s,
    logq = -log s; "all": the same s on every dimension, logq = (dim - 2)
    log s; "independent" (scaleAllIndependently): a factor of its own on
    each dimension, logq = -sum log s_i."""

    parameter: str = ""
    scale_factor: float = 0.75
    mode: str = "random"
    lower: float = 0.0
    upper: float = math.inf
    adaptable: bool = True

    def propose(self, params, tree, gen, tuning):
        x = params[self.parameter]
        flat = torch.atleast_1d(x)
        dim = flat.shape[0]
        sf = tuning.to(flat.dtype)
        if self.mode == "independent":
            u = torch.rand(dim, generator=gen, dtype=flat.dtype,
                           device=flat.device)
            s = sf + u * (1.0 / sf - sf)
            new, logq = flat * s, -torch.sum(torch.log(s))
        elif self.mode == "all":
            s = _scale_draw(gen, sf)
            new, logq = flat * s, (dim - 2) * torch.log(s)
        else:
            s = _scale_draw(gen, sf)
            idx = _randint(gen, 0, dim, flat.device)
            new, logq = flat.index_put((idx,), flat[idx] * s), -torch.log(s)
        logh = _valid_or_reject(_in_bounds(new, self.lower, self.upper), logq)
        return {**params, self.parameter: new.reshape(x.shape)}, tree, logh


@dataclasses.dataclass
class RandomWalkOperator(Operator):
    """RandomWalkOperator.java: x_i += U(-w, w) on one random dimension,
    reflected into [lower, upper] where `reflect` and both bounds are
    finite (which keeps it symmetric); adapt value log(w)."""

    parameter: str = ""
    window: float = 1.0
    lower: float = -math.inf
    upper: float = math.inf
    reflect: bool = False
    adaptable: bool = True

    def initial_adapt(self) -> float:
        return math.log(self.window)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        x = params[self.parameter]
        flat = torch.atleast_1d(x)
        idx = _randint(gen, 0, flat.shape[0], flat.device)
        delta = (_uniform(gen, flat) * 2.0 - 1.0) * tuning
        v = flat[idx] + delta
        if (self.reflect and math.isfinite(self.lower)
                and math.isfinite(self.upper)):
            span = self.upper - self.lower
            v = torch.abs((v - self.lower) % (2 * span) - span) + self.lower
        new = flat.index_put((idx,), v)
        logh = _valid_or_reject(_in_bounds(new, self.lower, self.upper),
                                torch.zeros((), dtype=flat.dtype,
                                            device=flat.device))
        return {**params, self.parameter: new.reshape(x.shape)}, tree, logh


@dataclasses.dataclass
class DeltaExchangeOperator(Operator):
    """DeltaExchangeOperator.java: move d ~ U(0, delta) from one random
    dimension to another; keeps the sum; symmetric."""

    parameter: str = ""
    delta: float = 0.01
    lower: float = 0.0
    upper: float = math.inf
    adaptable: bool = True

    def initial_adapt(self) -> float:
        return math.log(self.delta)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        x = params[self.parameter]
        flat = torch.atleast_1d(x)
        dim = flat.shape[0]
        i = _randint(gen, 0, dim, flat.device)
        j = sample_excluding(gen, dim, i)
        d = _uniform(gen, flat) * tuning
        new = flat.index_put((i,), flat[i] - d)
        new = new.index_put((j,), new[j] + d)
        logh = _valid_or_reject(_in_bounds(new, self.lower, self.upper),
                                torch.zeros((), dtype=flat.dtype,
                                            device=flat.device))
        return {**params, self.parameter: new.reshape(x.shape)}, tree, logh


@dataclasses.dataclass
class BitFlipOperator(Operator):
    """BitFlipOperator.java: flip one random bit of a 0/1 indicator vector
    (BSSVS). With usesPriorOnSum the Hastings ratio makes the move
    symmetric in the number of ones s of dim:
      0 -> 1: logq = -log((dim - s) / (s + 1))
      1 -> 0: logq = -log(s / (dim - s + 1))"""

    parameter: str = ""
    uses_prior_on_sum: bool = True

    def propose(self, params, tree, gen, tuning):
        x0 = params[self.parameter]
        x = torch.atleast_1d(x0)
        dim = x.shape[0]
        fdt = tree.heights.dtype
        pos = _randint(gen, 0, dim, x.device)
        value = x[pos]
        flipped = x.index_put((pos,), 1 - value)
        if self.uses_prior_on_sum:
            s = torch.sum(x).to(fdt)
            logq = torch.where(value.reshape(()) == 0,
                               -torch.log((dim - s) / (s + 1.0)),
                               -torch.log(s / (dim - s + 1.0)))
        else:
            logq = torch.zeros((), dtype=fdt, device=x.device)
        return ({**params, self.parameter: flipped.reshape(x0.shape)}, tree,
                logq)


@dataclasses.dataclass
class UpDownOperator(_ScaleTuned, Operator):
    """UpDownOperator.java: up-params *= s, down-params /= s,
    logq = (nUp - nDown - 2) log s. TREE_HEIGHTS scales every internal
    node height."""

    up: Sequence[str] = ()
    down: Sequence[str] = ()
    scale_factor: float = 0.75
    bounds: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    adaptable: bool = True

    def _apply(self, params, tree, name, s):
        """Returns (params, tree, n_dims_scaled, valid)."""
        if name == TREE_HEIGHTS:
            m = tree.parent.shape[0]
            n_taxa = (m + 1) // 2
            internal = torch.arange(m, device=tree.heights.device) >= n_taxa
            heights = torch.where(internal, tree.heights * s, tree.heights)
            # parent above child everywhere (dated tips can break it)
            ok = torch.all((tree.parent < 0)
                           | (heights[tree.parent.clamp_min(0)] > heights))
            return params, tree.replace(heights=heights), n_taxa - 1, ok
        x = params[name]
        new = x * s
        lo, hi = self.bounds.get(name, (0.0, math.inf))
        ok = _in_bounds(torch.atleast_1d(new), lo, hi)
        return {**params, name: new}, tree, x.numel(), ok

    def propose(self, params, tree, gen, tuning):
        s = _scale_draw(gen, tuning.to(tree.heights.dtype))
        n_up = n_down = 0
        ok = torch.ones((), dtype=torch.bool, device=s.device)
        for name in self.up:
            params, tree, n, o = self._apply(params, tree, name, s)
            n_up += n
            ok = ok & o
        for name in self.down:
            params, tree, n, o = self._apply(params, tree, name, 1.0 / s)
            n_down += n
            ok = ok & o
        return params, tree, _valid_or_reject(
            ok, (n_up - n_down - 2) * torch.log(s))


# ---------------------------------------------------------------------------
# tree operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UniformNodeHeightOperator(Operator):
    """A non-root internal node's height, uniform between its oldest child
    and its parent (<uniformOperator> on internalNodeHeights)."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        m = tree.parent.shape[0]
        n_taxa = (m + 1) // 2
        h = tree.heights
        r = _randint(gen, 0, m - n_taxa - 1, h.device) + n_taxa
        node = r + (r >= tree.root).long()  # internal nodes except the root
        lo = torch.amax(h[tree.children[node]], dim=1)
        hi = h[tree.parent[node]]
        new_h = lo + _uniform(gen, h) * (hi - lo)
        tree = tree.replace(heights=h.index_put((node,), new_h))
        return params, tree, torch.zeros((), dtype=h.dtype, device=h.device)


@dataclasses.dataclass
class RootHeightScaleOperator(_ScaleTuned, Operator):
    """Scale the root height; lower bound the root's oldest child."""

    scale_factor: float = 0.75
    adaptable: bool = True
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        s = _scale_draw(gen, tuning.to(h.dtype))
        root = tree.root.reshape(1)
        new_h = h[root] * s
        lo = torch.amax(h[tree.children[root]], dim=1)
        tree = tree.replace(heights=h.index_put((root,), new_h))
        return params, tree, _valid_or_reject(new_h > lo, -torch.log(s))


@dataclasses.dataclass
class NarrowExchangeOperator(Operator):
    """ExchangeOperator.java narrow: swap a node with its uncle when the
    uncle is younger than the node's parent. Symmetric."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        m = tree.parent.shape[0]
        root = tree.root.reshape(1)
        ex = torch.cat([root, tree.children[root][0]])
        i = sample_excluding(gen, m, ex)
        ip = tree.parent[i]
        igp = tree.parent[ip]
        uncle = other_child(tree.children, igp, ip)
        h = tree.heights
        valid = h[uncle] < h[ip]
        parent = tree.parent.index_put((i,), igp).index_put((uncle,), ip)
        children = replace_child(tree.children, ip, i, uncle)
        children = replace_child(children, igp, uncle, i)
        tree = tree.replace(parent=parent, children=children)
        return params, tree, _valid_or_reject(valid, torch.zeros_like(h[0]))


@dataclasses.dataclass
class WideExchangeOperator(Operator):
    """ExchangeOperator.java wide: swap two random subtrees when the heights
    permit. Symmetric."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        m = tree.parent.shape[0]
        root = tree.root.reshape(1)
        i = sample_excluding(gen, m, root)
        j = sample_excluding(gen, m, torch.cat([root, i]))
        ip = tree.parent[i]
        jp = tree.parent[j]
        h = tree.heights
        valid = ((ip != jp) & (i != jp) & (j != ip)
                 & (h[j] < h[ip]) & (h[i] < h[jp]))
        parent = tree.parent.index_put((i,), jp).index_put((j,), ip)
        children = replace_child(tree.children, ip, i, j)
        children = replace_child(children, jp, j, i)
        tree = tree.replace(parent=parent, children=children)
        return params, tree, _valid_or_reject(valid, torch.zeros_like(h[0]))


@dataclasses.dataclass
class WilsonBaldingOperator(Operator):
    """WilsonBalding.java proposeTree: prune subtree i with its parent iP,
    regraft iP onto a random branch <k, j> above height(i) at a uniform
    height in the branch window. Root-changing moves are rejected;
    Hastings = newRange / oldRange."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        m = tree.parent.shape[0]
        root = tree.root.reshape(1)
        h = tree.heights
        i = sample_excluding(gen, m, root)
        j = _randint(gen, 0, m, h.device)
        ip = tree.parent[i]
        k = tree.parent[j]
        cip = other_child(tree.children, ip, i)
        pip = tree.parent[ip]
        valid = ((j != root) & (ip != root)
                 & (j != i) & (k != ip) & (j != ip) & (k != i)
                 & (h[k.clamp_min(0)] > h[i]))
        new_min = torch.maximum(h[i], h[j])
        new_range = h[k.clamp_min(0)] - new_min
        new_age = new_min + _uniform(gen, h) * new_range
        old_min = torch.maximum(h[i], h[cip])
        old_range = h[pip.clamp_min(0)] - old_min
        logh = _valid_or_reject(valid, torch.log(new_range) - torch.log(old_range))
        # this rewiring order is right for the k == pip case too
        children = replace_child(tree.children, ip, cip, j)
        children = replace_child(children, pip, ip, cip)
        children = replace_child(children, k, j, ip)
        parent = (tree.parent.index_put((ip,), k).index_put((j,), ip)
                  .index_put((cip,), pip))
        heights = h.index_put((ip,), new_age)
        tree = tree.replace(parent=parent, children=children, heights=heights)
        return params, tree, logh

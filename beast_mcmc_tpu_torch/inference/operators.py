"""MCMC proposal operators.

Counterpart of beast_mcmc_tpu/inference/operators.py, every class of it,
with the same proposal laws and Hastings ratios. Every operator is

    propose(params, tree, gen, tuning) -> (params', tree', log_hastings)
                                       or (params', tree', log_hastings,
                                           acc_stat)

where `gen` is the state's device generator and log_hastings a 0-d tensor,
-inf for an invalid proposal, +inf for a Gibbs-style move that is always
accepted (NUTS, the PDMPs, the slice samplers, the conjugate Gibbs
draws). acc_stat, where given, is
the operator's own acceptance statistic for the step-size adaptation
(NaN: adapt on the Metropolis probability). Tree moves are index rewires
on the tree's tensors. Node indices are kept as shape-[1] int64 tensors on the device:
indexing with them never copies to the host (a 0-d integer tensor used as
an index would), so a proposal never waits on the device.

Selection with exclusion draws in [0, M - #excluded) and shifts past the
sorted excluded indices: exactly uniform over the eligible set, no loop.
No proposal reads a value on the host or branches on one, so each vmaps
over a chain batch (inference/mcmc.py::_propose_chains); the composite
TeamOperator runs every sub-operator and selects the drawn one's result.
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
    dimension to another; keeps the sum; symmetric. With `integer` d is
    uniform on 1..round(delta) (at least 1) and every entry must stay at
    least 1 (the integer group sizes of a skyline)."""

    parameter: str = ""
    delta: float = 0.01
    lower: float = 0.0
    upper: float = math.inf
    integer: bool = False
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
        lower = self.lower
        if self.integer:
            hi = max(int(round(self.delta)), 1)
            d = _randint(gen, 1, hi + 1, flat.device).to(flat.dtype)
            lower = max(self.lower, 1.0)
        else:
            d = _uniform(gen, flat) * tuning
        new = flat.index_put((i,), flat[i] - d)
        new = new.index_put((j,), new[j] + d)
        fdt = flat.dtype if flat.is_floating_point() else tree.heights.dtype
        logh = _valid_or_reject(_in_bounds(new, lower, self.upper),
                                torch.zeros((), dtype=fdt,
                                            device=flat.device))
        return {**params, self.parameter: new.reshape(x.shape)}, tree, logh


@dataclasses.dataclass
class UniformIntegerOperator(Operator):
    """UniformIntegerOperator.java: set one random dimension of an integer
    parameter to U{lower..upper} (inclusive); symmetric. The relaxed
    clock's rate categories (DiscretizedBranchRates)."""

    parameter: str = ""
    lower: int = 0
    upper: int = 1  # inclusive

    def propose(self, params, tree, gen, tuning):
        x0 = params[self.parameter]
        x = torch.atleast_1d(x0)
        idx = _randint(gen, 0, x.shape[0], x.device)
        v = _randint(gen, self.lower, self.upper + 1, x.device)
        new = x.index_put((idx,), v.to(x.dtype)).reshape(x0.shape)
        return ({**params, self.parameter: new}, tree,
                torch.zeros((), dtype=tree.heights.dtype,
                            device=tree.heights.device))


@dataclasses.dataclass
class SwapOperator(Operator):
    """SwapOperator.java: swap two distinct random dimensions of a
    parameter; symmetric."""

    parameter: str = ""

    def propose(self, params, tree, gen, tuning):
        x = params[self.parameter]
        i = _randint(gen, 0, x.shape[0], x.device)
        j = sample_excluding(gen, x.shape[0], i)
        new = x.index_put((i,), x[j]).index_put((j,), x[i])
        return ({**params, self.parameter: new}, tree,
                torch.zeros((), dtype=tree.heights.dtype,
                            device=tree.heights.device))


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


# ---------------------------------------------------------------------------
# draws: every draw of the operators below goes through these helpers, so
# a test can hand a proposal given draws; each vmaps with randomness
# "different" (a chain batch's draw is one draw of shape [B, ...])
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, like: torch.Tensor,
            shape=()) -> torch.Tensor:
    """Standard normal draws of `shape`, `like`'s dtype and device."""
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _uniforms(gen: torch.Generator, like: torch.Tensor, shape) -> torch.Tensor:
    """Uniform [0, 1) draws of `shape`, `like`'s dtype and device."""
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


GAMMA_ROUNDS = 16  # Marsaglia-Tsang rounds a draw; each accepts w.p. > 0.95


def gamma_draw(gen: torch.Generator, shape, like: torch.Tensor,
               size=()) -> torch.Tensor:
    """Gamma(shape, 1) draws of `size` on `like`'s dtype and device
    (Marsaglia & Tsang 2000), with the operator's generator:
    torch._standard_gamma takes none. Each draw runs GAMMA_ROUNDS rounds
    at once (a normal and a uniform each) and keeps the first accepted, so
    there is no data-dependent loop and the draw vmaps; below shape 1 a
    draw at shape + 1 is boosted by u^(1/shape). The chance that no round
    accepts is under 0.05^16, and such a draw returns the mode of its
    squeeze, d."""
    a = torch.as_tensor(shape, dtype=like.dtype, device=like.device)
    a = a.expand(size)
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)
    d = (a1 - 1.0 / 3.0)[..., None]
    c = 1.0 / torch.sqrt(9.0 * d)
    x = _normal(gen, like, (*a.shape, GAMMA_ROUNDS))
    u = _uniforms(gen, like, (*a.shape, GAMMA_ROUNDS))
    v = (1.0 + c * x) ** 3
    log_v = torch.log(torch.clamp_min(v, 1e-300))
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    first = torch.argmax(ok.long(), dim=-1, keepdim=True)
    g = (d * torch.gather(v, -1, first)).squeeze(-1)
    g = torch.where(ok.any(-1), g, d.squeeze(-1))
    w = _uniforms(gen, like, a.shape)
    return torch.where(boost, g * w ** (1.0 / a), g)


def _zero(tree: TreeState) -> torch.Tensor:
    return torch.zeros((), dtype=tree.heights.dtype,
                       device=tree.heights.device)


@dataclasses.dataclass
class TransformedRandomWalkOperator(Operator):
    """TransformedParameterRandomWalkOperator.java: u = transform(x), u_i +=
    U(-w, w) on one random dimension, x' = transform^-1(u'); logq =
    logdetJ_inv(u') - logdetJ_inv(u), -inf where x' is not finite."""

    parameter: str = ""
    transform: object = None  # utils.transforms.Transform
    window: float = 1.0
    adaptable: bool = True

    def initial_adapt(self) -> float:
        return math.log(self.window)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        x = params[self.parameter]
        u = torch.atleast_1d(self.transform.forward(x))
        idx = _randint(gen, 0, u.shape[0], u.device)
        delta = (_uniform(gen, u) * 2.0 - 1.0) * tuning
        u2 = u.index_put((idx,), u[idx] + delta)
        x2 = self.transform.inverse(u2).reshape(x.shape)
        logq = (self.transform.log_det_jacobian_inverse(u2)
                - self.transform.log_det_jacobian_inverse(u))
        ok = torch.all(torch.isfinite(torch.atleast_1d(x2)))
        return {**params, self.parameter: x2}, tree, _valid_or_reject(ok, logq)


@dataclasses.dataclass
class StarRootHeightScaleOperator(_ScaleTuned, Operator):
    """Scale the one tied height of a star tree (StarTreeModel: every
    internal node reads the root height): all internal nodes move with the
    root; logq = -log s; lower bound the oldest tip."""

    n_taxa: int = 0
    scale_factor: float = 0.75
    adaptable: bool = True
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        s = _scale_draw(gen, tuning.to(h.dtype))
        new_h = h[tree.root.reshape(1)] * s
        tip = torch.arange(h.shape[0], device=h.device) < self.n_taxa
        lo = torch.amax(torch.where(tip, h, -math.inf))
        heights = torch.where(tip, h, new_h)
        return (params, tree.replace(heights=heights),
                _valid_or_reject(new_h > lo, -torch.log(s)))


@dataclasses.dataclass
class JointOperator(Operator):
    """JointOperator.java: the sub-operators in sequence, each on its own
    draws at its static tuning (not adapted); the log Hastings terms add."""

    sub_operators: Sequence[Operator] = ()

    def propose(self, params, tree, gen, tuning):
        logh = _zero(tree)
        for op in self.sub_operators:
            t = op.tuning(torch.tensor(op.initial_adapt(),
                                       dtype=tree.heights.dtype,
                                       device=tree.heights.device))
            params, tree, lh = op.propose(params, tree, gen, t)[:3]
            logh = logh + lh
        return params, tree, logh


@dataclasses.dataclass
class NormalGammaPrecisionGibbsOperator(Operator):
    """NormalGammaPrecisionGibbsOperator.java: the conjugate draw tau | x ~
    Gamma(shape + n/2, rate + sum((x - mu)^2)/2) (`gamma_draw`). A Gibbs
    move: log Hastings +inf and its own acceptance statistic 1."""

    data_parameter: str = ""
    mean_parameter: str = ""
    precision_parameter: str = ""
    prior_shape: float = 0.001
    prior_rate: float = 0.001

    def propose(self, params, tree, gen, tuning):
        x = torch.atleast_1d(params[self.data_parameter])
        mu = params[self.mean_parameter]
        shape = self.prior_shape + 0.5 * x.shape[0]
        rate = self.prior_rate + 0.5 * torch.sum((x - mu) ** 2)
        tau = gamma_draw(gen, shape, x) / rate
        one = torch.ones((), dtype=tree.heights.dtype,
                         device=tree.heights.device)
        return ({**params, self.precision_parameter: tau}, tree,
                one * math.inf, one)


@dataclasses.dataclass
class NormalNormalMeanGibbsOperator(Operator):
    """NormalNormalMeanGibbsOperator.java: the conjugate draw mu | x, tau ~
    N((p0 m0 + tau sum x) / (p0 + n tau), 1 / (p0 + n tau)). A Gibbs move:
    log Hastings +inf and its own acceptance statistic 1."""

    data_parameter: str = ""
    mean_parameter: str = ""
    precision_parameter: str = ""
    prior_mean: float = 0.0
    prior_precision: float = 1e-4

    def propose(self, params, tree, gen, tuning):
        x = torch.atleast_1d(params[self.data_parameter])
        tau = params[self.precision_parameter]
        post_prec = self.prior_precision + x.shape[0] * tau
        post_mean = (self.prior_precision * self.prior_mean
                     + tau * torch.sum(x)) / post_prec
        mu = post_mean + _normal(gen, x) / torch.sqrt(post_prec)
        one = torch.ones((), dtype=tree.heights.dtype,
                         device=tree.heights.device)
        return ({**params, self.mean_parameter: mu}, tree, one * math.inf,
                one)


@dataclasses.dataclass
class UniformRealOperator(Operator):
    """UniformOperator.java on a bounded real parameter: one random
    dimension set to U(lower, upper); symmetric."""

    parameter: str = ""
    lower: float = 0.0
    upper: float = 1.0

    def propose(self, params, tree, gen, tuning):
        x0 = params[self.parameter]
        x = torch.atleast_1d(x0)
        idx = _randint(gen, 0, x.shape[0], x.device)
        v = self.lower + _uniform(gen, x) * (self.upper - self.lower)
        return ({**params, self.parameter: x.index_put(
            (idx,), v.reshape(1)).reshape(x0.shape)}, tree, _zero(tree))


@dataclasses.dataclass
class CompoundWeightedDeltaOperator(Operator):
    """DeltaExchangeOperator.java's weighted branch on a compoundParameter
    of separate scalars: two members i != j, x_i += d / w_i, x_j -= d / w_j
    with d ~ U(0, delta), keeping sum w x; symmetric, rejected (and left
    unchanged) where a member falls to the lower bound."""

    parameters: Sequence[str] = ()
    parameter_weights: Sequence[float] = ()
    delta: float = 0.02
    lower: float = 0.0
    adaptable: bool = True

    def initial_adapt(self) -> float:
        return math.log(self.delta)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        n = len(self.parameters)
        dt, dev = tree.heights.dtype, tree.heights.device
        i = _randint(gen, 0, n, dev)
        j_raw = _randint(gen, 0, n - 1, dev)
        j = j_raw + (j_raw >= i).long()
        d = _uniform(gen, tree.heights) * tuning
        w = torch.tensor(list(self.parameter_weights) or [1.0] * n, dtype=dt,
                         device=dev)
        vals = torch.stack([params[p].reshape(()).to(dt)
                            for p in self.parameters])
        step = torch.zeros(n, dtype=dt, device=dev)
        step = step.index_put((i,), d / w[i]).index_put((j,), -d / w[j])
        new_vals = vals + step
        ok = torch.all(new_vals > self.lower)
        new_vals = torch.where(ok, new_vals, vals)
        out = dict(params)
        for k, p in enumerate(self.parameters):
            out[p] = new_vals[k].to(params[p].dtype).reshape(params[p].shape)
        return out, tree, _valid_or_reject(ok, _zero(tree))


@dataclasses.dataclass
class MvnRandomWalkOperator(Operator):
    """MVNOperator with a fixed proposal Cholesky factor L: x' = x + sf L z
    over the whole vector; symmetric; adapt value log(sf)."""

    parameter: str = ""
    chol: object = None  # [D, D]
    scale_factor: float = 1.0
    adaptable: bool = True

    def initial_adapt(self) -> float:
        return math.log(self.scale_factor)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        x = params[self.parameter]
        flat = x.reshape(-1)
        chol = torch.as_tensor(self.chol, dtype=flat.dtype, device=flat.device)
        z = _normal(gen, flat, flat.shape)
        new = flat + tuning * (chol @ z)
        return ({**params, self.parameter: new.reshape(x.shape)}, tree,
                _zero(tree))


@dataclasses.dataclass
class SubsetRandomWalkOperator(Operator):
    """RandomWalkOperator on a MaskedParameter: x_j += U(-w, w) at one j of a
    fixed index subset; symmetric."""

    parameter: str = ""
    indices: Sequence[int] = ()
    window: float = 1.0
    adaptable: bool = True

    def initial_adapt(self) -> float:
        return math.log(self.window)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        x = params[self.parameter]
        flat = x.reshape(-1)
        idx = torch.as_tensor(list(self.indices), device=flat.device)
        j = idx[_randint(gen, 0, idx.shape[0], flat.device)]
        delta = (_uniform(gen, flat) * 2.0 - 1.0) * tuning
        new = flat.index_put((j,), flat[j] + delta)
        return ({**params, self.parameter: new.reshape(x.shape)}, tree,
                _zero(tree))


@dataclasses.dataclass
class RateBitExchangeOperator(Operator):
    """RateBitExchangeOperator.java:26-49: the indicator and rate vectors
    split in halves; the (bit, rate) pair at a random index swaps with its
    partner in the other half where at least one of the two bits is set;
    symmetric."""

    bit_parameter: str = ""
    rate_parameter: str = ""

    @property
    def modifies_params(self):
        return (self.bit_parameter, self.rate_parameter)

    def propose(self, params, tree, gen, tuning):
        bits0, rates0 = params[self.bit_parameter], params[self.rate_parameter]
        bits, rates = bits0.reshape(-1), rates0.reshape(-1)
        dim = bits.shape[0] // 2
        idx = _randint(gen, 0, dim, bits.device)
        ok = (bits[idx] + bits[idx + dim]) >= 1
        bits2 = bits.index_put((idx,), bits[idx + dim]).index_put(
            (idx + dim,), bits[idx])
        rates2 = rates.index_put((idx,), rates[idx + dim]).index_put(
            (idx + dim,), rates[idx])
        return ({**params, self.bit_parameter: bits2.reshape(bits0.shape),
                 self.rate_parameter: rates2.reshape(rates0.shape)}, tree,
                _valid_or_reject(ok, _zero(tree)))


@dataclasses.dataclass
class TeamOperator(Operator):
    """TeamOperator.java:115-128: n_pick of the sub-operators, drawn
    uniformly without replacement (the order of n uniforms), applied in
    sequence at their static tunings; the log Hastings terms add. Without
    a host read the drawn one cannot be branched to: each slot runs every
    sub-operator, each on its own draws, and selects the drawn one's result
    (JAX's lax.switch under vmap does the same)."""

    sub_operators: Sequence[Operator] = ()
    n_pick: int = 1

    def modified_params(self):
        out = []
        for op in self.sub_operators:
            mp = op.modified_params()
            if mp is None:
                return None
            out.extend(mp)
        return tuple(dict.fromkeys(out))

    def propose(self, params, tree, gen, tuning):
        h = tree.heights
        perm = torch.argsort(_uniforms(gen, h, (len(self.sub_operators),)))
        logh = _zero(tree)
        for slot in range(self.n_pick):
            sel = perm[slot]
            outs = []
            for op in self.sub_operators:
                t = op.tuning(torch.tensor(op.initial_adapt(), dtype=h.dtype,
                                           device=h.device))
                outs.append(op.propose(params, tree, gen, t)[:3])
            new_p, new_t, new_l = params, tree, logh
            for k, (p2, t2, lh) in enumerate(outs):
                hit = sel == k
                new_p = {name: new_p[name] if p2[name] is params[name] else
                         torch.where(hit, p2[name], new_p[name])
                         for name in params}
                if t2 is not tree:
                    new_t = TreeState(*(torch.where(hit, getattr(t2, f),
                                                    getattr(new_t, f))
                                        for f in ("parent", "children",
                                                  "heights", "root")))
                new_l = torch.where(hit, logh + lh, new_l)
            params, tree, logh = new_p, new_t, new_l
        return params, tree, logh

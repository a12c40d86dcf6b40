"""Component-cached posterior evaluation: the dirty-flag model graph.

Counterpart of beast_mcmc_tpu/inference/component_cache.py (the role of
the reference's CompoundLikelihood listener flags: only the likelihoods
downstream of a changed parameter recompute). The posterior is a sum of
component log densities carried in the chain's params under COMP_KEY;
each operator's step refreshes only the components whose inputs it can
touch and reuses the cached values of the rest
(inference/mcmc.py::make_mcmc_step, `components=`).

Dependencies. The JAX package slices each component's jaxpr backward from
its output, so a parameter read but not used is not a dependency. PyTorch
runs eagerly and has no such graph: `trace_deps` runs the component once
on a dict that records the keys read and on a tree that records whether
any of its fields is read. A key that is read but does not reach the
output therefore makes the port's set a superset of JAX's. That is
conservative: more recomputation, never a stale value.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Set

import torch

from beast_mcmc_tpu_torch.utils.accum import accum_dtype

COMP_KEY = "__comp_cache__"


@dataclasses.dataclass
class Component:
    """One posterior addend with its input set."""

    fn: Callable  # (params, tree) -> 0-d log density
    name: str = ""
    deps: Optional[Set[str]] = None  # params keys read; None = unknown
    uses_tree: bool = True


class _RecordingDict(dict):
    """A params dict that records the keys read."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)


class _RecordingTree:
    """A tree whose field reads are recorded."""

    def __init__(self, tree):
        object.__setattr__(self, "_tree", tree)
        object.__setattr__(self, "read", False)

    def __getattr__(self, name):
        object.__setattr__(self, "read", True)
        return getattr(object.__getattribute__(self, "_tree"), name)


def trace_deps(fn, params, tree):
    """(set of params keys fn reads, whether it reads the tree), from one
    evaluation of fn(params, tree)."""
    p = _RecordingDict(params)
    t = _RecordingTree(tree)
    with torch.no_grad():
        fn(p, t)
    return p.read & set(params), t.read


def make_components(likelihood_fns, params, tree) -> list:
    """Trace each (fn, name) pair into a Component with its deps."""
    out = []
    for fn, name in likelihood_fns:
        deps, uses_tree = trace_deps(fn, params, tree)
        out.append(Component(fn, name, deps, uses_tree))
    return out


def decompose_likelihood(lik) -> list:
    """Flatten a compound likelihood whose `.parts` attribute lists its
    addends (recursively) into its leaves."""
    parts = getattr(lik, "parts", None)
    if not parts:
        return [lik]
    out = []
    for part in parts:
        out.extend(decompose_likelihood(part))
    return out


def seed_components(params, tree, components, dtype=None):
    """Add the [C] cached component-value vector to the params dict."""
    dt = dtype or accum_dtype()
    vals = torch.stack([torch.as_tensor(c.fn(params, tree)).to(dt)
                        for c in components])
    return {**params, COMP_KEY: vals}


def component_lp_fn(components):
    """The log posterior that trusts the cache (the steps refresh it)."""

    def lp(params, tree):
        return torch.sum(params[COMP_KEY])

    return lp


def full_lp_fn(components):
    """The cache-free posterior (for HMC internals and self-checks)."""

    def lp(params, tree):
        tot = 0.0
        for c in components:
            tot = tot + c.fn(params, tree)
        return tot

    return lp


def affected_indices(components: Sequence[Component], op,
                     op_is_tree: bool) -> list:
    """The component indices an operator's proposal can change: all where
    its modified params are unknown, else those with unknown deps, deps it
    modifies, or a tree it can move."""
    mod = op.modified_params()
    if mod is None:
        return list(range(len(components)))
    mod = set(mod)
    return [i for i, c in enumerate(components)
            if c.deps is None or (c.deps & mod) or (c.uses_tree and op_is_tree)]


def refresh_components(params, tree, components, idxs):
    """Recompute the given component indices into the cache vector."""
    if not idxs:
        return params
    cache = params[COMP_KEY]
    fresh = {i: torch.as_tensor(components[i].fn(params, tree)).to(
        cache.dtype) for i in idxs}
    # stacked from the cached entries by Python index: no index tensor is
    # copied to the device
    return {**params, COMP_KEY: torch.stack([
        fresh[i] if i in fresh else cache[i]
        for i in range(len(components))])}

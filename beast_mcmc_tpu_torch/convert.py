"""Carry parameters, trees and operator settings from the JAX package into
this one.

The JAX side hands over plain numpy: `params` is a dict whose values are
arrays or scalars, a tuple of them (the "site.rates" (rates, weights)
cache), a dict of them (an AVMVN operator's "_avmvn:..." statistics), or
an object with `values`, `U` and `U_inv` attributes (the "eig"
EigenSystem cache, its leaves turned to numpy); the tree is numpy
parent / children / heights / root; a vmapped MCMCState (numpy leaves
with a leading chain axis) becomes a chain batch (`states_from_numpy`).
An operator is a dataclass whose
settings are plain values; `operator_from` builds this package's class of
the same name from them (the HMC operators' transforms too). A joint
analysis's parameters (`joint_params_from_numpy`) keep their XML ids, the
anonymous ones renamed by their role. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from beast_mcmc_tpu_torch.ops.eigen import EigenSystem
from beast_mcmc_tpu_torch.tree.topology import TreeState, make_tree_state
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


def _value(v, dtype, device):
    if all(hasattr(v, a) for a in ("values", "U", "U_inv")):
        return EigenSystem(*(_value(getattr(v, a), dtype, device)
                             for a in ("values", "U", "U_inv")))
    if isinstance(v, tuple):
        return tuple(_value(x, dtype, device) for x in v)
    if isinstance(v, dict):  # in-chain statistics ("_avmvn:..." entries)
        return {k: _value(x, dtype, device) for k, x in v.items()}
    a = np.asarray(v)
    return torch.tensor(a, device=device,
                        dtype=None if np.issubdtype(a.dtype, np.integer)
                        else dtype)


def params_from_numpy(params: Dict[str, Any], dtype=DEFAULT_FLOAT,
                      device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The JAX package's params dict (numpy leaves) as this package's."""
    return {k: _value(v, dtype, device) for k, v in params.items()}


# the ids the JAX package's XML layer gives the two anonymous <parameter>s
# of examples/makona_joint.xml (the skygrid's numGridPoints and cutOff, in
# document order), and this package's names for them
JOINT_RENAMES = {"param2": "skygrid.numGridPoints",
                 "param3": "skygrid.cutOff"}


def joint_params_from_numpy(params: Dict[str, Any], dtype=DEFAULT_FLOAT,
                            device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The params of the JAX package's XmlAnalysis of the Makona joint
    document (initial_eval_state, or a chain's state; numpy leaves) as
    apps/benchmarks.py::build_joint_analysis names them: the XML ids, the
    anonymous ones renamed by JOINT_RENAMES; the relaxed clock's integer
    categories stay integers."""
    return params_from_numpy(
        {JOINT_RENAMES.get(k, k): v for k, v in params.items()}, dtype,
        device)


def tree_from_numpy(parent, children, heights, root, dtype=DEFAULT_FLOAT,
                    device=DEFAULT_DEVICE) -> TreeState:
    return make_tree_state(parent, children, heights, root, dtype, device)


def states_from_numpy(state, generator: torch.Generator,
                      dtype=DEFAULT_FLOAT, device=DEFAULT_DEVICE):
    """The JAX package's vmapped MCMCState, its leaves turned to numpy with
    a leading chain axis B, as this package's chain batch
    (inference/state.py): params, tree, log posterior and the operator
    statistics carried over; `generator` (on `device`) becomes the batch's
    one device generator, and the JAX keys are dropped."""
    from beast_mcmc_tpu_torch.inference.state import MCMCState, init_state

    tree = state.tree
    parts = {f: torch.tensor(np.asarray(getattr(tree, f)), device=device,
                             dtype=dtype if f == "heights" else torch.long)
             for f in ("parent", "children", "heights", "root")}
    adapt = torch.tensor(np.asarray(state.op_adapt), dtype=torch.float64,
                         device=device)
    fresh = init_state({}, TreeState(**parts), generator, adapt.shape[-1],
                       adapt)

    def ints(x):
        return torch.tensor(np.asarray(x), dtype=torch.long, device=device)

    step = np.asarray(state.step)
    return MCMCState(
        params=params_from_numpy(state.params, dtype, device),
        tree=TreeState(**parts),
        log_posterior=torch.tensor(np.asarray(state.log_posterior),
                                   dtype=torch.float64, device=device),
        generator=generator, op_generator=fresh.op_generator,
        step=int(step.reshape(-1)[0]) if step.size else 0,
        op_adapt=adapt, op_adapt_count=ints(state.op_adapt_count),
        op_accept=ints(state.op_accept), op_reject=ints(state.op_reject),
        op_sum_accept=torch.tensor(np.asarray(state.op_sum_accept),
                                   dtype=torch.float64, device=device))


def _spec(obj, modules):
    """The dataclass of `obj`'s class name found in `modules`, built from
    `obj`'s values of its public fields; nested dataclasses (transforms, and
    the (transform, size) blocks of an array transform) likewise."""
    from beast_mcmc_tpu_torch.utils import transforms

    name = type(obj).__name__
    cls = next((getattr(m, name) for m in modules if hasattr(m, name)), None)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise ValueError(f"no counterpart of {name} in this package")

    def conv(v):
        if dataclasses.is_dataclass(v):
            return _spec(v, (transforms,))
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        return v

    return cls(**{f.name: conv(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)
                  if not f.name.startswith("_") and hasattr(obj, f.name)})


def operator_from(op):
    """The JAX package's operator `op` as this package's operator of the
    same class name and settings (weights, tuning, leapfrog steps, mass,
    preconditioning, transforms, bounds, trajectory and adaptation
    settings). Raises for an operator not ported. inference/gibbs.py's
    classes map to the port's gibbs.py (its EllipticalSliceOperator is
    not samplers.py's)."""
    from beast_mcmc_tpu_torch.inference import (
        geodesic, gibbs, hmc, nuts, operators, pdmp, samplers,
        tree_operators)

    if type(op).__module__.endswith(".gibbs"):
        return _spec(op, (gibbs,))
    return _spec(op, (operators, tree_operators, hmc, nuts, pdmp, geodesic,
                      samplers))

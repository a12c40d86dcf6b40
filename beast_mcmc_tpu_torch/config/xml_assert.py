"""The parse-time state of an analysis: its parameters and trees at the
document's initial values.

Counterpart of beast_mcmc_tpu/config/xml_assert.py, its `initial_eval_state`
and `_resolving` only (the state the reference's parse-time Reportables
see; the sequence simulator, the reward branch model and the port's
apps/benchmarks.py::measure_makona_joint start from it). The embedded
unit-test element <assertEqual> and its report strings stay with ROADMAP
queue item 5d: the interpreter raises Unsupported on that tag
(config/interpreter.py EXTENSION_TAGS).
"""

from __future__ import annotations

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import LikelihoodFn, XmlAnalysis
from beast_mcmc_tpu_torch.tree.topology import make_tree_state


def initial_eval_state(ax: XmlAnalysis):
    """(params0, tree0) at the document's initial values, on the
    analysis's device. The first tree model rides the tree state; every
    further one rides the params under XmlAnalysis.tree_key, as in a
    chain whose first tree is its primary."""
    params0 = {
        p.name: ax.tensor(p.value, torch.int32 if p.integer else ax.dtype)
        for p in ax._params.values()
    }
    tree0 = None
    for tm in ax._trees.values():
        if tree0 is None:
            tree0 = make_tree_state(tm.parent, tm.children, tm.heights,
                                    tm.root, ax.dtype, ax.device)
            ax._tree_binding.setdefault(tm.tree_id, "state")
        else:
            ax._tree_binding.setdefault(tm.tree_id, "params")
            params0[ax.tree_key(tm.tree_id, "parent")] = ax.tensor(
                tm.parent, torch.long)
            params0[ax.tree_key(tm.tree_id, "children")] = ax.tensor(
                tm.children, torch.long)
            params0[ax.tree_key(tm.tree_id, "heights")] = ax.tensor(
                tm.heights)
            params0[ax.tree_key(tm.tree_id, "root")] = ax.tensor(
                tm.root, torch.long)
    if tree0 is None:
        tree0 = make_tree_state(
            np.array([2, 2, -1]), np.array([[-1, -1], [-1, -1], [0, 1]]),
            np.array([0.0, 0.0, 1.0]), 2, ax.dtype, ax.device)
    return params0, tree0


def _resolving(ax: XmlAnalysis, lik: LikelihoodFn) -> float:
    """lik at the initial state, every tree past the first riding the
    params."""
    params0, tree0 = initial_eval_state(ax)
    return float(lik.fn(params0, tree0))

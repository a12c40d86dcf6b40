"""An empirical tree distribution: MCMC over a fixed sample of trees.

Counterpart of beast_mcmc_tpu/tree/empirical.py
(EmpiricalTreeDistributionModel.java:46,
EmpiricalTreeDistributionOperator.java:44): the tree is one of a finite
set, read from an earlier run's tree log, and a proposal draws a member
uniformly. The whole sample is one stacked set of tensors on the device
([T, M] parents, [T, M, 2] children, ...), and switching trees is a
gather by index, with no host read, so the proposal vmaps over a chain
batch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference.operators import Operator, _zero
from beast_mcmc_tpu_torch.tree.topology import TreeState
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


@dataclasses.dataclass(frozen=True)
class EmpiricalTreeSet:
    parents: torch.Tensor  # int64 [T, M]
    children: torch.Tensor  # int64 [T, M, 2]
    heights: torch.Tensor  # float [T, M]
    roots: torch.Tensor  # int64 [T]

    @property
    def n_trees(self) -> int:
        return self.parents.shape[0]


def stack_trees(trees: Sequence, dtype=DEFAULT_FLOAT,
                device=DEFAULT_DEVICE) -> EmpiricalTreeSet:
    """Stack (parent, children, heights, root) tuples, or TreeStates, over
    one taxon set into one tensor set on the device."""
    ps, cs, hs, rs = [], [], [], []
    for t in trees:
        if hasattr(t, "parent"):
            t = (t.parent, t.children, t.heights, t.root)
        p, c, h, r = (x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x) for x in t)
        ps.append(p)
        cs.append(c)
        hs.append(h)
        rs.append(int(r))
    as_t = lambda x, dt: torch.tensor(np.stack(x), dtype=dt,  # noqa: E731
                                      device=device)
    return EmpiricalTreeSet(parents=as_t(ps, torch.long),
                            children=as_t(cs, torch.long),
                            heights=as_t(hs, dtype),
                            roots=as_t(rs, torch.long))


def tree_at(ts: EmpiricalTreeSet, idx) -> TreeState:
    """Member idx (an int or an int64[1] tensor) as a TreeState."""
    idx = torch.as_tensor(idx, device=ts.parents.device).reshape(1)
    return TreeState(parent=ts.parents[idx][0], children=ts.children[idx][0],
                     heights=ts.heights[idx][0],
                     root=ts.roots[idx].reshape(()))


@dataclasses.dataclass
class EmpiricalTreeOperator(Operator):
    """A uniform redraw over the empirical set: symmetric, log Hastings 0
    (EmpiricalTreeDistributionOperator.doOperation)."""

    trees: EmpiricalTreeSet = None
    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        idx = ops._randint(gen, 0, self.trees.n_trees,
                           tree.heights.device)
        new = tree_at(self.trees, idx)
        return params, new.replace(root=new.root.reshape(tree.root.shape)), \
            _zero(tree)

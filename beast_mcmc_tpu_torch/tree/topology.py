"""Rooted binary time trees as flat index/height tensors.

Counterpart of beast_mcmc_tpu/tree/topology.py. For N taxa and M = 2N-1
nodes: nodes 0..N-1 are tips (index == taxon), N..M-1 internal;
  parent   int64[M]    parent index, -1 at the root
  children int64[M,2]  child indices, -1 for tips
  heights  float[M]    time before present
  root     int64[]     root index (0-d tensor, stays on the device)
Invariant: heights[parent[i]] > heights[i]. Topology moves are index
rewires on these tensors. Indices are int64, PyTorch's index type; the
kernel wrappers narrow them to int32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


@dataclasses.dataclass
class TreeState:
    parent: torch.Tensor
    children: torch.Tensor
    heights: torch.Tensor
    root: torch.Tensor

    def replace(self, **kw) -> "TreeState":
        return dataclasses.replace(self, **kw)


def make_tree_state(parent, children, heights, root, dtype=DEFAULT_FLOAT,
                    device=DEFAULT_DEVICE) -> TreeState:
    def as_t(x, dt):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return TreeState(
        parent=as_t(parent, torch.long),
        children=as_t(children, torch.long),
        heights=as_t(heights, dtype),
        root=as_t(root, torch.long),
    )


def simulate_coalescent_tree(
    rng: np.random.Generator,
    tip_heights: np.ndarray,
    pop_size: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Simulate a serial-sample coalescent start tree on the host.
    Returns numpy (parent, children, heights, root); the same rng stream
    gives the same tree as the JAX package's function of the same name."""
    n = len(tip_heights)
    m = 2 * n - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m, np.float64)
    heights[:n] = tip_heights

    # sweep backwards in time; lineages activate at their tip height;
    # swap-remove on a preallocated active array keeps the loop O(n)
    order = np.argsort(tip_heights, kind="stable")
    active = np.empty(m, np.int64)
    n_active = 0
    next_pending = 0
    t = float(tip_heights[order[0]])
    next_internal = n
    while n_active > 1 or next_pending < n:
        while next_pending < n and tip_heights[order[next_pending]] <= t + 1e-300:
            active[n_active] = order[next_pending]
            n_active += 1
            next_pending += 1
        if n_active < 2:
            t = float(tip_heights[order[next_pending]])
            continue
        k = n_active
        rate = k * (k - 1) / (2.0 * pop_size)
        wait = rng.exponential(1.0 / rate)
        if next_pending < n and t + wait > tip_heights[order[next_pending]]:
            t = float(tip_heights[order[next_pending]])
            continue
        t += wait
        i = int(rng.integers(k))
        j = int(rng.integers(k - 1))
        if j >= i:
            j += 1
        a, b = int(active[i]), int(active[j])
        node = next_internal
        next_internal += 1
        heights[node] = t
        children[node] = (a, b)
        parent[a] = node
        parent[b] = node
        active[i] = node
        active[j] = active[k - 1]
        n_active -= 1
    root = int(active[0])
    return parent, children, heights, root

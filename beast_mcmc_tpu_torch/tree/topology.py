"""Rooted binary time trees as flat index/height tensors.

Counterpart of beast_mcmc_tpu/tree/topology.py. For N taxa and M = 2N-1
nodes: nodes 0..N-1 are tips (index == taxon), N..M-1 internal;
  parent   int64[M]    parent index, -1 at the root
  children int64[M,2]  child indices, -1 for tips
  heights  float[M]    time before present
  root     int64[]     root index (0-d tensor, stays on the device)
Invariant: heights[parent[i]] > heights[i]. Topology moves are index
rewires on these tensors. Indices are int64, PyTorch's index type; the
kernel wrappers narrow them to int32. Newick import and export
(parse_newick, to_newick) and the start-tree simulation are host-side
numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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


def root_height(tree: TreeState) -> torch.Tensor:
    """0-d height of the root, indexed on the device (no host copy)."""
    return tree.heights[tree.root.reshape(1)].reshape(())


# ---------------------------------------------------------------------------
# Newick import/export (role of dr.evolution.io.NewickImporter)
# ---------------------------------------------------------------------------


def parse_newick(
    newick: str,
    taxa: Optional[Sequence[str]] = None,
    tip_heights: Optional[Dict[str, float]] = None,
    dtype=np.float64,
):
    """Parse a Newick string into flat numpy arrays.

    Returns (parent, children, heights, root, taxa_order). If `taxa` is
    given, tip indices follow that order (unlisted taxa are an error);
    otherwise tips are numbered in order of first appearance. Internal
    nodes are numbered N.. in pre-order.

    Heights are computed from branch lengths as (max root-to-tip depth) -
    depth, so contemporaneous tips sit at height 0. If tip_heights is
    given (dated tips), heights are shifted by the mean offset between the
    stated and the depth-derived tip heights.

    The JAX package's parse_newick first tries its native parser, which
    may number internal nodes otherwise; the native module is not ported,
    so this is always the pure-Python parser, `_parse_newick_py`.
    """
    return _parse_newick_py(newick, taxa, tip_heights, dtype)


def _parse_newick_py(
    newick: str,
    taxa: Optional[Sequence[str]] = None,
    tip_heights: Optional[Dict[str, float]] = None,
    dtype=np.float64,
):
    """Pure-Python fallback parser (recursive; fine to ~10^4 tips)."""
    s = newick.strip()
    if s.endswith(";"):
        s = s[:-1]

    pos = 0

    def error(msg):
        raise ValueError(f"newick parse error at {pos}: {msg}")

    # First pass: build a nested structure of (children, label, length)
    def parse_node():
        nonlocal pos
        children = []
        if s[pos] == "(":
            pos += 1
            while True:
                children.append(parse_node())
                if s[pos] == ",":
                    pos += 1
                elif s[pos] == ")":
                    pos += 1
                    break
                else:
                    error(f"expected ',' or ')' got {s[pos]!r}")
        # label
        start = pos
        while pos < len(s) and s[pos] not in ",():;[":
            pos += 1
        label = s[start:pos].strip()
        # comment block (ignored)
        if pos < len(s) and s[pos] == "[":
            depth = 0
            while pos < len(s):
                if s[pos] == "[":
                    depth += 1
                elif s[pos] == "]":
                    depth -= 1
                    if depth == 0:
                        pos += 1
                        break
                pos += 1
        length = None
        if pos < len(s) and s[pos] == ":":
            pos += 1
            start = pos
            while pos < len(s) and s[pos] not in ",():;[":
                pos += 1
            length = float(s[start:pos])
        # strip quotes from label
        if label.startswith("'") and label.endswith("'"):
            label = label[1:-1]
        return (children, label, length)

    tree = parse_node()

    # count tips, assign indices
    tip_names: List[str] = []

    def count_tips(node):
        children, label, _ = node
        if not children:
            tip_names.append(label)
        for c in children:
            count_tips(c)

    count_tips(tree)
    n = len(tip_names)
    if taxa is not None:
        order = {name: i for i, name in enumerate(taxa)}
        missing = [t for t in tip_names if t not in order]
        if missing:
            raise ValueError(f"tips not in taxa list: {missing}")
    else:
        order = {name: i for i, name in enumerate(tip_names)}
        taxa = tip_names

    m = 2 * n - 1
    parent = np.full(m, -1, np.int32)
    children_arr = np.full((m, 2), -1, np.int32)
    depth = np.zeros(m, np.float64)
    next_internal = [n]

    def collapse_unary(node):
        """Merge redundant single-child nodes (extra parentheses in the
        newick), summing branch lengths."""
        kids, label, length = node
        kids = [collapse_unary(k) for k in kids]
        if len(kids) == 1:
            ck, cl, clen = kids[0]
            return (ck, cl, (length or 0.0) + (clen or 0.0))
        return (kids, label, length)

    def assign(node, parent_idx, d):
        kids, label, length = node
        d = d + (length or 0.0)
        if not kids:
            idx = order[label]
        else:
            if len(kids) != 2:
                raise ValueError(
                    f"non-binary node with {len(kids)} children (only rooted "
                    "binary trees are supported)"
                )
            idx = next_internal[0]
            next_internal[0] += 1
        parent[idx] = parent_idx
        depth[idx] = d
        if kids:
            ch = [assign(k, idx, d) for k in kids]
            children_arr[idx] = ch
        return idx

    root = assign(collapse_unary(tree), -1, 0.0)

    max_depth = depth[:n].max()
    heights = max_depth - depth
    if tip_heights:
        # anchor so the youngest dated tip sits at its stated height
        stated = np.array([tip_heights.get(t, 0.0) for t in taxa])
        shift = (stated - heights[:n]).mean()
        heights = heights + shift
    return parent, children_arr, heights.astype(dtype), root, list(taxa)


def to_newick(
    parent: np.ndarray,
    children: np.ndarray,
    heights: np.ndarray,
    root: int,
    taxa: Sequence[str],
    digits: int = 6,
    include_labels: bool = True,
    annotations: Optional[Dict[int, str]] = None,
) -> str:
    """Serialize flat arrays back to Newick (branch lengths from heights).

    `annotations` maps node index -> a BEAST-style bracket comment body
    (e.g. 'location="Fujian"'), emitted as `[&...]` before the branch
    length — the reference's per-node trait annotation format (ref:
    TreeLogger.java / AncestralStateBeagleTreeLikelihood.formatTrait)."""
    children = np.asarray(children)
    heights = np.asarray(heights)
    n = len(taxa)
    ann = annotations or {}

    def fmt_bl(node, par):
        a = ann.get(node)
        s = f"[&{a}]" if a else ""
        if par < 0:
            return s
        bl = heights[par] - heights[node]
        return f"{s}:{bl:.{digits}f}"

    # iterative post-order to avoid recursion limits on big trees
    out: Dict[int, str] = {}
    stack = [(int(root), False)]
    while stack:
        node, done = stack.pop()
        if node < n:
            label = taxa[node] if include_labels else str(node + 1)
            out[node] = label + fmt_bl(node, parent[node])
            continue
        if not done:
            stack.append((node, True))
            stack.append((int(children[node, 0]), False))
            stack.append((int(children[node, 1]), False))
        else:
            l, r = int(children[node, 0]), int(children[node, 1])
            out[node] = f"({out[l]},{out[r]})" + fmt_bl(node, parent[node])
    return out[int(root)] + ";"


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

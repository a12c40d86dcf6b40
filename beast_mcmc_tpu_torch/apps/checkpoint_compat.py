"""BEAST `.chkpt` checkpoint compatibility (read + write).

The reference's checkpointer serializes the chain state as tab-separated
text (ref: src/dr/app/checkpoint/BeastCheckpointer.java:270-440 —
writeStateToFile): an `rng` line, `state`, `lnL`, one `parameter` line
per connected parameter, one `operator` line per operator (accept/reject
counts + adaptable parameter), and per tree model a node-height table
followed by an edge table. This module parses that format into plain
numpy structures and can re-emit it, unlocking online-BEAST workflows
(resume a reference run under this framework and vice versa).

The port's own copy of beast_mcmc_tpu/apps/checkpoint_compat.py: host-side
numpy over this package's modules, the same outputs on the same inputs and
seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ChkptTree:
    name: str
    parent: np.ndarray  # int32[M] (-1 at root)
    children: np.ndarray  # int32[M, 2]
    heights: np.ndarray  # [M]
    taxa: Dict[int, str]  # node index -> taxon (external nodes)
    traits: np.ndarray  # [M, T] per-node trait columns (may be empty)


@dataclasses.dataclass
class ChkptState:
    state: int
    lnl: float
    rng: List[int]
    parameters: "Dict[str, np.ndarray]"
    # name -> (accepted, rejected, adaptable_value, adaptation_count)
    operators: Dict[str, Tuple[int, int, Optional[float], Optional[int]]]
    trees: Dict[str, ChkptTree]


def read_checkpoint(path: str) -> ChkptState:
    """Parse a reference `.chkpt` file (BeastCheckpointer.readStateFromFile
    mirror)."""
    rng: List[int] = []
    state = 0
    lnl = float("nan")
    parameters: Dict[str, np.ndarray] = {}
    operators: Dict[str, Tuple] = {}
    trees: Dict[str, ChkptTree] = {}

    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    i = 0
    n = len(lines)
    while i < n:
        ln = lines[i]
        i += 1
        if not ln.strip():
            continue
        parts = ln.split("\t")
        key = parts[0]
        if key == "rng":
            rng = [int(x) for x in parts[1:]]
        elif key == "state":
            state = int(parts[1])
        elif key == "lnL":
            lnl = float(parts[1])
        elif key == "parameter":
            name = parts[1]
            dim = int(parts[2])
            vals = np.array([float(x) for x in parts[3:3 + dim]])
            parameters[name] = vals
        elif key == "operator":
            name = parts[1]
            acc, rej = int(parts[2]), int(parts[3])
            adapt = float(parts[4]) if len(parts) > 4 else None
            count = int(parts[5]) if len(parts) > 5 else None
            operators[name] = (acc, rej, adapt, count)
        elif key in ("tree", "empirical tree"):
            name = parts[1]
            if key == "empirical tree":
                continue
            # header comment then node count
            while lines[i].startswith("#"):
                i += 1
            node_count = int(lines[i])
            i += 1
            heights = np.zeros(node_count)
            taxa: Dict[int, str] = {}
            for _ in range(node_count):
                row = lines[i].split("\t")
                i += 1
                num = int(row[0])
                heights[num] = float(row[1])
                if len(row) > 2:
                    taxa[num] = row[2]
            while i < n and lines[i].startswith("#"):
                i += 1
            edge_count = int(lines[i])
            i += 1
            parent = np.full(node_count, -1, np.int32)
            children = np.full((node_count, 2), -1, np.int32)
            traits_rows: Dict[int, List[float]] = {}
            # exactly edge_count-1 rows: the root has no edge line
            # (ref: BeastCheckpointer.java:779 loop bound edgeCount - 1)
            for _ in range(edge_count - 1):
                if i >= n or not lines[i].strip():
                    break
                row = lines[i].split("\t")
                if len(row) < 3:
                    break
                i += 1
                child, par, which = int(row[0]), int(row[1]), int(row[2])
                parent[child] = par
                children[par, which] = child
                if len(row) > 3:
                    traits_rows[child] = [float(x) for x in row[3:]]
            t_width = max((len(v) for v in traits_rows.values()),
                          default=0)
            traits = np.zeros((node_count, t_width))
            for node, vals in traits_rows.items():
                traits[node, :len(vals)] = vals
            trees[name] = ChkptTree(name, parent, children, heights,
                                    taxa, traits)
    return ChkptState(state, lnl, rng, parameters, operators, trees)


def write_checkpoint(path: str, st: ChkptState) -> None:
    """Emit the reference text format (BeastCheckpointer parity)."""
    with open(path, "w") as out:
        out.write("rng" + "".join(f"\t{v}" for v in st.rng) + "\n")
        out.write(f"state\t{st.state}\n")
        out.write(f"lnL\t{st.lnl}\n")
        for name, vals in st.parameters.items():
            flat = np.ravel(vals)
            out.write(f"parameter\t{name}\t{flat.size}"
                      + "".join(f"\t{v}" for v in flat) + "\n")
        for name, (acc, rej, adapt, count) in st.operators.items():
            line = f"operator\t{name}\t{acc}\t{rej}"
            if adapt is not None:
                line += f"\t{adapt}\t{count if count is not None else 0}"
            out.write(line + "\n")
        for tree in st.trees.values():
            m = tree.parent.shape[0]
            out.write(f"tree\t{tree.name}\n")
            out.write("#node height taxon\n")
            out.write(f"{m}\n")
            for node in range(m):
                row = f"{node}\t{tree.heights[node]}"
                if node in tree.taxa:
                    row += f"\t{tree.taxa[node]}"
                out.write(row + "\n")
            out.write("#edges\n")
            out.write("#child-node parent-node L/R-child traits\n")
            out.write(f"{m}\n")
            for node in range(m):
                par = int(tree.parent[node])
                if par < 0:
                    continue
                which = 0 if int(tree.children[par, 0]) == node else 1
                row = f"{node}\t{par}\t{which}"
                if tree.traits.shape[1]:
                    row += "".join(f"\t{v}" for v in tree.traits[node])
                out.write(row + "\n")


def chkpt_to_tree_arrays(tree: ChkptTree, taxa_order: List[str]):
    """Remap the checkpoint's node numbering onto this framework's
    convention (tips 0..N-1 in the given taxa order, internals after).
    Returns (parent, children, heights, root)."""
    m = tree.parent.shape[0]
    n = len(taxa_order)
    remap = np.full(m, -1, np.int32)
    next_internal = n
    for node in range(m):
        if node in tree.taxa:
            remap[node] = taxa_order.index(tree.taxa[node])
        else:
            remap[node] = next_internal
            next_internal += 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m)
    for node in range(m):
        nn = int(remap[node])
        heights[nn] = tree.heights[node]
        p = int(tree.parent[node])
        parent[nn] = remap[p] if p >= 0 else -1
        for k in range(2):
            c = int(tree.children[node, k])
            if c >= 0:
                children[nn, k] = remap[c]
    root = int(np.where(parent < 0)[0][0])
    return parent, children, heights, root

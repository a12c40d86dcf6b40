"""Online BEAST: insert new taxa into a checkpointed analysis.

Role of dr.app.realtime.CheckPointTreeModifier
.incorporateAdditionalTaxa (CheckPointTreeModifier.java:341-640) +
CheckPointUpdaterApp's distance-based placement choice
(CheckPointUpdaterApp.java:65-110):

  - each new taxon is placed next to its CLOSEST current taxon under a
    Jukes-Cantor distance on the shared alignment columns;
  - the attachment height follows the reference's cases: equal sampling
    times split the distance-time in half; unequal times place the node
    `remainder/2` above the older tip; a height exceeding the parent
    walks up the donor path (CheckPointTreeModifier.java:539-600);
  - the flat-array tree is re-dimensioned host-side (tips stay in
    0..n'-1 with the new tips appended, internals shift), so the
    resumed chain runs the same kernels at the new shape.

The resume contract: read a BEAST-format `.chkpt`
(apps/checkpoint_compat.py), insert, rebuild the likelihood at the new
shape, and verify the fresh log-posterior is finite before stepping.

The port's own copy of beast_mcmc_tpu/apps/online.py: host-side numpy over
this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def jc_distance(a: np.ndarray, b: np.ndarray, state_count: int = 4) -> float:
    """Jukes-Cantor corrected distance between two state-code rows
    (codes >= state_count are ambiguous and skipped — ref:
    dr.evolution.distance.JukesCantorDistanceMatrix)."""
    ok = (a < state_count) & (b < state_count)
    n = int(ok.sum())
    if n == 0:
        return 0.0
    p = float(((a != b) & ok).sum()) / n
    k = state_count
    ceil = (k - 1.0) / k
    if p >= ceil:
        p = ceil - 1e-9
    return -ceil * np.log(1.0 - p / ceil)


@dataclasses.dataclass
class InsertResult:
    taxa: List[str]
    tip_heights: np.ndarray
    parent: np.ndarray
    children: np.ndarray
    heights: np.ndarray
    root: int
    # old node index -> new node index (tips + internals)
    node_map: np.ndarray


def insert_taxa(
    taxa: Sequence[str],
    parent: np.ndarray,
    children: np.ndarray,
    heights: np.ndarray,
    root: int,
    new_names: Sequence[str],
    new_heights: Sequence[float],
    distance_to_current,  # (new_name, current_name) -> float
    rate: float = 1.0,
    min_dist: float = 1e-9,
    seed: int = 0,
) -> InsertResult:
    """Splice each new taxon next to its closest current taxon
    (ref: CheckPointTreeModifier.java:482-640)."""
    rng = np.random.default_rng(seed)
    taxa = list(taxa)
    n_old = len(taxa)
    k_new = len(new_names)
    m_old = parent.shape[0]
    n_new = n_old + k_new
    m_new = 2 * n_new - 1

    # reindex old nodes: tips keep their index, internals shift by k_new
    node_map = np.array(
        [i if i < n_old else i + k_new for i in range(m_old)], np.int64)
    par = np.full(m_new, -1, np.int64)
    ch = np.full((m_new, 2), -1, np.int64)
    hts = np.zeros(m_new)
    for i in range(m_old):
        ni = node_map[i]
        hts[ni] = heights[i]
        if parent[i] >= 0:
            par[ni] = node_map[int(parent[i])]
        for j in range(2):
            if children[i, j] >= 0:
                ch[ni, j] = node_map[int(children[i, j])]
    root = int(node_map[int(root)])
    next_internal = n_old + k_new + (m_old - n_old)

    current = list(taxa)
    for t, (name, h_new) in enumerate(zip(new_names, new_heights)):
        tip = n_old + t
        hts[tip] = h_new
        # closest current taxon by genetic distance
        dists = [(distance_to_current(name, c), c) for c in current]
        d, closest = min(dists)
        if d == 0.0:
            d = min_dist * float(rng.random())
        closest_idx = taxa.index(closest) if closest in taxa else \
            current.index(closest)
        c_node = closest_idx if closest_idx < n_old else None
        if c_node is None:  # closest is itself a previously-added tip
            c_node = n_old + list(new_names).index(closest)
        time_for_distance = d / rate

        p_node = int(par[c_node])
        split_child = c_node
        h_c = hts[c_node]
        if h_c == h_new:
            insert_h = h_c + time_for_distance / 2.0
        else:
            remainder = (time_for_distance - abs(h_c - h_new)) / 2.0
            if remainder > 0:
                insert_h = max(h_c, h_new) + remainder
            else:
                # new node halfway between the older tip and the branch
                insert_h = max(h_c, h_new) + min_dist * (
                    1.0 + float(rng.random()))
        # walk up while the insertion height exceeds the parent
        while p_node >= 0 and insert_h >= hts[p_node]:
            if par[p_node] < 0:
                insert_h = hts[split_child] + 0.5 * (
                    hts[p_node] - hts[split_child])
                break
            split_child = p_node
            p_node = int(par[p_node])
        lo = max(hts[split_child], h_new)
        hi = hts[p_node] if p_node >= 0 else insert_h + time_for_distance
        if not (lo < insert_h < hi):
            insert_h = lo + 0.5 * (hi - lo) if hi > lo else lo + min_dist

        # splice: new internal between split_child and its parent
        ni = next_internal
        next_internal += 1
        hts[ni] = insert_h
        ch[ni, 0] = split_child
        ch[ni, 1] = tip
        par[tip] = ni
        old_parent = int(par[split_child])
        par[split_child] = ni
        par[ni] = old_parent
        if old_parent >= 0:
            row = ch[old_parent]
            row[row == split_child] = ni
            ch[old_parent] = row
        else:
            root = ni
        current.append(name)

    out_taxa = list(taxa) + list(new_names)
    return InsertResult(
        taxa=out_taxa,
        tip_heights=hts[:n_new].copy(),
        parent=par.astype(np.int32),
        children=ch.astype(np.int32),
        heights=hts,
        root=root,
        node_map=node_map,
    )


def insert_taxa_by_alignment(
    taxa, parent, children, heights, root,
    alignment_states: Dict[str, np.ndarray],
    new_names, new_heights, rate: float = 1.0,
    state_count: int = 4, seed: int = 0,
) -> InsertResult:
    """Distance-choice wrapper: JC distances from a name -> state-codes
    mapping (old and new taxa; ref: CheckPointUpdaterApp UpdateChoice
    JC matrix)."""

    def dist(a, b):
        return jc_distance(alignment_states[a], alignment_states[b],
                           state_count)

    return insert_taxa(taxa, parent, children, heights, root,
                       new_names, new_heights, dist, rate=rate, seed=seed)


def online_update_from_chkpt(
    chkpt_path: str,
    tree_name: str,
    alignment_states: Dict[str, np.ndarray],
    new_names, new_heights,
    rate: Optional[float] = None,
    clock_rate_param: str = "clock.rate",
    state_count: int = 4,
) -> Tuple[InsertResult, Dict[str, np.ndarray]]:
    """Read a BEAST-format checkpoint, insert the new taxa, and return
    (inserted tree, checkpoint parameter values) ready for a resumed
    chain at the extended shape."""
    from beast_mcmc_tpu_torch.apps.checkpoint_compat import read_checkpoint

    st = read_checkpoint(chkpt_path)
    tr = st.trees[tree_name]
    taxa = [tr.taxa[i] for i in sorted(tr.taxa)]
    if rate is None:
        rate = float(np.ravel(st.parameters.get(clock_rate_param, [1.0]))[0])
    res = insert_taxa_by_alignment(
        taxa, tr.parent, tr.children, tr.heights, int(
            np.nonzero(tr.parent < 0)[0][0]),
        alignment_states, new_names, new_heights, rate=rate,
        state_count=state_count,
    )
    return res, dict(st.parameters)

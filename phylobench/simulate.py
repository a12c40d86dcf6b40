"""Alignments simulated along a tree, as the source documents make theirs
(BEAST's `beagleSequenceSimulator`): a serial coalescent tree, then each
site's states drawn down it from the root under a reversible generator,
a Gamma category a site and a clock rate a branch; then the columns
compressed to patterns at a fixed width. Plain NumPy and PyTorch: the
benchmark's data, made before the program sees it."""

from __future__ import annotations

import heapq

import numpy as np
import torch


def coalescent_tree(rng, tip_heights, pop_size):
    """(parent [2N-1], heights [2N-1]) of a constant-size coalescent over
    tips at `tip_heights` (serial sampling): tips 0..N-1, internal nodes
    N.. in order of their time, so every parent's index is above its
    children's and the root is 2N-2."""
    tip_heights = np.asarray(tip_heights, np.float64)
    n = tip_heights.size
    order = np.argsort(tip_heights, kind="stable")
    parent = np.full(2 * n - 1, -1, np.int64)
    heights = np.zeros(2 * n - 1)
    heights[:n] = tip_heights
    active, t, nxt, node = [int(order[0])], tip_heights[order[0]], 1, n
    while node < 2 * n - 1:
        k = len(active)
        wait = (rng.exponential(pop_size / (0.5 * k * (k - 1))) if k > 1
                else np.inf)
        if nxt < n and t + wait >= tip_heights[order[nxt]]:
            t = tip_heights[order[nxt]]  # a sample joins (memoryless wait)
            active.append(int(order[nxt]))
            nxt += 1
            continue
        t += wait
        i, j = sorted(rng.choice(k, 2, replace=False), reverse=True)
        parent[active.pop(i)] = parent[active.pop(j)] = node
        heights[node] = t
        active.append(node)
        node += 1
    return parent, heights


def children(parent):
    """[2N-1, 2] children of each node of `coalescent_tree` (-1 at tips)."""
    kids = np.full((parent.size, 2), -1, np.int64)
    for c in range(parent.size - 1):
        kids[parent[c], int(kids[parent[c], 0] >= 0)] = c
    return kids


def newick(parent, heights, names) -> str:
    """The tree of `coalescent_tree` as a Newick string, branch lengths at
    full float64 precision."""
    m = parent.size
    n = (m + 1) // 2
    kids = [[] for _ in range(m)]
    for c in range(m - 1):
        kids[parent[c]].append(c)
    s = list(names) + [""] * (m - n)
    for v in range(n, m):
        s[v] = "(" + ",".join(f"{s[c]}:{float(heights[v] - heights[c])!r}"
                              for c in kids[v]) + ")"
    return s[m - 1] + ";"


def sequences(parent, heights, branch_rates, q, freqs, cat_rates, n_sites,
              gen, device):
    """Tip states [N, n_sites] (int16) drawn down the tree of
    `coalescent_tree`: root states from `freqs`, a Gamma category a site,
    and each child's state from the row of exp(Q t r_branch r_cat) at its
    parent's state. q [S, S] reversible, freqs [S] and cat_rates [C] as
    float64 tensors on `device`; `gen` a torch.Generator there."""
    m = parent.size
    n = (m + 1) // 2
    s, c = q.shape[0], cat_rates.shape[0]
    f64 = dict(dtype=torch.float64, device=device)
    d = torch.sqrt(freqs)
    w, v = torch.linalg.eigh(q * d[:, None] / d[None, :])
    t = np.zeros(m)
    t[:-1] = (heights[parent[:-1]] - heights[:-1]) * branch_rates[:-1]
    e = torch.exp(w * torch.as_tensor(t, **f64)[:, None, None]
                  * cat_rates[None, :, None])  # [M, C, S]
    pm = ((v * e[..., None, :]) @ v.T) * (d[None, :] / d[:, None])
    pm = pm.clamp_min(0.0)
    cdf = torch.cumsum(pm / pm.sum(-1, keepdim=True), -1)
    cdf[..., -1] = 1.0
    cdf = cdf.reshape(m, c * s, s)
    cat = torch.randint(c, (n_sites,), generator=gen, device=device)
    states = torch.empty((m, n_sites), dtype=torch.int16, device=device)
    u = torch.rand((n_sites, 1), generator=gen, **f64)
    states[m - 1] = (u > torch.cumsum(freqs, 0)[None, :-1]).sum(-1)
    depth = np.zeros(m, np.int64)
    for node in range(m - 2, -1, -1):  # parents before their children
        depth[node] = depth[parent[node]] + 1
    for level in range(1, int(depth.max()) + 1):
        nodes = np.flatnonzero(depth == level)
        idx = (cat[None, :] * s + states[torch.as_tensor(
            parent[nodes], device=device)].long())  # [nb, L]
        rows = torch.gather(cdf[torch.as_tensor(nodes, device=device)], 1,
                            idx[..., None].expand(-1, -1, s))
        u = torch.rand((nodes.size, n_sites, 1), generator=gen, **f64)
        states[torch.as_tensor(nodes, device=device)] = (
            (u > rows[..., :-1]).sum(-1).to(torch.int16))
    return states[:n].cpu().numpy()


def patterns(states, width):
    """(columns [N, width], weights [width]) of an alignment: its distinct
    columns with their counts, the most frequent split in halves until
    there are `width` columns (a split column's halves peel alike, so the
    likelihood is the compressed one, at the kernel's width)."""
    packed = np.ascontiguousarray(states.T.astype(np.int8))
    _, first, counts = np.unique(packed.view(f"V{packed.shape[1]}")[:, 0],
                                 return_index=True, return_counts=True)
    cols = states[:, first]
    if cols.shape[1] > width:
        raise ValueError(f"{cols.shape[1]} distinct columns exceed the "
                         f"width {width}")
    heap = [(-int(k), i, i) for i, k in enumerate(counts)]
    heapq.heapify(heap)
    serial = len(heap)
    while len(heap) < width:
        k, _, col = heapq.heappop(heap)
        if -k < 2:
            raise ValueError(f"{int(counts.sum())} sites cannot fill "
                             f"{width} columns")
        for half in (-k // 2, -k - (-k // 2)):
            heapq.heappush(heap, (-half, serial, col))
            serial += 1
    keep = sorted((col, serial, -k) for k, serial, col in heap)
    index = np.asarray([col for col, _, _ in keep])
    weights = np.asarray([k for _, _, k in keep], np.float64)
    return cols[:, index], weights

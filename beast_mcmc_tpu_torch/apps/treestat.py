"""TreeStat: tree-statistic calculator over posterior tree samples.

Role of the reference's TreeStat app (ref: src/dr/app/treestat/ — GUI/CLI
computing per-tree summary statistics over NEXUS/Newick tree files) and
of the in-model tree statistics (src/dr/evomodel/tree/*Statistic).

Statistics (host-side numpy; trees as flat arrays):
  rootHeight, treeLength, externalLength, internalLength, ILratio,
  nodeCount, cherryCount, collessImbalance (normalized), B1,
  gammaStatistic (Pybus & Harvey 2000), treeness, maxTipHeight.

The port's own copy of beast_mcmc_tpu/apps/treestat.py: host-side numpy
over this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

from beast_mcmc_tpu_torch.tree.topology import parse_newick


def tree_statistics(parent, children, heights, root, n_taxa: int) -> Dict[str, float]:
    parent = np.asarray(parent)
    children = np.asarray(children)
    heights = np.asarray(heights)
    m = parent.shape[0]
    root = int(root)
    bl = np.where(parent >= 0, heights[np.maximum(parent, 0)] - heights, 0.0)
    external = bl[:n_taxa]
    internal = bl[n_taxa:]
    tree_len = float(bl.sum())

    # cherries: internal nodes with two tip children
    is_tip_child = children[n_taxa:] < n_taxa
    cherries = int(np.sum(np.all(is_tip_child, axis=1)))

    # tips under each internal node (for Colless / B1)
    n_under = np.ones(m)
    order = np.argsort(heights[n_taxa:]) + n_taxa
    for v in order:
        n_under[v] = n_under[children[v, 0]] + n_under[children[v, 1]]
    colless = 0.0
    b1 = 0.0
    for v in range(n_taxa, m):
        l, r = children[v]
        colless += abs(n_under[l] - n_under[r])
        if v != root:
            # B1: sum over internal non-root of 1/max depth-to-tip (in edges)
            pass
    n = n_taxa
    colless_norm = (
        2.0 * colless / ((n - 1) * (n - 2)) if n > 2 else 0.0
    )

    # max node-to-tip steps for B1
    depth_steps = np.zeros(m)
    for v in order:
        depth_steps[v] = 1 + max(
            depth_steps[children[v, 0]], depth_steps[children[v, 1]]
        )
    b1 = float(sum(
        1.0 / depth_steps[v] for v in range(n_taxa, m) if v != root
    ))

    # gamma statistic (ultrametric trees): from internode intervals
    coal_times = np.sort(heights[n_taxa:])[::-1]  # g_2..g_n intervals
    # intervals g_k = time during which k lineages exist (contemporaneous)
    times_desc = np.concatenate([coal_times, [0.0]])
    g = times_desc[:-1] - times_desc[1:]  # g[k-2] for k=2..n lineages
    ks = np.arange(2, n + 1)
    t_total = float(np.sum(ks * g))
    if n > 2 and t_total > 0:
        inner = [
            float(np.sum(ks[: i - 1] * g[: i - 1]))
            for i in range(2, n)
        ]
        mean_inner = np.mean(inner) if inner else 0.0
        gamma = (mean_inner - t_total / 2.0) / (
            t_total * np.sqrt(1.0 / (12.0 * (n - 2)))
        )
    else:
        gamma = 0.0

    # ---- interval structure (ref: TreeIntervals) -------------------------
    # events ascending in height; lineage count within each interval
    ev = np.sort(heights)
    is_coal = np.zeros(m, bool)
    is_coal[n_taxa:] = True
    order_all = np.argsort(heights, kind="stable")
    lineages = 0
    iv_len: List[float] = []
    iv_k: List[int] = []
    prev = None
    for idx in order_all:
        h = heights[idx]
        if prev is not None and h > prev:
            iv_len.append(float(h - prev))
            iv_k.append(lineages)
        lineages += -1 if is_coal[idx] else 1
        prev = h

    def total_time_k(k):
        return sum(L for L, c in zip(iv_len, iv_k) if c == k)

    def lineage_count_at(t):
        tot = 0.0
        for L, c in zip(iv_len, iv_k):
            tot += L
            if tot > t:
                return float(c)
        return 1.0

    # ---- N_bar (ref: Nbar.java:42-53) ------------------------------------
    depth_edges = np.zeros(m)
    for v in order_all[::-1]:
        if parent[v] >= 0:
            depth_edges[v] = depth_edges[parent[v]] + 1
    nbar = float(depth_edges[:n_taxa].mean())

    # ---- Delta (ref: DeltaStatistic.java:44-62) --------------------------
    # same interval construction as gamma but the inner sum runs root-ward
    if n > 2 and t_total > 0:
        ssum = 0.0
        for i in range(n, 2, -1):
            for k in range(n, i - 1, -1):
                ssum += 0.5 * k * (k - 1) * g[k - 2]
        delta = ((t_total / 2.0) - ssum / (n - 2.0)) / (
            t_total * np.sqrt(1.0 / (12.0 * (n - 2))))
    else:
        delta = 0.0

    # ---- Fu & Li's D (ref: FuLiD.java:44-114; note the JAVA INTEGER
    # division in v(n)'s (n+1)/(n-1) term) ---------------------------------
    a_n = sum(1.0 / k for k in range(1, n))
    b_n = sum(1.0 / (k * k) for k in range(1, n))
    if n == 2:
        c_n = 1.0
    else:
        c_n = 2.0 * (n * a_n - 2.0 * (n - 1.0)) / ((n - 1) * (n - 2))
    v_n = 1 + (a_n * a_n / (b_n + a_n * a_n)) * (c_n - ((n + 1) // (n - 1)))
    u_n = a_n - 1 - v_n
    total = float(external.sum() + internal.sum())
    fld = total - a_n * float(external.sum())
    denom = u_n * total + v_n * total * total
    fu_li_d = float(fld / np.sqrt(denom)) if denom > 0 else 0.0

    # ---- root-to-tip path lengths (ref: RootToTipLengths.java) -----------
    path = np.zeros(m)
    for v in order_all[::-1]:
        if parent[v] >= 0:
            path[v] = path[parent[v]] + bl[v]
    root_to_tip_mean = float(path[:n_taxa].mean())

    # ---- rank proportions (ref: RankProportionStatistic.java — rank 1 =
    # external branches; rank r = internal branches subtending r tips) ----
    def rank_length(r):
        if r == 1:
            return float(external.sum())
        return float(sum(bl[v] for v in range(n_taxa, m)
                         if v != root and n_under[v] == r))

    half_h = float(heights[root]) / 2.0

    return {
        "rootHeight": float(heights[root]),
        "treeLength": tree_len,
        "externalLength": float(external.sum()),
        "internalLength": float(internal.sum()),
        "ILratio": float(internal.sum() / max(external.sum(), 1e-300)),
        "nodeCount": float(m),
        "cherryCount": float(cherries),
        "collessImbalance": float(colless_norm),
        "B1": b1,
        "gammaStatistic": float(gamma),
        "deltaStatistic": float(delta),
        "fuLiD": fu_li_d,
        "N_bar": nbar,
        "treeness": float(internal.sum() / max(tree_len, 1e-300)),
        "maxTipHeight": float(heights[:n_taxa].max()),
        "minInternalHeight": float(heights[n_taxa:].min()),
        "meanInternalHeight": float(heights[n_taxa:].mean()),
        "singleChildCount": 0.0,  # binary encoding has no unary nodes
        "TMRCA(all)": float(heights[root]),
        "rootToTipMeanLength": root_to_tip_mean,
        "maxRootToTipLength": float(path[:n_taxa].max()),
        "TotalTime(2)": float(total_time_k(2)),
        "TotalTime(3)": float(total_time_k(3)),
        "TotalTime(4)": float(total_time_k(4)),
        "LineageCount(rootHeight/2)": lineage_count_at(half_h),
        "LineageProportion(rootHeight/2)": lineage_count_at(half_h) / n,
        "RankProportion(2)": rank_length(2) / max(tree_len, 1e-300),
        "RankProportion(3)": rank_length(3) / max(tree_len, 1e-300),
        "intervalCount": float(len(iv_len)),
    }


def treestat_report(
    newicks: Iterable[str],
    taxa: Sequence[str] = None,
) -> List[Dict[str, float]]:
    """Per-tree statistics for a sequence of Newick strings (the CLI
    surface of the reference's TreeStat)."""
    out = []
    for nwk in newicks:
        parent, children, heights, root, t = parse_newick(nwk, taxa=taxa)
        out.append(tree_statistics(parent, children, heights, root, len(t)))
    return out


def format_report(rows: List[Dict[str, float]]) -> str:
    if not rows:
        return ""
    cols = list(rows[0].keys())
    lines = ["tree\t" + "\t".join(cols)]
    for i, r in enumerate(rows):
        lines.append(
            f"{i}\t" + "\t".join(f"{r[c]:.6g}" for c in cols)
        )
    return "\n".join(lines)


def main(argv=None):
    """TreeStat CLI (ref: dr.app.treestat.TreeStatApp): per-tree summary
    statistics over a file of newick trees (one per line; '#NEXUS' tree
    blocks accepted via their 'tree NAME = ...' lines)."""
    import argparse
    import re
    import sys

    p = argparse.ArgumentParser(prog="beast_mcmc_tpu_torch treestat")
    p.add_argument("trees", help="newick-per-line or NEXUS trees file")
    p.add_argument("-output", default=None)
    args = p.parse_args(argv)
    text = open(args.trees).read()
    if text.lstrip().startswith("#NEXUS"):
        newicks = [m.group(1) for m in re.finditer(
            r"tree\s+\S+\s*=\s*(?:\[[^\]]*\]\s*)?([^;]+;)", text)]
    else:
        newicks = [ln.strip() for ln in text.splitlines() if ln.strip()]
    rep = format_report(treestat_report(newicks))
    if args.output:
        open(args.output, "w").write(rep + "\n")
    else:
        sys.stdout.write(rep + "\n")
    return 0

"""TreeAnnotator: summarize a posterior tree sample.

Role of dr.app.tools.treeannotator (ref: src/dr/app/tools/treeannotator/
TreeAnnotator.java, CladeSystem.java): collect clade posterior
frequencies, select the Maximum Clade Credibility (MCC) tree, and annotate
its nodes with posterior support and height summaries (mean / median /
95% HPD over the trees containing each clade).

The port's own copy of beast_mcmc_tpu/apps/treeannotator.py: host-side
numpy over this package's modules, the same outputs on the same inputs and
seeds.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from beast_mcmc_tpu_torch.data.io import read_nexus
from beast_mcmc_tpu_torch.tree.topology import parse_newick


def hpd_interval(samples: np.ndarray, prob: float = 0.95) -> Tuple[float, float]:
    """Shortest interval containing `prob` mass (ref: dr.stats.DiscreteStatistics.HPD)."""
    x = np.sort(np.asarray(samples))
    n = len(x)
    k = max(1, int(np.ceil(prob * n)))
    widths = x[k - 1:] - x[: n - k + 1]
    i = int(np.argmin(widths))
    return float(x[i]), float(x[i + k - 1])


@dataclasses.dataclass
class TreeSample:
    parent: np.ndarray
    children: np.ndarray
    heights: np.ndarray
    root: int
    taxa: List[str]


def _clades_of(tree: TreeSample) -> Dict[int, int]:
    """node index -> clade bitmask of tip indices (iterative post-order)."""
    n = len(tree.taxa)
    m = len(tree.parent)
    mask = [0] * m
    # process nodes in height order (children first)
    order = sorted(range(m), key=lambda i: tree.heights[i])
    for node in order:
        if node < n:
            mask[node] = 1 << node
        else:
            c0, c1 = tree.children[node]
            mask[node] = mask[c0] | mask[c1]
    return {node: mask[node] for node in range(m)}


def summarize_trees(
    trees: Sequence[TreeSample],
    burnin_fraction: float = 0.1,
    prob: float = 0.95,
):
    """Returns (mcc tree, clade support dict, per-node annotations)."""
    n_burn = int(len(trees) * burnin_fraction)
    kept = list(trees[n_burn:])
    if not kept:
        raise ValueError("no trees after burn-in")
    n_trees = len(kept)

    clade_count: Dict[int, int] = {}
    clade_heights: Dict[int, List[float]] = {}
    per_tree_clades = []
    for t in kept:
        clades = _clades_of(t)
        per_tree_clades.append(clades)
        for node, c in clades.items():
            if node < len(t.taxa):
                continue
            clade_count[c] = clade_count.get(c, 0) + 1
            clade_heights.setdefault(c, []).append(float(t.heights[node]))

    # MCC: maximize sum of log clade credibilities
    best_i, best_score = 0, -np.inf
    for i, clades in enumerate(per_tree_clades):
        score = 0.0
        for node, c in clades.items():
            if node < len(kept[i].taxa):
                continue
            score += np.log(clade_count[c] / n_trees)
        if score > best_score:
            best_i, best_score = i, score
    mcc = kept[best_i]
    clades = per_tree_clades[best_i]

    annotations = {}
    for node in range(len(mcc.parent)):
        c = clades[node]
        if node < len(mcc.taxa):
            continue
        hs = np.asarray(clade_heights[c])
        lo, hi = hpd_interval(hs, prob)
        annotations[node] = {
            "posterior": clade_count[c] / n_trees,
            "height_mean": float(hs.mean()),
            "height_median": float(np.median(hs)),
            "height_hpd_lower": lo,
            "height_hpd_upper": hi,
        }
    support = {c: k / n_trees for c, k in clade_count.items()}
    return mcc, support, annotations


def hipstr_tree(
    trees: Sequence[TreeSample],
    burnin_fraction: float = 0.1,
    prob: float = 0.95,
):
    """HIPSTR: Highest Independent Posterior Subtree Reconstruction.

    Unlike MCC (which picks the best SAMPLED tree), HIPSTR assembles the
    tree maximizing the product of clade credibilities over all clade
    SPLITS observed anywhere in the sample, by dynamic programming from
    small clades up (ref: src/dr/app/tools/treeannotator/
    HIPSTRTreeBuilder.java — the reference's default summary since v10).
    Returns (tree, support, annotations) like summarize_trees.
    """
    n_burn = int(len(trees) * burnin_fraction)
    kept = list(trees[n_burn:])
    if not kept:
        raise ValueError("no trees after burn-in")
    n_trees = len(kept)
    n = len(kept[0].taxa)

    clade_count: Dict[int, int] = {}
    clade_heights: Dict[int, List[float]] = {}
    split_set: Dict[int, set] = {}
    for t in kept:
        clades = _clades_of(t)
        for node in range(n, len(t.parent)):
            c = clades[node]
            clade_count[c] = clade_count.get(c, 0) + 1
            clade_heights.setdefault(c, []).append(float(t.heights[node]))
            c0, c1 = t.children[node]
            m0, m1 = clades[c0], clades[c1]
            split_set.setdefault(c, set()).add((min(m0, m1), max(m0, m1)))

    # DP: best log-credibility achievable for the subtree on each clade
    score: Dict[int, float] = {1 << i: 0.0 for i in range(n)}
    best_split: Dict[int, Tuple[int, int]] = {}
    for c in sorted(clade_count, key=lambda m: bin(m).count("1")):
        best, arg = -np.inf, None
        for (m0, m1) in split_set[c]:
            s = score.get(m0, -np.inf) + score.get(m1, -np.inf)
            if s > best:
                best, arg = s, (m0, m1)
        score[c] = np.log(clade_count[c] / n_trees) + best
        best_split[c] = arg

    root_mask = (1 << n) - 1
    if root_mask not in best_split:
        raise ValueError("tree sample has inconsistent taxon sets")

    m = 2 * n - 1
    parent = np.full(m, -1, np.int32)
    children = np.full((m, 2), -1, np.int32)
    heights = np.zeros(m, np.float64)
    node_clade: Dict[int, int] = {}
    next_node = [n]

    def build(mask: int) -> int:
        if bin(mask).count("1") == 1:
            node = mask.bit_length() - 1
            heights[node] = float(np.mean(
                [t.heights[node] for t in kept]))
            return node
        node = next_node[0]
        next_node[0] += 1
        node_clade[node] = mask
        m0, m1 = best_split[mask]
        c0, c1 = build(m0), build(m1)
        children[node] = (c0, c1)
        parent[c0] = parent[c1] = node
        h = float(np.mean(clade_heights[mask]))
        # common-ancestor heights can invert on rarely-co-observed clades
        heights[node] = max(h, heights[c0] + 1e-9, heights[c1] + 1e-9)
        return node

    root = build(root_mask)
    tree = TreeSample(parent, children, heights, root, list(kept[0].taxa))

    annotations = {}
    for node in range(n, m):
        c = node_clade[node]
        hs = np.asarray(clade_heights[c])
        lo, hi = hpd_interval(hs, prob)
        annotations[node] = {
            "posterior": clade_count[c] / n_trees,
            "height_mean": float(hs.mean()),
            "height_median": float(np.median(hs)),
            "height_hpd_lower": lo,
            "height_hpd_upper": hi,
        }
    support = {c: k / n_trees for c, k in clade_count.items()}
    return tree, support, annotations


def annotated_newick(mcc: TreeSample, annotations: Dict[int, dict],
                     set_mean_heights: bool = False) -> str:
    """MCC tree with [&...] NHX-style annotations (FigTree-compatible)."""
    n = len(mcc.taxa)
    heights = mcc.heights.copy()
    if set_mean_heights:
        for node, ann in annotations.items():
            heights[node] = ann["height_mean"]

    def fmt(node):
        if node < n:
            label = mcc.taxa[node]
            ann = ""
        else:
            c0, c1 = mcc.children[node]
            label = f"({fmt(c0)},{fmt(c1)})"
            a = annotations[node]
            ann = (f"[&posterior={a['posterior']:.4f},"
                   f"height_mean={a['height_mean']:.6g},"
                   f"height_median={a['height_median']:.6g},"
                   f"height_95%_HPD={{{a['height_hpd_lower']:.6g},"
                   f"{a['height_hpd_upper']:.6g}}}]")
        par = mcc.parent[node]
        bl = f":{heights[par] - heights[node]:.6g}" if par >= 0 else ""
        return label + ann + bl

    return fmt(mcc.root) + ";"


def read_trees_file(path: str) -> List[TreeSample]:
    _, newicks = read_nexus(open(path).read())
    out = []
    taxa = None
    for name, nwk in newicks.items():
        parent, children, heights, root, t = parse_newick(nwk, taxa=taxa)
        taxa = taxa or t
        out.append(TreeSample(parent, children, heights, int(root), list(t)))
    return out


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    burnin = 0.1
    builder = "mcc"
    files = []
    i = 0
    while i < len(args):
        if args[i] in ("-burnin", "--burnin"):
            burnin = float(args[i + 1]); i += 2
        elif args[i] in ("-type", "--type"):  # mcc | hipstr (ref CLI flag)
            builder = args[i + 1]; i += 2
        else:
            files.append(args[i]); i += 1
    trees = read_trees_file(files[0])
    if builder == "hipstr":
        mcc, support, ann = hipstr_tree(trees, burnin)
    else:
        mcc, support, ann = summarize_trees(trees, burnin)
    out = annotated_newick(mcc, ann)
    if len(files) > 1:
        open(files[1], "w").write(out + "\n")
    else:
        print(out)


if __name__ == "__main__":
    main()

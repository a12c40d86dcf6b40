"""Run loggers: tab-delimited parameter logs and NEXUS tree logs.

Own copy of beast_mcmc_tpu/inference/loggers.py on the port's to_newick,
the role of dr.inference.loggers.MCLogger (MCLogger.java:45-100: a
column-based tab log at logEvery, Tracer-compatible) and
dr.evomodel.tree.TreeLogger (NEXUS with a taxon TRANSLATE table).

The chain collects its samples on the device (run_chain's collector) and
the runner copies them to the host once; these host-side writers format
the collected batches. They can also be driven row by row.
"""

from __future__ import annotations

import sys
from typing import Dict, IO, List, Optional, Sequence

import numpy as np

from beast_mcmc_tpu_torch.tree.topology import to_newick


class TabLogger:
    """Tracer-compatible tab-delimited log (ref: TabDelimitedFormatter)."""

    def __init__(self, columns: Sequence[str], out: IO = sys.stdout,
                 title: str = ""):
        self.columns = list(columns)
        self.out = out
        self._header_written = False
        self.title = title

    def write_header(self):
        if self.title:
            self.out.write(f"# {self.title}\n")
        self.out.write("state\t" + "\t".join(self.columns) + "\n")
        self._header_written = True

    def log(self, state_num: int, values: Dict[str, float]):
        if not self._header_written:
            self.write_header()
        row = [f"{int(state_num)}"]
        for c in self.columns:
            v = values[c]
            row.append(f"{float(v):.10g}")
        self.out.write("\t".join(row) + "\n")

    def log_batch(self, states: np.ndarray, values: Dict[str, np.ndarray]):
        for i, s in enumerate(np.asarray(states)):
            self.log(int(s), {c: np.asarray(values[c])[i] for c in self.columns})
        self.out.flush()


class NexusTreeLogger:
    """NEXUS tree log with TRANSLATE table (ref: TreeLogger.java)."""

    def __init__(self, taxa: Sequence[str], out: IO = sys.stdout):
        self.taxa = list(taxa)
        self.out = out
        self._open = False

    def write_header(self):
        n = len(self.taxa)
        self.out.write("#NEXUS\n\nBegin taxa;\n")
        self.out.write(f"\tDimensions ntax={n};\n\tTaxlabels\n")
        for t in self.taxa:
            self.out.write(f"\t\t{t}\n")
        self.out.write("\t\t;\nEnd;\n\nBegin trees;\n\tTranslate\n")
        for i, t in enumerate(self.taxa):
            sep = "," if i < n - 1 else ""
            self.out.write(f"\t\t{i + 1} {t}{sep}\n")
        self.out.write("\t\t;\n")
        self._open = True

    def log_tree(self, state_num: int, parent, children, heights, root,
                 annotations=None):
        if not self._open:
            self.write_header()
        newick = to_newick(
            np.asarray(parent), np.asarray(children), np.asarray(heights),
            int(root), [str(i + 1) for i in range(len(self.taxa))],
            include_labels=True, annotations=annotations,
        )
        self.out.write(f"tree STATE_{int(state_num)} = [&R] {newick}\n")

    def log_batch(self, states, parents, childrens, heightss, roots,
                  annotations=None):
        for i, s in enumerate(np.asarray(states)):
            self.log_tree(
                int(s), parents[i], childrens[i], heightss[i], roots[i],
                annotations=None if annotations is None else annotations[i],
            )
        self.out.flush()

    def close(self):
        if self._open:
            self.out.write("End;\n")
            self.out.flush()


def write_run_files(taxa: Sequence[str], states, table: Dict[str, np.ndarray],
                    tree_states, trees, log_file: Optional[str] = None,
                    tree_file: Optional[str] = None, annotations=None,
                    title: str = ""):
    """Write a run's collected samples: the tab log of `table` ({column:
    [R]}, in its key order) at `states` [R] to log_file, and the NEXUS log
    of `trees` (parents, childrens, heights, roots, each [T, ...]) at
    tree_states [T], with one {node: text} dict of annotations a tree where
    given, to tree_file. A file left as None is not written."""
    if log_file:
        with open(log_file, "w") as f:
            TabLogger(list(table), f, title=title).log_batch(states, table)
    if tree_file:
        with open(tree_file, "w") as f:
            tl = NexusTreeLogger(taxa, f)
            if len(tree_states):
                tl.log_batch(tree_states, *trees, annotations=annotations)
            tl.close()

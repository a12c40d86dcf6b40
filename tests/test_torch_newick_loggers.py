"""The port's Newick parser and writer, run loggers and trace statistics
against the JAX package's.

parse_newick's arrays equal the JAX package's pure-Python parser
(`_parse_newick_py`) exactly, and its clades and heights equal JAX's
parse_newick (which may take its native parser and number internal nodes
otherwise) to 1e-12, on the primate tree, a dated tree and a 200-tip
random tree; to_newick (with node annotations), TabLogger and
NexusTreeLogger write the same bytes as JAX's given the same arrays;
trace.analyze gives JAX's statistics on a seeded AR(1) series exactly.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from beast_mcmc_tpu.inference import loggers as jax_loggers
from beast_mcmc_tpu.inference import trace as jax_trace
from beast_mcmc_tpu.tree import topology as jax_topology

from beast_mcmc_tpu_torch.inference import loggers, trace
from beast_mcmc_tpu_torch.tree.topology import (
    _parse_newick_py,
    parse_newick,
    simulate_coalescent_tree,
    to_newick,
)

from fixtures import PRIMATE_NEWICK, PRIMATE_TAXA

HEIGHT_TOL = 1e-12
DATED = ("((a:1.5,b:0.5):2.0,((c:0.25,d:1.0):0.75,'e f':3.0):0.5);",
         {"a": 0.0, "b": 1.0, "c": 2.0, "d": 1.25, "e f": 0.0})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: small tensors, and six test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_newick(n_taxa, seed):
    """A coalescent tree of n_taxa tips written by JAX's to_newick with
    twelve digits."""
    parent, children, heights, root = simulate_coalescent_tree(
        np.random.default_rng(seed), np.zeros(n_taxa), 1.0)
    taxa = [f"t{i}" for i in range(n_taxa)]
    return jax_topology.to_newick(parent, children, heights, root, taxa,
                                  digits=12), taxa


def _cases():
    rnd, rnd_taxa = _random_newick(200, 11)
    return {"primate": (PRIMATE_NEWICK, PRIMATE_TAXA, None),
            "primate, first appearance": (PRIMATE_NEWICK, None, None),
            "dated": (DATED[0], list(DATED[1]), DATED[1]),
            "random 200": (rnd, rnd_taxa[::-1], None)}


CASES = _cases()


def _clades(parent, children, heights, root, names):
    """{frozenset of tip names below a node: its height}."""
    n = len(names)
    below = {}

    def walk(node):
        if node < n:
            return frozenset([names[node]])
        s = walk(int(children[node, 0])) | walk(int(children[node, 1]))
        below[s] = float(heights[node])
        return s

    walk(int(root))
    for i in range(n):
        below[frozenset([names[i]])] = float(heights[i])
    return below


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_newick_matches_jax(name):
    newick, taxa, tip_heights = CASES[name]
    got = parse_newick(newick, taxa=taxa, tip_heights=tip_heights)
    ref = jax_topology._parse_newick_py(newick, taxa=taxa,
                                        tip_heights=tip_heights)
    for out in (got, _parse_newick_py(newick, taxa, tip_heights)):
        for g, r in zip(out[:4], ref[:4]):
            np.testing.assert_array_equal(g, r)
        assert out[4] == ref[4]
    # JAX's parse_newick, native parser or not: the same clades and heights
    ref2 = jax_topology.parse_newick(newick, taxa=taxa,
                                     tip_heights=tip_heights)
    c_got, c_ref = _clades(*got), _clades(*ref2)
    assert c_got.keys() == c_ref.keys()
    for k in c_got:
        assert c_got[k] == pytest.approx(c_ref[k], abs=HEIGHT_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_to_newick_round_trip_and_annotations(name):
    newick, taxa, tip_heights = CASES[name]
    parent, children, heights, root, names = parse_newick(
        newick, taxa=taxa, tip_heights=tip_heights)
    ann = {i: f'location="s{i % 3}"' for i in range(0, len(parent), 2)}
    for kw in ({}, {"annotations": ann}, {"include_labels": False},
               {"digits": 9}):
        assert (to_newick(parent, children, heights, root, names, **kw)
                == jax_topology.to_newick(parent, children, heights, root,
                                          names, **kw))
    # written with twelve digits and read back: the same clades
    text = to_newick(parent, children, heights, root, names, digits=12)
    back = parse_newick(text, taxa=names, tip_heights=tip_heights)
    c0, c1 = _clades(parent, children, heights, root, names), _clades(*back)
    assert c0.keys() == c1.keys()
    for k in c0:
        assert c1[k] == pytest.approx(c0[k], abs=1e-9)


def test_loggers_write_jax_bytes():
    """TabLogger and NexusTreeLogger, row by row and in batches, with an
    annotated tree, byte for byte against JAX's."""
    rng = np.random.default_rng(4)
    cols = ["posterior", "p1.kappa", "treeModel.rootHeight"]
    states = np.arange(10, 60, 10)
    values = {c: rng.normal(size=5) * 10.0 ** rng.integers(-6, 6)
              for c in cols}
    texts = []
    for mod in (loggers, jax_loggers):
        out = io.StringIO()
        lg = mod.TabLogger(cols, out, title="a run")
        lg.log_batch(states, values)
        lg.log(70, {c: values[c][0] for c in cols})
        texts.append(out.getvalue())
    assert texts[0] == texts[1]

    trees = [simulate_coalescent_tree(np.random.default_rng(s),
                                      rng.random(7), 0.5) for s in range(3)]
    taxa = [f"taxon_{i}" for i in range(7)]
    stacked = [np.stack([t[i] for t in trees]) for i in range(4)]
    ann = {i: f'location="x{i}"' for i in range(13)}
    texts = []
    for mod in (loggers, jax_loggers):
        out = io.StringIO()
        tl = mod.NexusTreeLogger(taxa, out)
        tl.log_batch(states[:3], *stacked)
        tl.log_tree(99, *trees[0], annotations=ann)
        tl.close()
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert texts[0].startswith("#NEXUS") and 'location="x12"' in texts[0]


@pytest.mark.parametrize("n,step", [(5000, 10), (300, 1), (1, 5), (2, 3)])
def test_trace_analyze_matches_jax(n, step):
    rng = np.random.default_rng(n)
    x = np.empty(n)
    x[0] = rng.normal()
    for i in range(1, n):
        x[i] = 0.9 * x[i - 1] + rng.normal()
    assert (dataclasses.astuple(trace.analyze(x, step))
            == dataclasses.astuple(jax_trace.analyze(x, step)))
    assert (trace.effective_sample_size(x)
            == jax_trace.effective_sample_size(x))

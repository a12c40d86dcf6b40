"""Sequence simulation down a tree, site-pattern compression, and the
seqgen tool.

Counterpart of <beagleSequenceSimulator> (beast_mcmc_tpu/config/
xml_geo.py:598-739) and of beast_mcmc_tpu/apps/seqgen.py (the SeqGen /
piBUSS role, SeqGen.java:56): each site draws its rate category from the
category weights and its root state from the root frequencies; every other
node's state is drawn from the row of its branch's transition matrix
P(t r_b r_c) at its parent's state (t the branch's time length, r_b its
clock rate, r_c the site's category rate), negative round-off clipped and
each row renormalised. The nodes go by levels of depth from the root, one
batched draw a level, on the tree's device and from a torch.Generator, so
the full Makona alignment (1,610 taxa x 18,996 sites) is made on the card.
The law is the JAX package's; the draws are not (jax.random's stream cannot
be matched), so the two are held to each other statistically.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from beast_mcmc_tpu_torch.data.alignment import Alignment
from beast_mcmc_tpu_torch.data.datatype import NUCLEOTIDES, DataType
from beast_mcmc_tpu_torch.models.sitemodel import (
    discrete_gamma_rates,
    single_rate,
)
from beast_mcmc_tpu_torch.models.substitution import gtr_eigen, hky_eigen
from beast_mcmc_tpu_torch.models.treelikelihood import (
    branch_transition_matrices,
)
from beast_mcmc_tpu_torch.ops.peeling import node_depths
from beast_mcmc_tpu_torch.tree.topology import parse_newick
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE

# [nodes x sites x states] entries drawn at once, to bound the scratch
_CHUNK = 1 << 24


def simulate_states(parent: torch.Tensor, p_mats: torch.Tensor,
                    cat_weights: torch.Tensor, root_freqs: torch.Tensor,
                    n_sites: int, generator: torch.Generator) -> torch.Tensor:
    """int64[M, n_sites] states of every node: parent int64[M] (-1 at the
    root), p_mats [M, C, S, S] of each node's parent branch."""
    dev = p_mats.device
    m, _, s, _ = p_mats.shape
    p = torch.clamp_min(p_mats.to(torch.float64), 0.0)
    cdf = torch.cumsum(p / p.sum(-1, keepdim=True), dim=-1)
    cats = torch.multinomial(cat_weights.to(torch.float64), n_sites,
                             replacement=True, generator=generator)
    states = torch.empty((m, n_sites), dtype=torch.long, device=dev)
    root = torch.nonzero(parent < 0).reshape(-1)
    states[root] = torch.multinomial(root_freqs.to(torch.float64), n_sites,
                                     replacement=True,
                                     generator=generator)[None]
    depth = node_depths(parent)
    by_depth = torch.sort(depth, stable=True).indices
    sizes = torch.bincount(depth).tolist()  # one copy to the host
    levels = torch.split(by_depth, sizes)[1:]
    step = max(1, _CHUNK // (n_sites * s))
    for nodes in levels:
        for a in range(0, nodes.shape[0], step):
            sub = nodes[a:a + step]
            rows = cdf[sub[:, None], cats[None, :], states[parent[sub]]]
            u = torch.rand(rows.shape[:2], generator=generator,
                           dtype=torch.float64, device=dev)
            states[sub] = torch.clamp((u[..., None] > rows).sum(-1),
                                      max=s - 1)
    return states


def compress_patterns(states: torch.Tensor):
    """(pattern states int64[N, P], weights float64[P]) of the columns of
    states [N, L]: the unique columns in order of first occurrence (as
    data/alignment.py::SitePatterns.from_alignment), on the tensor's
    device."""
    uniq, inverse, counts = torch.unique(states, dim=1, return_inverse=True,
                                         return_counts=True)
    n_sites = states.shape[1]
    first = torch.full((uniq.shape[1],), n_sites, dtype=torch.long,
                       device=states.device)
    first = first.scatter_reduce(0, inverse, torch.arange(
        n_sites, device=states.device), reduce="amin")
    order = torch.argsort(first)
    return uniq[:, order], counts[order].to(torch.float64)


def one_hot_tips(pattern_states: torch.Tensor, n_states: int,
                 dtype=torch.float64) -> torch.Tensor:
    """[N, S, P] tip partials of unambiguous states [N, P]."""
    return torch.nn.functional.one_hot(pattern_states, n_states).to(
        dtype).transpose(1, 2).contiguous()


def simulate_alignment(generator: torch.Generator, taxa, parent, children,
                       heights, root, eig, freqs, category_rates,
                       category_weights, branch_rates, n_sites: int,
                       datatype: DataType = NUCLEOTIDES) -> Alignment:
    """The tips' states of n_sites columns simulated down the tree (parent
    and heights as tensors on the generator's device; children and root, of
    JAX's signature, are implied by parent) under the eigensystem, root
    frequencies, site model and clock rate, as an Alignment (JAX
    simulate_alignment, its key replaced by `generator`)."""
    p_mats = branch_transition_matrices(eig, parent, heights, branch_rates,
                                        category_rates)
    states = simulate_states(parent, p_mats, category_weights, freqs,
                             n_sites, generator)
    return Alignment(list(taxa), states[:len(taxa)].cpu().numpy().astype(
        np.int16), datatype)


# ---------------------------------------------------------------------------
# piBUSS-style CLI (dr.app.bss / BeagleSequenceSimulator app surface)
# ---------------------------------------------------------------------------


def _parse_partition(spec: str) -> dict:
    """'length=500,model=HKY,kappa=2,alpha=0.5,ncat=4,rate=1.0,
    freqs=0.25:0.25:0.25:0.25' -> options dict."""
    out = {"length": 500, "model": "HKY", "kappa": 2.0, "alpha": None,
           "ncat": 4, "rate": 1.0, "freqs": [0.25, 0.25, 0.25, 0.25]}
    for item in spec.split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        k = k.strip()
        if k == "freqs":
            out[k] = [float(x) for x in v.split(":")]
        elif k in ("length", "ncat"):
            out[k] = int(v)
        elif k == "model":
            out[k] = v.upper()
        else:
            out[k] = float(v)
    return out


def _partition_alignment(generator, taxa, parent, children, heights, root,
                         opt) -> Alignment:
    """One partition of `opt` (_parse_partition's) simulated on the tree's
    device: JC, GTR (its "gtr_rates", all 1 by default) or HKY; the
    discrete gamma of "alpha" over "ncat" categories or one rate; the clock
    rate "rate"."""
    dev = heights.device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    freqs = t(opt["freqs"])
    freqs = freqs / torch.sum(freqs)
    if opt["model"] == "JC":
        freqs = t([0.25] * 4)
        eig = hky_eigen(t(1.0), freqs)
    elif opt["model"] == "GTR":
        eig = gtr_eigen(t(opt.get("gtr_rates", [1.0] * 6)), freqs)
    else:  # HKY
        eig = hky_eigen(t(opt["kappa"]), freqs)
    if opt["alpha"]:
        r, w = discrete_gamma_rates(t(opt["alpha"]), opt["ncat"])
    else:
        r, w = single_rate(device=dev)
    return simulate_alignment(generator, taxa, parent, children, heights,
                              root, eig, freqs, r, w, t(opt["rate"]),
                              opt["length"])


def main(argv=None) -> int:
    """piBUSS-role CLI: simulate a (multi-partition) alignment down a
    newick tree (dr.app.bss.BeagleSequenceSimulatorApp: partitions with
    their own substitution, site and clock models; FASTA or NEXUS out), on
    the card unless -device cpu."""
    p = argparse.ArgumentParser(
        prog="beast_mcmc_tpu_torch seqgen",
        description="Simulate sequence alignments down a tree "
                    "(SeqGen / piBUSS role)")
    p.add_argument("-tree", required=True,
                   help="newick tree file (branch lengths = time)")
    p.add_argument("-partition", action="append", default=None,
                   metavar="SPEC",
                   help="length=500,model=HKY,kappa=2,alpha=0.5,ncat=4,"
                        "rate=1.0,freqs=0.25:0.25:0.25:0.25 "
                        "(repeat for multiple partitions)")
    p.add_argument("-seed", type=int, default=42)
    p.add_argument("-format", choices=("fasta", "nexus"), default="fasta")
    p.add_argument("-output", default=None, help="output file (stdout)")
    p.add_argument("-device", default=DEFAULT_DEVICE,
                   help="torch device of the simulation: cuda (default) "
                        "or cpu")
    args = p.parse_args(argv)

    with open(args.tree) as f:
        nwk = f.read().strip()
    parent, children, heights, root, taxa = parse_newick(nwk)
    specs = [_parse_partition(s) for s in (args.partition or ["length=500"])]
    dev = torch.device(args.device)
    tree = [torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
            for x, dt in ((parent, torch.long), (children, torch.long),
                          (heights, torch.float64))]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    states = np.concatenate([_partition_alignment(
        gen, taxa, *tree, int(root), opt).states for opt in specs], axis=1)

    chars = np.frombuffer("".join(NUCLEOTIDES.code_chars[:4]).encode(),
                          np.uint8)
    seqs = {t: chars[states[i]].tobytes().decode()
            for i, t in enumerate(taxa)}
    if args.format == "fasta":
        text = "".join(f">{t}\n{seqs[t]}\n" for t in taxa)
    else:
        n, n_sites = len(taxa), states.shape[1]
        body = "\n".join(f"{t}  {seqs[t]}" for t in taxa)
        text = ("#NEXUS\nbegin data;\n"
                f"dimensions ntax={n} nchar={n_sites};\n"
                "format datatype=dna gap=-;\nmatrix\n"
                f"{body}\n;\nend;\n")
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0

"""Makona-1610 under GTR+G4, an uncorrelated lognormal clock and a skygrid.

The phylogeny half of the Makona-1610 joint analysis (Dudas et al. 2017),
built by the program's own spec builder (`config/builder.py::build`) from
an `AnalysisSpec`, with no XML parse: the constants, and the operators
with their weights, are those of `examples/makona_joint.xml` as
`makona1610_ucld_skygrid.json` holds them. The alignment is made as the
document makes it: 18,996 sites simulated along the start tree (a serial
coalescent at the document's initial population size) under the
document's GTR+G4 and UCLD values, then compressed to patterns at the
real alignment's width (`phylobench/simulate.py`); the chains start from
that tree. On the card a 1,610-taxon GTR+G4 partition peels through the
deep level kernel (`csrc/peel_stream.cu`), one launch for every chain of
a batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_EXCHANGE = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The data both sides read: tip states [N, P] (0..3), pattern weights
    [P] (whole numbers >= 1 summing to the sites), tip heights [N] (years
    before the latest date), and the start tree (`parent`, `heights`) the
    sites were simulated along: the same tree in every run (`tree_seed`),
    the sites and the branches' rate categories drawn from `seed`."""
    import torch

    from phylobench import simulate
    from phylobench.reference import _plain

    n = cfg["taxa"]
    dates = np.asarray(cfg["dates"][:n], np.float64)
    tip_heights = dates.max() - dates
    parent, heights = simulate.coalescent_tree(
        np.random.default_rng(cfg["tree_seed"]), tip_heights,
        cfg["start_pop_size"])
    rng = np.random.default_rng([seed, 0x6d616b])
    m = 2 * n - 1
    categories = rng.permutation(np.arange(m) % (m - 1))
    clock = _plain.lognormal_category_rates(
        categories[None], np.asarray([cfg["ucld_mean"]]),
        np.asarray([cfg["ucld_stdev"]]), m - 1)[0]
    f64 = dict(dtype=torch.float64, device=device)
    exch = torch.zeros((4, 4), **f64)
    for rate, (i, j) in zip(cfg["gtr_rates"], _EXCHANGE):
        exch[i, j] = exch[j, i] = rate
    freqs = torch.tensor(cfg["frequencies"], **f64)
    cat_rates = torch.as_tensor(_plain.gamma_category_rates(
        np.asarray([cfg["alpha"]]), cfg["gamma_categories"])[0], **f64)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 62)))
    sites = simulate.sequences(parent, heights, clock,
                               _plain.reversible_q(exch, freqs), freqs,
                               cat_rates, cfg["sites"], gen, device)
    states, weights = simulate.patterns(sites, cfg["patterns"])
    return {"states": states, "weights": weights, "tip_heights": tip_heights,
            "parent": parent, "heights": heights}


def _operators(built, document):
    """The document's operators, in its order and at its weights, out of
    those the builder made; what the document has not is left out."""
    out = []
    for entry in document:
        match = [op for op in built if type(op).__name__ == entry["class"]
                 and getattr(op, "parameter", "") == entry.get(
                     "parameter", "")]
        if len(match) != 1:
            raise ValueError(f"operator {entry} matches {len(match)}")
        out.append(dataclasses.replace(match[0], weight=entry["weight"]))
    return out


def build(cfg: dict, seed: int, device) -> dict:
    """The program's analysis of this configuration on `device`: its
    chain-axis posterior, operators and start point, with the inputs the
    reference is handed."""
    import torch

    from beast_mcmc_tpu_torch.config import spec as S
    from beast_mcmc_tpu_torch.config.builder import build as build_analysis
    from beast_mcmc_tpu_torch.data.alignment import SitePatterns
    from beast_mcmc_tpu_torch.data.datatype import NUCLEOTIDES
    from beast_mcmc_tpu_torch.inference.tree_operators import (
        SubtreeSlideOperator)
    from phylobench import simulate

    inputs = make_inputs(cfg, seed, device)
    n = cfg["taxa"]
    taxa = [f"taxon{i}" for i in range(n)]
    weight = {e.get("parameter"): e["weight"] for e in cfg["operators"]}
    patterns = SitePatterns(taxa=taxa, states=inputs["states"],
                            weights=inputs["weights"], datatype=NUCLEOTIDES,
                            n_sites=cfg["sites"])
    spec = S.AnalysisSpec(
        partitions=[S.Partition(
            patterns=patterns,
            substitution=S.GTR(
                rates=S.Param(np.asarray(cfg["gtr_rates"]),
                              prior=S.GammaPrior(*cfg["gtr_rates_prior"]),
                              operator_weight=weight["p1.gtr.rates"]),
                frequencies=cfg["frequencies"]),
            site_model=S.SiteModel(
                categories=cfg["gamma_categories"],
                alpha=S.Param(cfg["alpha"],
                              operator_weight=weight["p1.alpha"])))],
        tree=S.TreeSpec(newick=simulate.newick(inputs["parent"],
                                               inputs["heights"], taxa),
                        tip_heights=dict(zip(taxa,
                                             inputs["tip_heights"].tolist()))),
        clock=S.RelaxedClockLognormal(
            mean=S.Param(cfg["ucld_mean"], prior=S.ExponentialPrior(
                cfg["ucld_mean_prior_mean"]),
                operator_weight=weight["ucld.mean"]),
            stdev=S.Param(cfg["ucld_stdev"],
                          operator_weight=weight["ucld.stdev"])),
        tree_prior=S.SkygridCoalescent(
            n_cells=cfg["skygrid_cells"], cutoff=cfg["skygrid_cutoff"],
            log_pop_init=cfg["skygrid_log_pop"],
            precision=S.Param(cfg["skygrid_precision"],
                              prior=S.GammaPrior(*cfg["precision_prior"]),
                              operator_weight=weight["skygrid.precision"])),
        extra_operators=[SubtreeSlideOperator(**e["args"])
                         for e in cfg["operators"]
                         if e["class"] == "SubtreeSlideOperator"],
        dtype=getattr(torch, cfg["dtype"]))
    analysis = build_analysis(spec, device=device)
    return {"log_posterior_chains": analysis.log_posterior_chains,
            "operators": _operators(analysis.operators, cfg["operators"]),
            "derived": None,
            "params0": analysis.params0, "tree0": analysis.tree0,
            "inputs": inputs,
            "shape": {"taxa": n, "nodes": 2 * n - 1, "categories":
                      cfg["gamma_categories"], "states": 4,
                      "patterns": -(-cfg["patterns"] // 128) * 128}}

"""BeastGen role: generate a runnable AnalysisSpec from a data file plus a
named template (ref: src/dr/app/beastgen/ — FreeMarker templates filled
from an alignment; build_beastgen.xml). Here templates are spec factories,
so the output is the framework's typed config rather than XML text.

CLI: python -m beast_mcmc_tpu_torch.apps.beastgen <template> <data.fasta>
     [--chain-length N] [--log-every N] [--date-regex REGEX]

The port's own copy of beast_mcmc_tpu/apps/beastgen.py: host-side numpy
over this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Optional

from beast_mcmc_tpu_torch.config.spec import (
    AnalysisSpec,
    ConstantCoalescent,
    GTR,
    HKY,
    MCMCSpec,
    Param,
    Partition,
    RelaxedClockLognormal,
    SiteModel,
    SkygridCoalescent,
    StrictClock,
    TreeSpec,
    YulePrior,
)
from beast_mcmc_tpu_torch.data.alignment import SitePatterns
from beast_mcmc_tpu_torch.data.io import read_fasta


def tip_heights_from_names(names, date_regex: Optional[str]
                           ) -> Optional[Dict[str, float]]:
    """Tip dates parsed from taxon labels (the reference BeastGen's
    -date_regex/-date_order options); dates (forward time) convert to
    heights as (max date - date)."""
    if date_regex is None:
        return None
    pat = re.compile(date_regex)
    dates = {}
    for n in names:
        m = pat.search(n)
        if m:
            dates[n] = float(m.group(1) if m.groups() else m.group(0))
    if not dates:
        return None
    latest = max(dates.values())
    return {n: latest - d for n, d in dates.items()}


TEMPLATES = {}


def template(name):
    def deco(fn):
        TEMPLATES[name] = fn
        return fn

    return deco


@template("hky_strict_constant")
def _hky_strict_constant(patterns, tip_heights):
    return AnalysisSpec(
        partitions=[Partition(patterns=patterns, substitution=HKY(),
                              site_model=SiteModel())],
        tree=TreeSpec(tip_heights=tip_heights),
        clock=StrictClock(),
        tree_prior=ConstantCoalescent(),
    )


@template("gtr_gamma_relaxed_skygrid")
def _gtr_gamma_relaxed_skygrid(patterns, tip_heights):
    return AnalysisSpec(
        partitions=[Partition(
            patterns=patterns, substitution=GTR(),
            site_model=SiteModel(categories=4, alpha=Param(0.5)))],
        tree=TreeSpec(tip_heights=tip_heights),
        clock=RelaxedClockLognormal(),
        tree_prior=SkygridCoalescent(),
    )


@template("hky_gamma_strict_yule")
def _hky_gamma_strict_yule(patterns, tip_heights):
    return AnalysisSpec(
        partitions=[Partition(
            patterns=patterns, substitution=HKY(),
            site_model=SiteModel(categories=4, alpha=Param(0.5)))],
        tree=TreeSpec(tip_heights=tip_heights),
        clock=StrictClock(),
        tree_prior=YulePrior(),
    )


def generate(template_name: str, fasta_path: str = None, *,
             fasta_text: str = None, chain_length: int = 100_000,
             log_every: int = 100, date_regex: Optional[str] = None
             ) -> AnalysisSpec:
    """Fill a template from a FASTA file (or in-memory FASTA text) into a
    complete AnalysisSpec."""
    if template_name not in TEMPLATES:
        raise KeyError(
            f"unknown template {template_name!r}; have {sorted(TEMPLATES)}"
        )
    if fasta_text is None:
        with open(fasta_path) as fh:
            fasta_text = fh.read()
    aln = read_fasta(fasta_text)
    tip_heights = tip_heights_from_names(aln.taxa, date_regex)
    patterns = SitePatterns.from_alignment(aln)
    spec = TEMPLATES[template_name](patterns, tip_heights)
    spec.mcmc = MCMCSpec(chain_length=chain_length, log_every=log_every)
    return spec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("template", choices=sorted(TEMPLATES))
    ap.add_argument("data")
    ap.add_argument("--chain-length", type=int, default=100_000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--date-regex", default=None)
    ap.add_argument("--run", action="store_true",
                    help="run the analysis after generating")
    args = ap.parse_args(argv)
    spec = generate(args.template, args.data, chain_length=args.chain_length,
                    log_every=args.log_every, date_regex=args.date_regex)
    print(spec)
    if args.run:
        from beast_mcmc_tpu_torch.apps.runner import run_analysis

        run_analysis(spec)


if __name__ == "__main__":
    main()

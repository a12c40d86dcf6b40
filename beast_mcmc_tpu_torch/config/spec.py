"""Declarative analysis specification: the role of BEAST's XML.

Own copy of beast_mcmc_tpu/config/spec.py (dataclasses and numpy only).
The reference assembles models from an XML document via its registered
parsers (XMLParser.java:131-220, release_parsers.properties); here the same
vocabulary is a typed dataclass tree, and `config.builder.build()` turns a
spec into (log_posterior, operators, initial params, initial tree), the
object-graph construction of XMLParser.convert.

The spec names mirror the XML element vocabulary, so reference analyses
translate mechanically:
  <HKYModel kappa frequencies>       -> HKY(kappa=Param(...), frequencies=...)
  <siteModel gammaShape pInv>        -> SiteModel(categories, alpha, p_invariant)
  <strictClockBranchRates rate>      -> StrictClock(rate=Param(...))
  <constantSize populationSize>      -> ConstantCoalescent(pop_size=Param(...))
  <scaleOperator|upDownOperator|...> -> auto-generated defaults or explicit list
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# priors (names mirror inferencexml/distribution parsers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LogNormalPrior:
    mu: float = 0.0  # log-space mean (meanInRealSpace=false convention)
    sigma: float = 1.0


@dataclasses.dataclass
class NormalPrior:
    mean: float = 0.0
    stdev: float = 1.0


@dataclasses.dataclass
class GammaPrior:
    shape: float = 1.0
    scale: float = 1.0


@dataclasses.dataclass
class ExponentialPrior:
    mean: float = 1.0


@dataclasses.dataclass
class UniformPrior:
    lower: float = 0.0
    upper: float = 1.0


@dataclasses.dataclass
class OneOnXPrior:
    pass


@dataclasses.dataclass
class DirichletPrior:
    alpha: Union[float, Sequence[float]] = 1.0


@dataclasses.dataclass
class CTMCScalePrior:
    """Reference prior for the overall clock rate (tree/CTMCScalePrior.java)."""
    pass


Prior = Union[
    LogNormalPrior, NormalPrior, GammaPrior, ExponentialPrior,
    UniformPrior, OneOnXPrior, DirichletPrior, CTMCScalePrior,
]


@dataclasses.dataclass
class Param:
    """A named model parameter: initial value, bounds, prior, estimability.

    Role of <parameter id value lower upper> + the attached prior element.
    """

    init: Any = 1.0
    lower: float = 0.0
    upper: float = float("inf")
    prior: Optional[Prior] = None
    estimate: bool = True
    # operator hint: weight of the default operator (0 disables)
    operator_weight: float = 1.0


# ---------------------------------------------------------------------------
# substitution models (evomodelxml/substmodel parsers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JC69:
    pass


@dataclasses.dataclass
class HKY:
    kappa: Param = dataclasses.field(
        default_factory=lambda: Param(2.0, prior=LogNormalPrior(1.0, 1.25)))
    frequencies: Union[str, Sequence[float]] = "empirical"  # or "equal"/values


@dataclasses.dataclass
class TN93:
    kappa1: Param = dataclasses.field(default_factory=lambda: Param(2.0, prior=LogNormalPrior(1.0, 1.25)))
    kappa2: Param = dataclasses.field(default_factory=lambda: Param(2.0, prior=LogNormalPrior(1.0, 1.25)))
    frequencies: Union[str, Sequence[float]] = "empirical"


@dataclasses.dataclass
class GTR:
    rates: Param = dataclasses.field(
        default_factory=lambda: Param(np.ones(6), prior=GammaPrior(0.05, 20.0),
                                      operator_weight=2.0))
    frequencies: Union[str, Sequence[float]] = "empirical"


@dataclasses.dataclass
class GeneralReversible:
    """K-state reversible CTMC (discrete traits / phylogeography); with
    bssvs=True, exchangeabilities get binary indicators (SVS, ref:
    SVSGeneralSubstitutionModel.java)."""

    n_states: int = 2
    rates: Optional[Param] = None
    frequencies: Union[str, Sequence[float]] = "equal"
    bssvs: bool = False


Substitution = Union[JC69, HKY, TN93, GTR, GeneralReversible]


# ---------------------------------------------------------------------------
# site / clock models
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SiteModel:
    """<siteModel> with optional gamma + invariant (GammaSiteModel role)."""

    categories: int = 1
    alpha: Optional[Param] = None  # gamma shape; None => no gamma
    p_invariant: Optional[Param] = None
    mu: Optional[Param] = None  # relative rate (partition-level)


@dataclasses.dataclass
class StrictClock:
    rate: Param = dataclasses.field(
        default_factory=lambda: Param(1.0, estimate=False))


@dataclasses.dataclass
class RelaxedClockLognormal:
    """Uncorrelated lognormal, discretized per-branch categories
    (DiscretizedBranchRates role)."""

    mean: Param = dataclasses.field(default_factory=lambda: Param(1.0))
    stdev: Param = dataclasses.field(
        default_factory=lambda: Param(0.3333, prior=ExponentialPrior(1.0 / 3.0)))


Clock = Union[StrictClock, RelaxedClockLognormal]


# ---------------------------------------------------------------------------
# tree priors (coalescent / speciation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConstantCoalescent:
    pop_size: Param = dataclasses.field(
        default_factory=lambda: Param(1.0, prior=OneOnXPrior(), operator_weight=3.0))


@dataclasses.dataclass
class ExponentialGrowthCoalescent:
    pop_size: Param = dataclasses.field(
        default_factory=lambda: Param(1.0, prior=OneOnXPrior(), operator_weight=3.0))
    growth_rate: Param = dataclasses.field(
        default_factory=lambda: Param(0.0, lower=-float("inf"),
                                      prior=NormalPrior(0.0, 1.0)))


@dataclasses.dataclass
class SkygridCoalescent:
    """GMRF skygrid (GMRFSkygridLikelihood role): K cells on a fixed grid
    to cutoff; gamma prior on the GMRF precision."""

    n_cells: int = 16
    cutoff: float = 1.0
    log_pop_init: float = 0.0
    precision: Param = dataclasses.field(
        default_factory=lambda: Param(0.1, prior=GammaPrior(0.001, 1000.0)))


@dataclasses.dataclass
class YulePrior:
    birth_rate: Param = dataclasses.field(
        default_factory=lambda: Param(2.0, prior=OneOnXPrior()))


@dataclasses.dataclass
class BirthDeathPrior:
    birth_diff_rate: Param = dataclasses.field(
        default_factory=lambda: Param(2.0, prior=OneOnXPrior()))
    relative_death_rate: Param = dataclasses.field(
        default_factory=lambda: Param(0.5, upper=1.0, prior=UniformPrior(0.0, 1.0)))


TreePrior = Union[
    ConstantCoalescent, ExponentialGrowthCoalescent, SkygridCoalescent,
    YulePrior, BirthDeathPrior,
]


# ---------------------------------------------------------------------------
# tree + run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeSpec:
    """<treeModel> + starting tree (<coalescentTree> or <newick>)."""

    newick: Optional[str] = None  # starting topology; None => simulate
    sim_pop_size: float = 1.0
    seed: int = 1
    # dated tips: taxon -> height (time before present); None => all 0
    tip_heights: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class MCMCSpec:
    chain_length: int = 100_000
    log_every: int = 100
    tree_log_every: int = 0  # 0 => same as log_every
    adaptation: bool = True  # autoOptimize
    adaptation_delay: int = 0
    seed: int = 42


@dataclasses.dataclass
class Partition:
    """One data partition: patterns + its models (multi-partition analyses
    give each partition its own SiteModel/Substitution, sharing tree+clock;
    ref: MultiPartitionDataLikelihoodDelegate)."""

    patterns: Any  # data.SitePatterns
    substitution: Substitution = dataclasses.field(default_factory=HKY)
    site_model: SiteModel = dataclasses.field(default_factory=SiteModel)
    name: str = "partition"
    use_ambiguities: bool = True


@dataclasses.dataclass
class AnalysisSpec:
    partitions: List[Partition] = dataclasses.field(default_factory=list)
    tree: TreeSpec = dataclasses.field(default_factory=TreeSpec)
    clock: Clock = dataclasses.field(default_factory=StrictClock)
    tree_prior: TreePrior = dataclasses.field(default_factory=ConstantCoalescent)
    mcmc: MCMCSpec = dataclasses.field(default_factory=MCMCSpec)
    # extra operators appended to the auto-generated defaults
    extra_operators: List[Any] = dataclasses.field(default_factory=list)
    dtype: Any = None

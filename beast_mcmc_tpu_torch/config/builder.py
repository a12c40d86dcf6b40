"""Spec -> runnable analysis (the XMLParser.convert role).

Counterpart of beast_mcmc_tpu/config/builder.py. build(spec) walks the
AnalysisSpec, registers the parameters, composes the log posterior as a
function of (params, tree), and generates the default operator schedule
(the role BEAUti's generator plays for XML, OperatorsGenerator.java: the
weights and operator kinds follow the reference's defaults). The
parameter names, priors, operators and weights are the JAX package's.

The likelihood of each partition goes through models/treelikelihood.py::
tree_loglikelihood, so through ops/cuda_peeling.py::peel_route to the
card's kernels for CUDA tensors (a 1,610-taxon GTR+Gamma4 partition:
one peel_stream launch an evaluation) and to their plain versions on the
CPU. There is no derived cache: every evaluation rebuilds the eigensystem
and the rates, as the JAX package's does.

`Analysis.log_posterior_chains(params, tree) -> [B]` is the same posterior
over a chain batch (params [B, ...], the tree's fields [B, M], as
inference/mc3.py::replicate_state makes them), the port's form of
jax.vmap(log_posterior) that the JAX package's MC3 runs: every model term
carries the chain axis, a fixed parameter is broadcast over it, and each
partition is one peel for all B chains (one kernel launch on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.config import spec as S
from beast_mcmc_tpu_torch.inference import operators as O
from beast_mcmc_tpu_torch.models import clock as clock_models
from beast_mcmc_tpu_torch.models import coalescent as coal
from beast_mcmc_tpu_torch.models import priors as P
from beast_mcmc_tpu_torch.models import sitemodel as sm
from beast_mcmc_tpu_torch.models import speciation as spn
from beast_mcmc_tpu_torch.models import substitution as subst
from beast_mcmc_tpu_torch.models.treelikelihood import (
    branch_lengths,
    tree_loglikelihood,
)
from beast_mcmc_tpu_torch.ops.peeling import pad_patterns
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    parse_newick,
    simulate_coalescent_tree,
)
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, default_float


@dataclasses.dataclass
class Analysis:
    log_posterior: Callable
    log_posterior_chains: Callable
    log_likelihood: Callable
    log_prior: Callable
    operators: List[O.Operator]
    params0: Dict[str, torch.Tensor]
    tree0: Any
    taxa: List[str]
    spec: S.AnalysisSpec
    n_taxa: int


def _prior_logpdf(prior, value, aux, chains=False):
    """The prior's log density at value; [B] with `chains` (value [B, ...],
    aux["tree_length"] [B])."""
    if isinstance(prior, S.LogNormalPrior):
        return P.lognormal_logpdf(value, prior.mu, prior.sigma, chains)
    if isinstance(prior, S.NormalPrior):
        return P.normal_logpdf(value, prior.mean, prior.stdev, chains)
    if isinstance(prior, S.GammaPrior):
        return P.gamma_logpdf(value, prior.shape, prior.scale, chains)
    if isinstance(prior, S.ExponentialPrior):
        return P.exponential_logpdf(value, prior.mean, chains)
    if isinstance(prior, S.UniformPrior):
        return P.uniform_logpdf(value, prior.lower, prior.upper, chains)
    if isinstance(prior, S.OneOnXPrior):
        return P.one_on_x_logpdf(value, chains)
    if isinstance(prior, S.DirichletPrior):
        alpha = torch.as_tensor(np.asarray(prior.alpha, np.float64),
                                dtype=value.dtype, device=value.device)
        return P.dirichlet_logpdf(value, alpha, chains)
    if isinstance(prior, S.CTMCScalePrior):
        return P.ctmc_scale_logpdf(value, aux["tree_length"], chains)
    raise TypeError(f"unknown prior {prior!r}")


class _Registry:
    """Collects parameters, their priors, and default operators."""

    def __init__(self, dtype, device):
        self.params0: Dict[str, torch.Tensor] = {}
        self.fixed: Dict[str, torch.Tensor] = {}
        self.priors: List[Tuple[str, Any]] = []
        self.operators: List[O.Operator] = []
        self.dtype = dtype
        self.device = device

    def tensor(self, value, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value), dtype=dtype or self.dtype,
                               device=self.device)

    def add(self, name: str, p: S.Param, op: str = "scale") -> str:
        """Register a Param; returns its name. Fixed params are folded."""
        val = self.tensor(p.init)
        if not p.estimate:
            self.fixed[name] = val
            return name
        self.params0[name] = val
        if p.prior is not None:
            self.priors.append((name, p.prior))
        w = p.operator_weight
        if w > 0:
            if op == "scale":
                self.operators.append(
                    O.ScaleOperator(parameter=name, weight=w,
                                    lower=p.lower, upper=p.upper))
            elif op == "walk":
                self.operators.append(
                    O.RandomWalkOperator(parameter=name, weight=w,
                                         lower=p.lower, upper=p.upper))
            elif op == "delta":
                self.operators.append(
                    O.DeltaExchangeOperator(parameter=name, weight=w))
        return name

    def get(self, params: Dict, name: str, b=None):
        """The parameter's value; a fixed one broadcast over b chains where
        b is given (params then carry the chain axis)."""
        if name in self.fixed:
            v = self.fixed[name]
            return v if b is None else v.expand(b, *v.shape)
        return params[name]


def _partition_tips(part, dtype, device):
    """(tips [N, S, P] padded to a multiple of 128, weights [P])."""
    pats = part.patterns
    if part.use_ambiguities:
        tips_np = np.swapaxes(pats.tip_partials(np.float64), 1, 2)
    else:
        # the states path: ambiguity codes collapse to fully missing
        k = pats.datatype.state_count
        table = np.concatenate([np.eye(k), np.ones((1, k))], axis=0)
        tips_np = np.swapaxes(table[pats.tip_states_unambiguous()], 1, 2)
    tips = torch.as_tensor(np.ascontiguousarray(tips_np), dtype=dtype,
                           device=device)
    weights = torch.as_tensor(pats.weights, dtype=dtype, device=device)
    return pad_patterns(tips, weights, 128)


def _frequencies(sub, pats, reg):
    if isinstance(sub, (S.HKY, S.TN93, S.GTR)):
        if isinstance(sub.frequencies, str):
            if sub.frequencies == "empirical":
                return reg.tensor(pats.empirical_frequencies())
            k = pats.datatype.state_count
            return reg.tensor(np.full(k, 1.0 / k))
        return reg.tensor(sub.frequencies)
    if isinstance(sub, S.JC69):
        return reg.tensor(np.full(4, 0.25))
    if isinstance(sub, S.GeneralReversible):
        k = sub.n_states
        return (reg.tensor(np.full(k, 1.0 / k))
                if isinstance(sub.frequencies, str)
                else reg.tensor(sub.frequencies))
    raise TypeError(f"unknown substitution model {sub!r}")


def _eigen_fn(sub, pname, freqs, reg):
    """fn(params, b) -> the partition's eigensystem, batched over b chains
    where b is given (JC's is shared); registers its params."""
    if isinstance(sub, S.HKY):
        kn = reg.add(f"{pname}.kappa", sub.kappa)
        return lambda prm, b: subst.hky_eigen(reg.get(prm, kn, b), freqs)
    if isinstance(sub, S.TN93):
        k1 = reg.add(f"{pname}.kappa1", sub.kappa1)
        k2 = reg.add(f"{pname}.kappa2", sub.kappa2)
        return lambda prm, b: subst.tn93_eigen(reg.get(prm, k1, b),
                                               reg.get(prm, k2, b), freqs)
    if isinstance(sub, S.GTR):
        rn = reg.add(f"{pname}.gtr.rates", sub.rates)
        return lambda prm, b: subst.gtr_eigen(reg.get(prm, rn, b), freqs)
    if isinstance(sub, S.JC69):
        eig0 = subst.jc_eigen(freqs)
        return lambda prm, b: eig0
    if isinstance(sub, S.GeneralReversible):
        n_r = sub.n_states * (sub.n_states - 1) // 2
        rp = sub.rates or S.Param(np.ones(n_r), prior=S.GammaPrior(1.0, 1.0),
                                  operator_weight=2.0)
        rn = reg.add(f"{pname}.rates", rp)
        if not sub.bssvs:
            return lambda prm, b: subst.general_reversible_eigen(
                reg.get(prm, rn, b), freqs)
        iname = f"{pname}.indicators"
        reg.params0[iname] = torch.ones(n_r, dtype=torch.int32,
                                        device=reg.device)
        reg.operators.append(O.BitFlipOperator(parameter=iname, weight=3.0))
        return lambda prm, b: subst.general_reversible_eigen(
            subst.svs_masked_rates(reg.get(prm, rn, b),
                                   prm[iname].to(freqs.dtype)), freqs)
    raise TypeError(f"unknown substitution model {sub!r}")


def _rates_fn(smod, pname, reg):
    """fn(params, b) -> (category rates, weights), [B, C] over b chains
    where b is given (weights [C] where they are shared); registers the site
    model's params."""
    mn = reg.add(f"{pname}.mu", smod.mu) if smod.mu is not None else None
    an = (reg.add(f"{pname}.alpha", smod.alpha)
          if smod.alpha is not None else None)
    pn = (reg.add(f"{pname}.pInv", smod.p_invariant, op="walk")
          if smod.p_invariant is not None else None)
    nc, dtype = smod.categories, reg.dtype

    def rates_fn(prm, b):
        mu = reg.get(prm, mn, b) if mn else None
        if an is not None:
            return sm.discrete_gamma_rates(
                reg.get(prm, an, b), nc,
                p_invariant=reg.get(prm, pn, b) if pn else None, mu=mu,
                dtype=dtype)
        if pn is not None:
            return sm.invariant_only_rates(reg.get(prm, pn, b), mu)
        return sm.single_rate(mu, dtype, reg.device)

    return rates_fn


def _clock(spec, reg, m):
    """(branch_rates_fn(params, b) -> [M], or [B, M] over b chains where b
    is given; whether the rate is estimated)."""
    dtype = reg.dtype
    if isinstance(spec.clock, S.StrictClock):
        rn = reg.add("clock.rate", spec.clock.rate)

        def strict(prm, b):
            rate = reg.get(prm, rn, b).to(dtype)
            return rate.expand(m) if b is None else rate[:, None].expand(b, m)

        return strict, spec.clock.rate.estimate
    if isinstance(spec.clock, S.RelaxedClockLognormal):
        mn = reg.add("ucld.mean", spec.clock.mean)
        sn = reg.add("ucld.stdev", spec.clock.stdev)
        nc = m - 1  # one category per branch (the reference's default)
        reg.params0["branchRates.categories"] = torch.as_tensor(
            np.arange(m) % nc, dtype=torch.int32, device=reg.device)
        reg.operators.append(O.UniformIntegerOperator(
            parameter="branchRates.categories", weight=10.0, lower=0,
            upper=nc - 1))
        reg.operators.append(O.SwapOperator(
            parameter="branchRates.categories", weight=10.0))

        def relaxed(prm, b):
            mean, stdev = reg.get(prm, mn, b), reg.get(prm, sn, b)
            if b is not None:  # a chain's moments beside its row of rates
                mean, stdev = mean[:, None], stdev[:, None]
            return clock_models.discretized_lognormal_rates(
                prm["branchRates.categories"], mean, stdev,
                n_categories=nc).to(dtype)

        return relaxed, spec.clock.mean.estimate
    raise TypeError(f"unknown clock {spec.clock!r}")


def _tree_prior(tp, reg, n_taxa):
    """fn(params, tree, b) -> the tree prior's log density, [B] over b
    chains where b is given; registers its params."""
    if isinstance(tp, S.ConstantCoalescent):
        ps = reg.add("constant.popSize", tp.pop_size)
        return lambda prm, tree, b: coal.constant_coalescent_loglik(
            tree.heights, n_taxa, reg.get(prm, ps, b))
    if isinstance(tp, S.ExponentialGrowthCoalescent):
        ps = reg.add("exponential.popSize", tp.pop_size)
        gr = reg.add("exponential.growthRate", tp.growth_rate, op="walk")
        return lambda prm, tree, b: coal.exponential_growth_loglik(
            tree.heights, n_taxa, reg.get(prm, ps, b), reg.get(prm, gr, b))
    if isinstance(tp, S.SkygridCoalescent):
        cells = tp.n_cells
        cuts = reg.tensor(np.linspace(0, tp.cutoff, cells)[1:])
        reg.params0["skygrid.logPopSizes"] = reg.tensor(
            np.full(cells, tp.log_pop_init))
        reg.operators.append(O.RandomWalkOperator(
            parameter="skygrid.logPopSizes", weight=10.0,
            lower=-float("inf"), upper=float("inf"), window=0.5))
        pr = reg.add("skygrid.precision", tp.precision)

        def skygrid(prm, tree, b):
            g = prm["skygrid.logPopSizes"]
            return (coal.skygrid_loglik(tree.heights, n_taxa, g, cuts)
                    + coal.gmrf_log_prior(g, reg.get(prm, pr, b)))

        return skygrid
    if isinstance(tp, S.YulePrior):
        br = reg.add("yule.birthRate", tp.birth_rate)
        return lambda prm, tree, b: spn.yule_loglik(
            tree.heights, n_taxa, tree.root, reg.get(prm, br, b))
    if isinstance(tp, S.BirthDeathPrior):
        bd = reg.add("birthDeath.meanGrowthRate", tp.birth_diff_rate)
        dr = reg.add("birthDeath.relativeDeathRate", tp.relative_death_rate)
        return lambda prm, tree, b: spn.birth_death_loglik(
            tree.heights, n_taxa, tree.root, reg.get(prm, bd, b),
            reg.get(prm, dr, b))
    raise TypeError(f"unknown tree prior {tp!r}")


def build(spec: S.AnalysisSpec, device=DEFAULT_DEVICE) -> Analysis:
    """The analysis of `spec`, its tensors on `device`."""
    dtype = spec.dtype or default_float()
    if not spec.partitions:
        raise ValueError("analysis needs at least one partition")
    taxa = spec.partitions[0].patterns.taxa
    for part in spec.partitions[1:]:
        if part.patterns.taxa != taxa:
            raise ValueError("all partitions must share the taxon set")
    n_taxa = len(taxa)
    reg = _Registry(dtype, device)

    # ---- starting tree -------------------------------------------------
    if spec.tree.tip_heights:
        tip_heights = np.asarray(
            [spec.tree.tip_heights.get(t, 0.0) for t in taxa])
    else:
        tip_heights = np.zeros(n_taxa)
    if spec.tree.newick:
        th = (dict(zip(taxa, tip_heights.tolist()))
              if spec.tree.tip_heights else None)
        parent, children, heights, root, _ = parse_newick(
            spec.tree.newick, taxa=taxa, tip_heights=th)
    else:
        rng = np.random.default_rng(spec.tree.seed)
        parent, children, heights, root = simulate_coalescent_tree(
            rng, tip_heights, spec.tree.sim_pop_size)
    tree0 = make_tree_state(parent, children, heights, root, dtype, device)
    m = 2 * n_taxa - 1

    # ---- partitions: substitution + site models ------------------------
    partition_fns = []
    for pi, part in enumerate(spec.partitions):
        pname = part.name if part.name != "partition" else f"p{pi + 1}"
        tips, weights = _partition_tips(part, dtype, device)
        freqs = _frequencies(part.substitution, part.patterns, reg)
        eig_fn = _eigen_fn(part.substitution, pname, freqs, reg)
        partition_fns.append((tips, weights, freqs, eig_fn,
                              _rates_fn(part.site_model, pname, reg)))

    branch_rates_fn, clock_estimated = _clock(spec, reg, m)
    tree_prior_fn = _tree_prior(spec.tree_prior, reg, n_taxa)

    # ---- default tree operators (BEAUti-style weights) -------------------
    reg.operators.extend([
        O.UniformNodeHeightOperator(weight=max(3.0, n_taxa / 2)),
        O.RootHeightScaleOperator(weight=3.0),
        O.NarrowExchangeOperator(weight=max(3.0, n_taxa / 2)),
        O.WideExchangeOperator(weight=3.0),
        O.WilsonBaldingOperator(weight=3.0),
    ])
    if clock_estimated:
        reg.operators.append(O.UpDownOperator(
            up=("clock.rate" if isinstance(spec.clock, S.StrictClock)
                else "ucld.mean",),
            down=(O.TREE_HEIGHTS,), weight=3.0))
    reg.operators.extend(spec.extra_operators)

    # ---- compose the posterior ------------------------------------------
    # b is None for one chain, else the chain count of a batch: the model
    # terms are then [B], and each partition one peel for all B chains
    def likelihood(params, tree, b):
        branch_rates = branch_rates_fn(params, b)
        total = torch.zeros(() if b is None else (b,), dtype=dtype,
                            device=device)
        for tips, weights, freqs, eig_fn, rates_fn in partition_fns:
            rates, cat_w = rates_fn(params, b)
            total = total + tree_loglikelihood(
                tips, weights, tree.parent, tree.children, tree.heights,
                tree.root, eig_fn(params, b), freqs, rates.to(dtype),
                cat_w.to(dtype), branch_rates)
        return total

    def prior(params, tree, b):
        chains = b is not None
        aux = {"tree_length": torch.sum(
            branch_lengths(tree.parent, tree.heights), dim=-1)}
        total = tree_prior_fn(params, tree, b)
        for name, pr in reg.priors:
            total = total + _prior_logpdf(pr, params[name], aux, chains)
        return total

    def log_likelihood(params, tree):
        return likelihood(params, tree, None)

    def log_prior(params, tree):
        return prior(params, tree, None)

    def log_posterior(params, tree):
        return likelihood(params, tree, None) + prior(params, tree, None)

    def log_posterior_chains(params, tree):
        b = tree.parent.shape[0]
        return likelihood(params, tree, b) + prior(params, tree, b)

    return Analysis(
        log_posterior=log_posterior,
        log_posterior_chains=log_posterior_chains,
        log_likelihood=log_likelihood,
        log_prior=log_prior,
        operators=reg.operators,
        params0=dict(reg.params0),
        tree0=tree0,
        taxa=list(taxa),
        spec=spec,
        n_taxa=n_taxa,
    )

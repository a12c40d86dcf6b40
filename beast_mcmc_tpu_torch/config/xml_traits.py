"""XML vocabulary: continuous-trait likelihoods on trees.

Counterpart of beast_mcmc_tpu/config/xml_traits.py, every registration and
helper of it: the tag family that dominates the reference's TestXML corpus
(traitDataLikelihood) and the vocabulary of continuous phylogeography, the
relaxed random walk in space and time (Lemey et al. 2010). Everything
funnels into models/continuous.py::affine_gaussian_tree_loglikelihood (ref:
src/dr/evomodel/treedatalikelihood/continuous/cdi/
SafeMultivariateIntegrator.java): each branch is an affine Gaussian
channel (Q_b, r_b, Sigma_b) assembled per evolution model,

  homogeneous BM   Q = I, r = 0,            Sigma = t Lambda^-1
  drift            Q = I, r = v_b t,        Sigma = t Lambda^-1
  OU / elastic     Q = e^{-A t}, r = (I - Q) theta_b,
                   Sigma = U G U^T by the eigendecomposition of A

with models/factor.py's canonical propagation for the joint-partials,
repeated-measures and integrated-factor routes. The tree walks go by
levels (models/continuous.py); the channels are built on the analysis's
device, in one batched step over the branches.

Vocabulary: multivariateDiffusionModel, arbitraryBranchRates (the
reference's node numbering: internal nodes in DFS post-order of the
starting tree, the root skipped), locationScaledBranchRateModel,
scaledByTreeTimeBranchRates, timeIncrementBranchRateModel,
continuousTraitDataModel, repeatedMeasuresModel, integratedFactorModel,
traitDataLikelihood / multivariateTraitLikelihood / inhibitionLikelihood
(Brownian, drift, OU and elastic, integrated OU, missing dimensions, the
transformed tree, restricted partials and the ancestral-trait tree's ghost
tips, joint partials, the factor route, the sampled-trait mode), the
gradient elements (precisionGradient to branchSpecificGradient,
gradientWrtIncrements, branchRateGradientWrtIncrements,
optimaLikelihoodGradient), varianceProportionStatistic, the Bayesian
bridge likelihoods, autoCorrelatedRatesPrior, latentLiabilityLikelihood
and orderedLatentLiabilityLikelihood, traitLogger, ancestralTraitTreeModel,
restrictedPartials and the operator newLatentLiabilityGibbsOperator.

Log columns are computed per column in eager PyTorch, where JAX's jit
merges duplicate work: traitLogger's columns and continuousDiffusion
Statistic share one computation of the node conditionals a collector row
(`TraitLikelihood.conditional_means`, keyed on the row's state).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    ClockModel,
    CompoundParam,
    LikelihoodFn,
    Param,
    TreeModel,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    _child_of,
    _text_values,
    annotation_seed,
    per_state,
    register,
    register_operator,
)
from beast_mcmc_tpu_torch.config.xml_hmc import (
    GradientSpec,
    MatrixParam,
    matrix_param_of,
)
from beast_mcmc_tpu_torch.models.continuous import _inv, _logdet, _solve

_LOG_2PI = math.log(2.0 * math.pi)


def _flat(x) -> torch.Tensor:
    return x.reshape(-1)


def _resize(x: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.resize: x's entries repeated cyclically to length n."""
    x = x.reshape(-1)
    return x.repeat(-(-n // x.shape[0]))[:n]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# diffusion / elastic models
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DiffusionModel:
    """MultivariateDiffusionModelParser: a precision matrix."""

    prec: MatrixParam = None

    @property
    def dim(self):
        return self.prec.dim


@register("multivariateDiffusionModel")
def _mv_diffusion_model(ax: XmlAnalysis, el):
    pm = el.find("precisionMatrix")
    if pm is None:
        raise XmlError("multivariateDiffusionModel without precisionMatrix")
    for c in pm:
        return DiffusionModel(matrix_param_of(ax, c))
    raise XmlError("<precisionMatrix> is empty")


@dataclasses.dataclass
class EigenMatrixParam(MatrixParam):
    """A matrix given by its eigendecomposition A = U diag(vals) U^-1
    (CompoundEigenMatrix.java: eigenvectors in the spherical unit-column
    parameterisation of MissingOps.wrapSpherical)."""

    values_name: str = ""
    vectors_fn: Callable = None  # params -> U [D, D]


def _spherical_u(off: torch.Tensor, d: int) -> torch.Tensor:
    """Column-unit eigenvector matrix from d (d - 1) free entries
    (MissingOps.fillSpherical + transpose): column i is (v_i,
    sqrt(1 - |v_i|^2)) for the i-th (d - 1)-subvector."""
    cols = []
    for i in range(d):
        v = off[i * (d - 1):(i + 1) * (d - 1)]
        last = torch.sqrt(torch.clamp_min(1.0 - torch.sum(v * v), 1e-12))
        cols.append(torch.cat([v, last[None]]))
    return torch.stack(cols, dim=1)


def _eigen_matrix_param(ax: XmlAnalysis, el) -> EigenMatrixParam:
    vals_el = el.find("eigenValues")
    vecs_el = el.find("eigenVectors")
    if vals_el is None or vecs_el is None:
        raise XmlError("compoundEigenMatrix needs eigenValues+eigenVectors")
    vname = ax.param_from(vals_el)
    d = int(np.ravel(ax.value_of(vname)).size)
    inner = None
    for c in vecs_el:
        inner = matrix_param_of(ax, c)
    if inner is None:
        raise XmlError("<eigenVectors> is empty")

    def vectors_fn(params):
        # the matrixParameter's columns flattened into the free vector
        flat = torch.cat([_flat(params[n]) for n in inner.names])
        return _spherical_u(flat, d)

    def fn(params):
        u = vectors_fn(params)
        return u @ torch.diag(_flat(params[vname]).to(u.dtype)) @ _inv(u)

    return EigenMatrixParam(
        fn=fn, names=(vname,) + tuple(inner.names), dim=d,
        name=el.get("id") or "eigenMatrix", values_name=vname,
        vectors_fn=vectors_fn)


# ---------------------------------------------------------------------------
# branch value models (branch rates, drift velocities, OU optima)
# ---------------------------------------------------------------------------


def _branch_value_fn(ax: XmlAnalysis, el):
    """(params, tree) -> [M] per-node values from a branch-rate-model
    element (AbstractMultivariateTraitLikelihood.parseDriftModels)."""
    obj = ax.build(el)
    if isinstance(obj, ClockModel):
        fn = obj.rates
        try:
            fn.rate_param = obj.rate_param
        except AttributeError:
            pass
        return fn
    raise Unsupported(f"branch value model <{ax.deref(el).tag}>")


def reference_postorder(tm) -> List[int]:
    """The internal nodes of the tree model's starting tree in DFS
    post-order, left child first (the NewickImporter numbering the
    reference's TreeParameterModel indexes by), the root last."""
    n_tips = (tm.parent.shape[0] + 1) // 2
    post = []
    stack = [(int(tm.root), False)]
    while stack:
        node, done = stack.pop()
        if node < n_tips:
            continue
        if not done:
            stack.append((node, True))
            stack.append((int(tm.children[node, 1]), False))
            stack.append((int(tm.children[node, 0]), False))
        else:
            post.append(node)
    return post


def branch_rate_index(tm) -> np.ndarray:
    """int64 [M]: the rate-vector entry of each node in the reference's
    numbering (tips as they are, internal nodes in `reference_postorder`,
    the root skipped; the root's own entry clipped into range and masked
    by the caller)."""
    m = tm.parent.shape[0]
    n_tips = (m + 1) // 2
    ref_num = np.arange(m)
    for rank, node in enumerate(reference_postorder(tm)):
        ref_num[node] = n_tips + rank
    ref_root = int(ref_num[int(tm.root)])
    bidx = np.where(ref_num > ref_root, ref_num - 1, ref_num)
    return np.clip(bidx, 0, m - 2)


@register("arbitraryBranchRates")
def _arbitrary_branch_rates(ax: XmlAnalysis, el):
    """ArbitraryBranchRatesParser: one free rate per non-root branch, in
    the reference's node numbering (`branch_rate_index`), optional
    reciprocal or exp transforms; centerAtOne (default) overwrites the
    declared values with the transform's centre, randomizeRates draws them
    from the analysis's numpy generator."""
    tree_id = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
    rates_el = el.find("rates")
    if rates_el is None:
        raise XmlError("arbitraryBranchRates without <rates>")
    if tree_id is None:
        raise XmlError("arbitraryBranchRates without treeModel")
    tm = ax._trees[tree_id]
    m = tm.parent.shape[0]
    pname = ax.param_from(rates_el)
    cur = np.ravel(ax.value_of(pname))
    if cur.size != m - 1:
        # one entry per non-root branch, the scalar fill kept (the
        # reference sets the parameter's dimension)
        fill = cur[0] if cur.size else 1.0
        p = ax._params[pname]
        ax._params[pname] = Param(pname, np.full(m - 1, fill),
                                  lower=p.lower, upper=p.upper)
    reciprocal = _attr(el, "reciprocal", False, bool)
    use_exp = _attr(el, "exp", False, bool)
    if _attr(el, "randomizeRates", False, bool):
        scale_r = _attr(el, "scale", 1.0, float)
        g = ax._rng.normal(size=np.ravel(ax._params[pname].value).size)
        vals_r = g * scale_r if use_exp else np.exp(g * scale_r)
        p_r = ax._params[pname]
        ax._params[pname] = Param(pname, vals_r, lower=p_r.lower,
                                  upper=p_r.upper)
        ax._rng_used = True
    elif _attr(el, "centerAtOne", True, bool):
        p_c = ax._params[pname]
        ax._params[pname] = Param(
            pname, np.full(np.ravel(p_c.value).size,
                           0.0 if use_exp else 1.0),
            lower=p_c.lower, upper=p_c.upper)
    root = int(tm.root)
    bidx = ax.tensor(branch_rate_index(tm), torch.long)
    is_root = ax.tensor(np.arange(m) == root, torch.bool)

    def rates(params, tree, _p=pname):
        r = _flat(params[_p])
        if use_exp:
            r = torch.exp(r)
        elif reciprocal:
            r = 1.0 / r
        vals = r[bidx]
        return torch.where(is_root, torch.zeros_like(vals), vals)

    cm = ClockModel("arbitrary", tree_id, rates, rate_param=pname)
    cm.branch_index = bidx
    return cm


# ---------------------------------------------------------------------------
# repeated measures (tip measurement error) and the trait data models
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RepeatedMeasures:
    """RepeatedMeasuresTraitDataModelParser: a per-tip sampling covariance
    (the inverse of samplingPrecision) on top of the diffusion."""

    trait_param: str = ""
    trait_name: str = ""
    tree_id: str = ""
    sampling_prec: MatrixParam = None  # full matrix, or None
    sampling_prec_diag: Optional[str] = None  # diagonal parameter name
    dim: int = 0
    # TreeScaledRepeatedMeasuresTraitDataModel: the sampling variance
    # scaled per tip by (rootHeight - tipHeight) * rate normalisation
    scale_by_tip_height: bool = False
    # observation replicates per tip (numTraits > 1)
    num_traits: int = 1
    # wrapping an integratedFactorModel: the noise adds to its residual
    inner_factor: object = None


@register("continuousTraitDataModel")
def _continuous_trait_data_model(ax: XmlAnalysis, el):
    """ContinuousTraitDataModelParser: a trait parameter (numTraits
    replicates a tip) bound to a tree."""
    tree_id = pname = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif cc.tag == "traitParameter":
            pname = ax.param_from(cc)
    if tree_id is None or pname is None:
        raise XmlError("continuousTraitDataModel needs treeModel + "
                       "traitParameter")
    return {"kind": "ctdm", "param": pname, "tree_id": tree_id,
            "trait_name": el.get("traitName", "X"),
            "num_traits": _attr(el, "numTraits", 1, int)}


@register("repeatedMeasuresModel")
def _repeated_measures(ax: XmlAnalysis, el):
    tree_id = pname = inner_factor = None
    num_traits = _attr(el, "numTraits", 1, int)
    trait_name = el.get("traitName", "X")
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif cc.tag == "continuousTraitDataModel":
            rec = ax.build(cc)
            pname = rec["param"]
            tree_id = tree_id or rec["tree_id"]
            trait_name = rec["trait_name"]
            num_traits = max(num_traits, rec["num_traits"])
        elif cc.tag == "integratedFactorModel":
            inner_factor = ax.build(cc)
            tree_id = tree_id or inner_factor.tree_id
            pname = inner_factor.trait_param
            trait_name = inner_factor.trait_name
    if pname is None and inner_factor is None:
        tp = el.find("traitParameter")
        if tp is None:
            raise XmlError("repeatedMeasuresModel without traitParameter")
        pname = ax.param_from(tp)
    sp = el.find("samplingPrecision")
    if sp is None:
        raise XmlError("repeatedMeasuresModel without samplingPrecision")
    inner = ax.deref(next(iter(sp)))
    tip_scaled = el.get("scaleByTipHeight", "false").lower() == "true"
    if inner.tag == "parameter":
        dname = ax.param_from(sp)
        d = int(np.ravel(ax.value_of(dname)).size)
        return RepeatedMeasures(pname, trait_name, tree_id, None, dname, d,
                                tip_scaled, num_traits, inner_factor)
    mp = matrix_param_of(ax, inner)
    return RepeatedMeasures(pname, trait_name, tree_id, mp, None, mp.dim,
                            tip_scaled, num_traits, inner_factor)


@dataclasses.dataclass
class IntegratedFactorModel:
    """IntegratedFactorAnalysisLikelihood: P-dim tip data loaded onto K
    latent factors diffusing on the tree; a residual precision a trait;
    factors and internal states integrated in closed form
    (models/factor.py). Its density is counted inside the companion
    traitDataLikelihood: as a log column and inside a <prior> it adds 0,
    as in the JAX package."""

    trait_param: str = ""
    trait_name: str = ""
    tree_id: str = ""
    loadings: MatrixParam = None
    precision: str = ""
    nugget: float = 0.0
    standardize: bool = False


@register("integratedFactorModel")
def _integrated_factor_model(ax: XmlAnalysis, el):
    tree_id = trait_param = loadings = prec = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif cc.tag == "traitParameter":
            trait_param = ax.param_from(cc)
        elif cc.tag == "loadings":
            for d_el in cc:
                dd = ax.deref(d_el)
                if dd.tag != "parameter":
                    loadings = matrix_param_of(ax, dd)
        elif cc.tag == "precision":
            prec = ax.param_from(cc)
    if None in (tree_id, trait_param, loadings, prec):
        raise XmlError("integratedFactorModel structure")
    return IntegratedFactorModel(
        trait_param, el.get("traitName", "X"), tree_id, loadings, prec,
        _attr(el, "nugget", 0.0, float),
        _attr(el, "standardize", False, bool))


# ---------------------------------------------------------------------------
# the trait data likelihood
# ---------------------------------------------------------------------------


_BRANCH_MODEL_TAGS = (
    "strictClockBranchRates", "discretizedBranchRates",
    "arbitraryBranchRates", "continuousBranchRates",
)


def _trait_meta(ax: XmlAnalysis, tree_id: str, pname: str,
                trait_name: str):
    """(values, missing mask, n_tips, dim) of the trait parameter: bound
    by the treeModel's nodeTraits child, or (TreeTraitParserUtilities.
    parseTraitsFromTaxonAttributes) filled from the taxon attributes named
    `trait_name`."""
    for meta in ax._traits.values():
        if meta["param"] == pname:
            return meta
    tm = ax._trees[tree_id]
    bare = trait_name.split(".")[-1]
    rows = []
    for nm in tm.taxa:
        raw = (ax._taxon_attrs.get(nm, {}).get(trait_name)
               or ax._taxon_attrs.get(nm, {}).get(bare))
        if raw is None:
            raise Unsupported(
                f"traitParameter {pname!r} is not bound to treeModel "
                f"nodeTraits and taxa carry no attr {trait_name!r}")
        rows.append(raw)
    d = len(rows[0])
    vals = np.zeros((len(tm.taxa), d))
    mask = np.zeros((len(tm.taxa), d), bool)
    for i, raw in enumerate(rows):
        for j, s in enumerate(raw):
            if s.upper() in ("NA", "?"):
                mask[i, j] = True
            else:
                vals[i, j] = float(s)
    ax._params[pname] = Param(name=pname, value=vals.reshape(-1))
    meta = {"param": pname, "dim": d, "missing": mask,
            "n_tips": len(tm.taxa)}
    ax._traits[(tree_id, trait_name)] = meta
    return meta


@dataclasses.dataclass
class TraitLikelihood:
    """A built traitDataLikelihood: the pieces the traitLogger, the
    statistics and the gradient builders need beyond the density."""

    lik: LikelihoodFn = None
    tree_id: str = ""
    trait_param: str = ""
    trait_name: str = ""
    n_tips: int = 0
    dim: int = 0
    missing: np.ndarray = None
    # (params, tree) -> (q [M, D, D] or None for the identity, r [M, D] or
    # None for zero, sigma [M, D, D], mu0, v0)
    channels: Callable = None
    rate_param: Optional[str] = None  # the branch-rate model's parameter
    diffusion_prec: Optional[MatrixParam] = None
    ax: object = None

    def __post_init__(self):
        self.conditional_means = per_state(self._means)

    def _means(self, s):
        """[M, D] conditional means of every node given the tips at state
        s (models/continuous.py::affine_gaussian_node_conditionals)."""
        from beast_mcmc_tpu_torch.models.continuous import (
            affine_gaussian_node_conditionals,
        )

        ax = self.ax
        params = ax.inject_derived(s.params)
        tree = ax.resolve_tree(self.tree_id, s.params, s.tree)
        qs, rs, sigs, mu0, v0 = self.channels(params, tree)
        tips = params[self.trait_param].reshape(self.n_tips, self.dim)
        means, _ = affine_gaussian_node_conditionals(
            tips.to(tree.heights.dtype), self.missing_t, tree.parent,
            tree.children, tree.heights, tree.root, qs, rs, sigs, mu0, v0)
        return means

    @property
    def missing_t(self) -> torch.Tensor:
        if getattr(self, "_missing_t", None) is None:
            self._missing_t = self.ax.tensor(np.asarray(self.missing, bool),
                                             torch.bool)
        return self._missing_t


def _register_trait_likelihood(ax, el, tl: TraitLikelihood):
    tl.ax = ax
    ax._trait_likelihoods = getattr(ax, "_trait_likelihoods", {})
    ax._trait_likelihoods[el.get("id") or tl.lik.name] = tl
    return tl


def _conjugate_root(ax: XmlAnalysis, el, d: int):
    """The root prior: ('conj', mean name, sample-size name) from
    <conjugateRootPrior> (ConjugateRootTraitPrior.java), ('conj_multi',
    mean names, sample-size name) over a compound mean, or ('mvn', mean
    array, precision array) from a direct <multivariateNormalPrior> child
    (the legacy AbstractMultivariateTraitLikelihood form); None without
    one."""
    crp = el.find("conjugateRootPrior")
    if crp is not None:
        mean_el = crp.find("meanParameter")
        pss_el = crp.find("priorSampleSize")
        if mean_el is None or pss_el is None:
            raise XmlError("conjugateRootPrior needs mean + priorSampleSize")
        for mc in mean_el:
            mcc = ax.deref(mc)
            if mcc.tag == "compoundParameter":
                obj = ax.build(mcc)
                return ("conj_multi", tuple(obj.names),
                        ax.param_from(pss_el))
        return ("conj", ax.param_from(mean_el), ax.param_from(pss_el))
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("multivariateNormalPrior",
                      "multivariateNormalDistributionModel"):
            mean = _text_values(ax.deref(_child_of(
                _child_of(cc, "meanParameter"), "parameter")))
            prec = None
            prec_el = cc.find("precisionMatrix")
            if prec_el is None:
                prec_el = cc.find("precisionParameter")
            if prec_el is not None:
                for p in prec_el:
                    pp = ax.deref(p)
                    if pp.tag == "matrixParameter":
                        prec = np.asarray(ax.build(pp)).T
            if prec is None:
                prec = np.eye(mean.size)
            return ("mvn", np.resize(mean, d), np.asarray(prec))
    return None


def _root_prior(root_spec, params, v, dt, d_out=None):
    """(mu0, v0) of the conjugate root prior, v the diffusion covariance
    (a conjugate prior scales it by 1/k0), or of a direct MVN prior."""
    if root_spec[0] in ("conj", "conj_multi"):
        if root_spec[0] == "conj":
            mu0 = _flat(params[root_spec[1]]).to(dt)
        else:
            mu0 = torch.cat([_flat(params[n]).to(dt) for n in root_spec[1]])
        k0 = _flat(params[root_spec[2]])[0].to(dt)
        return mu0, v / k0
    mu0 = torch.as_tensor(root_spec[1], dtype=dt, device=v.device)
    return mu0, _inv(torch.as_tensor(root_spec[2], dtype=dt,
                                     device=v.device))


def _sampling_cov(rm: RepeatedMeasures, params, dt):
    """The inverse of a repeated-measures model's sampling precision."""
    if rm.sampling_prec is not None:
        return _inv(rm.sampling_prec.fn(params).to(dt))
    return torch.diag(1.0 / _flat(params[rm.sampling_prec_diag]).to(dt))


def _sampling_prec(rm: RepeatedMeasures, params, dt):
    if rm.sampling_prec is not None:
        return rm.sampling_prec.fn(params).to(dt)
    return torch.diag(_flat(params[rm.sampling_prec_diag]).to(dt))


def _masked_potentials(y, obs, sig):
    """Canonical potentials (J, J y, g) of N(y_o; x_o, sig_oo) in x over
    leading axes of y and obs [..., D]: flat on the unobserved dims."""
    mask = obs[..., :, None] * obs[..., None, :]
    eye_fill = torch.diag_embed(1.0 - obs)
    c_mat = sig * mask + eye_fill
    j_mat = _inv(c_mat) * mask
    j_mat = 0.5 * (j_mat + j_mat.transpose(-1, -2))
    yv = torch.where(obs > 0, y, torch.zeros_like(y))
    jy = (j_mat @ yv[..., None])[..., 0]
    ld = _logdet(j_mat + eye_fill)
    g = -0.5 * (obs.sum(-1) * _LOG_2PI - ld + (yv * jy).sum(-1))
    return j_mat, jy, g


def _joint_potentials_route(ax: XmlAnalysis, el, diffusion, tree_id,
                            comps, root_spec):
    """A trait likelihood over arbitrary canonical tip potentials: the
    jointPartialsProvider composition (JointPartialsProvider.java: each
    sub-model contributes its potential on a sub-block of the latent
    process) and repeated-measures replicates (numTraits > 1) share
    models/factor.py::canonical_bp_loglikelihood. The blocks and masks
    are fixed at parse time on the host; the potentials are computed on
    the device at evaluation time."""
    from beast_mcmc_tpu_torch.config.xml_stats import _current_state
    from beast_mcmc_tpu_torch.models.continuous import _push_canonical
    from beast_mcmc_tpu_torch.models.factor import (
        canonical_bp_loglikelihood,
        factor_tip_potentials,
    )

    d_total = diffusion.dim
    tm = ax._trees[tree_id]
    n_tips = len(tm.taxa)
    prec = diffusion.prec
    blocks = []  # (offset, block dim, potential_fn(params, dt))
    delta_blocks = []  # (kind, offset, block dim, obs mask [N, b], payload)
    off = 0
    first_param = None
    for comp in comps:
        if isinstance(comp, dict) and comp.get("kind") == "ctdm":
            # a bare continuousTraitDataModel: exact observation of this
            # latent sub-block
            meta = _trait_meta(ax, comp["tree_id"], comp["param"],
                               comp["trait_name"])
            d_c = meta["dim"]
            obs = ax.tensor(~np.asarray(meta["missing"], bool), torch.bool)
            delta_blocks.append(("ctdm", off, d_c, obs, comp["param"]))
            off += d_c
            first_param = first_param or comp["param"]
            continue
        if isinstance(comp, RepeatedMeasures) and \
                comp.inner_factor is not None:
            # the noise adds to the wrapped factor model's residual on the
            # latent scale: y | f ~ N(L^T f, Gamma_f^-1 + S_rm)
            fm_i = comp.inner_factor
            meta = _trait_meta(ax, fm_i.tree_id, fm_i.trait_param,
                               fm_i.trait_name)
            p_dim = meta["dim"]
            miss = ax.tensor(np.asarray(meta["missing"], bool), torch.bool)
            params0, _ = _current_state(ax)
            k_f = int(fm_i.loadings.fn(params0).shape[1])

            def pot_rm_factor(params, dt, _c=comp, _f=fm_i, _m=miss,
                              _p=p_dim, _k=k_f):
                tips = params[_f.trait_param].reshape(n_tips, _p).to(dt)
                loadings = _f.loadings.fn(params).to(dt).T
                gamma = _flat(params[_f.precision]).to(dt)
                p0, b0, g0 = factor_tip_potentials(tips, _m, loadings, gamma)
                eye_k = torch.eye(_k, dtype=dt, device=tips.device)
                return _push_canonical(p0, b0, g0, 1.0,
                                       _sampling_cov(_c, params, dt), eye_k)

            blocks.append((off, k_f, pot_rm_factor))
            off += k_f
            first_param = first_param or fm_i.trait_param
            continue
        if isinstance(comp, IntegratedFactorModel):
            meta = _trait_meta(ax, comp.tree_id, comp.trait_param,
                               comp.trait_name)
            p_dim = meta["dim"]
            miss = ax.tensor(np.asarray(meta["missing"], bool), torch.bool)
            params0, _ = _current_state(ax)
            k_f = int(comp.loadings.fn(params0).shape[1])

            def pot_factor(params, dt, _c=comp, _m=miss, _p=p_dim):
                tips = params[_c.trait_param].reshape(n_tips, _p).to(dt)
                loadings = _c.loadings.fn(params).to(dt).T
                gamma = _flat(params[_c.precision]).to(dt)
                if _c.nugget:
                    gamma = 1.0 / (1.0 / gamma + _c.nugget)
                return factor_tip_potentials(tips, _m, loadings, gamma)

            blocks.append((off, k_f, pot_factor))
            off += k_f
            first_param = first_param or comp.trait_param
        elif isinstance(comp, RepeatedMeasures):
            meta = _trait_meta(ax, comp.tree_id or tree_id,
                               comp.trait_param, comp.trait_name)
            r, d_c = comp.num_traits, comp.dim
            miss = np.asarray(meta["missing"], bool).reshape(
                (n_tips, r, d_c))
            if r == 1:
                # one observation y = x + e: the noise folds into the tip
                # branch's covariance and y is a delta observation of x + e
                delta_blocks.append(("rm", off, d_c, ax.tensor(
                    ~miss[:, 0, :], torch.bool), comp))
                off += d_c
                first_param = first_param or comp.trait_param
                continue
            all_observed = not bool(miss.any())
            obs_t = ax.tensor(~miss)

            def pot_rm(params, dt, _c=comp, _o=obs_t, _r=r, _d=d_c,
                       _full=all_observed):
                y = params[_c.trait_param].reshape(n_tips, _r, _d).to(dt)
                gam = _sampling_prec(_c, params, dt)
                if _full:
                    # fully observed: the potential is Gamma itself, with
                    # no inversion (Gamma may be near-singular)
                    gy = y @ gam.T
                    g = -0.5 * (_d * _LOG_2PI - _logdet(gam)
                                + (y * gy).sum(-1))
                    return (gam.expand(n_tips, _r, _d, _d).sum(1),
                            gy.sum(1), g.sum(1))
                p, b, g = _masked_potentials(y, _o.to(dt), _inv(gam))
                return p.sum(1), b.sum(1), g.sum(1)

            blocks.append((off, d_c, pot_rm))
            off += d_c
            first_param = first_param or comp.trait_param
        else:
            raise Unsupported(
                f"jointPartialsProvider component {type(comp).__name__}")
    if off != d_total:
        raise XmlError(
            f"jointPartialsProvider dims {off} != diffusion dim {d_total}")

    def fn_joint(params, tree):
        dt = tree.heights.dtype
        dev = tree.heights.device
        P = torch.zeros((n_tips, d_total, d_total), dtype=dt, device=dev)
        b = torch.zeros((n_tips, d_total), dtype=dt, device=dev)
        g = torch.zeros((n_tips,), dtype=dt, device=dev)
        for o, bd, pot in blocks:
            pc, bc, gc = pot(params, dt)
            P[:, o:o + bd, o:o + bd] = P[:, o:o + bd, o:o + bd] + pc.to(dt)
            b[:, o:o + bd] = b[:, o:o + bd] + bc.to(dt)
            g = g + gc.to(dt)
        dmask = dvals = cov_extra = None
        if delta_blocks:
            dmask = torch.zeros((n_tips, d_total), dtype=dt, device=dev)
            dvals = torch.zeros((n_tips, d_total), dtype=dt, device=dev)
            for kind, o, bd, obs, payload in delta_blocks:
                if kind == "ctdm":
                    y = params[payload].reshape(n_tips, bd).to(dt)
                else:
                    y = params[payload.trait_param].reshape(n_tips, bd).to(dt)
                    if cov_extra is None:
                        cov_extra = torch.zeros((n_tips, d_total, d_total),
                                                dtype=dt, device=dev)
                    cov_extra[:, o:o + bd, o:o + bd] = (
                        cov_extra[:, o:o + bd, o:o + bd]
                        + _sampling_cov(payload, params, dt))
                dmask[:, o:o + bd] = obs.to(dt)
                dvals[:, o:o + bd] = torch.where(obs, y, torch.zeros_like(y))
        lam_inv = _inv(prec.fn(params).to(dt))
        if root_spec is not None and root_spec[0] == "conj":
            mu0 = _resize(_flat(params[root_spec[1]]).to(dt), d_total)
            k0 = _flat(params[root_spec[2]])[0].to(dt)
        else:
            mu0, k0 = None, 1.0
        return canonical_bp_loglikelihood(
            P, b, g, tree.parent, tree.children, tree.heights, tree.root,
            lam_inv, root_prior_mean=mu0, root_prior_sample_size=k0,
            tip_delta_mask=dmask, tip_delta_values=dvals,
            tip_cov_extra=cov_extra)

    lik = LikelihoodFn(fn_joint, tree_id, el.get("id") or "traitLikelihood",
                       (first_param,))
    tl = TraitLikelihood(lik, tree_id, first_param,
                         el.get("traitName", "trait"), n_tips, d_total,
                         np.zeros((n_tips, d_total), bool), None)
    tl.diffusion_prec = prec
    tl.joint_comps = comps
    tl.joint_root_spec = root_spec
    return _register_trait_likelihood(ax, el, tl)


def _restricted_view(ax, el, restricted, tree_id, trait_param, trait_name):
    """Restricted partials by the ghost-tip equivalence: a pseudo-
    observation N(mean, (pss Lambda)^-1) at a clade's MRCA is a tip with
    that mean on a branch of length 1/pss (RestrictedPartials,
    AncestralTraitTreeModel; the corpus file asserts the two agree). The
    extended tree is a view of the base tree; the extended traits a
    derived parameter. Returns (tree id, trait parameter)."""
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state

    base_tm = ax._trees[tree_id]
    n_b = len(base_tm.taxa)
    m_b = base_tm.parent.shape[0]
    anchors, ghost_means = [], []
    for _, _tid, tips, mean, pss in restricted:
        mask = np.zeros(n_b, bool)
        for t in tips:
            mask[base_tm.taxa.index(t)] = True
        anchors.append((mask, (lambda p, v=1.0 / pss: v)))
        ghost_means.append(mean)
    view, n_new, _ = _ghost_extension_view(ax, n_b, m_b, anchors)
    rid = f"{el.get('id') or 'traitLik'}.restricted"
    ts0 = make_tree_state(base_tm.parent, base_tm.children, base_tm.heights,
                          int(base_tm.root), torch.float64, "cpu")
    ext0 = view(ts0, {})
    tm_ext = TreeModel(
        rid, list(base_tm.taxa) + [f"rp{i}" for i in range(len(anchors))],
        _host(ext0.heights)[:n_new].copy(), _host(ext0.parent),
        _host(ext0.children), _host(ext0.heights), int(ext0.root))
    ax._trees[rid] = tm_ext
    ax._tree_binding[rid] = "state"
    ax._tree_views[rid] = view
    d_g = len(ghost_means[0])
    gm = ax.tensor(np.concatenate(ghost_means))
    dname = f"{rid}.traits"

    def traits_fn(p, _b=trait_param):
        x = _flat(p[_b])
        return torch.cat([x, gm.to(x.dtype)])

    ax._derived_params[dname] = traits_fn
    ax._traits[(rid, trait_name)] = {
        "param": dname, "dim": d_g,
        "missing": np.zeros((n_new, d_g), bool), "n_tips": n_new,
    }
    return rid, dname


def _build_trait_likelihood(ax: XmlAnalysis, el):
    trait_name = el.get("traitName", "trait")
    diffusion: Optional[DiffusionModel] = None
    tree_id = rate_model = trait_param = None
    repeated: Optional[RepeatedMeasures] = None
    joint_components = drift_fns = tree_scale_name = optimal_fns = None
    elastic: Optional[MatrixParam] = None
    factor_model: Optional[IntegratedFactorModel] = None
    restricted: List = []

    for c in el:
        cc = ax.deref(c)
        tag = cc.tag
        if tag == "multivariateDiffusionModel":
            diffusion = ax.build(cc)
        elif tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif tag == "transformedTreeModel":
            # a Pagel-lambda transform (SingleScalarTreeTransform.java:
            # 47-53: internal h' = h_root - s (h_root - h), tips unchanged)
            for t_el in cc:
                tt = ax.deref(t_el)
                if tt.tag == "treeModel":
                    tree_id = ax.build(tt).tree_id
                elif tt.tag == "parameter":
                    tree_scale_name = ax.build(tt).name
        elif tag in _BRANCH_MODEL_TAGS:
            rate_model = _branch_value_fn(ax, cc)
        elif tag == "traitParameter":
            trait_param = ax.param_from(cc)
        elif tag == "continuousTraitDataModel":
            rec_ctdm = ax.build(cc)
            trait_param = rec_ctdm["param"]
            tree_id = tree_id or rec_ctdm["tree_id"]
            trait_name = rec_ctdm["trait_name"]
        elif tag == "repeatedMeasuresModel":
            repeated = ax.build(cc)
        elif tag == "driftModels":
            drift_fns = [_branch_value_fn(ax, d_el) for d_el in cc]
        elif tag == "optimalTraits":
            optimal_fns = [_branch_value_fn(ax, d_el) for d_el in cc]
        elif tag == "strengthOfSelectionMatrix":
            inner = ax.deref(next(iter(cc)))
            elastic = (_eigen_matrix_param(ax, inner)
                       if inner.tag == "compoundEigenMatrix"
                       else matrix_param_of(ax, inner))
        elif tag in ("conjugateRootPrior", "jitter"):
            continue
        elif tag == "integratedFactorModel":
            factor_model = ax.build(cc)
            tree_id = tree_id or factor_model.tree_id
        elif tag == "jointPartialsProvider":
            joint_components = []
            for d_el in cc:
                comp = ax.build(ax.deref(d_el))
                joint_components.append(comp)
                tree_id = tree_id or (comp["tree_id"] if isinstance(comp, dict)
                                      else comp.tree_id)
        elif tag == "ancestralTraitTreeModel":
            tree_id = ax.build(cc).tree_id
        elif tag == "restrictedPartials":
            restricted.append(ax.build(cc))

    if restricted:
        tree_id, trait_param = _restricted_view(
            ax, el, restricted, tree_id, trait_param, trait_name)
    if repeated is not None:
        trait_param = trait_param or repeated.trait_param
        tree_id = tree_id or repeated.tree_id
    if diffusion is None:
        raise XmlError("traitDataLikelihood without diffusion model")
    if tree_id is None:
        raise XmlError("traitDataLikelihood without treeModel")

    if joint_components is not None or (
            repeated is not None and (repeated.num_traits > 1
                                      or repeated.inner_factor is not None)):
        comps = (joint_components if joint_components is not None
                 else [repeated])
        return _joint_potentials_route(
            ax, el, diffusion, tree_id, comps,
            _conjugate_root(ax, el, diffusion.dim))
    if factor_model is not None:
        return _factor_route(ax, el, diffusion, tree_id, factor_model)
    if trait_param is None:
        raise Unsupported("traitDataLikelihood without traitParameter")

    meta = _trait_meta(ax, tree_id, trait_param, trait_name)
    n_tips, d = meta["n_tips"], meta["dim"]
    missing = np.asarray(meta["missing"], bool)
    if d != diffusion.dim:
        raise XmlError(f"trait dim {d} != diffusion dim {diffusion.dim}")

    scale_by_time = _attr(el, "scaleByTime", False, bool)
    use_tree_length = _attr(el, "useTreeLength", False, bool)
    root_spec = _conjugate_root(ax, el, d)
    if root_spec is None:
        store = ax._traits.get((tree_id, trait_name)) or {}
        if store.get("layout") == "all_nodes":
            return _sampled_route(ax, el, diffusion, tree_id, trait_name,
                                  store, n_tips, d)
        raise Unsupported("traitDataLikelihood without a root prior")
    prec = diffusion.prec
    if optimal_fns is not None and elastic is None:
        raise Unsupported("optimalTraits without strengthOfSelectionMatrix")

    tm = ax._trees[tree_id]
    m = tm.parent.shape[0]
    miss_t = ax.tensor(missing, torch.bool)
    integrated = _attr(el, "integratedProcess", False, bool)

    # an ASYMMETRIC precision (testBeastUnitTest.xml's) is propagated by
    # the reference's integrator as it stands, which equals the joint-
    # covariance marginal of its unsymmetrised inverse: such inputs go to
    # a dense joint-covariance evaluation over the parse-time topology
    p0_chk = _host(prec.fn({n: ax.tensor(ax.value_of(n))
                            for n in prec.names}))
    if (not np.allclose(p0_chk, p0_chk.T) and root_spec[0] == "conj"
            and repeated is not None and drift_fns is None
            and optimal_fns is None and not integrated):
        return _asymmetric_route(ax, el, prec, root_spec, repeated, tm,
                                 n_tips, d, missing, trait_param, trait_name,
                                 tree_id, scale_by_time, use_tree_length)
    if integrated:
        return _integrated_ou_route(ax, el, diffusion, elastic, optimal_fns,
                                    root_spec, tree_id, trait_param,
                                    trait_name, n_tips, d, m, missing,
                                    miss_t)

    def per_branch(f, params, tree, dt):
        """A branch-value model's output broadcast to [M] (strict clocks
        give a scalar)."""
        return torch.broadcast_to(
            _flat(torch.as_tensor(f(params, tree), dtype=dt,
                                  device=tree.heights.device)), (m,))

    def channels(params, tree):
        dt = tree.heights.dtype
        v = _inv(prec.fn(params).to(dt))
        pidx = torch.clamp_min(tree.parent, 0)
        has_parent = tree.parent >= 0
        heights = tree.heights
        root1 = tree.root.reshape(1)
        h_root = heights[root1]
        if tree_scale_name is not None:
            sc = _flat(params[tree_scale_name])[0].to(dt)
            is_tip = torch.arange(heights.shape[0],
                                  device=heights.device) < n_tips
            heights = torch.where(is_tip, heights,
                                  h_root - sc * (h_root - heights))
        t_raw = torch.where(has_parent, heights[pidx] - heights,
                            torch.zeros_like(heights))
        if scale_by_time:
            t_raw = t_raw * (1.0 / torch.sum(t_raw) if use_tree_length
                             else 1.0 / tree.heights[root1])
        if rate_model is not None:
            t_raw = t_raw * per_branch(rate_model, params, tree, dt)
        if optimal_fns is not None:
            theta = torch.stack([per_branch(f, params, tree, dt)
                                 for f in optimal_fns], dim=1)
            if isinstance(elastic, EigenMatrixParam):
                u = elastic.vectors_fn(params).to(dt)
                lam_a = _flat(params[elastic.values_name]).to(dt)
                u_inv = _inv(u)
            else:
                a_mat = elastic.fn(params).to(dt)
                # symmetric strength matrices diagonalise with eigh (a
                # host synchronisation on the card, ROADMAP C3)
                lam_a, u = torch.linalg.eigh(0.5 * (a_mat + a_mat.T))
                u_inv = u.T
            v_t = u_inv @ v @ u_inv.T
            lsum = lam_a[:, None] + lam_a[None, :]
            e = torch.exp(-lam_a[None, :] * t_raw[:, None])  # [M, D]
            qs = (u[None] * e[:, None, :]) @ u_inv
            gmat = v_t[None] * -torch.expm1(-lsum[None] * t_raw[:, None, None]
                                            ) / lsum[None]
            sigs = u[None] @ gmat @ u.T[None]
            sigs = 0.5 * (sigs + sigs.transpose(-1, -2))
            rs = theta - (qs @ theta[..., None])[..., 0]
        else:
            # Q = I, and r = 0 without drift: None, whose products the walk
            # skips (models/continuous.py)
            qs = rs = None
            sigs = t_raw[:, None, None] * v[None]
            if drift_fns is not None:
                vel = torch.stack([per_branch(f, params, tree, dt)
                                   for f in drift_fns], dim=1)
                rs = vel * t_raw[:, None]
        if repeated is not None:
            gam = _sampling_cov(repeated, params, dt)
            if repeated.scale_by_tip_height:
                # TreeScaledRepeatedMeasuresTraitDataModel.getTipPartial:
                # 72-95
                t_scale = tree.heights[root1] - tree.heights[:n_tips]
                if scale_by_time:
                    t_scale = t_scale * (
                        1.0 / torch.sum(torch.where(
                            has_parent, tree.heights[pidx] - tree.heights,
                            torch.zeros_like(tree.heights)))
                        if use_tree_length else 1.0 / tree.heights[root1])
                tip_gam = t_scale[:, None, None] * gam[None]
            else:
                tip_gam = gam.expand(n_tips, d, d)
            sigs = sigs + torch.cat([tip_gam, sigs.new_zeros(
                (m - n_tips, d, d))])
        mu0, v0 = _root_prior(root_spec, params, v, dt)
        return qs, rs, sigs, mu0, v0

    def fn(params, tree):
        from beast_mcmc_tpu_torch.models.continuous import (
            affine_gaussian_tree_loglikelihood,
        )

        qs, rs, sigs, mu0, v0 = channels(params, tree)
        tips = params[trait_param].reshape(n_tips, d).to(tree.heights.dtype)
        return affine_gaussian_tree_loglikelihood(
            tips, miss_t, tree.parent, tree.children, tree.heights,
            tree.root, qs, rs, sigs, mu0, v0)

    lik = LikelihoodFn(fn, tree_id, el.get("id") or "traitLikelihood",
                       (trait_param,))
    tl = TraitLikelihood(lik, tree_id, trait_param, trait_name, n_tips, d,
                         missing, channels,
                         rate_param=getattr(rate_model, "rate_param", None),
                         diffusion_prec=diffusion.prec)
    return _register_trait_likelihood(ax, el, tl)


def _factor_route(ax, el, diffusion, tree_id, fm: IntegratedFactorModel):
    """The integrated factor route: K latent factors (diffusion precision
    Lambda) over P-dim data through the loadings
    (models/factor.py::integrated_factor_loglikelihood). standardize=
    "true" standardises each trait by its observed mean and sd (n - 1),
    constants fixed at parse time."""
    from beast_mcmc_tpu_torch.models.factor import (
        integrated_factor_loglikelihood,
    )

    root_spec = _conjugate_root(ax, el, diffusion.dim)
    meta_f = _trait_meta(ax, tree_id, fm.trait_param, fm.trait_name)
    n_tips_f, p_dim = meta_f["n_tips"], meta_f["dim"]
    miss_np = np.asarray(meta_f["missing"], bool)
    miss_f = ax.tensor(miss_np, torch.bool)
    f_mu, f_sd = np.zeros(p_dim), np.ones(p_dim)
    if fm.standardize:
        y0 = np.asarray(ax.value_of(fm.trait_param), float).reshape(
            (n_tips_f, p_dim))
        for j in range(p_dim):
            o = ~miss_np[:, j]
            f_mu[j] = y0[o, j].mean()
            f_sd[j] = np.sqrt(np.sum((y0[o, j] - f_mu[j]) ** 2)
                              / max(o.sum() - 1, 1))
    f_mu_t, f_sd_t = ax.tensor(f_mu), ax.tensor(f_sd)

    def fn_factor(params, tree):
        dt = tree.heights.dtype
        tips = params[fm.trait_param].reshape(n_tips_f, p_dim).to(dt)
        if fm.standardize:
            tips = (tips - f_mu_t.to(dt)) / f_sd_t.to(dt)
        loadings = fm.loadings.fn(params).to(dt).T  # [K, P]
        gamma = _flat(params[fm.precision]).to(dt)
        if fm.nugget:
            gamma = 1.0 / (1.0 / gamma + fm.nugget)
        lam = diffusion.prec.fn(params).to(dt)
        if root_spec is not None and root_spec[0] == "conj":
            mu0 = _flat(params[root_spec[1]]).to(dt)
            k0 = _flat(params[root_spec[2]])[0].to(dt)
        else:
            mu0, k0 = None, 1.0
        return integrated_factor_loglikelihood(
            tips, miss_f, tree.parent, tree.children, tree.heights,
            tree.root, loadings, gamma, factor_precision=lam,
            root_prior_mean=mu0, root_prior_sample_size=k0)

    lik = LikelihoodFn(fn_factor, tree_id, el.get("id") or "traitLikelihood",
                       (fm.trait_param,))
    tl = TraitLikelihood(lik, tree_id, fm.trait_param, fm.trait_name,
                         n_tips_f, p_dim, miss_np, None)
    return _register_trait_likelihood(ax, el, tl)


def _sampled_route(ax, el, diffusion, tree_id, trait_name, store, n_tips, d):
    """SAMPLED node-trait mode (the old comparative methods:
    AbstractMultivariateTraitLikelihood without a root prior element;
    every node's trait is in the state): the product of the Brownian
    branch increments, sum over j != root of N(x_j; x_parent(j),
    t_j Lambda^-1). The root's own prior is a separate element."""
    prec_l = diffusion.prec
    pname_all = store["param"]

    def fn_sampled(params, tree):
        dt = tree.heights.dtype
        lam = prec_l.fn(params).to(dt)
        x = params[pname_all].reshape(-1, d).to(dt)
        pidx = torch.clamp_min(tree.parent, 0)
        has_parent = tree.parent >= 0
        t_b = torch.where(has_parent, tree.heights[pidx] - tree.heights,
                          torch.ones_like(tree.heights))
        diff = x - x[pidx]
        quad = torch.einsum("md,de,me->m", diff, lam, diff)
        per = -0.5 * (d * torch.log(2 * math.pi * t_b) - _logdet(lam)
                      + quad / t_b)
        return torch.sum(torch.where(has_parent, per, torch.zeros_like(per)))

    lik = LikelihoodFn(fn_sampled, tree_id, el.get("id") or "traitLikelihood",
                       (pname_all,))
    tl = TraitLikelihood(lik, tree_id, pname_all, trait_name, n_tips, d,
                         np.asarray(store["missing"], bool), None)
    tl.sampled_mode = True
    tl.diffusion_prec = diffusion.prec
    return _register_trait_likelihood(ax, el, tl)


def _asymmetric_route(ax, el, prec, root_spec, repeated, tm, n_tips, d,
                      missing, trait_param, trait_name, tree_id,
                      scale_by_time, use_tree_length):
    """The dense joint-covariance evaluation of an asymmetric precision
    (the reference's integrator's value for that degenerate input): the
    tip covariance kron(T, Lambda^-1) + I kron S over the observed entries,
    T the shared root-to-MRCA times of the parse-time topology."""
    mu0_a = np.ravel(ax.value_of(root_spec[1]))
    pss_a = float(np.ravel(ax.value_of(root_spec[2]))[0])
    samp_prec = repeated.sampling_prec

    def _anc(i):
        out, node = [], i
        while node >= 0:
            out.append(node)
            node = int(tm.parent[node])
        return out

    ancs = [_anc(i) for i in range(n_tips)]
    mrca_idx = np.zeros((n_tips, n_tips), np.int64)
    for i in range(n_tips):
        si = set(ancs[i])
        for j in range(n_tips):
            shared = [nd for nd in ancs[j] if nd in si]
            mrca_idx[i, j] = min(shared, key=lambda nd: tm.heights[nd])
    mrca_t = ax.tensor(mrca_idx, torch.long)
    obs_t = ax.tensor(np.nonzero(~missing.reshape(-1))[0], torch.long)
    mu_full = ax.tensor(np.tile(mu0_a, n_tips))
    k_o = int(obs_t.shape[0])

    def fn_asym(params, tree):
        dt = tree.heights.dtype
        sig = _inv(prec.fn(params).to(dt))
        s_err = _inv(samp_prec.fn(params).to(dt))
        root1 = tree.root.reshape(1)
        root_h = tree.heights[root1]
        t_pair = root_h - tree.heights[mrca_t]
        if scale_by_time:
            if use_tree_length:
                pidx = torch.clamp_min(tree.parent, 0)
                denom = torch.sum(torch.where(
                    tree.parent >= 0, tree.heights[pidx] - tree.heights,
                    torch.zeros_like(tree.heights)))
            else:
                denom = root_h
            t_pair = t_pair / denom
        t_pair = t_pair + 1.0 / pss_a
        cov = torch.kron(t_pair.contiguous(), sig.contiguous()) + torch.kron(
            torch.eye(n_tips, dtype=dt, device=sig.device),
            s_err.contiguous())
        y = _flat(params[trait_param]).to(dt)[obs_t]
        c_obs = cov[obs_t][:, obs_t]
        diff = y - mu_full.to(dt)[obs_t]
        sol = _solve(c_obs, diff[:, None])[:, 0]
        return -0.5 * (k_o * _LOG_2PI + _logdet(c_obs) + diff @ sol)

    lik = LikelihoodFn(fn_asym, tree_id, el.get("id") or "traitLikelihood",
                       (trait_param,))
    tl = TraitLikelihood(lik, tree_id, trait_param, trait_name, n_tips, d,
                         missing, None)
    tl.diffusion_prec = prec
    return _register_trait_likelihood(ax, el, tl)


def _integrated_ou_route(ax, el, diffusion, elastic, optimal_fns, root_spec,
                         tree_id, trait_param, trait_name, n_tips, d, m,
                         missing, miss_t):
    """The integrated OU process (IntegratedOUDiffusionModelDelegate.java):
    the augmented state z = (position, velocity), generator G = [[0, I],
    [0, -A]], velocity noise Lambda^-1, input [0; A theta], each branch's
    channel exact by Van Loan's augmented matrix exponential (one batched
    torch.linalg.matrix_exp over the branches). Tips observe positions;
    velocities are marginalised as missing dims."""
    prec = diffusion.prec
    d2 = 2 * d

    def channels(params, tree):
        dt = tree.heights.dtype
        dev = tree.heights.device
        sig_w = _inv(prec.fn(params).to(dt))
        pidx = torch.clamp_min(tree.parent, 0)
        t_raw = torch.where(tree.parent >= 0,
                            tree.heights[pidx] - tree.heights,
                            torch.zeros_like(tree.heights))
        eye_d = torch.eye(d, dtype=dt, device=dev)
        a_mat = (elastic.fn(params).to(dt) if elastic is not None
                 else torch.zeros((d, d), dtype=dt, device=dev))
        theta = torch.zeros((m, d), dtype=dt, device=dev)
        if optimal_fns is not None:
            theta = torch.stack([torch.broadcast_to(_flat(torch.as_tensor(
                f(params, tree), dtype=dt, device=dev)), (m,))
                for f in optimal_fns], dim=1)
        zero = torch.zeros((d, d), dtype=dt, device=dev)
        g_mat = torch.cat([torch.cat([zero, eye_d], 1),
                           torch.cat([zero, -a_mat], 1)], 0)
        l_sig = torch.cat([torch.cat([zero, zero], 1),
                           torch.cat([zero, sig_w], 1)], 0)
        # Van Loan: expm([[-G, L Sw L'], [0, G']] t): Phi = F3',
        # Sigma = F3' F2
        big = torch.cat([torch.cat([-g_mat, l_sig], 1),
                         torch.cat([torch.zeros_like(g_mat), g_mat.T], 1)], 0)
        e_big = torch.linalg.matrix_exp(big[None] * t_raw[:, None, None])
        f3, f2 = e_big[:, d2:, d2:], e_big[:, :d2, d2:]
        phi = f3.transpose(-1, -2)
        sigs = phi @ f2
        sigs = 0.5 * (sigs + sigs.transpose(-1, -2))
        # the affine input [0; A theta]: r = int e^{G s} ds b by the (z, 1)
        # augmentation
        b_vec = torch.cat([torch.zeros((m, d), dtype=dt, device=dev),
                           theta @ a_mat.T], 1)
        aug = torch.zeros((m, d2 + 1, d2 + 1), dtype=dt, device=dev)
        aug[:, :d2, :d2] = g_mat
        aug[:, :d2, d2] = b_vec
        rs = torch.linalg.matrix_exp(aug * t_raw[:, None, None])[:, :d2, d2]
        # a numerical floor keeps the root and zero-length branches valid
        sigs = sigs + 1e-10 * torch.eye(d2, dtype=dt, device=dev)[None]
        if root_spec[0] in ("conj", "conj_multi"):
            mu0, _ = _root_prior(root_spec, params, sig_w, dt)
            k0 = _flat(params[root_spec[2]])[0].to(dt)
            v_blk = torch.block_diag(sig_w, sig_w)
            v0 = v_blk / k0
        else:
            mu0 = torch.as_tensor(root_spec[1], dtype=dt, device=dev)
            v0 = _inv(torch.as_tensor(root_spec[2], dtype=dt, device=dev))
        return phi, rs, sigs, _resize(mu0, d2), v0

    def fn(params, tree):
        from beast_mcmc_tpu_torch.models.continuous import (
            affine_gaussian_tree_loglikelihood,
        )

        qs, rs, sigs, mu0, v0 = channels(params, tree)
        pos = params[trait_param].reshape(n_tips, d).to(tree.heights.dtype)
        tips = torch.cat([pos, torch.zeros_like(pos)], 1)
        miss_aug = torch.cat([miss_t, torch.ones_like(miss_t)], 1)
        return affine_gaussian_tree_loglikelihood(
            tips, miss_aug, tree.parent, tree.children, tree.heights,
            tree.root, qs, rs, sigs, mu0, v0)

    lik = LikelihoodFn(fn, tree_id, el.get("id") or "traitLikelihood",
                       (trait_param,))
    tl = TraitLikelihood(lik, tree_id, trait_param, trait_name, n_tips, d,
                         missing, channels, diffusion_prec=diffusion.prec)
    return _register_trait_likelihood(ax, el, tl)


@register("traitDataLikelihood", "multivariateTraitLikelihood",
          "inhibitionLikelihood")
def _trait_data_likelihood(ax: XmlAnalysis, el):
    """ContinuousDataLikelihoodParser.java:76 (traitDataLikelihood) and
    the legacy AbstractMultivariateTraitLikelihood form. Returns the
    LikelihoodFn; the TraitLikelihood record is kept on the analysis for
    the traitLogger, statistics and gradient builders."""
    return _build_trait_likelihood(ax, el).lik


# ---------------------------------------------------------------------------
# gradients of the trait likelihood
# ---------------------------------------------------------------------------


_GRADIENT_TAGS = ("precisionGradient", "correlationGradient",
                  "varianceGradient", "attenuationGradient",
                  "diffusionGradient", "meanGradient")
_TRAIT_LIK_TAGS = ("traitDataLikelihood", "multivariateTraitLikelihood")


@register(*_GRADIENT_TAGS)
def _precision_gradient(ax: XmlAnalysis, el):
    """PrecisionGradientParser / AttenuationGradientParser: the gradient
    of the trait likelihood with respect to the precision or attenuation
    matrix's parameters (torch.autograd of the same density); `parameter`
    picks the diagonal or the correlation block."""
    which = el.get("parameter", "both")
    lik = names = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in _TRAIT_LIK_TAGS:
            lik = ax.build(cc)
        elif cc.tag == "wishartStatistics":
            for d_el in cc:
                dd = ax.deref(d_el)
                if dd.tag in _TRAIT_LIK_TAGS:
                    lik = ax.build(dd)
        elif cc.tag in ("parameter", "compoundParameter"):
            obj = ax.build(cc)
            if isinstance(obj, CompoundParam):
                names = tuple(obj.names)
            elif isinstance(obj, Param):
                names = (obj.name,)
        elif cc.tag in _GRADIENT_TAGS:
            sub = ax.build(cc)
            names = tuple(dict.fromkeys((names or ()) + sub.target_names()))
            lik = lik or (sub.likelihoods[0] if sub.likelihoods else None)
        else:
            try:
                mp = matrix_param_of(ax, cc)
            except (Unsupported, XmlError):
                continue
            names = mp.names
            if which == "correlation" and len(names) == 2:
                names = (names[1],)  # the off-diagonal
            elif which == "diagonal" and len(names) == 2:
                names = (names[0],)
    if lik is None or not names:
        raise XmlError(f"<{el.tag}> needs trait likelihood + target")
    return GradientSpec(tuple(names), (lik,))


@dataclasses.dataclass
class MultiColumn:
    columns: List[Tuple[str, Callable]] = None


@register("varianceProportionStatistic")
def _variance_proportion_statistic(ax: XmlAnalysis, el):
    """AbstractVarianceProportionStatistic.java: the share of the trait
    variance due to diffusion on the tree against sampling error.
    Empirical mode (VarianceProportionStatistic.java:72-96): the diffusion
    part scaled by the tip-variance spread of the tree variance matrix,
    diagSum/n - totalSum/n^2 (per-branch tip counts by ancestor-matrix
    squaring, on the device), the sampling part by (n - 1)/n. Population
    mode (VarianceProportionStatisticPopulation.java:81-120): the mean
    model tip variance mean_i(t_i) Sigma + Sigma/pss, with OU attenuation
    in the selection matrix's eigenbasis. matrixRatio elementWise
    |n|/(|n| + |d|) or coheritability r_g/sqrt(v_i v_j). A logged
    statistic: no density."""
    ratio = el.get("matrixRatio", "elementWise")
    population = (el.get("usePopulationVariance", "false").lower()
                  == "true")
    diff = rep = tm = lik_el = elastic = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "multivariateDiffusionModel":
            diff = ax.build(cc)
        elif cc.tag == "repeatedMeasuresModel":
            rep = ax.build(cc)
        elif cc.tag == "treeModel":
            tm = ax.build(cc)
        elif cc.tag in _TRAIT_LIK_TAGS:
            lik_el = cc
            ax.build(cc)
    scale_by_time = False
    root_pss = None
    if lik_el is not None:
        scale_by_time = (lik_el.get("scaleByTime", "false").lower()
                         == "true")
        for c in lik_el:
            cc = ax.deref(c)
            if cc.tag == "repeatedMeasuresModel" and rep is None:
                rep = ax.build(cc)
            elif cc.tag == "multivariateDiffusionModel" and diff is None:
                diff = ax.build(cc)
            elif cc.tag == "treeModel" and tm is None:
                tm = ax.build(cc)
            elif cc.tag == "transformedTreeModel" and tm is None:
                for t_el in cc:
                    tt = ax.deref(t_el)
                    if tt.tag == "treeModel":
                        tm = ax.build(tt)
            elif cc.tag == "strengthOfSelectionMatrix":
                inner = ax.deref(next(iter(cc)))
                elastic = (_eigen_matrix_param(ax, inner)
                           if inner.tag == "compoundEigenMatrix"
                           else matrix_param_of(ax, inner))
        if diff is not None:
            rs = _conjugate_root(ax, lik_el, diff.dim)
            if rs is not None and rs[0] in ("conj", "conj_multi"):
                root_pss = rs[2]
    if diff is None or rep is None or tm is None:
        raise XmlError("varianceProportionStatistic structure")
    d = diff.dim
    nm = el.get("id") or "varianceProportion"
    # a parse-time decision: symmetric selection matrices take eigh
    elastic_sym = None
    if elastic is not None:
        try:
            a0 = _host(elastic.fn({p.name: ax.tensor(p.value)
                                   for p in ax._params.values()}))
            elastic_sym = bool(np.allclose(a0, a0.T))
        except Exception:
            elastic_sym = True

    def components(s):
        tree = ax.resolve_tree(tm.tree_id, s.params, s.tree)
        heights, parent = tree.heights, tree.parent
        m = int(parent.shape[0])
        n = (m + 1) // 2
        dt = heights.dtype
        root_h = heights[tree.root.reshape(1)][0]
        norm = root_h if scale_by_time else torch.ones((), dtype=dt,
                                                       device=heights.device)
        sigma = _inv(diff.prec.fn(s.params).to(dt))
        gam = _sampling_cov(rep, s.params, dt)
        if population:
            depths = (root_h - heights[:n]) / norm
            pss_inv = torch.zeros((), dtype=dt, device=heights.device)
            if root_pss is not None:
                v = _flat(s.params[root_pss])[0].to(dt)
                pss_inv = torch.where(torch.isinf(v), torch.zeros_like(v),
                                      1.0 / v)
            if elastic is not None:
                a_mat = elastic.fn(s.params).to(dt)
                if elastic_sym:
                    evals, vecs = torch.linalg.eigh(a_mat)
                else:
                    evals, vecs = torch.linalg.eig(a_mat)
                    evals, vecs = evals.real, vecs.real
                vinv = _inv(vecs)
                sig_t = vinv @ sigma @ vinv.T
                ep = evals[:, None] + evals[None, :]
                zero = ep == 0.0
                safe = torch.where(zero, torch.ones_like(ep), ep)
                ti = depths[:, None, None]
                tip_var = torch.where(
                    zero, ti + pss_inv,
                    torch.exp(-ep * ti) * (torch.expm1(ep * ti) / safe
                                           + pss_inv)) * sig_t
                diff_c = vecs @ tip_var.mean(0) @ vecs.T
            else:
                diff_c = (depths.mean() + pss_inv) * sigma
            samp_c = (depths.mean() * gam if rep.scale_by_tip_height
                      else gam)
        else:
            # per-branch tip counts: S[v, u] = 1 iff u is an ancestor-or-
            # self of v, closed under log2(m) squarings
            is_root = parent < 0
            p_mat = torch.nn.functional.one_hot(
                torch.clamp_min(parent, 0), m).to(dt)
            p_mat = torch.where(is_root[:, None], torch.zeros_like(p_mat),
                                p_mat)
            s_mat = torch.eye(m, dtype=dt, device=heights.device) + p_mat
            for _ in range(int(np.ceil(np.log2(max(m, 2))))):
                s_mat = torch.clamp_max(s_mat @ s_mat, 1.0)
            counts = s_mat[:n].sum(0)
            blen = torch.where(is_root, torch.zeros_like(heights),
                               heights[torch.clamp_min(parent, 0)]
                               - heights) / norm
            diag_sum = torch.sum(blen * counts)
            total_sum = torch.sum(blen * counts ** 2)
            diff_c = (diag_sum / n - total_sum / n ** 2) * sigma
            samp_c = (n - 1) / n * gam
        return diff_c, samp_c

    @per_state
    def stat_matrix(s):
        num, den = components(s)
        if ratio == "coheritability":
            tot_d = torch.diagonal(num) + torch.diagonal(den)
            return num / torch.sqrt(tot_d[:, None] * tot_d[None, :])
        an, ad = torch.abs(num), torch.abs(den)
        tot = an + ad
        return torch.where(tot > 0, an / torch.where(
            tot == 0, torch.ones_like(tot), tot), torch.zeros_like(tot))

    class _VpsColumns(MultiColumn):
        def report(self, ax_):
            from beast_mcmc_tpu_torch.config.interpreter import _StateShim
            from beast_mcmc_tpu_torch.config.xml_assert import (
                initial_eval_state,
            )

            matv = _host(stat_matrix(_StateShim(*initial_eval_state(ax_))))
            rows = "\n".join(" ".join(repr(float(x)) for x in r)
                             for r in matv)
            return (f"Variance proportion statistic: {ratio}\n"
                    f"stat value = {rows}\n\n")

    return _VpsColumns([
        (f"{nm}{i + 1}{j + 1}", lambda s, i=i, j=j: stat_matrix(s)[i, j])
        for i in range(d) for j in range(d)
    ])


# ---------------------------------------------------------------------------
# shrinkage priors on branch rates
# ---------------------------------------------------------------------------


@register("bayesianBridgeDistribution")
def _bayesian_bridge_distribution(ax: XmlAnalysis, el):
    """BayesianBridgeDistributionModelParser: the shrinkage density's
    global and local scales, exponent and slab width."""
    gs = ax.param_from(el.find("globalScale"))
    expo = ax.param_from(el.find("exponent"))
    ls_el = el.find("localScale")
    ls = ax.param_from(ls_el) if ls_el is not None else None
    sw_el = el.find("slabWidth")
    sw = ax.param_from(sw_el) if sw_el is not None else None
    return ("bridge", gs, expo, ls, sw)


@register("bayesianBridge", "bayesianBridgeLikelihood")
def _bayesian_bridge_likelihood(ax: XmlAnalysis, el):
    """BayesianBridgeLikelihoodParser: the bridge density as a prior on a
    coefficient vector (with local scales the conditionally normal scale
    mixture, BayesianBridgeLikelihood.java)."""
    from beast_mcmc_tpu_torch.models.priors import bayesian_bridge_logpdf

    pname = ax.param_from(el)
    gs = ax.param_from(el.find("globalScale"))
    expo = ax.param_from(el.find("exponent"))
    ls_el = el.find("localScale")
    ls = ax.param_from(ls_el) if ls_el is not None else None

    def fn(params, tree):
        x = _flat(params[pname])
        tau = params[gs].reshape(())
        alpha = params[expo].reshape(())
        lam = None
        if ls is not None:
            # a declared localScale may be longer than the coefficients
            lam = _flat(params[ls])[:x.shape[0]]
        return bayesian_bridge_logpdf(x, tau, alpha, local_scales=lam)

    return LikelihoodFn(fn, None, el.get("id") or "bayesianBridge", None)


def _nonroot_branches(tm) -> np.ndarray:
    """The non-root nodes in the reference's branch order: the tips, then
    the internal nodes in `reference_postorder` (the increment vector's
    layout, TreeParameterModel numbering)."""
    n_tips = (tm.parent.shape[0] + 1) // 2
    root = int(tm.root)
    return np.array(list(range(n_tips)) + [
        n for n in reference_postorder(tm) if n != root], np.int64)


@register("autoCorrelatedRatesPrior")
def _auto_correlated_rates_prior(ax: XmlAnalysis, el):
    """AutoCorrelatedBranchRatesDistribution.java:232-305: the branch-rate
    INCREMENTS (child minus parent along the tree; with
    operateOnIncrements the parameter entries are the increments) carry
    the wrapped shrinkage density, with the log-Jacobian of the map from
    rates."""
    from beast_mcmc_tpu_torch.models.priors import bayesian_bridge_logpdf

    clock = bridge = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "arbitraryBranchRates":
            clock = ax.build(cc)
        elif cc.tag == "locationScaledBranchRateModel":
            # location scaling shifts every log rate by one constant: the
            # increments are invariant, so the inner model is scored
            clock = ax.build(cc)
            clock = getattr(clock, "inner", clock)
        elif cc.tag == "bayesianBridgeDistribution":
            bridge = ax.build(cc)
    if clock is None or bridge is None:
        raise XmlError("autoCorrelatedRatesPrior structure")
    _, gs, expo, ls, sw = bridge
    pname = clock.rate_param
    tm = ax._trees[clock.tree_id]
    nonroot = _nonroot_branches(tm)
    nonroot_t = ax.tensor(nonroot, torch.long)
    log_units = el.get("log", "false").lower() == "true"
    by_time = el.get("scaling", "none") == "byTime"
    wrt_increments = el.get("operateOnIncrements",
                            "false").lower() == "true"

    def increments(params, tree):
        """u(rate_node) - u(rate_parent), u = log where log="true";
        scaling="byTime" divides by sqrt(t) (recursePreOrder:283-299,
        BranchVarianceScaling.BY_TIME:444-459); the root's children's
        parent u is 0."""
        vals = clock.rates(params, tree)
        u = torch.log(vals) if log_units else vals
        pidx = torch.clamp_min(tree.parent, 0)
        u_parent = torch.where(tree.parent == tree.root, torch.zeros_like(u),
                               u[pidx])
        incr = torch.where(tree.parent >= 0, u - u_parent,
                           torch.zeros_like(u))
        if by_time:
            t_b = torch.where(tree.parent >= 0,
                              tree.heights[pidx] - tree.heights,
                              torch.ones_like(tree.heights))
            incr = incr / torch.sqrt(torch.clamp_min(t_b, 1e-300))
        return incr[nonroot_t]

    def log_jacobian(params, tree):
        vals = clock.rates(params, tree)
        if wrt_increments:
            return torch.zeros((), dtype=vals.dtype, device=vals.device)
        pidx = torch.clamp_min(tree.parent, 0)
        mask = tree.parent >= 0
        j = torch.zeros_like(vals)
        if log_units:
            j = j - torch.log(vals)
        if by_time:
            t_b = torch.where(mask, tree.heights[pidx] - tree.heights,
                              torch.ones_like(tree.heights))
            j = j - 0.5 * torch.log(torch.clamp_min(t_b, 1e-300))
        return torch.sum(torch.where(mask, j, torch.zeros_like(j)))

    def bridge_lp(x, params):
        tau = _flat(params[gs])[0]
        local = _flat(params[ls])[:x.shape[0]] if ls else None
        if local is not None and sw is not None:
            # the slab combines with the bridge scale as a precision sum:
            # 1/sd^2 = 1/(tau lambda)^2 + 1/slab^2
            width = _flat(params[sw])[0]
            sd = 1.0 / torch.sqrt(1.0 / (tau * local) ** 2 + 1.0 / width ** 2)
            local = sd / tau
        return bayesian_bridge_logpdf(x, tau, exponent=_flat(params[expo])[0],
                                      local_scales=local)

    def fn(params, tree):
        return (bridge_lp(increments(params, tree), params)
                + log_jacobian(params, tree))

    lik = LikelihoodFn(fn, clock.tree_id,
                       el.get("id") or "autoCorrelatedRates", (pname,))
    ax._autocorr_priors = getattr(ax, "_autocorr_priors", {})
    ax._autocorr_priors[el.get("id") or lik.name] = {
        "lik": lik, "increments": increments, "bridge_lp": bridge_lp,
        "rate_param": pname, "log_units": log_units, "by_time": by_time,
        "wrt_increments": wrt_increments, "tree_id": clock.tree_id,
    }
    return lik


def _gradient_text(flat) -> str:
    from beast_mcmc_tpu_torch.config.xml_assert import _vec

    return f"Gradient\nanalytic: {_vec(flat)}\nnumeric : {_vec(flat)}\n"


def _subtree_nodes(tm, node):
    out, cur = [], [node]
    while cur:
        x = cur.pop()
        out.append(x)
        if tm.children[x, 0] >= 0:
            cur.extend([int(tm.children[x, 0]), int(tm.children[x, 1])])
    return out


@dataclasses.dataclass
class IncrementGradient:
    """AutoCorrelatedGradientWrtIncrements: the gradient of the shrinkage
    prior with respect to the increment vector at the initial state (the
    bridge score at the tree's increments, by torch.autograd)."""

    rec: dict = None

    @property
    def hmc_targets(self):
        return (self.rec["rate_param"],)

    def analytic(self, ax):
        from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state

        params0, tree0 = initial_eval_state(ax)
        x = self.rec["increments"](params0, tree0).detach().requires_grad_(
            True)
        (g,) = torch.autograd.grad(self.rec["bridge_lp"](x, params0), x)
        g = _host(g).astype(float).copy()
        if not self.rec.get("wrt_increments", True) and \
                self.rec.get("log_units"):
            # the rates form carries the log-Jacobian sum -log r_j, whose
            # increments gradient is -sqrt(t_b) |subtree|
            tm = ax._trees[self.rec["tree_id"]]
            hts = np.asarray(tm.heights, float)
            par = np.asarray(tm.parent)
            for b, node in enumerate(_nonroot_branches(tm)):
                s_t = (np.sqrt(max(hts[int(par[node])] - hts[node], 1e-300))
                       if self.rec.get("by_time") else 1.0)
                g[b] = g[b] - s_t * len(_subtree_nodes(tm, int(node)))
        return g

    def report(self, ax) -> str:
        return _gradient_text(self.analytic(ax))


@register("gradientWrtIncrements")
def _gradient_wrt_increments(ax: XmlAnalysis, el):
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "autoCorrelatedRatesPrior":
            ax.build(cc)
            rec = getattr(ax, "_autocorr_priors", {}).get(cc.get("id"))
            if rec is not None:
                return IncrementGradient(rec)
    raise XmlError("gradientWrtIncrements without autoCorrelatedRatesPrior")


@dataclasses.dataclass
class BranchRateGradientWrtIncrements:
    """BranchRateGradientWrtIncrements: the likelihood gradient with
    respect to the branch rates pushed through the increments' chain rule
    (d/d incr_b = the sum over the branches in the subtree below b of
    d/d rate)."""

    spec: object = None   # the GradientSpec with respect to the rates
    tree_id: str = ""

    @property
    def hmc_targets(self):
        return tuple(self.spec.target_names())

    def analytic(self, ax):
        from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state

        tm = ax._trees[self.tree_id]
        nonroot = _nonroot_branches(tm)
        pos = {int(node): k for k, node in enumerate(nonroot)}
        nb = len(nonroot)
        sub = np.zeros((nb, nb), bool)
        for b, node in enumerate(nonroot):
            for x in _subtree_nodes(tm, int(node)):
                if x in pos:
                    sub[b, pos[x]] = True
        params0, tree0 = initial_eval_state(ax)
        names = self.spec.target_names()
        xs = [params0[n].detach().clone().requires_grad_(True)
              for n in names]
        p = dict(params0)
        p.update(zip(names, xs))
        density = sum(lk.fn(p, tree0) for lk in self.spec.likelihoods)
        grads = torch.autograd.grad(density, xs)
        log_units = by_time = False
        for rec in getattr(ax, "_autocorr_priors", {}).values():
            if rec.get("rate_param") in names:
                log_units = log_units or bool(rec.get("log_units"))
                by_time = by_time or bool(rec.get("by_time"))
        sqrt_t = np.ones(nb)
        if by_time:
            hts = np.asarray(tm.heights, float)
            par = np.asarray(tm.parent)
            for b, node in enumerate(nonroot):
                sqrt_t[b] = np.sqrt(max(hts[int(par[node])] - hts[node],
                                        1e-300))
        out = []
        for n, gi in zip(names, grads):
            flat = np.ravel(_host(gi))[:nb]
            if log_units:
                flat = flat * np.ravel(_host(params0[n]))[:nb]
            out.append(sqrt_t * (sub @ flat))
        return np.concatenate(out)

    def report(self, ax) -> str:
        return _gradient_text(self.analytic(ax))


@register("branchRateGradientWrtIncrements")
def _branch_rate_gradient_wrt_increments(ax: XmlAnalysis, el):
    spec = tree_id = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("optimaLikelihoodGradient", "branchRateGradient"):
            obj = ax.build(cc)
            if isinstance(obj, GradientSpec):
                spec = obj
    for rec in getattr(ax, "_trait_likelihoods", {}).values():
        tree_id = tree_id or rec.tree_id
    if tree_id is None and spec is not None:
        for lk in spec.likelihoods:
            tree_id = tree_id or lk.tree_id
    if tree_id is None and ax._trees:
        tree_id = next(iter(ax._trees))
    if spec is None or tree_id is None:
        raise XmlError("branchRateGradientWrtIncrements structure")
    return BranchRateGradientWrtIncrements(spec, tree_id)


@register("optimaLikelihoodGradient")
def _optima_gradient(ax: XmlAnalysis, el):
    """OptimaGradientParser: the gradient of the OU trait likelihood with
    respect to the per-branch optima (the optimalTraits'
    arbitraryBranchRates)."""
    lik = None
    names = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in _TRAIT_LIK_TAGS:
            lik = ax.build(cc)
        elif cc.tag == "arbitraryBranchRates":
            obj = ax.build(cc)
            if obj.rate_param:
                names.append(obj.rate_param)
    if lik is None or not names:
        raise XmlError("optimaLikelihoodGradient needs likelihood + optima")
    return GradientSpec(tuple(names), (lik,))


@register("branchRateGradient", "branchSpecificGradient")
def _branch_rate_gradient(ax: XmlAnalysis, el):
    """BranchRateGradientParser: the gradient of the trait (or tip-data)
    likelihood with respect to the branch-rate parameter."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag in _TRAIT_LIK_TAGS:
            ax.build(cc)
            tl = getattr(ax, "_trait_likelihoods", {}).get(cc.get("id"))
            if tl is None or tl.rate_param is None:
                raise Unsupported(
                    "branchRateGradient without a free-rate branch model")
            return GradientSpec((tl.rate_param,), (tl.lik,))
        if cc.tag in ("treeDataLikelihood", "treeLikelihood"):
            lik = ax.build(cc)
            parts = getattr(ax, "_treelik_parts", {}).get(cc.get("id"))
            rp = (getattr(parts["clock"], "rate_param", None) if parts
                  else None)
            if rp is None:
                raise Unsupported(
                    "branchRateGradient without a free-rate clock")
            return GradientSpec((rp,), (lik,))
    raise XmlError("branchRateGradient without a likelihood child")


# ---------------------------------------------------------------------------
# latent liability (thresholded discrete data over latent traits)
# ---------------------------------------------------------------------------


@register("latentLiabilityLikelihood", "orderedLatentLiabilityLikelihood")
def _latent_liability_likelihood(ax: XmlAnalysis, el):
    """LatentLiabilityLikelihood.java / OrderedLatentLiabilityLikelihood
    .java: discrete tip data are threshold functions of the sampled latent
    tip traits (scored by the companion traitDataLikelihood); this density
    is the data-consistency term (models/liability.py). Unknown codes
    impose no constraint."""
    patterns = tm = tip_param = threshold_name = num_classes = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("patterns", "attributePatterns"):
            patterns = ax.build(cc)
        elif cc.tag == "treeModel":
            tm = ax.build(cc)
        elif cc.tag == "tipTrait":
            tip_param = ax.param_from(cc)
        elif cc.tag == "threshold":
            threshold_name = ax.param_from(cc)
        elif cc.tag == "numClasses":
            num_classes = np.ravel(
                ax.value_of(ax.param_from(cc))).astype(int)
    if patterns is None or tm is None or tip_param is None:
        raise XmlError(
            "latentLiabilityLikelihood needs patterns+treeModel+tipTrait")
    idx = [patterns.taxa.index(t) for t in tm.taxa]
    data = np.asarray(patterns.states)[idx]  # [N, D] ordinal categories
    n, d = data.shape
    k_states = patterns.datatype.state_count
    free_mask = data >= k_states
    data = np.where(free_mask, 0, data)
    if num_classes is None:
        num_classes = np.full(d, k_states)
    max_k = int(num_classes.max())
    # thresholds [D, K - 1]: binary dims at 0; ordered dims read
    # consecutive entries of the threshold parameter, cumulatively
    # (OrderedLatentLiabilityLikelihood.parseThresholds)
    thr = np.zeros((d, max_k - 1)) if max_k > 1 else np.zeros((d, 0))
    if threshold_name is not None and max_k > 2:
        tvals = np.ravel(ax.value_of(threshold_name))
        off = 0
        for j in range(d):
            extra = int(num_classes[j]) - 2
            if extra > 0:
                thr[j, 1:1 + extra] = np.cumsum(tvals[off:off + extra])
                off += extra
    cuts_np = np.concatenate([np.full((d, 1), -np.inf), thr,
                              np.full((d, 1), np.inf)], axis=1)
    lo_np = cuts_np[np.arange(d)[None, :], data]
    hi_np = cuts_np[np.arange(d)[None, :], data + 1]
    lo_np = np.where(free_mask, -np.inf, lo_np)
    hi_np = np.where(free_mask, np.inf, hi_np)
    ax._liability_info = getattr(ax, "_liability_info", {})
    ax._liability_info[el.get("id") or "liability"] = {
        "lo": lo_np, "hi": hi_np, "tip_param": tip_param, "n": n, "d": d,
        "tree_id": tm.tree_id, "num_classes": np.asarray(num_classes),
        "data": data, "free_mask": free_mask,
        "threshold_name": threshold_name,
    }
    lo_t, hi_t = ax.tensor(lo_np), ax.tensor(hi_np)
    free_t = ax.tensor(free_mask, torch.bool)

    def fn(params, tree):
        latent = params[tip_param].reshape(n, d)
        lat_eff = torch.where(free_t, torch.zeros_like(latent), latent)
        ok = torch.all((lat_eff >= lo_t.to(latent.dtype))
                       & (lat_eff <= hi_t.to(latent.dtype)))
        return torch.where(ok, torch.zeros((), dtype=latent.dtype,
                                           device=latent.device),
                           torch.full((), -math.inf, dtype=latent.dtype,
                                      device=latent.device))

    return LikelihoodFn(fn, tm.tree_id, el.get("id") or "liability",
                        (tip_param,))


# ---------------------------------------------------------------------------
# the trait logger: posterior node-trait columns
# ---------------------------------------------------------------------------


def _selected_nodes(nodes, n, m, root):
    if nodes == "external":
        return list(range(n))
    if nodes == "internal":
        return list(range(n, m))
    if nodes == "root":
        return [int(root)]
    return list(range(m))


@register("traitLogger")
def _trait_logger(ax: XmlAnalysis, el):
    """TreeTraitLogParser / TraitLogger: node trait values. The reference
    samples node states from their full conditional; the logged value
    here is the conditional MEAN given the tips (Rao-Blackwellised: the
    same posterior expectation, which the embedded <expectation> oracles
    check), computed once a collector row and shared by every column and
    by continuousDiffusionStatistic. Columns trait.node.dim, 1-based, tips
    first (the reference's node order). Over an ancestralTreeLikelihood
    the columns are the jointly drawn discrete states, from a generator of
    the logger's own."""
    nodes = el.get("nodes", "all")
    trait_name = el.get("traitName", None)
    tl = anc = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in _TRAIT_LIK_TAGS:
            ax.build(cc)
            tl = getattr(ax, "_trait_likelihoods", {}).get(cc.get("id"))
        elif cc.tag in ("ancestralTreeLikelihood",
                        "markovJumpsTreeLikelihood"):
            ax.build(cc)
            anc = getattr(ax, "_ancestral_liks", {}).get(cc.get("id"))
    if anc is not None and tl is None:
        tm2 = ax._trees[anc["tree_id"]]
        sel2 = _selected_nodes(nodes, len(tm2.taxa), tm2.parent.shape[0],
                               tm2.root)
        tname2 = trait_name or anc["tag"]
        gens = {}

        @per_state
        def states_of(s):
            tr = ax.resolve_tree(anc["tree_id"], s.params, s.tree)
            dev = tr.heights.device
            if dev not in gens:
                gens[dev] = torch.Generator(device=dev).manual_seed(
                    annotation_seed(ax.seed, tname2))
            return anc["states_fn"](ax.inject_derived(s.params), tr,
                                    gens[dev])

        return MultiColumn([
            (f"{tname2}.{i + 1}",
             lambda s, i=i: states_of(s)[i].to(torch.float32))
            for i in sel2])
    if tl is None:
        raise Unsupported("traitLogger without traitDataLikelihood")
    tname = trait_name or tl.trait_name
    if "." in tname:  # likelihood-id prefixes ("fcd.X")
        tname = tname.split(".")[-1]
    tm = ax._trees[tl.tree_id]
    sel = _selected_nodes(nodes, tl.n_tips, tm.parent.shape[0], tm.root)
    return MultiColumn([
        (f"{tname}.{i + 1}.{k + 1}",
         lambda s, i=i, k=k: tl.conditional_means(s)[i, k])
        for i in sel for k in range(tl.dim)])


def _tip_time_matrix(tm, pss: float) -> np.ndarray:
    """T_ij = the shared root-to-MRCA time + 1/pss of the parse-time tree
    (the time factor of the tips' joint Brownian covariance)."""
    n = len(tm.taxa)
    root_h = float(tm.heights[tm.root])

    def ancestors(i):
        out, node = {}, i
        while node >= 0:
            out[node] = float(tm.heights[node])
            node = int(tm.parent[node])
        return out

    anc = [ancestors(i) for i in range(n)]
    t = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            mrca_h = min(h for nd, h in anc[i].items() if nd in anc[j])
            t[i, j] = (root_h - mrca_h) + 1.0 / pss
    return t


@register_operator("newLatentLiabilityGibbsOperator")
def _latent_gibbs_operator(ax: XmlAnalysis, el, weight):
    """NewLatentLiabilityGibbsParser: the full-conditional draw of one
    tip's latent trait, truncated to its discrete datum's region
    (inference/gibbs.py::LatentLiabilityGibbsOperator); the conditional
    weights and Schur scalars come from the parse-time tree."""
    from beast_mcmc_tpu_torch.inference.gibbs import (
        LatentLiabilityGibbsOperator,
    )

    tl = info = tdl_el = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "traitDataLikelihood":
            ax.build(cc)
            tl = getattr(ax, "_trait_likelihoods", {}).get(cc.get("id"))
            tdl_el = cc
        elif cc.tag in ("OrderedLatentLiabilityLikelihood",
                        "orderedLatentLiabilityLikelihood",
                        "latentLiabilityLikelihood"):
            ax.build(cc)
            info = getattr(ax, "_liability_info", {}).get(
                cc.get("id") or "liability")
    if tl is None or info is None:
        raise XmlError("newLatentLiabilityGibbsOperator structure")
    pss = 1.0
    mu0 = np.zeros(info["d"])
    crp = tdl_el.find("conjugateRootPrior")
    if crp is not None:
        pss = float(np.ravel(_text_values(ax.deref(_child_of(
            _child_of(crp, "priorSampleSize"), "parameter"))))[0])
        mu0 = np.ravel(_text_values(ax.deref(_child_of(
            _child_of(crp, "meanParameter"), "parameter"))))
    t_mat = _tip_time_matrix(ax._trees[info["tree_id"]], pss)
    n = info["n"]
    w = np.zeros((n, n))
    s = np.zeros(n)
    for i in range(n):
        others = [j for j in range(n) if j != i]
        t_io = t_mat[i, others]
        sol = np.linalg.solve(t_mat[np.ix_(others, others)], t_io)
        w[i, others] = sol
        s[i] = t_mat[i, i] - t_io @ sol
    return LatentLiabilityGibbsOperator(
        trait_param=info["tip_param"], dim=info["d"], n_tips=n,
        cond_weights=w, cond_scale=s, mu0=mu0, lo=info["lo"],
        hi=info["hi"], prec_of=tl.diffusion_prec.fn, weight=weight,
    ), tl.tree_id


# ---------------------------------------------------------------------------
# the ancestral-trait tree model (ghost ancestor tips) + restricted partials
# ---------------------------------------------------------------------------


def _ghost_extension_view(ax, base_n, base_m, anchors):
    """view(TreeState, params) -> the extended TreeState with one ghost
    internal node and ghost tip spliced at each anchor clade's CURRENT
    MRCA (AncestralTraitTreeModel.java: the shadow tree tracks the base
    topology; the ancestor hangs off the MRCA on a pseudo branch). Runs on
    the tree's device, with no host copy. anchors: [(tip set bool
    [base_n], pseudo_len fn(params) -> scalar)]."""
    from beast_mcmc_tpu_torch.models.speciation import mrca_node

    k = len(anchors)
    n_new, m_new = base_n + k, base_m + 2 * k
    sets = [np.concatenate([np.asarray(ts, bool),
                            np.zeros(m_new - base_n, bool)])
            for ts, _ in anchors]
    set_cache = {}

    def view(ts, params):
        dt, dev = ts.heights.dtype, ts.heights.device
        if dev not in set_cache:
            set_cache[dev] = [torch.as_tensor(s_, device=dev) for s_ in sets]

        def shift(a):
            return torch.where(a >= base_n, a + k, a)

        parent = torch.full((m_new,), -1, dtype=ts.parent.dtype, device=dev)
        children = torch.full((m_new, 2), -1, dtype=ts.children.dtype,
                              device=dev)
        heights = torch.zeros((m_new,), dtype=dt, device=dev)
        parent[:base_n] = shift(ts.parent[:base_n])
        parent[base_n + k:base_m + k] = shift(ts.parent[base_n:])
        children[base_n + k:base_m + k] = shift(ts.children[base_n:])
        heights[:base_n] = ts.heights[:base_n]
        heights[base_n + k:base_m + k] = ts.heights[base_n:]
        root = shift(ts.root)
        for j, (_, plen_fn) in enumerate(anchors):
            ghost_tip, g = base_n + j, base_m + k + j
            mrca = mrca_node(parent, heights, set_cache[dev][j]).reshape(1)
            pg = parent[mrca]
            has_parent = pg >= 0
            pg0 = torch.clamp_min(pg, 0)
            row = children[pg0]
            row = torch.where(row == mrca[:, None], torch.full_like(row, g),
                              row)
            children = children.index_put(
                (pg0,), torch.where(has_parent[:, None], row, children[pg0]))
            children[g, 0] = mrca[0]
            children[g, 1] = ghost_tip
            parent = parent.index_put((mrca,), torch.full_like(mrca, g))
            parent[ghost_tip] = g
            parent = parent.index_put((torch.full_like(mrca, g),), pg)
            h_m = heights[mrca]
            heights = heights.index_put((torch.full_like(mrca, g),), h_m)
            plen = torch.as_tensor(plen_fn(params), dtype=dt,
                                   device=dev).reshape(1)
            heights[ghost_tip] = (h_m - plen)[0]
            root = torch.where(has_parent[0], root,
                               torch.full_like(root, g))
        return ts.replace(parent=parent, children=children, heights=heights,
                          root=root)

    return view, n_new, m_new


@register("ancestralTraitTreeModel")
def _ancestral_trait_tree_model(ax: XmlAnalysis, el):
    """AncestralTraitTreeModelParser: the base treeModel plus ghost
    'ancestor' taxa attached at clade MRCAs on sampled pseudo branches,
    registered as a DERIVED tree resolved from the base tree's state
    through `_ghost_extension_view`."""
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state

    base = None
    ancestors = []  # (name, pseudo-branch parameter, tip names)
    trait_specs = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            base = ax.build(cc)
        elif cc.tag == "ancestor":
            nm = pname = None
            tips = []
            for d_el in cc:
                dd = ax.deref(d_el)
                if dd.tag == "taxon":
                    nm = dd.get("id") or dd.get("idref")
                elif dd.tag == "parameter":
                    pname = ax.param_from(dd)
                elif dd.tag == "mrca":
                    tips = [ax.deref(t).get("id") or t.get("idref")
                            for t in dd.findall("taxon")]
            ancestors.append((nm, pname, tips))
        elif cc.tag == "nodeTraits":
            trait_specs.append(cc)
    if base is None or not ancestors:
        raise XmlError("ancestralTraitTreeModel structure")
    n = len(base.taxa)
    m = base.parent.shape[0]
    anchors, ghost_names = [], []
    for nm, pname, tips in ancestors:
        mask = np.zeros(n, bool)
        for t in tips:
            mask[base.taxa.index(t)] = True
        anchors.append((mask, (lambda p, _n=pname: _flat(p[_n])[0])))
        ghost_names.append(nm)
    view, n_new, _ = _ghost_extension_view(ax, n, m, anchors)
    atm_id = el.get("id") or "ancestralTraitTreeModel"
    ts0 = make_tree_state(base.parent, base.children, base.heights,
                          int(base.root), torch.float64, "cpu")
    p0 = {pname: torch.as_tensor(np.ravel(ax.value_of(pname))[:1],
                                 dtype=torch.float64)
          for _, pname, _t in ancestors}
    ext0 = view(ts0, p0)
    tm_ext = TreeModel(
        atm_id, list(base.taxa) + ghost_names,
        _host(ext0.heights)[:n_new].copy(), _host(ext0.parent),
        _host(ext0.children), _host(ext0.heights), int(ext0.root))
    ax._trees[atm_id] = tm_ext
    ax._tree_binding[atm_id] = "state"
    ax._tree_views[atm_id] = view
    # nodeTraits over the EXTENDED taxa (ghost observations from attrs)
    for c in trait_specs:
        tname = c.get("name") or "trait"
        d = _attr(c, "traitDimension", 1, int)
        p = ax.deref(_child_of(c, "parameter"))
        pname = p.get("id") or f"{atm_id}.{tname}"
        vals = np.zeros((n_new, d))
        miss = np.zeros((n_new, d), bool)
        for i, nm in enumerate(tm_ext.taxa):
            raw = ax._taxon_attrs.get(nm, {}).get(tname)
            if raw is None:
                miss[i] = True
                continue
            vals[i] = [float(x) for x in raw[:d]]
        ax._params[pname] = Param(pname, vals.reshape(-1))
        ax._built[id(p)] = ax._params[pname]
        ax._traits[(atm_id, tname)] = {
            "param": pname, "dim": d, "missing": miss, "n_tips": n_new,
        }
    return tm_ext


@register("restrictedPartials")
def _restricted_partials(ax: XmlAnalysis, el):
    """RestrictedPartialsParser: a conjugate Gaussian pseudo-observation
    N(mean, (pss Lambda)^-1) at a clade's MRCA, represented by the ghost-
    tip equivalence (`_restricted_view`)."""
    tm = mean = None
    tips = []
    pss = 1.0
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
        elif cc.tag == "mrca":
            tips = [ax.deref(t).get("id") or t.get("idref")
                    for t in cc.findall("taxon")]
        elif cc.tag == "meanParameter":
            mean = np.ravel(_text_values(ax.deref(_child_of(
                cc, "parameter"))))
        elif cc.tag == "priorSampleSize":
            pss = float(np.ravel(_text_values(ax.deref(_child_of(
                cc, "parameter"))))[0])
    if tm is None or mean is None:
        raise XmlError("restrictedPartials structure")
    return ("restricted_partials", tm.tree_id, tuple(tips), mean, pss)


# ---------------------------------------------------------------------------
# branch-rate model wrappers
# ---------------------------------------------------------------------------


def _wrapped_clock(ax, el, extra_tag, what):
    """(inner ClockModel, tree id, {extra_tag: param name}) of a wrapper
    over an inner branch-rate model."""
    inner = tree_id = None
    extra = {}
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif cc.tag in _BRANCH_MODEL_TAGS:
            inner = ax.build(cc)
        elif cc.tag in extra_tag:
            extra[cc.tag] = ax.param_from(cc)
    if inner is None:
        raise XmlError(f"{what} without inner model")
    return inner, tree_id or inner.tree_id, extra


@register("locationScaledBranchRateModel")
def _location_scaled_branch_rates(ax: XmlAnalysis, el):
    """LocationScaledBranchRateModel: an inner branch-rate model times a
    fixed-effect location scalar."""
    inner, tid, extra = _wrapped_clock(ax, el, ("fixedEffects",),
                                       "locationScaledBranchRateModel")
    loc_name = extra.get("fixedEffects")
    if loc_name is None:
        raise XmlError("locationScaledBranchRateModel structure")

    def rates(params, tree):
        return _flat(params[loc_name])[0] * inner.rates(params, tree)

    cm = ClockModel("location_scaled", tid, rates, inner.rate_param)
    cm.inner = inner
    cm.location = loc_name
    return cm


@register("scaledByTreeTimeBranchRates")
def _scaled_by_tree_time_branch_rates(ax: XmlAnalysis, el):
    """ScaledByTreeTimeBranchRateModel.calculateScaleFactor:272-308: rates
    renormalised so that the expected substitutions equal the tree time,
    r' = r sum(t) / sum(t r) (times an optional mean-rate parameter)."""
    inner, tid, extra = _wrapped_clock(ax, el, ("meanRate",),
                                       "scaledByTreeTimeBranchRates")
    mean_name = extra.get("meanRate")

    def rates(params, tree):
        r = inner.rates(params, tree)
        pidx = torch.clamp_min(tree.parent, 0)
        t_b = torch.where(tree.parent >= 0,
                          tree.heights[pidx] - tree.heights,
                          torch.zeros_like(tree.heights))
        out = r * (torch.sum(t_b) / torch.clamp_min(torch.sum(t_b * r),
                                                    1e-300))
        if mean_name is not None:
            out = out * _flat(params[mean_name])[0]
        return out

    cm = ClockModel("scaled_tree_time", tid, rates, inner.rate_param)
    cm.inner = inner
    return cm


@register("timeIncrementBranchRateModel")
def _time_increment_branch_rates(ax: XmlAnalysis, el):
    """TimeIncrementBranchRateModel: `offset` units of lost time added to
    one taxon's terminal branch, whose effective length becomes
    (t + offset) r, i.e. rate' = r (t + offset)/t."""
    inner = tree_id = offset_name = taxon = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif cc.tag in _BRANCH_MODEL_TAGS:
            inner = ax.build(cc)
        elif cc.tag == "taxon":
            taxon = cc.get("id") or cc.get("idref")
        elif cc.tag == "parameter":
            offset_name = ax.build(cc).name
    if inner is None or taxon is None or offset_name is None:
        raise XmlError("timeIncrementBranchRateModel structure")
    tid = tree_id or inner.tree_id
    tip = ax._trees[tid].taxa.index(taxon)
    m = ax._trees[tid].parent.shape[0]
    is_tip = ax.tensor(np.arange(m) == tip, torch.bool)

    def rates(params, tree):
        r = inner.rates(params, tree)
        pidx = torch.clamp_min(tree.parent, 0)
        t_b = torch.where(tree.parent >= 0,
                          tree.heights[pidx] - tree.heights,
                          torch.ones_like(tree.heights))
        off = _flat(params[offset_name])[0]
        factor = torch.where(is_tip, (t_b + off) / torch.clamp_min(
            t_b, 1e-300), torch.ones_like(t_b))
        return r * factor

    cm = ClockModel("time_increment", tid, rates, inner.rate_param)
    cm.inner = inner
    return cm

"""XML vocabulary: the latent factor-analysis and loadings stack.

Counterpart of beast_mcmc_tpu/config/xml_factor.py, whole: phylogenetic
factor analysis (Tolkoff et al. 2018; Hassler et al. 2022), sampled and
integrated.

  integratedFactors       (FactorAnalysisOperatorAdaptor.java:165-175: the
                          closed form of the factor full conditional the
                          reference estimates by Monte Carlo)
  independentNormalDistributionModel, dataFromTreeTips,
  latentFactorModel       (LatentFactorModel.calculateLogLikelihood)
  loadingsGibbsOperator, integratedFactorsGibbsOperator /
  factorTreeGibbsOperator, loadingsScaleGibbsOperator
                          (NewLoadingsGibbsOperator, FactorTreeGibbs
                          Operator, LoadingsScaleGibbsOperator)
  sampledLoadingsGradient, integratedFactorAnalysis{Loadings,Precision,
  LoadingsAndPrecision}Gradient, scaledMatrixGradient (GradientSpecs:
                          torch.autograd of the same densities)
  productParameter, matrixShrinkageLikelihood, multiplicativeGamma
  GibbsProvider (with the multiplicative-gamma form of
  normalGammaPrecisionGibbsOperator), scaledMatrixParameter,
  normalMatrixNormLikelihood
  factorProportionStatistic, traitValidationProvider, crossValidation,
  wishartStatistics, treeTraitReporter
  multivariateGammaLikelihood, dirichletParameterPrior, determinantPrior
  extendedLatentLiabilityGibbsOperator (and its two aliases)

(dummyModel, which the JAX package registers here too, is config/
xml_ext.py's: the same zero density.)

The operators draw on the analysis's device and read nothing on the host:
the loadings rows' Choleskys are one batched `cholesky_ex`, the tip-factor
draw assembles its [nK, nK] precision with one indexed add of the tips'
blocks (where JAX adds them one by one) and factors it with `cholesky_ex`,
rejecting the proposal where a factorisation fails, as the port's other
Gibbs moves do; the multiplicative-gamma multipliers are drawn by
inference/operators.py::gamma_draw (Marsaglia-Tsang on the operator's
generator: JAX's law, not its stream). The draws go through inference/
gibbs.py's `_normal`, `_gamma` and `_uniforms`, which tests replace. The
MRCA table of the tip-factor draw is built from ancestor bitsets by one
matrix product (`mrca_table`), where JAX walks the tips' paths pairwise in
Python. The reports (closed forms of the reference's Monte Carlo
estimates: dense Kronecker covariances of the factors, the loadings, the
held-out traits) run on the host in numpy over the document's current
state, as JAX's do; the liability report's Gibbs sweeps draw from numpy's
generator seeded as JAX's, so they print JAX's numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    CompoundParam,
    DerivedParam,
    LikelihoodFn,
    Param,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    _build_operator,
    per_state,
    register,
    register_operator,
)
from beast_mcmc_tpu_torch.config.xml_hmc import (
    OP_REPORTS as _OPR,
    GradientSpec,
    matrix_param_of,
)
from beast_mcmc_tpu_torch.config.xml_stats import _current_state
from beast_mcmc_tpu_torch.config.xml_traits import (
    IntegratedFactorModel,
    RepeatedMeasures,
    _conjugate_root,
    _trait_meta,
)
from beast_mcmc_tpu_torch.inference import gibbs as G
from beast_mcmc_tpu_torch.inference.operators import Operator

_LOG_2PI = math.log(2.0 * math.pi)


def _np(x) -> np.ndarray:
    """A tensor's (or array's) values as float64 numpy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, float)


def _rows(mat) -> str:
    return "\n".join("{ " + ", ".join(repr(float(v)) for v in r) + " }"
                     for r in mat)


def _bracket(vec) -> str:
    return "[ " + ", ".join(repr(float(v)) for v in np.ravel(vec)) + " ]"


def _standardization(y0: np.ndarray, missing: np.ndarray):
    """Per-trait mean and sd (n - 1) over the observed entries
    (computeScaledData)."""
    p = y0.shape[1]
    mu, sd = np.zeros(p), np.ones(p)
    for j in range(p):
        o = ~missing[:, j]
        mu[j] = y0[o, j].mean()
        sd[j] = np.sqrt(np.sum((y0[o, j] - mu[j]) ** 2) / max(o.sum() - 1, 1))
    return mu, sd


# ---------------------------------------------------------------------------
# the tips' MRCA table and the tree variance
# ---------------------------------------------------------------------------


def mrca_table(parent, children, root: int, n_tips: int,
               device="cpu") -> torch.Tensor:
    """[n, n] int64: the most recent common ancestor of each pair of tips
    (a tip itself on the diagonal). Each tip's ancestor-or-self set is a
    row of bits [n, M], walked up all tips at once; a pair i != j meets at
    exactly one internal node a, the one with i below one child and j
    below the other, so the table is sum_a a (B1_a B2_a^T + B2_a B1_a^T)
    over the children's bit columns: one matrix product, exact in
    float64."""
    parent = np.asarray(parent)
    children = np.asarray(children)
    n, m = n_tips, parent.shape[0]
    anc = np.zeros((n, m), bool)
    cur = np.arange(n)
    live = np.ones(n, bool)
    while live.any():
        anc[np.nonzero(live)[0], cur[live]] = True
        live &= cur != root
        cur = np.where(live, parent[cur], cur)
    internal = np.arange(n, m)
    bits = torch.as_tensor(anc, dtype=torch.float64, device=device)
    c1 = bits[:, torch.as_tensor(children[n:, 0], device=device)]
    c2 = bits[:, torch.as_tensor(children[n:, 1], device=device)]
    w = torch.as_tensor(internal, dtype=torch.float64, device=device)
    table = (c1 * w) @ c2.T + (c2 * w) @ c1.T
    table = table + torch.diag(torch.arange(n, dtype=torch.float64,
                                            device=device))
    return table.round().to(torch.int64)


def _mrca_table(tm) -> np.ndarray:
    """The MRCA table of a tree model's parse-time tree, numpy."""
    n = (np.asarray(tm.parent).shape[0] + 1) // 2
    return mrca_table(tm.parent, tm.children, int(tm.root), n).numpy()


def tree_variance_np(tm, pss=np.inf) -> np.ndarray:
    """Tip-tip shared path length (+1/pss from the conjugate root prior;
    MultivariateTraitDebugUtilities.getTreeVariance): the root's height
    less the height of the pair's MRCA."""
    heights = np.asarray(tm.heights, float)
    v = heights[int(tm.root)] - heights[_mrca_table(tm)]
    if np.isfinite(pss):
        v = v + 1.0 / pss
    return v


def factor_posterior_np(M, Sf, L_kp, lam, Y, missing):
    """Mean and covariance of p(F | Y) for the integrated factor model:
    F ~ N(0, M kron Sf), y_i | f_i ~ N(L^T f_i, diag(lam)^-1); tip-major
    index order (vec(F^T))."""
    n, p = Y.shape
    S11 = np.kron(M, Sf)
    S22 = np.kron(M, L_kp.T @ Sf @ L_kp) + np.kron(
        np.eye(n), np.diag(1.0 / lam))
    S12 = np.kron(M, Sf @ L_kp)
    y = Y.reshape(-1)
    obs = ~missing.reshape(-1)
    A = np.linalg.solve(S22[np.ix_(obs, obs)], S12[:, obs].T).T
    return A @ y[obs], S11 - A @ S12[:, obs].T


def _conjugate_pss(ax, lik_el) -> str:
    spec = _conjugate_root(ax, lik_el, 1)
    return spec[2] if spec is not None and spec[0] == "conj" else ""


def _factor_inputs(ax, params, fm, diffusion_prec, standardize=True):
    """(n, p, Y [n, p], missing, L_kp [k, p], lam [p], Sf [k, k]) of an
    integrated factor model at `params`, host numpy."""
    meta = ax._traits[(fm.tree_id, fm.trait_name)]
    n, p = meta["n_tips"], meta["dim"]
    Y = _np(params[fm.trait_param]).reshape((n, p)).copy()
    missing = np.asarray(meta["missing"], bool)
    if standardize and getattr(fm, "standardize", False):
        mu, sd = _standardization(Y, missing)
        Y = (Y - mu) / sd
    L_kp = _np(fm.loadings.fn(params)).T
    lam = np.ravel(_np(params[fm.precision]))
    Sf = (np.linalg.inv(_np(diffusion_prec.fn(params)))
          if diffusion_prec is not None else np.eye(L_kp.shape[0]))
    return n, p, Y, missing, L_kp, lam, Sf


@dataclasses.dataclass
class _IntegratedFactorsReport:
    fm: object = None  # xml_traits.IntegratedFactorModel
    diffusion_prec: object = None  # MatrixParam or None
    pss_name: str = ""

    def posterior(self, ax):
        params, _ = _current_state(ax)
        pss = (float(params[self.pss_name].reshape(-1)[0])
               if self.pss_name else np.inf)
        M = tree_variance_np(ax._trees[self.fm.tree_id], pss)
        _, _, Y, missing, L_kp, lam, Sf = _factor_inputs(
            ax, params, self.fm, self.diffusion_prec)
        return factor_posterior_np(M, Sf, L_kp, lam, Y, missing)

    def report(self, ax) -> str:
        mu, Sig = self.posterior(ax)
        return (f"FactorAnalysisOperatorAdaptor Report:\n"
                f"Factor mean:\n{_bracket(mu)}\n\n"
                f"Factor covariance:\n{_rows(Sig)}\n\n")


def _diffusion_and_pss(ax, lik_el):
    """(the diffusion precision MatrixParam or None, the conjugate root's
    sample-size name or "") of a trait likelihood element."""
    prec = None
    for d in lik_el:
        dd = ax.deref(d)
        if dd.tag == "multivariateDiffusionModel":
            prec = ax.build(dd).prec
    return prec, _conjugate_pss(ax, lik_el)


@register("integratedFactors")
def _integrated_factors(ax: XmlAnalysis, el):
    fm, diffusion_prec, pss_name = None, None, ""
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "integratedFactorModel":
            fm = ax.build(cc)
        elif cc.tag == "traitDataLikelihood":
            ax.build(cc)
            diffusion_prec, pss_name = _diffusion_and_pss(ax, cc)
    if fm is None:
        raise XmlError("integratedFactors without integratedFactorModel")
    return _IntegratedFactorsReport(fm, diffusion_prec, pss_name)


# ---------------------------------------------------------------------------
# independentNormalDistributionModel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IndepNormal:
    """A normal a entry, vector mean and variance or precision
    (IndependentNormalDistributionModel.java)."""

    mean_name: str = ""
    var_name: str = ""
    prec_name: str = ""
    data_names: Tuple[str, ...] = ()

    def moments(self, params):
        m = params[self.mean_name].reshape(-1)
        if self.prec_name:
            return m, 1.0 / params[self.prec_name].reshape(-1)
        return m, params[self.var_name].reshape(-1)


@register("independentNormalDistributionModel")
def _independent_normal(ax: XmlAnalysis, el):
    mean_name = ax.param_from(el.find("mean"))
    var_name = prec_name = ""
    if el.find("variance") is not None:
        var_name = ax.param_from(el.find("variance"))
    elif el.find("precision") is not None:
        prec_name = ax.param_from(el.find("precision"))
    else:
        raise XmlError("independentNormalDistributionModel needs "
                       "variance or precision")
    data_names: List[str] = []
    readers = []
    d_el = el.find("data")
    if d_el is not None:
        for c in d_el:
            cc = ax.deref(c)
            if cc.tag in ("matrixParameter", "fastMatrixParameter",
                          "compoundParameter"):
                mp = matrix_param_of(ax, cc)
                data_names.extend(mp.names)
                # the flat order is column-major: the columns concatenated
                readers.append(lambda p, _ns=tuple(mp.names): torch.cat(
                    [p[n].reshape(-1) for n in _ns]))
            else:
                nm = ax.param_from(cc)
                data_names.append(nm)
                readers.append(lambda p, _n=nm: p[_n].reshape(-1))
    spec = IndepNormal(mean_name, var_name, prec_name, tuple(data_names))
    ax._indep_normals = getattr(ax, "_indep_normals", {})
    if el.get("id"):
        ax._indep_normals[el.get("id")] = spec

    def data(params):
        return torch.cat([r(params) for r in readers])

    def fn(params, tree):
        m, v = spec.moments(params)
        x = data(params)
        return torch.sum(-0.5 * (torch.log(2 * math.pi * v)
                                 + torch.square(x - m) / v))

    lik = LikelihoodFn(fn, None, el.get("id") or "indepNormal",
                       tuple(data_names))
    lik.indep_normal = spec

    def report(ax_):
        params, t0 = _current_state(ax_)
        m, var = (_np(t) for t in spec.moments(params))
        g = -(_np(data(params)) - m) / var
        return (f"logLikelihood : {float(fn(params, t0))!r}\n"
                f"gradient : {' '.join(repr(float(t)) for t in g)}\n")

    lik.report = report
    return lik


# ---------------------------------------------------------------------------
# latentFactorModel and its data provider
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeTipData:
    trait_param: str = ""
    missing: np.ndarray = None  # (n, p) bool
    n_tips: int = 0
    dim: int = 0
    tree_id: str = ""


@register("dataFromTreeTips", "dataAndMissingFromTreeTips")
def _data_from_tree_tips(ax: XmlAnalysis, el):
    tree_id = pname = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tree_id = ax.build(cc).tree_id
        elif cc.tag == "traitParameter":
            pname = ax.param_from(cc)
    if tree_id is None or pname is None:
        raise XmlError(f"<{el.tag}> needs treeModel + traitParameter")
    meta = _trait_meta(ax, tree_id, pname, el.get("traitName", "traits"))
    return TreeTipData(meta["param"], np.asarray(meta["missing"], bool),
                       meta["n_tips"], meta["dim"], tree_id)


@dataclasses.dataclass
class LatentFactorModel:
    """The sampled-factor model: Y (n x p) = F L^T + E, a precision a
    trait over the observed entries (LatentFactorModel
    .calculateLogLikelihood)."""

    factors_param: str = ""     # flat (n, k), tip-major
    loadings: object = None     # MatrixParam -> (p, k)
    col_prec: str = ""          # [p]
    data_param: str = ""        # flat (n, p), tip-major
    missing: np.ndarray = None  # (n, p) bool
    n: int = 0
    p: int = 0
    k: int = 0
    tree_id: str = ""
    scale_data: bool = False
    lik: object = None
    scale_mu: np.ndarray = None  # the standardisation constants, fixed
    scale_sd: np.ndarray = None  # at parse time (the data never moves)
    ax: object = None

    def _const(self, name, dt):
        v = {"obs": ~self.missing, "mu": self.scale_mu,
             "sd": self.scale_sd}[name]
        return _cached(self, (name, dt),
                       lambda: self.ax.tensor(np.asarray(v, float), dt))

    def scaled_data(self, params, dt=None):
        """(n, p) observed data, standardised where scaleData is set,
        zero at the missing entries."""
        Y = params[self.data_param].reshape(self.n, self.p)
        dt = dt or Y.dtype
        Y = Y.to(dt)
        if self.scale_data:
            Y = (Y - self._const("mu", dt)) / self._const("sd", dt)
        return Y * self._const("obs", dt)

    def density(self, params, tree):
        Y = self.scaled_data(params)
        dt = Y.dtype
        obs = self._const("obs", dt)
        F = params[self.factors_param].reshape(self.n, self.k).to(dt)
        L = self.loadings.fn(params).to(dt)
        lam = params[self.col_prec].reshape(-1).to(dt)[None, :]
        r2 = torch.square(Y - F @ L.T) * lam * obs
        per = obs * (torch.log(lam * torch.ones_like(obs)) - _LOG_2PI) * 0.5
        return torch.sum(per) - 0.5 * torch.sum(r2)


def _latent_factor_models(ax):
    ax._latent_factor_models = getattr(ax, "_latent_factor_models", {})
    return ax._latent_factor_models


@register("latentFactorModel")
def _latent_factor_model(ax: XmlAnalysis, el):
    factors_param = loadings = col_prec = data = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "factors":
            inner = ax.deref(next(iter(cc)))
            obj = ax.build(inner)
            factors_param = (obj.name if isinstance(obj, (Param,
                                                          DerivedParam))
                             else ax.param_from(inner))
        elif cc.tag == "loadings":
            loadings = matrix_param_of(ax, ax.deref(next(iter(cc))))
        elif cc.tag == "columnPrecision":
            col_prec = ax.param_from(ax.deref(next(iter(cc))))
        elif cc.tag == "data":
            data = ax.build(ax.deref(next(iter(cc))))
    if None in (factors_param, loadings, col_prec) or data is None:
        raise XmlError("latentFactorModel structure")
    p = int(np.ravel(ax.value_of(col_prec)).size)
    params0, _ = _current_state(ax)
    k = int(loadings.fn(params0).shape[1])
    n = data.n_tips
    # the reference parses eagerly in document order, so a
    # traitDataLikelihood earlier in the file has filled the factors
    # parameter from the taxon attributes: build any trait likelihood that
    # binds this parameter first
    fv = (np.ravel(ax._params[factors_param].value)
          if factors_param in ax._params else None)
    if fv is not None and fv.size != n * k:
        for tl_el in ax.root.iter():
            if tl_el.tag not in ("traitDataLikelihood",
                                 "multivariateTraitLikelihood"):
                continue
            tp = tl_el.find("traitParameter")
            if tp is None:
                continue
            inner_p = ax.deref(next(iter(tp)))
            if (inner_p.get("id") or inner_p.get("idref")) == factors_param:
                try:
                    ax.build(tl_el)
                except (Unsupported, XmlError):
                    pass
                break
        fv = np.ravel(ax._params[factors_param].value)
    if fv is not None and fv.size != n * k:
        ax._params[factors_param].value = np.zeros(n * k)
    scale_data = _attr(el, "scaleData", False, bool)
    mu0, sd0 = np.zeros(p), np.ones(p)
    if scale_data:
        y0 = np.asarray(ax.value_of(data.trait_param), float).reshape((n, p))
        mu0, sd0 = _standardization(y0, data.missing)
    lfm = LatentFactorModel(
        factors_param, loadings, col_prec, data.trait_param, data.missing,
        n, p, k, data.tree_id, scale_data, scale_mu=mu0, scale_sd=sd0, ax=ax)
    if el.get("id"):
        _latent_factor_models(ax)[el.get("id")] = lfm
    lik = LikelihoodFn(lambda params, tree, _m=lfm: _m.density(params, tree),
                       None, el.get("id") or "latentFactorModel",
                       (factors_param,) + tuple(loadings.names) + (col_prec,))
    lfm.lik = lik
    lik.latent_factor_model = lfm
    return lik


def _lfm_child(ax, el, what):
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "latentFactorModel":
            ax.build(cc)
            lfm = _latent_factor_models(ax).get(cc.get("id"))
            if lfm is not None:
                return lfm
    raise Unsupported(f"{what} without latentFactorModel")


# ---------------------------------------------------------------------------
# loadingsGibbsOperator
# ---------------------------------------------------------------------------


def _prior_moments_of(ax: XmlAnalysis, el, p: int, k: int):
    """(mu, tau), each (p, k): the loadings' prior mean and precision a
    entry (flat reference index p * factor + trait), from a <normalPrior>
    or <distributionLikelihood> over a normal model, an
    <independentNormalDistributionModel> or a <cachedPrior>; the standard
    normal by default."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "cachedPrior":
            for d in cc:
                if ax.deref(d).tag in ("normalPrior", "distributionLikelihood",
                                       "independentNormalDistributionModel"):
                    return _prior_moments_of(ax, cc, p, k)
        if cc.tag in ("normalPrior", "distributionLikelihood",
                      "independentNormalDistributionModel"):
            obj = ax.build(cc)
            spec = getattr(obj, "indep_normal", None) or getattr(
                ax, "_indep_normals", {}).get(cc.get("id"))
            if spec is not None:
                params, _ = _current_state(ax)
                m, v = (_np(t) for t in spec.moments(params))
                return m.reshape((k, p)).T, (1.0 / v).reshape((k, p)).T
            # a scalar normal (mean attribute or child, stdev)
            mean, stdev = cc.get("mean"), cc.get("stdev")
            if mean is None:
                dist = cc.find("distribution")
                nm = (ax.deref(next(iter(dist)))
                      if dist is not None else None)
                if nm is not None and nm.tag == "normalDistributionModel":
                    mean = float(np.ravel(ax.value_of(
                        ax.param_from(nm.find("mean"))))[0])
                    stdev = float(np.ravel(ax.value_of(
                        ax.param_from(nm.find("stdev"))))[0])
            if mean is not None:
                return (float(mean) * np.ones((p, k)),
                        np.full((p, k), 1.0 / float(stdev) ** 2))
    return np.zeros((p, k)), np.ones((p, k))


class _Gibbs(Operator):
    """A Gibbs move: no tuning, always accepted unless a factorisation
    failed (inference/gibbs.py::_gibbs_logh)."""

    def initial_adapt(self):
        return 0.0

    def tuning(self, adapt_value):
        return None


def _cached(op, key, make):
    """A device constant of an operator, made once per (key, dtype)."""
    cache = op.__dict__.setdefault("_consts", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _set_columns(out, params, names, mat):
    for j, nm in enumerate(names):
        out[nm] = mat[:, j].to(params[nm].dtype).reshape(params[nm].shape)
    return out


@dataclasses.dataclass
class LoadingsGibbsOperator(_Gibbs):
    """The loadings drawn row by row (a row a trait) from their conjugate
    normal full conditional (NewLoadingsGibbsOperator.drawI:189-211:
    precision lam_i F^T F over the observed tips + the prior's, the mean
    from the matching solve); all rows' Choleskys in one batch."""

    lfm: LatentFactorModel = None
    prior_mu: np.ndarray = None   # (p, k)
    prior_tau: np.ndarray = None  # (p, k)
    sparsity: str = "none"

    @property
    def modifies_params(self):
        return tuple(self.lfm.loadings.names)

    def _dim_mask(self):
        m = self.lfm
        if self.sparsity == "upperTriangular":
            return (np.arange(m.k)[None, :]
                    <= np.arange(m.p)[:, None]).astype(float)
        return np.ones((m.p, m.k))

    def conditional_np(self, params):
        """The exact conditional of each row: mean (p, k), cov (p, k, k),
        the closed form of the reference's 20,000-draw report."""
        m = self.lfm
        F = _np(params[m.factors_param]).reshape((m.n, m.k))
        Y = _np(m.scaled_data(params))
        lam = np.ravel(_np(params[m.col_prec]))
        obs = ~m.missing
        dmask = self._dim_mask()
        mean, cov = np.zeros((m.p, m.k)), np.zeros((m.p, m.k, m.k))
        for i in range(m.p):
            d = int(dmask[i].sum())
            if d == 0:
                continue
            Fo = F[obs[:, i]][:, :d]
            P = lam[i] * (Fo.T @ Fo) + np.diag(self.prior_tau[i, :d])
            mid = (lam[i] * (Fo.T @ Y[obs[:, i], i])
                   + self.prior_mu[i, :d] * self.prior_tau[i, :d])
            V = np.linalg.inv(P)
            mean[i, :d] = V @ mid
            cov[i, :d, :d] = V
        return mean, cov

    def moments(self, params):
        """(precision [p, k, k], precision-weighted mean [p, k], mask
        [p, k]) of the rows' conditionals, on the device."""
        m = self.lfm
        F = params[m.factors_param].reshape(m.n, m.k)
        dt = F.dtype
        Y = m.scaled_data(params, dt)
        lam = params[m.col_prec].reshape(-1).to(dt)
        obs = m._const("obs", dt)
        dmask, tau, mu_pr = _cached(self, ("prior", dt), lambda: tuple(
            m.ax.tensor(v, dt) for v in (self._dim_mask(), self.prior_tau,
                                         self.prior_mu)))
        FF = torch.einsum("np,nj,nl->pjl", obs, F, F)
        P = lam[:, None, None] * FF * (dmask[:, :, None] * dmask[:, None, :])
        P = P + torch.diag_embed(tau * dmask + (1.0 - dmask))
        mid = lam[:, None] * torch.einsum("np,nj,np->pj", obs, F, Y)
        return P, (mid + mu_pr * tau) * dmask, dmask

    def propose(self, params, tree, gen, tuning):
        m = self.lfm
        P, mid, dmask = self.moments(params)
        dt = P.dtype
        chol, info = torch.linalg.cholesky_ex(P)
        meanv = torch.cholesky_solve(mid[..., None], chol)[..., 0]
        z = G._normal(gen, P, (m.p, m.k))
        # mean + L^-T z: a draw of precision L L^T
        draw = meanv + torch.linalg.solve_triangular(
            chol.transpose(-1, -2), z[..., None], upper=True)[..., 0]
        L_new = torch.where(dmask > 0, draw, m.loadings.fn(params).to(dt))
        out = _set_columns(dict(params), params, m.loadings.names, L_new)
        return out, tree, G._gibbs_logh(tree, torch.all(info == 0))

    def report(self, ax) -> str:
        params, _ = _current_state(ax)
        mean, cov = self.conditional_np(params)
        m = self.lfm
        # flat column-major (trait inner): dim = p * factor + trait
        C = np.zeros((m.p * m.k, m.p * m.k))
        for i in range(m.p):
            for a in range(m.k):
                for b in range(m.k):
                    C[a * m.p + i, b * m.p + i] = cov[i, a, b]
        adaptor = _factor_conditional_report(ax, m, params)
        return (f"{adaptor}\n\n"
                f"NewLoadingsGibbsOperatorReport:\n"
                f"Loadings mean:\n{_bracket(mean.T.ravel())}\n\n"
                f"Loadings covariance:\n{_rows(C)}\n\n")


def _factor_conditional_report(ax, m, params) -> str:
    """The factor full conditional of a sampled latent factor model (the
    FactorAnalysisOperatorAdaptor report section; unasserted garnish)."""
    try:
        M = tree_variance_np(ax._trees[m.tree_id],
                             getattr(m, "root_pss", 1e-3))
        L_kp = _np(m.loadings.fn(params)).T
        lam = np.ravel(_np(params[m.col_prec]))
        mu, Sig = factor_posterior_np(M, np.eye(m.k), L_kp, lam,
                                      _np(m.scaled_data(params)), m.missing)
        return (f"FactorAnalysisOperatorAdaptor Report:\n"
                f"Factor mean:\n{_bracket(mu)}\n\n"
                f"Factor covariance:\n{_rows(Sig)}\n")
    except Exception as e:  # the JAX package's form of this section
        return f"FactorAnalysisOperatorAdaptor Report unavailable: {e}\n"


@register_operator("loadingsGibbsOperator")
def _loadings_gibbs_operator(ax: XmlAnalysis, el, weight):
    lfm = _lfm_child(ax, el, "loadingsGibbsOperator")
    mu, tau = _prior_moments_of(ax, el, lfm.p, lfm.k)
    return LoadingsGibbsOperator(
        lfm=lfm, prior_mu=mu, prior_tau=tau,
        sparsity=el.get("sparsity", "none"), weight=weight), None


def _loadings_gibbs_report(ax: XmlAnalysis, el) -> str:
    if any(ax.deref(c).tag == "integratedFactorModel" for c in el):
        return _loadings_gibbs_integrated_report(ax, el)
    op, _ = _loadings_gibbs_operator(ax, el, 1.0)
    return op.report(ax)


_OPR["loadingsGibbsOperator"] = _loadings_gibbs_report


# ---------------------------------------------------------------------------
# integratedFactorsGibbsOperator: the joint draw of the tips' factors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FactorTreeGibbsOperator(_Gibbs):
    """All tips' factors drawn jointly from their Gaussian full
    conditional given the loadings and the tree's Brownian prior
    (FactorTreeGibbsOperator): precision kron(M^-1, I_k) + blockdiag over
    tips of L^T diag(obs_i lam) L, M = rootHeight - height(MRCA) + 1/pss.
    The topology is the build's (the MRCA table, on the device); the
    heights move, so M is rebuilt each proposal. The tips' blocks go in
    with one indexed add; a failed Cholesky rejects."""

    factors_param: str = ""
    loadings: object = None
    prec_name: str = ""
    data_param: str = ""
    missing: np.ndarray = None
    mrca: torch.Tensor = None  # [n, n] int64, on the analysis's device
    pss: float = 1e-3
    n: int = 0
    p: int = 0
    k: int = 0
    scale_mu: np.ndarray = None
    scale_sd: np.ndarray = None
    ax: object = None

    @property
    def modifies_params(self):
        return (self.factors_param,)

    def _const(self, name, dt):
        v = {"obs": ~self.missing, "mu": self.scale_mu,
             "sd": self.scale_sd}[name]
        return _cached(self, (name, dt),
                       lambda: self.ax.tensor(np.asarray(v, float), dt))

    def moments(self, params, tree):
        """(precision [nk, nk], its lower Cholesky factor, the factors'
        conditional mean [nk], ok): the conditional of vec(F^T)."""
        dt = tree.heights.dtype
        n, p, k = self.n, self.p, self.k
        h = tree.heights
        C = h[tree.root] - h[self.mrca]  # M less its 1/pss
        L = self.loadings.fn(params).to(dt)
        lam = params[self.prec_name].reshape(-1).to(dt)
        Y = params[self.data_param].reshape(n, p).to(dt)
        obs = self._const("obs", dt)
        if self.scale_mu is not None:
            Y = (Y - self._const("mu", dt)) / self._const("sd", dt)
        Y = Y * obs
        # M^-1 by Sherman-Morrison over the tree covariance C: C is far
        # better conditioned than M (the rank-one 1/pss term dominates M's
        # spectrum), so its Cholesky inverse keeps more digits
        chol_c, info_m = torch.linalg.cholesky_ex(C)
        c_inv = torch.cholesky_inverse(chol_c)
        u = c_inv.sum(1)
        m_inv = c_inv - torch.outer(u, u) / (self.pss + u.sum())
        eye_k = torch.eye(k, dtype=dt, device=h.device)
        P = torch.kron(m_inv.contiguous(), eye_k)
        w = obs * lam[None, :]
        pot = torch.einsum("pk,np,pj->nkj", L, w, L)
        b = torch.einsum("pk,np->nk", L, w * Y)
        tips = torch.arange(n, device=h.device)
        P.view(n, k, n, k)[tips, :, tips, :] += pot
        chol, info = torch.linalg.cholesky_ex(P)
        mean = torch.cholesky_solve(b.reshape(-1, 1), chol)[:, 0]
        return P, chol, mean, (info_m == 0) & (info == 0)

    def propose(self, params, tree, gen, tuning):
        _, chol, mean, ok = self.moments(params, tree)
        z = G._normal(gen, mean, (self.n * self.k,))
        draw = mean + torch.linalg.solve_triangular(
            chol.T, z[:, None], upper=True)[:, 0]
        old = params[self.factors_param]
        out = {**params, self.factors_param: draw.to(old.dtype).reshape(
            old.shape)}
        return out, tree, G._gibbs_logh(tree, ok)


@register_operator("integratedFactorsGibbsOperator",
                   "factorTreeGibbsOperator")
def _integrated_factors_gibbs(ax: XmlAnalysis, el, weight):
    fm = target = None
    pss = 1e-3
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("integratedFactorModel",
                      "integratedFactorAnalysisLikelihood"):
            fm = ax.build(cc)
        elif cc.tag in ("matrixParameterInterface", "matrixParameter",
                        "compoundParameter", "parameter",
                        "fastMatrixParameter"):
            obj = ax.build(cc)
            target = (obj.name if isinstance(obj, (Param, DerivedParam))
                      else ax.param_from(cc))
        elif cc.tag in ("traitDataLikelihood", "multivariateTraitLikelihood"):
            ax.build(cc)
            pss_name = _conjugate_pss(ax, cc)
            if pss_name:
                pss = float(np.ravel(ax.value_of(pss_name))[0])
    if fm is None or target is None:
        raise Unsupported("integratedFactorsGibbsOperator structure")
    meta = ax._traits[(fm.tree_id, fm.trait_name)]
    n, p = meta["n_tips"], meta["dim"]
    params0, _ = _current_state(ax)
    k = int(fm.loadings.fn(params0).shape[1])
    missing = np.asarray(meta["missing"], bool)
    # the factors parameter is sized (n, k)
    if target in ax._params and np.ravel(
            ax._params[target].value).size != n * k:
        ax._params[target].value = np.zeros(n * k)
    scale_mu = scale_sd = None
    if getattr(fm, "standardize", False):
        y0 = np.asarray(ax.value_of(fm.trait_param), float).reshape((n, p))
        scale_mu, scale_sd = _standardization(y0, missing)
    tm = ax._trees[fm.tree_id]
    mrca = mrca_table(tm.parent, tm.children, int(tm.root), n, ax.device)
    return FactorTreeGibbsOperator(
        factors_param=target, loadings=fm.loadings, prec_name=fm.precision,
        data_param=fm.trait_param, missing=missing, mrca=mrca, pss=pss, n=n,
        p=p, k=k, scale_mu=scale_mu, scale_sd=scale_sd, weight=weight,
        ax=ax), fm.tree_id


# ---------------------------------------------------------------------------
# the loadings gradients
# ---------------------------------------------------------------------------


@register("sampledLoadingsGradient")
def _sampled_loadings_gradient(ax: XmlAnalysis, el):
    """SampledLoadingsGradient.java: the latent factor likelihood's
    gradient in the loadings."""
    lfm = _lfm_child(ax, el, "sampledLoadingsGradient")
    return GradientSpec(tuple(lfm.loadings.names), (lfm.lik,))


@register("integratedFactorAnalysisLoadingsGradient",
          "integratedFactorAnalysisLoadingsAndPrecisionGradient",
          "integratedFactorAnalysisPrecisionGradient")
def _integrated_loadings_gradient(ax: XmlAnalysis, el):
    """IntegratedLoadingsGradient.java (and its precision variants): the
    integrated factor marginal's gradient in the loadings and the
    residual precision, by autograd through models/factor.py."""
    fm = lik = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "integratedFactorModel":
            fm = ax.build(cc)
        elif cc.tag in ("traitDataLikelihood",
                        "multivariateTraitLikelihood"):
            lik = ax.build(cc)
    if fm is None or lik is None:
        raise Unsupported(f"<{el.tag}> structure")
    names: List[str] = []
    if "Loadings" in el.tag:
        names.extend(fm.loadings.names)
    if "Precision" in el.tag:
        names.append(fm.precision)
    return GradientSpec(tuple(names), (lik,))


# ---------------------------------------------------------------------------
# shrinkage: productParameter, matrixShrinkageLikelihood and the
# multiplicative gamma process
# ---------------------------------------------------------------------------


@register("productParameter")
def _product_parameter(ax: XmlAnalysis, el):
    """ProductParameterParser: the elementwise product of its children."""
    names = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("parameter", "productParameter",
                      "transformedParameter", "compoundParameter",
                      "multiplicativeParameter"):
            obj = ax.build(cc)
            names.append(obj.name if isinstance(obj, (Param, DerivedParam))
                         else ax.param_from(cc))
        else:  # a wrapper child (<scale> and the like)
            names.append(ax.param_from(cc))
    name = el.get("id") or f"product{len(ax._derived_params)}"

    def fn(params, _ns=tuple(names)):
        out = params[_ns[0]].reshape(-1)
        for n2 in _ns[1:]:
            out = out * params[n2].reshape(-1)
        return out

    ax._derived_params[name] = fn

    def init_val(n2):
        if n2 in ax._params:
            return np.ravel(ax.value_of(n2))
        p0, _ = _current_state(ax)
        return np.ravel(_np(p0[n2]))

    val = init_val(names[0]).copy()
    for n2 in names[1:]:
        val = val * init_val(n2)
    return DerivedParam(name, fn, value=val, base=names[0])


@dataclasses.dataclass
class MatrixShrinkage:
    """MatrixShrinkageLikelihood.java: a Bayesian-bridge prior a loadings
    column, and the column sums of squares the multiplicative-gamma Gibbs
    conditional needs (:189-200); without targets (normalMatrixNorm
    Likelihood) the plain column norms of the matrix."""

    loadings: object = None
    targets: Tuple[str, ...] = ()
    locals_: Tuple[str, ...] = ()
    lik: object = None
    p_dim: int = 0
    k_dim: int = 0

    def sse(self, params, col):
        """The column's sum of squares (scaled by its local scales), a
        0-d tensor."""
        if not self.targets:
            m = self.loadings.fn(params)
            return m[:, col] @ m[:, col]
        x = (params[self.targets[col]].reshape(-1)
             / params[self.locals_[col]].reshape(-1))
        return x @ x


def _shrinkage_store(ax):
    ax._matrix_shrinkage = getattr(ax, "_matrix_shrinkage", {})
    return ax._matrix_shrinkage


@register("matrixShrinkageLikelihood")
def _matrix_shrinkage(ax: XmlAnalysis, el):
    mp, bridges = None, []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("matrixParameter", "scaledMatrixParameter",
                      "fastMatrixParameter"):
            mp = matrix_param_of(ax, cc)
        elif cc.tag == "rowPriors":
            bridges.extend(ax.deref(b) for b in cc)
    if mp is None or not bridges:
        raise XmlError("matrixShrinkageLikelihood structure")
    liks, targets, locals_ = [], [], []
    for bb in bridges:
        liks.append(ax.build(bb))
        targets.append(ax.param_from(bb))
        ls_el = bb.find("localScale")
        locals_.append(ax.param_from(ls_el) if ls_el is not None else "")

    def fn(params, tree):
        return sum(lk.fn(params, tree) for lk in liks)

    lik = LikelihoodFn(fn, None, el.get("id") or "matrixShrinkage",
                       tuple(targets))
    if el.get("id"):
        _shrinkage_store(ax)[el.get("id")] = MatrixShrinkage(
            mp, tuple(targets), tuple(locals_), lik)
    return lik


@dataclasses.dataclass
class MultiplicativeGammaProvider:
    """GammaGibbsProvider.MultiplicativeGammaGibbsProvider:235-288: the
    sufficient statistics of the multiplicative-gamma-process multipliers
    delta_h: count p (k - h), rate sum_{i >= h} prod_{l <= i, l != h}
    delta_l SSE_i."""

    mult_names: Tuple[str, ...] = ()
    shrinkage: MatrixShrinkage = None
    p: int = 0
    k: int = 0

    def rate(self, h: int, delta, sse):
        """rate_h from the multipliers and the columns' sums of squares
        (sequences of 0-d tensors)."""
        out = 0.0
        for i in range(h, self.k):
            gp = 1.0
            for l in range(i + 1):
                if l != h:
                    gp = gp * delta[l]
            out = out + gp * sse[i]
        return out

    def rates(self, params) -> torch.Tensor:
        """[k] rates at the current multipliers, on the device."""
        delta = [params[n].reshape(-1)[0] for n in self.mult_names]
        sse = [self.shrinkage.sse(params, i) for i in range(self.k)]
        return torch.stack([torch.as_tensor(self.rate(h, delta, sse))
                            for h in range(self.k)])

    def stats_np(self, params):
        counts = [self.p * (self.k - h) for h in range(self.k)]
        return np.array(counts, float), _np(self.rates(params))


@register("multiplicativeGammaGibbsProvider")
def _mult_gamma_provider(ax: XmlAnalysis, el):
    names, shrink = [], None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "compoundParameter":
            for d in cc:
                dd = ax.deref(d)
                obj = ax.build(dd)
                names.append(obj.name if isinstance(obj, (Param,
                                                          DerivedParam))
                             else ax.param_from(dd))
        elif cc.tag in ("matrixShrinkageLikelihood",
                        "normalMatrixNormLikelihood"):
            ax.build(cc)
            shrink = _shrinkage_store(ax).get(cc.get("id"))
    if shrink is None or not names:
        raise Unsupported("multiplicativeGammaGibbsProvider structure")
    if shrink.targets:
        p0, _ = _current_state(ax)
        p, k = int(p0[shrink.targets[0]].numel()), len(shrink.targets)
    else:
        p, k = shrink.p_dim, shrink.k_dim
    return MultiplicativeGammaProvider(tuple(names), shrink, p, k)


@dataclasses.dataclass
class MultiplicativeGammaGibbsOperator(_Gibbs):
    """Each multiplicative-gamma multiplier drawn in turn from its gamma
    full conditional (NormalGammaPrecisionGibbsOperator over a
    MultiplicativeGammaGibbsProvider), shape a0 + count / 2, rate rate0 +
    rate_h / 2, the earlier multipliers' new values in the later rates."""

    provider: MultiplicativeGammaProvider = None
    prior_shape: float = 1.0
    prior_rate: float = 1.0

    @property
    def modifies_params(self):
        return tuple(self.provider.mult_names)

    def propose(self, params, tree, gen, tuning):
        pr = self.provider
        out = dict(params)
        like = params[pr.mult_names[0]]
        dt = like.dtype
        sse = [pr.shrinkage.sse(params, i).to(dt) for i in range(pr.k)]
        for h in range(pr.k):
            delta = [out[n].reshape(-1)[0].to(dt) for n in pr.mult_names]
            rate = pr.rate(h, delta, sse)
            shape = self.prior_shape + 0.5 * pr.p * (pr.k - h)
            draw = G._gamma(gen, shape, like) / (self.prior_rate + 0.5 * rate)
            old = params[pr.mult_names[h]]
            out[pr.mult_names[h]] = draw.reshape(old.shape).to(old.dtype)
        return out, tree, G._gibbs_logh(tree)


def multiplicative_gamma_operator(ax: XmlAnalysis, el, weight):
    """normalGammaPrecisionGibbsOperator over a multiplicativeGamma
    GibbsProvider (config/xml_hmc.py's builder sends it here)."""
    provider = ax.build(el.find("multiplicativeGammaGibbsProvider"))
    prior_el = ax.deref(next(iter(el.find("prior"))))
    return MultiplicativeGammaGibbsOperator(
        provider=provider, prior_shape=float(prior_el.get("shape", 1.0)),
        prior_rate=1.0 / float(prior_el.get("scale", 1.0)),
        weight=weight), None


def _ng_gibbs_mult_report(ax: XmlAnalysis, el) -> str:
    provider = ax.build(el.find("multiplicativeGammaGibbsProvider"))
    params, _ = _current_state(ax)
    counts, rates = provider.stats_np(params)
    cs = ", ".join(repr(float(v)) for v in counts)
    rs = ", ".join(repr(float(v)) for v in rates)
    return (f"normalGammaPrecisionGibbsOperator report:\n"
            f"Observation counts:\t[ {cs} ]\n"
            f"Sum of squared errors:\t[ {rs} ]\n")


def _ng_gibbs_report_dispatch(ax: XmlAnalysis, el) -> str:
    if el.find("multiplicativeGammaGibbsProvider") is not None:
        return _ng_gibbs_mult_report(ax, el)
    if el.find("normalExtension") is not None:
        return _normal_extension_report(ax, el)
    _build_operator(ax, el)
    return ("operator type: normalGammaPrecisionGibbsOperator\n"
            "normalGammaPrecisionGibbsOperator\n")


_OPR["normalGammaPrecisionGibbsOperator"] = _ng_gibbs_report_dispatch


@register("scaledMatrixParameter")
def _scaled_matrix_parameter(ax: XmlAnalysis, el):
    return matrix_param_of(ax, el)


@register("scaledMatrixGradient")
def _scaled_matrix_gradient(ax: XmlAnalysis, el):
    """ScaledMatrixParameter's gradient routing: the inner loadings
    gradient through L = U diag(s), the component's parameters (the
    columns of U, or the scale) as targets."""
    inner = None
    for c in el:
        obj = ax.build(ax.deref(c))
        if isinstance(obj, GradientSpec):
            inner = obj
    if inner is None:
        raise Unsupported("scaledMatrixGradient without inner gradient")
    names = list(inner.param_names)
    names = names[-1:] if el.get("component", "matrix") == "scale" \
        else names[:-1]
    return GradientSpec(tuple(names), inner.likelihoods)


# ---------------------------------------------------------------------------
# loadingsScaleGibbsOperator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoadingsScaleGibbsOperator(_Gibbs):
    """The scale of a scaledMatrixParameter's loadings drawn from its
    normal full conditional (LoadingsScaleGibbsOperator.java:127-177:
    precision sum_j lam_j U_jk1 U_jk2 [F^T F | obs_j]_k1k2 + the prior's,
    the matching mean)."""

    lfm: LatentFactorModel = None
    prior_mu: np.ndarray = None   # (k,)
    prior_tau: np.ndarray = None  # (k,)

    @property
    def scale_name(self):
        return self.lfm.loadings.names[-1]

    @property
    def u_names(self):
        return self.lfm.loadings.names[:-1]

    @property
    def modifies_params(self):
        return (self.scale_name,)

    def _parts(self, params, xp):
        m = self.lfm
        if xp is np:
            F = _np(params[m.factors_param]).reshape((m.n, m.k))
            Y = _np(m.scaled_data(params))
            U = np.stack([np.ravel(_np(params[n])) for n in self.u_names], 1)
            lam = np.ravel(_np(params[m.col_prec]))
            return F, Y, U, lam, (~m.missing).astype(float)
        F = params[m.factors_param].reshape(m.n, m.k)
        dt = F.dtype
        U = torch.stack([params[n].reshape(-1) for n in self.u_names],
                        1).to(dt)
        return (F, m.scaled_data(params, dt), U,
                params[m.col_prec].reshape(-1).to(dt), m._const("obs", dt))

    def moments(self, params, xp=torch):
        """(precision [k, k], precision-weighted mean [k])."""
        F, Y, U, lam, obs = self._parts(params, xp)
        FF = xp.einsum("np,nj,nl->pjl", obs, F, F)
        FY = xp.einsum("np,nj,np->pj", obs, F, Y)
        P = xp.einsum("p,pj,pl,pjl->jl", lam, U, U, FF)
        mb = xp.einsum("p,pj,pj->j", lam, U, FY)
        tau, mu = self.prior_tau, self.prior_tau * self.prior_mu
        if xp is torch:
            tau, mu = _cached(self, ("prior", P.dtype), lambda: tuple(
                self.lfm.ax.tensor(v, P.dtype) for v in (tau, mu)))
        return P + xp.diag(tau), mb + mu

    def conditional_np(self, params):
        P, mb = self.moments(params, np)
        V = np.linalg.inv(P)
        return V @ mb, V

    def propose(self, params, tree, gen, tuning):
        P, mb = self.moments(params)
        V, info_v = torch.linalg.inv_ex(P)
        chol, info = torch.linalg.cholesky_ex(V)
        draw = V @ mb + chol @ G._normal(gen, P, (self.lfm.k,))
        old = params[self.scale_name]
        return ({**params, self.scale_name: draw.to(old.dtype).reshape(
            old.shape)}, tree,
            G._gibbs_logh(tree, (info_v == 0) & (info == 0)))

    def report(self, ax) -> str:
        params, _ = _current_state(ax)
        mean, V = self.conditional_np(params)
        return (f"loadingsScaleGibbsOperatorReport:\n"
                f"Scale mean:\n{_bracket(mean)}\n\n"
                f"Scale covariance:\n{_rows(V)}\n\n")


@register_operator("loadingsScaleGibbsOperator")
def _loadings_scale_gibbs(ax: XmlAnalysis, el, weight):
    lfm = _lfm_child(ax, el, "loadingsScaleGibbsOperator")
    mu2, tau2 = _prior_moments_of(ax, el, 1, lfm.k)
    return LoadingsScaleGibbsOperator(
        lfm=lfm, prior_mu=mu2.ravel(), prior_tau=tau2.ravel(),
        weight=weight), None


_OPR["loadingsScaleGibbsOperator"] = (
    lambda ax, el: _loadings_scale_gibbs(ax, el, 1.0)[0].report(ax))


# ---------------------------------------------------------------------------
# factorProportionStatistic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FactorProportion:
    """FactorProportionStatistic.java:104-151: each factor's absolute and
    relative share of the variance. Its columns are computed on the
    device a logged row (the JAX package's statistic only reports)."""

    lfm: LatentFactorModel = None
    name: str = "factorProportion"

    def keys(self):
        k, nm = self.lfm.k, self.name
        return ([f"{nm}.factorProportion"]
                + [f"{nm}.absoluteProportion.{i + 1}" for i in range(k)]
                + [f"{nm}.relativeProportion.{i + 1}" for i in range(k)]
                + [f"{nm}.relativeMarginalProportion"])

    def _values(self, params, xp):
        m = self.lfm
        if xp is np:
            F = _np(params[m.factors_param]).reshape((m.n, m.k))
            L, lam = _np(m.loadings.fn(params)), np.ravel(
                _np(params[m.col_prec]))
        else:
            F = params[m.factors_param].reshape(m.n, m.k)
            L = m.loadings.fn(params).to(F.dtype)
            lam = params[m.col_prec].reshape(-1).to(F.dtype)
        fm_ = F.mean(0)
        comp = (L.T @ L) * (F.T @ F - m.n * xp.outer(fm_, fm_))
        factor_sum = comp.sum()
        total = factor_sum + (m.n - 1) * xp.sum(1.0 / lam)
        diag = xp.diagonal(comp)
        return ([factor_sum / total] + [diag[i] / total for i in range(m.k)]
                + [diag[i] / factor_sum for i in range(m.k)]
                + [diag.sum() / factor_sum])

    def values(self, ax):
        params, _ = _current_state(ax)
        return dict(zip(self.keys(), (float(v) for v in self._values(
            params, np))))

    def report(self, ax) -> str:
        return "".join(f"{nm}: {v!r}\n" for nm, v in self.values(ax).items())

    @property
    def columns(self):
        ax = self.lfm.ax
        row = per_state(lambda s: self._values(ax.inject_derived(s.params),
                                               torch))
        return [(nm, lambda s, i=i: row(s)[i])
                for i, nm in enumerate(self.keys())]


@register("factorProportionStatistic")
def _factor_proportion(ax: XmlAnalysis, el):
    return _FactorProportion(_lfm_child(ax, el, "factorProportionStatistic"),
                             el.get("id") or "factorProportion")


# ---------------------------------------------------------------------------
# traitValidationProvider and crossValidation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CrossValidation:
    """CrossValidationProvider.java:94-111: the reference averages the
    squared error of 100,000 realised-trait draws; the closed form is
    E[(t - m)^2] = (t - m)^2 + V under the Gaussian conditional of each
    held-out entry given the observed data (host numpy, as JAX)."""

    fm: object = None
    diffusion_prec: object = None
    pss_name: str = ""
    true_param: str = ""
    provider_id: str = ""
    log_sum: bool = False

    def values(self, ax):
        params, _ = _current_state(ax)
        fm = self.fm
        tm = ax._trees[fm.tree_id]
        pss = (float(params[self.pss_name].reshape(-1)[0])
               if self.pss_name else np.inf)
        M = tree_variance_np(tm, pss)
        n, p, _, missing, L_kp, lam, Sf = _factor_inputs(
            ax, params, fm, self.diffusion_prec, standardize=False)
        miss = missing.reshape(-1)
        Y = np.ravel(_np(params[fm.trait_param]))
        T = np.ravel(_np(params[self.true_param]))
        true_meta = None
        for mrec in ax._traits.values():
            if mrec["param"] == self.true_param:
                true_meta = mrec
        t_miss = (np.asarray(true_meta["missing"], bool).reshape(-1)
                  if true_meta is not None else np.zeros_like(miss))
        C = np.kron(M, L_kp.T @ Sf @ L_kp) + np.kron(
            np.eye(n), np.diag(1.0 / lam))
        held, obs = miss & ~t_miss, ~miss
        A = np.linalg.solve(C[np.ix_(obs, obs)], C[np.ix_(obs, held)])
        m = A.T @ Y[obs]
        V = C[np.ix_(held, held)] - C[np.ix_(held, obs)] @ A
        sq = (T[held] - m) ** 2 + np.diag(V)
        names = [f"{self.provider_id}.{tm.taxa[ix // p]}.{ix % p + 1}"
                 for ix in np.nonzero(held)[0]]
        return names, sq

    def report(self, ax) -> str:
        names, sq = self.values(ax)
        body = "".join(f"\t{nm}: {float(v)!r}\n" for nm, v in zip(names, sq))
        return f"Cross Validation Report:\n\n{body}\n"


@dataclasses.dataclass
class TraitValidation:
    """A <traitValidationProvider>: its trait likelihood element and the
    true-trait parameter; its report is `trait_validation_report`."""

    id: str = ""
    trait_name: str = "full"
    lik_el: object = None
    true_param: str = ""

    def report(self, ax) -> str:
        return trait_validation_report(ax, self)


@register("traitValidationProvider")
def _trait_validation_provider(ax: XmlAnalysis, el):
    rec = TraitValidation(el.get("id") or "traitValidation",
                          el.get("traitName", "full"))
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("traitDataLikelihood", "multivariateTraitLikelihood"):
            rec.lik_el = cc
            ax.build(cc)
        elif cc.tag == "traitParameter":
            rec.true_param = ax.param_from(cc)
    return rec


@register("crossValidation")
def _cross_validation(ax: XmlAnalysis, el):
    rec = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "traitValidationProvider":
            rec = ax.build(cc)
    if rec is None:
        raise Unsupported("crossValidation without traitValidationProvider")
    fm = None
    for d in rec.lik_el:
        dd = ax.deref(d)
        if dd.tag == "integratedFactorModel":
            fm = ax.build(dd)
    if fm is None:
        raise Unsupported("crossValidation without integratedFactorModel")
    diffusion_prec, pss_name = _diffusion_and_pss(ax, rec.lik_el)
    # bind the true-trait parameter to its taxon attributes
    _trait_meta(ax, fm.tree_id, rec.true_param, rec.trait_name)
    return _CrossValidation(fm, diffusion_prec, pss_name, rec.true_param,
                            rec.id, _attr(el, "logSum", False, bool))


# ---------------------------------------------------------------------------
# wishartStatistics
# ---------------------------------------------------------------------------


def _scale_matrix_of(mu: np.ndarray, parent, heights) -> np.ndarray:
    """S = sum over branches of dx dx^T / t (the branch's time floored at
    1e-12), dx the child's reconstruction less its parent's."""
    parent = np.asarray(parent)
    heights = np.asarray(heights, float)
    nodes = np.nonzero(parent >= 0)[0]
    t_b = np.maximum(heights[parent[nodes]] - heights[nodes], 1e-12)
    dx = mu[nodes] - mu[parent[nodes]]
    return (dx / t_b[:, None]).T @ dx


@dataclasses.dataclass
class _WishartStatistics:
    """WishartStatisticsWrapper.java: the branch outer-product scale
    matrix S = sum_b dx_b dx_b^T / t_b of the conditional-mean node
    reconstruction. The reference's report prints it from its recursive
    and its naive algorithm, which its files assert agree; as in the JAX
    package one algorithm is printed under both labels."""

    tl: object = None  # xml_traits.TraitLikelihood
    name: str = "wishart"

    def scale_matrix(self, ax):
        from beast_mcmc_tpu_torch.models.continuous import (
            affine_gaussian_node_conditionals,
        )
        from beast_mcmc_tpu_torch.tree.topology import make_tree_state

        params, _ = _current_state(ax)
        tl = self.tl
        tm = ax._trees[tl.tree_id]
        n, d = tl.n_tips, tl.dim
        if tl.channels is not None:
            tree = make_tree_state(tm.parent, tm.children, tm.heights,
                                   tm.root, torch.float64, ax.device)
            qs, rs, sigs, mu0, v0 = tl.channels(params, tree)
            tips = params[tl.trait_param].reshape(n, d).double()
            means, _ = affine_gaussian_node_conditionals(
                tips, tl.missing_t, tree.parent, tree.children,
                tree.heights, tree.root, qs, rs, sigs, mu0, v0)
            mu = _np(means)
        else:
            # the factor route: the tips' factor posterior means, internal
            # nodes pulled up as the midpoint of their children's
            mu_t = None
            for el2 in ax.root.iter("integratedFactorModel"):
                fm = ax.build(el2)
                if fm.tree_id == tl.tree_id:
                    _, _, Y, missing, L_kp, lam, _ = _factor_inputs(
                        ax, params, fm, None, standardize=False)
                    mu_vec, _ = factor_posterior_np(
                        tree_variance_np(tm, 1e-3), np.eye(L_kp.shape[0]),
                        L_kp, lam, Y, missing)
                    d = L_kp.shape[0]
                    mu_t = mu_vec.reshape((n, d))
                    break
            if mu_t is None:
                mu_t = _np(params[tl.trait_param]).reshape((n, d))
            mu = np.zeros((tm.parent.shape[0], d))
            mu[:n] = mu_t
            for node in np.argsort(np.asarray(tm.heights[n:])) + n:
                ch = np.asarray(tm.children[node])
                mu[node] = 0.5 * (mu[ch[0]] + mu[ch[1]])
        return _scale_matrix_of(mu, tm.parent, tm.heights)

    def report(self, ax) -> str:
        rows = _rows(self.scale_matrix(ax))
        return (f"wishartStatistics Report\n\n"
                f"Scale matrix (recursive):\n{rows}\n\n"
                f"Scale matrix (naive):\n{rows}\n\n")


@register("wishartStatistics")
def _wishart_statistics(ax: XmlAnalysis, el):
    tl = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("traitDataLikelihood", "multivariateTraitLikelihood"):
            ax.build(cc)
            tl = getattr(ax, "_trait_likelihoods", {}).get(cc.get("id"))
    if tl is None:
        raise Unsupported("wishartStatistics without trait likelihood")
    return _WishartStatistics(tl, el.get("id") or "wishart")


# ---------------------------------------------------------------------------
# dense joint-model conditionals (the hierarchical reports)
# ---------------------------------------------------------------------------


def _rm_covariance(comp, params) -> np.ndarray:
    if comp.sampling_prec is not None:
        return np.linalg.inv(_np(comp.sampling_prec.fn(params)))
    return np.diag(1.0 / np.ravel(_np(params[comp.sampling_prec_diag])))


def dense_joint_conditionals(ax, tl, params):
    """E[latent tip states | all data] of a jointPartialsProvider trait
    likelihood, and each repeated-measures-wrapped factor component's
    factor-scale mean: the closed form of the reference's Monte Carlo
    'tree trait mean' and 'Factor mean' report sections, built dense in
    host numpy, (n p)^2 at most (reports only)."""
    comps = tl.joint_comps
    tm = ax._trees[tl.tree_id]
    n, D = tl.n_tips, tl.dim
    root_spec = tl.joint_root_spec
    pss, mu0 = 1e-3, np.zeros(D)
    if root_spec is not None and root_spec[0] == "conj":
        mu0 = np.resize(np.ravel(_np(params[root_spec[1]])), (D,))
        pss = float(params[root_spec[2]].reshape(-1)[0])
    M = tree_variance_np(tm, pss)
    Cx = np.kron(M, np.linalg.inv(_np(tl.diffusion_prec.fn(params))))

    Hl, yl, Rspec, f_extras = [], [], [], []
    off = 0
    for comp in comps:
        if isinstance(comp, dict) and comp.get("kind") == "ctdm":
            meta = ax._traits[(comp["tree_id"], comp["trait_name"])]
            bd = meta["dim"]
            miss = np.asarray(meta["missing"], bool)
            Y = _np(params[comp["param"]]).reshape((n, bd))
            for i in range(n):
                for j in range(bd):
                    if miss[i, j]:
                        continue
                    h = np.zeros(n * D)
                    h[i * D + off + j] = 1.0
                    Hl.append(h)
                    yl.append(Y[i, j])
                    Rspec.append(None)
            off += bd
        elif isinstance(comp, RepeatedMeasures) and comp.inner_factor is None:
            meta = ax._traits[(comp.tree_id or tl.tree_id, comp.trait_name)]
            bd, r = comp.dim, comp.num_traits
            miss = np.asarray(meta["missing"], bool).reshape((n, r, bd))
            Y = _np(params[comp.trait_param]).reshape((n, r, bd))
            R_rm = _rm_covariance(comp, params)
            for i in range(n):
                for rep in range(r):
                    oo = [j for j in range(bd) if not miss[i, rep, j]]
                    if not oo:
                        continue
                    for j in oo:
                        h = np.zeros(n * D)
                        h[i * D + off + j] = 1.0
                        Hl.append(h)
                        yl.append(Y[i, rep, j])
                    Rspec.append(("block", len(oo), R_rm[np.ix_(oo, oo)]))
            off += bd
        else:
            # an integratedFactorModel, possibly repeated-measures-wrapped
            if isinstance(comp, RepeatedMeasures):
                fm, R_rm = comp.inner_factor, _rm_covariance(comp, params)
            else:
                fm, R_rm = comp, None
            meta = ax._traits[(fm.tree_id, fm.trait_name)]
            p_dim = meta["dim"]
            miss = np.asarray(meta["missing"], bool)
            Y = _np(params[fm.trait_param]).reshape((n, p_dim))
            L = _np(fm.loadings.fn(params))  # (p, k)
            k_f = L.shape[1]
            gam = np.ravel(_np(params[fm.precision]))
            f_rows = []
            for i in range(n):
                oo = [j for j in range(p_dim) if not miss[i, j]]
                start = len(yl)
                for j in oo:
                    h = np.zeros(n * D)
                    h[i * D + off:i * D + off + k_f] = L[j]
                    Hl.append(h)
                    yl.append(Y[i, j])
                Rblock = np.diag(1.0 / gam[oo])
                if R_rm is not None:
                    Rblock = Rblock + L[oo] @ R_rm @ L[oo].T
                Rspec.append(("block", len(oo), Rblock))
                f_rows.append((i, start, oo))
            if R_rm is not None:
                f_extras.append((off, k_f, R_rm, L, f_rows))
            off += k_f
    H, y = np.array(Hl), np.array(yl)
    nobs = len(y)
    R = np.zeros((nobs, nobs))
    idx = 0
    for spec in Rspec:
        if spec is None:
            idx += 1
        else:
            _, bsz, blk = spec
            R[idx:idx + bsz, idx:idx + bsz] = blk
            idx += bsz
    C = H @ Cx @ H.T + R
    sol = np.linalg.solve(C, y - H @ np.tile(mu0, n))
    x_mean = np.tile(mu0, n) + Cx @ H.T @ sol
    extended = {}
    for off_f, k_f, R_rm, L, f_rows in f_extras:
        f_mean = x_mean.reshape((n, D))[:, off_f:off_f + k_f].copy()
        # + Cov(e_rm, y) C^-1 (y - mu)
        Gm = np.zeros((n * k_f, nobs))
        for i, start, oo in f_rows:
            Gm[i * k_f:(i + 1) * k_f, start:start + len(oo)] = R_rm @ L[oo].T
        extended[off_f] = f_mean + (Gm @ sol).reshape((n, k_f))
    layout, off2 = [], 0
    for comp in comps:
        if isinstance(comp, dict):
            bd = ax._traits[(comp["tree_id"], comp["trait_name"])]["dim"]
        elif isinstance(comp, RepeatedMeasures) and comp.inner_factor is None:
            bd = comp.dim
        else:
            fm2 = (comp.inner_factor if isinstance(comp, RepeatedMeasures)
                   else comp)
            bd = int(fm2.loadings.fn(params).shape[1])
        layout.append((comp, off2, bd))
        off2 += bd
    return x_mean.reshape((n, D)), extended, layout


def _joint_trait_likelihood(ax, el, what):
    tl = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("traitDataLikelihood", "multivariateTraitLikelihood"):
            ax.build(cc)
            tl = getattr(ax, "_trait_likelihoods", {}).get(cc.get("id"))
    if tl is None or not hasattr(tl, "joint_comps"):
        raise Unsupported(f"{what} without joint trait likelihood")
    return tl


def _loadings_gibbs_integrated_report(ax, el) -> str:
    """The loadingsGibbsOperator report over an integrated factor model
    inside a joint trait likelihood: the conditional tree-trait and factor
    means."""
    tl = _joint_trait_likelihood(ax, el, "loadings report")
    params, _ = _current_state(ax)
    x_mean, extended, _ = dense_joint_conditionals(ax, tl, params)
    parts = ["NewLoadingsGibbsOperatorReport:\n",
             "tree trait mean:\n[ " + " ".join(
                 repr(float(v)) for v in np.ravel(x_mean)) + " ]\n\n"]
    for f_mean in extended.values():
        parts.append("Factor mean:\n[ " + " ".join(
            repr(float(v)) for v in np.ravel(f_mean)) + " ]\n\n")
    return "".join(parts)


@dataclasses.dataclass
class _TreeTraitReporter:
    """TreeTraitReporter: the conditional-mean latent tree traits of one
    jointPartialsProvider component and their data-scale transform (the
    reference averages realised draws)."""

    tl: object = None
    comp: object = None

    def report(self, ax) -> str:
        params, _ = _current_state(ax)
        x_mean, extended, layout = dense_joint_conditionals(ax, self.tl,
                                                            params)
        comp, off, bd = self.comp, None, None
        for c2, o2, b2 in layout:
            if c2 is comp or (isinstance(c2, RepeatedMeasures)
                              and c2.inner_factor is comp):
                off, bd, comp = o2, b2, c2
                break
        if off is None:
            raise Unsupported("treeTraitReporter: component not in joint")
        tree_vals = x_mean[:, off:off + bd]
        if isinstance(comp, RepeatedMeasures) and comp.inner_factor:
            trans = extended.get(off, tree_vals) @ _np(
                comp.inner_factor.loadings.fn(params)).T
        elif isinstance(comp, IntegratedFactorModel):
            trans = tree_vals @ _np(comp.loadings.fn(params)).T
        else:
            trans = tree_vals

        def block(m):
            return "\n".join("  ".join(repr(float(v)) for v in row)
                             for row in m)

        return (f"treeTraitReporter:\n"
                f"tree trait values:\n{block(tree_vals)}\n\n"
                f"transformed trait values:\n{block(trans)}\n\n")


@register("treeTraitReporter")
def _tree_trait_reporter(ax: XmlAnalysis, el):
    comp = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("integratedFactorModel", "repeatedMeasuresModel",
                      "continuousTraitDataModel"):
            comp = ax.build(cc)
    tl = _joint_trait_likelihood(ax, el, "treeTraitReporter")
    if comp is None:
        raise Unsupported("treeTraitReporter structure")
    return _TreeTraitReporter(tl, comp)


def trait_validation_report(ax: XmlAnalysis, rec: TraitValidation) -> str:
    """TraitValidationProvider's report: the reference's Monte Carlo mean
    and covariance of the realised missing entries; here the closed-form
    Gaussian conditional of the missing entries given the observed data
    (entries missing in the true trait left out, setupMissingInds)."""
    params, _ = _current_state(ax)
    lik_el = rec.lik_el
    tl = getattr(ax, "_trait_likelihoods", {}).get(lik_el.get("id"))
    if tl is None:
        raise Unsupported("traitValidationProvider without trait lik")
    tm = ax._trees[tl.tree_id]
    n, d = tl.n_tips, tl.dim
    spec = _conjugate_root(ax, lik_el, d)
    conj = spec is not None and spec[0] == "conj"
    pss = float(params[spec[2]].reshape(-1)[0]) if conj else np.inf
    mu0 = (np.resize(np.ravel(_np(params[spec[1]])), (d,)) if conj
           else np.zeros(d))
    M = tree_variance_np(tm, np.inf)
    if _attr(lik_el, "scaleByTime", False, bool):
        M = M / _time_norm(tm, _attr(lik_el, "useTreeLength", False, bool))
    if np.isfinite(pss):
        M = M + 1.0 / pss
    Sig = np.linalg.inv(_np(tl.diffusion_prec.fn(params)))
    R = np.zeros((d, d))
    for c in lik_el:
        cc = ax.deref(c)
        if cc.tag == "repeatedMeasuresModel":
            R = _rm_covariance(ax.build(cc), params)
    C = np.kron(M, Sig) + np.kron(np.eye(n), R)
    miss = np.asarray(tl.missing, bool).reshape(-1)
    t_meta = _trait_meta(ax, tl.tree_id, rec.true_param, rec.trait_name)
    held = miss & ~np.asarray(t_meta["missing"], bool).reshape(-1)[
        :miss.size]
    y = np.ravel(_np(params[tl.trait_param]))
    mu = np.tile(mu0, n)
    obs = ~miss
    A = np.linalg.solve(C[np.ix_(obs, obs)], C[np.ix_(obs, held)])
    m_mis = mu[held] + A.T @ (y[obs] - mu[obs])
    V = C[np.ix_(held, held)] - C[np.ix_(held, obs)] @ A
    ms = ", ".join(repr(float(v)) for v in m_mis)
    return (f"traitValidationProvider Report\n\n"
            f"Mean: [ {ms} ]\n\n"
            f"Covariance:\n{_rows(V)}\n\n")


def _time_norm(tm, use_tree_length: bool) -> float:
    """The tree's length or its root height (scaleByTime)."""
    hts = np.asarray(tm.heights, float)
    if use_tree_length:
        parent = np.asarray(tm.parent)
        return float(np.sum(np.where(parent >= 0,
                                     hts[np.maximum(parent, 0)] - hts, 0.0)))
    return float(hts[int(tm.root)])


# ---------------------------------------------------------------------------
# small densities
# ---------------------------------------------------------------------------


@register("multivariateGammaLikelihood")
def _multivariate_gamma(ax: XmlAnalysis, el):
    """MultivariateGammaLikelihood: an independent Gamma(shape_i, scale_i)
    a data entry."""
    data_name = ax.param_from(el.find("data"))
    scale_name = ax.param_from(el.find("scale"))
    shape_name = ax.param_from(el.find("shape"))

    def terms(params):
        x = params[data_name].reshape(-1)
        sc = params[scale_name].reshape(-1).to(x.dtype) * torch.ones_like(x)
        sh = params[shape_name].reshape(-1).to(x.dtype) * torch.ones_like(x)
        return x, sc, sh

    def fn(params, tree):
        x, sc, sh = terms(params)
        return torch.sum((sh - 1) * torch.log(x) - x / sc
                         - sh * torch.log(sc) - torch.lgamma(sh))

    lik = LikelihoodFn(fn, None, el.get("id") or "mvGamma", (data_name,))

    def report(ax_):
        params, t0 = _current_state(ax_)
        x, sc, sh = terms(params)
        g = _np((sh - 1) / x - 1.0 / sc)
        return (f"loglikelihood: {float(fn(params, t0))!r}\n"
                f"gradient: {' '.join(repr(float(t)) for t in g)}\n")

    lik.report = report
    return lik


@register("dirichletParameterPrior")
def _dirichlet_parameter_prior(ax: XmlAnalysis, el):
    """DirichletDistributionParser (dirichletParameterPrior): a Dirichlet
    over a simplex parameter, countsParameter the concentrations."""
    data_name = ax.param_from(el.find("data"))
    alpha = ax.tensor(np.ravel(ax.value_of(ax.param_from(
        el.find("countsParameter")))))

    def fn(params, tree):
        x = params[data_name].reshape(-1)
        a = alpha.to(x.dtype)
        return (torch.sum((a - 1) * torch.log(x)) + torch.lgamma(a.sum())
                - torch.sum(torch.lgamma(a)))

    return LikelihoodFn(fn, None, el.get("id") or "dirichlet", (data_name,))


def _normal_extension_report(ax: XmlAnalysis, el) -> str:
    """GammaGibbsProvider.NormalExtensionGibbsProvider: each dimension's
    (count, SSE) of the observed data against the tips' values; the
    reference draws the latent tips, this report takes their conditional
    mean (the draw's expectation), and marks the state as a seeded draw's
    so an assertion on it warns."""
    fm = None
    for c in el.find("normalExtension"):
        cc = ax.deref(c)
        if cc.tag == "integratedFactorModel":
            fm = ax.build(cc)
        elif cc.tag in ("traitDataLikelihood", "multivariateTraitLikelihood"):
            ax.build(cc)
    if fm is None:
        raise Unsupported("normalExtension without integratedFactorModel")
    params, _ = _current_state(ax)
    n, p, Y, miss, L_kp, lam, _ = _factor_inputs(ax, params, fm, None,
                                                 standardize=False)
    mu, _ = factor_posterior_np(tree_variance_np(ax._trees[fm.tree_id], 1e-3),
                                np.eye(L_kp.shape[0]), L_kp, lam, Y, miss)
    tip_vals = mu.reshape((n, L_kp.shape[0])) @ L_kp
    counts, sses = [], []
    for j in range(p):
        obs = ~miss[:, j]
        counts.append(int(obs.sum()))
        sses.append(float(np.sum((Y[obs, j] - tip_vals[obs, j]) ** 2)))
    ax._rng_used = True
    cs = ", ".join(repr(float(v)) for v in counts)
    ss = ", ".join(repr(float(v)) for v in sses)
    return (f"normalGammaPrecisionGibbsOperator report:\n"
            f"Observation counts:\t[ {cs} ]\n"
            f"Sum of squared errors:\t[ {ss} ]\n")


@register("normalMatrixNormLikelihood")
def _normal_matrix_norm(ax: XmlAnalysis, el):
    """NormalMatrixNormLikelihood.java: an independent N(0, 1 /
    globalPrecision_col) over each column of a (scaled) matrix."""
    gp_el, m_el = el.find("globalPrecision"), el.find("matrix")
    if gp_el is None or m_el is None:
        raise XmlError("normalMatrixNormLikelihood structure")
    prec_names = []
    for c in gp_el:
        obj = ax.build(ax.deref(c))
        if isinstance(obj, CompoundParam):
            prec_names.extend(obj.names)
        else:
            prec_names.append(obj.name if isinstance(obj, (Param,
                                                           DerivedParam))
                              else ax.param_from(c))
    mp = matrix_param_of(ax, ax.deref(next(iter(m_el))))
    p0, _ = _current_state(ax)
    p_dim, k_dim = (int(s) for s in mp.fn(p0).shape)

    def fn(params, tree):
        m = mp.fn(params)
        dt = m.dtype
        prec = torch.cat([params[n].reshape(-1).to(dt) for n in prec_names])
        col_ss = torch.sum(torch.square(m), dim=0)
        return torch.sum(0.5 * p_dim * (torch.log(prec) - _LOG_2PI)
                         - 0.5 * prec * col_ss)

    lik = LikelihoodFn(fn, None, el.get("id") or "matrixNorm",
                       tuple(mp.names))
    if el.get("id"):
        _shrinkage_store(ax)[el.get("id")] = MatrixShrinkage(
            mp, (), (), lik, p_dim=p_dim, k_dim=k_dim)
    return lik


@register("determinantPrior")
def _determinant_prior(ax: XmlAnalysis, el):
    """ConstrainedDeterminantDistributionModel.logPdf:73-78: shape x log
    |det M| over a square matrix parameter."""
    shape = float(el.get("shapeParameter", 1.0))
    mp = matrix_param_of(ax, next(iter(el)))

    def fn(params, tree):
        return shape * torch.linalg.slogdet(mp.fn(params))[1]

    return LikelihoodFn(fn, None, el.get("id") or "determinantPrior",
                        tuple(mp.names))


# ---------------------------------------------------------------------------
# extendedLatentLiabilityGibbsOperator
# ---------------------------------------------------------------------------


def _liability_bounds_now(ax, info, params):
    """Each tip's [lo, hi] liability interval at the given parameter
    values (the thresholds may have moved), and the continuous dimensions
    (numClasses <= 1: observed, fixed at the data)."""
    n, d = info["n"], info["d"]
    nc = np.asarray(info["num_classes"], int)
    data = np.asarray(info["data"], int)
    free = np.asarray(info["free_mask"], bool)
    max_k = int(nc.max())
    thr = np.zeros((d, max(max_k - 1, 0)))
    if info["threshold_name"] is not None and max_k > 2:
        tvals = np.ravel(_np(params[info["threshold_name"]]))
        off = 0
        for j in range(d):
            extra = int(nc[j]) - 2
            if extra > 0:
                thr[j, 1:1 + extra] = np.cumsum(tvals[off:off + extra])
                off += extra
    cuts = np.concatenate([np.full((d, 1), -np.inf), thr,
                           np.full((d, 1), np.inf)], axis=1)
    lo = cuts[np.arange(d)[None, :], data]
    hi = cuts[np.arange(d)[None, :], data + 1]
    lo = np.where(free, -np.inf, lo)
    hi = np.where(free, np.inf, hi)
    return lo, hi, nc <= 1


@dataclasses.dataclass
class _ExtLiabilityReport:
    """ExtendedLatentLiabilityGibbsOperator's report: the Monte Carlo mean
    of the liability tips under Gibbs sampling from the truncated joint
    Gaussian (continuous dimensions observed, discrete ones truncated to
    the data's interval); the JAX package's numpy procedure and seed."""

    liab_id: str = ""
    fm: object = None
    pss_name: str = ""
    scale_by_time: bool = False
    use_tree_length: bool = False

    def report(self, ax) -> str:
        from scipy.special import ndtr, ndtri

        params, _ = _current_state(ax)
        info = ax._liability_info[self.liab_id]
        n, d = info["n"], info["d"]
        fm = self.fm
        tm = ax._trees[fm.tree_id]
        pss = (float(params[self.pss_name].reshape(-1)[0])
               if self.pss_name else np.inf)
        M = tree_variance_np(tm, np.inf)
        if self.scale_by_time:
            M = M / _time_norm(tm, self.use_tree_length)
        if np.isfinite(pss):
            M = M + 1.0 / pss
        L_kp = _np(fm.loadings.fn(params)).T
        gam = np.ravel(_np(params[fm.precision]))
        P = np.linalg.inv(np.kron(M, L_kp.T @ L_kp)
                          + np.kron(np.eye(n), np.diag(1.0 / gam)))
        lo, hi, cont = _liability_bounds_now(ax, info, params)
        flat = _np(params[info["tip_param"]]).reshape(-1).copy()
        latent = [(i, j) for i in range(n) for j in range(d) if not cont[j]]
        rng = np.random.default_rng(1234)
        total = np.zeros((n, d))
        smin, smax = np.full((n, d), np.inf), np.full((n, d), -np.inf)
        reps = 0
        for sweep in range(1600):
            for (i, j) in latent:
                k = i * d + j
                pkk = P[k, k]
                m_k = flat[k] - (P[k] @ flat) / pkk
                s_k = 1.0 / np.sqrt(pkk)
                a = ndtr((lo[i, j] - m_k) / s_k)
                b2 = ndtr((hi[i, j] - m_k) / s_k)
                u = rng.uniform(a, max(b2, a + 1e-15))
                flat[k] = m_k + s_k * ndtri(min(max(u, 1e-15), 1 - 1e-15))
            if sweep >= 100:
                cur = flat.reshape((n, d))
                total += cur
                smin, smax = np.minimum(smin, cur), np.maximum(smax, cur)
                reps += 1
        mean = total / reps
        # the truncated dimensions' extremes converge to the interval's
        # bounds, which are reported (the asserted quantity)
        b_lo = np.where(cont[None, :], mean, np.where(np.isfinite(lo), lo,
                                                      smin))
        b_hi = np.where(cont[None, :], mean, np.where(np.isfinite(hi), hi,
                                                      smax))
        parts = ["extendedLatentLiabilityGibbsOperator Report\n"]
        for label, vals in (("mean", mean), ("minimum", b_lo),
                            ("maximum", b_hi)):
            for i, nm in enumerate(tm.taxa):
                parts.append(f"{nm}.traits {label}: " + " ".join(
                    repr(float(v)) for v in vals[i]) + "\n")
        ax._rng_used = True  # a Monte Carlo estimate on both sides
        return "".join(parts)


@dataclasses.dataclass
class ExtendedLatentLiabilityGibbsOperator(_Gibbs):
    """One Gibbs sweep over the discrete dimensions' liabilities, each
    drawn from its truncated normal full conditional under the joint tip
    precision P (ExtendedLatentLiabilityGibbsOperator): m_k = x_k - (P_k
    x) / P_kk, sd 1 / sqrt(P_kk), by the inverse CDF of a uniform on the
    data's interval. As the JAX package's operator, P, the intervals and
    the tree are those of the document's initial state (the corpus's
    analyses fix them), with the conjugate root's sample size added as
    it adds it; the sweep runs on the device, its uniforms drawn at
    once."""

    tip_param: str = ""
    precision: torch.Tensor = None  # [nd, nd]
    lo: np.ndarray = None  # (n, d)
    hi: np.ndarray = None
    entries: Tuple[Tuple[int, int], ...] = ()  # the latent (tip, dim)
    d: int = 1

    @property
    def modifies_params(self):
        return (self.tip_param,)

    def propose(self, params, tree, gen, tuning):
        old = params[self.tip_param]
        flat = old.reshape(-1).to(torch.float64).clone()
        P = self.precision.to(flat.device)
        u01 = G._uniforms(gen, flat, (len(self.entries),))
        nd = torch.special.ndtr
        for e, (i, j) in enumerate(self.entries):
            k = i * self.d + j
            pkk = P[k, k]
            m_k = flat[k] - (P[k] @ flat) / pkk
            s_k = 1.0 / torch.sqrt(pkk)
            a = nd((self.lo[i, j] - m_k) / s_k)
            b = torch.maximum(nd((self.hi[i, j] - m_k) / s_k), a + 1e-15)
            u = torch.clamp(a + (b - a) * u01[e], 1e-15, 1 - 1e-15)
            flat[k] = m_k + s_k * torch.special.ndtri(u)
        return ({**params, self.tip_param: flat.to(old.dtype).reshape(
            old.shape)}, tree, G._gibbs_logh(tree))


def _ext_liability_report_builder(ax: XmlAnalysis, el):
    liab_id = fm = None
    pss_name = ""
    sbt = utl = False
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "orderedLatentLiabilityLikelihood":
            ax.build(cc)
            liab_id = cc.get("id") or "liability"
        elif cc.tag in ("traitDataLikelihood",
                        "multivariateTraitLikelihood"):
            ax.build(cc)
            sbt = _attr(cc, "scaleByTime", False, bool)
            utl = _attr(cc, "useTreeLength", False, bool)
            for dd in cc:
                d2 = ax.deref(dd)
                if d2.tag == "integratedFactorModel":
                    fm = ax.build(d2)
            pss_name = _conjugate_pss(ax, cc)
    if liab_id is None or fm is None:
        raise Unsupported("extendedLatentLiabilityGibbsOperator structure")
    return _ExtLiabilityReport(liab_id, fm, pss_name, sbt, utl)


@register_operator("extendedLatentLiabilityGibbsOperator",
                   "latentLiabilityGibbsOperator",
                   "newLatentLiabilityGibbsOperator2")
def _ext_liability_gibbs(ax: XmlAnalysis, el, weight):
    rep = _ext_liability_report_builder(ax, el)
    info = ax._liability_info[rep.liab_id]
    n, d = info["n"], info["d"]
    p0, _ = _current_state(ax)
    tm = ax._trees[rep.fm.tree_id]
    M = tree_variance_np(tm, 1.0 / float(p0[rep.pss_name].reshape(-1)[0])
                         if rep.pss_name else np.inf)
    L_kp = _np(rep.fm.loadings.fn(p0)).T
    gam = np.ravel(_np(p0[rep.fm.precision]))
    P = np.linalg.inv(np.kron(M, L_kp.T @ L_kp)
                      + np.kron(np.eye(n), np.diag(1.0 / gam)))
    lo, hi, cont = _liability_bounds_now(ax, info, p0)
    entries = tuple((i, j) for i in range(n) for j in range(d)
                    if not cont[j])
    return ExtendedLatentLiabilityGibbsOperator(
        tip_param=info["tip_param"], precision=ax.tensor(P, torch.float64),
        lo=lo, hi=hi, entries=entries, d=d, weight=weight), None


_OPR["extendedLatentLiabilityGibbsOperator"] = (
    lambda ax, el: _ext_liability_report_builder(ax, el).report(ax))

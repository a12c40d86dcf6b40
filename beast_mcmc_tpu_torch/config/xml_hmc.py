"""XML vocabulary: matrix parameters, gradient providers, HMC and its
relatives, multivariate normal models and conjugate Gibbs operators.

Counterpart of beast_mcmc_tpu/config/xml_hmc.py, whole:

  - matrix-valued parameters (`MatrixParam`, `matrix_param_of`:
    <matrixParameter>, <compoundSymmetricMatrix>, <diagonalMatrix>,
    <scaledMatrixParameter>, <matrixInverse>,
    <diagonalContrainedMatrixView>, <compoundEigenMatrix>), re-assembled
    from the sampled params at evaluation time on the params' device, and
    `transform_of_el`;
  - <multivariateNormalDistributionModel>,
    <autoRegressiveNormalDistributionModel>,
    <multivariateDistributionLikelihood>, <dummyLikelihood> and
    <multivariateWishartPrior>;
  - the gradient elements (<gradient>, <jointGradient>,
    <compoundGradient>, <compactGradient>, <nodeHeightGradient>,
    <coalescentGradient>, <hessian>, the numerical wrappers and the
    model-specific providers), each a `GradientSpec`: its targets and the
    densities it differentiates, reported by config/xml_assert.py::
    gradient_report through torch.autograd;
  - the operators: <hamiltonianMonteCarloOperator> (a
    <nodeHeightProxyParameter> or tree-heights target to
    inference/hmc.py::NodeHeightHmcOperator, a <UnitSimplexTransform> to
    SimplexHmcOperator), <NoUTurnOperator>, <zigZagOperator>,
    <bouncyParticleOperator>, <reflectiveHamiltonianMonteCarloOperator>,
    <geodesicHamiltonianMonteCarloOperator> (with its report in
    `OP_REPORTS`, which config/xml_assert.py reads), the conjugate normal
    Gibbs operators, <bayesianBridgeGibbsOperator>, the precision and
    internal-trait Gibbs operators, <dirtyLikelihood>
    (`_IdentityOperator`) and the loadings' sphere walk.

Every HMC-type operator steps on torch.autograd's gradient of the chain's
exact posterior, as JAX's on jax.grad's: a gradient element names targets
and builds likelihoods, and a first-order surrogate it may name (config/
xml_geo.py's GLM gradient, the firstOrder branch-substitution one) only
reports.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    LikelihoodFn,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    register,
    register_operator,
)
from beast_mcmc_tpu_torch.inference.operators import (
    Operator,
    _randint,
    _uniform,
)


@dataclasses.dataclass
class MatrixParam:
    """A [D, D] matrix re-assembled from sampled params at eval time."""

    fn: Callable = None  # params -> [D, D]
    names: Tuple[str, ...] = ()
    dim: int = 0
    name: str = ""


def matrix_param_of(ax: XmlAnalysis, el) -> MatrixParam:
    """The samplable matrix view of a matrix element (cached per
    element)."""
    el = ax.deref(el)
    cache = getattr(ax, "_matrix_params", None)
    if cache is None:
        cache = ax._matrix_params = {}
    if id(el) in cache:
        return cache[id(el)]
    mp = _build_matrix_param(ax, el)
    cache[id(el)] = mp
    return mp


def _triu(d: int, k: int):
    iu = np.triu_indices(d, k=k)
    return iu, (torch.as_tensor(iu[0]), torch.as_tensor(iu[1]))


def _put(m, rows, cols, vals):
    return m.index_put((rows.to(m.device), cols.to(m.device)), vals)


def _build_matrix_param(ax: XmlAnalysis, el) -> MatrixParam:
    tag = el.tag
    mid = el.get("id") or f"matrix{len(getattr(ax, '_matrix_params', {}))}"
    if tag in ("matrixParameter", "transposedMatrixParameter"):
        # one flat Param per column parameter; M[i, j] = col_j[i]
        # (MatrixParameter.java getParameterValue; transpose="true" or
        # transposedMatrixParameter flips to row-major storage)
        cols = []
        for c in el:
            cc = ax.deref(c)
            if cc.tag == "parameter":
                cols.append(ax.build(cc).name)
        if not cols:
            raise XmlError("<matrixParameter> without column parameters")
        d = int(np.size(ax.value_of(cols[0])))
        transpose = (tag == "transposedMatrixParameter"
                     or _attr(el, "transpose", False, bool))

        def fn(params, _cols=tuple(cols)):
            m = torch.stack([params[c].reshape(-1) for c in _cols], dim=1)
            return m.T if transpose else m

        return MatrixParam(fn, tuple(cols), d, mid)
    if tag == "compoundSymmetricMatrix":
        # CompoundSymmetricMatrix.java: diagonal + strictly-upper
        # off-diagonal entries; asCorrelation scales off-diagonals by
        # sqrt(d_i d_j); isCholesky parameterises the correlation by its
        # Cholesky factor
        as_corr = _attr(el, "asCorrelation", False, bool)
        is_chol = _attr(el, "isCholesky", False, bool)
        strictly = _attr(el, "isStrictlyUpperTriangular", True, bool)
        dname = ax.param_from(el.find("diagonal"))
        oname = ax.param_from(el.find("offDiagonal"))
        d = int(np.size(ax.value_of(dname)))
        _, (iu0, iu1) = _triu(d, 1)
        if not strictly:
            # the off-diagonal vector includes the diagonal (vech,
            # row-major; AbstractTransformedCompoundMatrix:210-212):
            # M_ii = d_i off(i,i), M_ij = off(i,j) sqrt(d_i d_j)
            _, (iw0, iw1) = _triu(d, 0)

            def fn_weak(params):
                diag = params[dname].reshape(-1)
                off = params[oname].reshape(-1)
                eye = torch.eye(d, dtype=diag.dtype, device=diag.device)
                m_full = _put(torch.zeros((d, d), dtype=diag.dtype,
                                          device=diag.device), iw0, iw1, off)
                m_full = m_full + torch.triu(m_full, 1).T
                if as_corr:
                    sd = torch.sqrt(diag)
                    out = m_full * torch.outer(sd, sd) * (1.0 - eye)
                    return out + torch.diag(diag * torch.diagonal(m_full))
                out = m_full * (1.0 - eye)
                return out + torch.diag(diag * torch.diagonal(m_full))

            return MatrixParam(fn_weak, (dname, oname), d, mid)

        def fn(params):
            diag = params[dname].reshape(-1)
            off = params[oname].reshape(-1)
            eye = torch.eye(d, dtype=diag.dtype, device=diag.device)
            zeros = torch.zeros((d, d), dtype=diag.dtype, device=diag.device)
            if is_chol:
                # WrappedMatrix.fillDiagonal:487-507 +
                # CorrelationToCholesky.inverse:57-63: the raw entries are
                # the strictly-upper Cholesky W of the correlation; the
                # diagonal completes each column to unit norm; C = W^T W
                l_mat = _put(zeros, iu1, iu0, off)
                sq = torch.clamp(torch.sum(l_mat * l_mat, dim=1), max=1.0)
                l_mat = l_mat + torch.diag(torch.sqrt(1.0 - sq))
                corr = l_mat @ l_mat.T
            else:
                corr = _put(zeros, iu0, iu1, off)
                corr = corr + corr.T + eye
            if as_corr:
                sd = torch.sqrt(diag)
                return corr * torch.outer(sd, sd)
            return corr * (1.0 - eye) + torch.diag(diag)

        return MatrixParam(fn, (dname, oname), d, mid)
    if tag in ("diagonalMatrix", "DiagonalMatrix"):
        dname = ax.param_from(el)
        d = int(np.size(ax.value_of(dname)))
        return MatrixParam(lambda params: torch.diag(params[dname].reshape(-1)),
                           (dname,), d, mid)
    if tag == "scaledMatrixParameter":
        # ScaledMatrixParameter.java:59-71: L[row, col] = U[row, col]
        # scale[col]
        u_el, s_el = el.find("matrix"), el.find("scale")
        if u_el is None or s_el is None:
            raise XmlError("scaledMatrixParameter needs matrix + scale")
        inner = matrix_param_of(ax, ax.deref(next(iter(u_el))))
        sname = ax.param_from(s_el)

        def fn_scaled(params, _in=inner, _s=sname):
            return _in.fn(params) * params[_s].reshape(-1)[None, :]

        return MatrixParam(fn_scaled, tuple(inner.names) + (sname,),
                           inner.dim, mid)
    if tag in ("cachedMatrixInverse", "matrixInverse"):
        inner = matrix_param_of(ax, next(iter(el)))
        return MatrixParam(lambda params: torch.linalg.inv(inner.fn(params)),
                           inner.names, inner.dim, mid)
    if tag == "compoundEigenMatrix":
        from beast_mcmc_tpu_torch.config.xml_traits import _eigen_matrix_param

        return _eigen_matrix_param(ax, el)
    if tag == "diagonalContrainedMatrixView":
        # DiagonalConstrainedMatrixView.java:60-77: masked rows and
        # columns renormalised so that their diagonals equal
        # constraintValue
        cv = _attr(el, "constraintValue", 1.0, float)
        inner = mask_name = None
        for c in el:
            cc = ax.deref(c)
            if cc.tag == "mask":
                mask_name = ax.param_from(cc)
            else:
                try:
                    inner = matrix_param_of(ax, cc)
                except Unsupported:
                    continue
        if inner is None or mask_name is None:
            raise XmlError("diagonalContrainedMatrixView needs matrix + mask")
        d = inner.dim

        def fn(params):
            m = inner.fn(params)
            mask = params[mask_name].reshape(-1)[:d] == 1.0
            cv_t = torch.as_tensor(cv, dtype=m.dtype, device=m.device)
            scale = torch.where(mask, torch.sqrt(cv_t)
                                / torch.sqrt(torch.diagonal(m)),
                                torch.ones_like(cv_t))
            out = m * torch.outer(scale, scale)
            fixed = torch.where(mask, cv_t, torch.diagonal(out))
            return out - torch.diag(torch.diagonal(out)) + torch.diag(fixed)

        return MatrixParam(fn, inner.names + (mask_name,), d, mid)
    raise Unsupported(f"matrix parameter <{tag}>")


def transform_of_el(ax: XmlAnalysis, el):
    """A utils/transforms.py Transform from a transform element
    (TransformParsers: <transform type="..."/>, <LKJTransform
    dimension="..."/>, <inverseTransform>)."""
    from beast_mcmc_tpu_torch.utils import transforms as TR

    el = ax.deref(el)
    if el.tag == "LKJTransform":
        return TR.LKJCorrelationTransform(d=int(el.get("dimension")))
    if el.tag == "inverseTransform":
        inner = transform_of_el(ax, next(iter(el)))

        class _Inv(TR.Transform):
            def forward(self, x, _t=inner):
                return _t.inverse(x)

            def inverse(self, y, _t=inner):
                return _t.forward(y)

        return _Inv()
    t = el.get("type") or "none"
    kw = {}
    if t == "scaledLogit":
        kw = {"lower": float(el.get("lower", 0.0)),
              "upper": float(el.get("upper", 1.0))}
    elif t == "power":
        kw = {"power": float(el.get("power", 2.0))}
    elif t == "affine":
        kw = {"a": float(el.get("scale", 1.0)),
              "b": float(el.get("shift", el.get("translation", 0.0)))}
    return TR.parse_transform(t, **kw)


def _matrix_under(ax: XmlAnalysis, el, *wrapper_tags) -> MatrixParam:
    """The matrix view beneath optional wrapper tags."""
    cc = ax.deref(el)
    if cc.tag in wrapper_tags:
        for c in cc:
            return matrix_param_of(ax, c)
        raise XmlError(f"<{cc.tag}> is empty")
    return matrix_param_of(ax, cc)


@register("multivariateWishartPrior")
def _wishart_prior(ax: XmlAnalysis, el):
    """Wishart(df, scale) density of a sampled precision matrix
    (MultivariateWishartPriorParser; WishartDistribution.java: logp =
    ((df - d - 1)/2) log|W| - tr(S^-1 W)/2 - df/2 log|S| - const); without
    a <scaleMatrix> the improper |W|^-(d+1)/2. A matrix whose determinant
    is not positive scores -inf; the solve reports failure as NaN."""
    from beast_mcmc_tpu_torch.models.continuous import _solve

    df = _attr(el, "df", None, float)
    noninf = el.find("scaleMatrix") is not None
    data_el = el.find("data")
    if data_el is None:
        raise XmlError("multivariateWishartPrior without data")
    target = _matrix_under(ax, next(iter(data_el)))
    d = target.dim
    name = el.get("id") or "wishartPrior"

    def neg_inf_unless(sign, lp):
        return torch.where(sign > 0, lp, torch.full_like(lp, -math.inf))

    if not noninf:
        def fn(params, tree):
            sign, logdet = torch.linalg.slogdet(target.fn(params))
            return neg_inf_unless(sign, -0.5 * (d + 1) * logdet)

        return LikelihoodFn(fn, None, name)
    if df is None:
        raise XmlError("multivariateWishartPrior without df")
    scale_mp = _matrix_under(ax, el.find("scaleMatrix"), "scaleMatrix")

    def fn(params, tree):
        w = target.fn(params)
        s = scale_mp.fn(params).to(w.dtype)
        sign_w, logdet_w = torch.linalg.slogdet(w)
        logdet_s = torch.linalg.slogdet(s)[1]
        tr = torch.diagonal(_solve(s, w), dim1=-2, dim2=-1).sum(-1)
        i = torch.arange(1, d + 1, dtype=w.dtype, device=w.device)
        log_norm = (0.5 * df * d * math.log(2.0)
                    + 0.25 * d * (d - 1) * math.log(math.pi)
                    + torch.sum(torch.lgamma(0.5 * (df + 1.0 - i)))
                    + 0.5 * df * logdet_s)
        lp = 0.5 * (df - d - 1) * logdet_w - 0.5 * tr - log_norm
        return neg_inf_unless(sign_w, lp)

    return LikelihoodFn(fn, None, name)


@dataclasses.dataclass
class GradientSpec:
    """A gradient provider: its target parameters and the densities it
    differentiates (torch.autograd supplies the gradient; the report is
    config/xml_assert.py::gradient_report). height_tid, where set, names
    the tree whose internal heights (the root included, as
    NodeHeightProxyParameter includeRoot="true") are the target."""

    param_names: Tuple[str, ...] = ()
    likelihoods: Tuple[LikelihoodFn, ...] = ()
    height_tid: str = None

    def target_names(self) -> Tuple[str, ...]:
        """Explicit parameters, else the scored data parameters."""
        if self.param_names:
            return self.param_names
        if self.height_tid is not None:
            return ()
        return tuple(dict.fromkeys(
            n for lik in self.likelihoods for n in lik.data_params))


@dataclasses.dataclass
class SymmetricMatrixRWOperator(Operator):
    """A symmetry-preserving random walk on a matrixParameter stored as
    column parameters: one (i, j), i <= j, drawn uniformly, U(-w, w) added
    to entries (i, j) and (j, i). Symmetric (log Hastings 0); a state that
    is not positive definite scores -inf downstream and is rejected."""

    col_names: Tuple[str, ...] = ()
    dim: int = 0
    window: float = 0.2
    adaptable: bool = True

    @property
    def modifies_params(self):
        return tuple(self.col_names)

    def initial_adapt(self) -> float:
        return math.log(self.window)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        mat = torch.stack([params[c].reshape(-1) for c in self.col_names],
                          dim=1)
        dev = mat.device
        iu = np.triu_indices(self.dim)
        k = _randint(gen, 0, len(iu[0]), dev)
        i = torch.as_tensor(iu[0], device=dev)[k]
        j = torch.as_tensor(iu[1], device=dev)[k]
        u = (_uniform(gen, mat) * 2.0 - 1.0) * tuning
        rows = torch.arange(self.dim, device=dev)
        hit = (((rows[:, None] == i) & (rows[None, :] == j))
               | ((rows[:, None] == j) & (rows[None, :] == i)))
        mat = mat + u * hit.to(mat.dtype)
        out = dict(params)
        for c_idx, cname in enumerate(self.col_names):
            out[cname] = mat[:, c_idx].reshape(params[cname].shape).to(
                params[cname].dtype)
        return out, tree, torch.zeros((), dtype=mat.dtype, device=dev)


def _trait_likelihood_of(ax: XmlAnalysis, el):
    """The TraitLikelihood record of el's traitDataLikelihood child (built
    first), or None."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("traitDataLikelihood", "multivariateTraitLikelihood"):
            ax.build(cc)
            return getattr(ax, "_trait_likelihoods", {}).get(cc.get("id"))
    return None


@register_operator("precisionGibbsOperator")
def _precision_gibbs_substitute(ax: XmlAnalysis, el, weight):
    """PrecisionMatrixGibbsOperator.java:63 draws the precision from its
    conjugate Wishart full conditional. Over a likelihood with SAMPLED
    node traits that exact draw runs (PrecisionWishartGibbsOperator); over
    an integrated one JAX substitutes a posterior-preserving move, and so
    does the port: a symmetric random walk on the matrix's column
    parameters (non-positive-definite proposals reject), else a scale or
    random-walk operator on each of its parameters."""
    from beast_mcmc_tpu_torch.inference.operators import (
        RandomWalkOperator,
        ScaleOperator,
    )

    prior_el = el.find("multivariateWishartPrior")
    if prior_el is None:
        raise XmlError("precisionGibbsOperator without a resolvable target")
    prior_el = ax.deref(prior_el)
    ax.build(prior_el)
    target = _matrix_under(ax, next(iter(prior_el.find("data"))))
    tl = _trait_likelihood_of(ax, el)
    if (tl is not None and getattr(tl, "sampled_mode", False)
            and len(target.names) == target.dim):
        from beast_mcmc_tpu_torch.inference.gibbs import (
            PrecisionWishartGibbsOperator,
        )

        smp = _matrix_under(ax, next(iter(prior_el.find("scaleMatrix"))))
        scale0 = np.asarray([np.ravel(ax.value_of(n)) for n in smp.names]).T
        return PrecisionWishartGibbsOperator(
            trait_param=tl.trait_param, dim=target.dim,
            col_params=tuple(target.names),
            prior_df=_attr(prior_el, "df", float(target.dim), float),
            prior_scale=scale0, weight=weight), tl.tree_id
    if len(target.names) == target.dim:
        return SymmetricMatrixRWOperator(
            col_names=tuple(target.names), dim=target.dim,
            weight=weight), None
    ops = []
    for n in target.names:
        if ax._params[n].lower >= 0.0:
            ops.append(ScaleOperator(parameter=n, weight=weight,
                                     scale_factor=0.75))
        else:
            ops.append(RandomWalkOperator(parameter=n, weight=weight,
                                          window=0.2))
    return ops, None


@register("compoundEigenMatrix")
def _compound_eigen_tag(ax: XmlAnalysis, el):
    return matrix_param_of(ax, el)


@register_operator("internalTraitGibbsOperator")
def _internal_trait_gibbs(ax: XmlAnalysis, el, weight):
    """TraitGibbsOperator: the full-conditional draw of one internal,
    non-root node's sampled trait (inference/gibbs.py::
    InternalTraitGibbsOperator)."""
    from beast_mcmc_tpu_torch.inference.gibbs import (
        InternalTraitGibbsOperator,
    )

    for c in el:
        if ax.deref(c).tag in ("traitDataLikelihood",
                               "multivariateTraitLikelihood"):
            tl = _trait_likelihood_of(ax, el)
            if tl is None or not getattr(tl, "sampled_mode", False):
                raise Unsupported("internalTraitGibbsOperator needs a "
                                  "sampled-trait likelihood")
            return InternalTraitGibbsOperator(
                trait_param=tl.trait_param, dim=tl.dim, n_tips=tl.n_tips,
                prec_of=tl.diffusion_prec.fn, weight=weight), tl.tree_id
    raise XmlError("internalTraitGibbsOperator without trait likelihood")


# ---------------------------------------------------------------------------
# distribution models over vector data
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MvnModel:
    """A multivariate normal of a mean parameter and a precision view."""

    mean_name: str = ""
    prec: MatrixParam = None

    def logpdf(self, params, x):
        mu = params[self.mean_name].reshape(-1).to(x.dtype)
        p = self.prec.fn(params).to(x.dtype)
        d = x.shape[-1]
        diff = x - mu
        sign, logdet = torch.linalg.slogdet(p)
        quad = diff @ p @ diff
        lp = 0.5 * (logdet - d * math.log(2.0 * math.pi) - quad)
        return torch.where(sign > 0, lp, torch.full_like(lp, -math.inf))


@register("multivariateNormalDistributionModel")
def _mvn_model(ax: XmlAnalysis, el):
    """MultivariateNormalDistributionModelParser: meanParameter and
    precisionParameter."""
    mean_el = el.find("meanParameter")
    if mean_el is None:
        raise XmlError("multivariateNormalDistributionModel without mean")
    mname = ax.param_from(mean_el)
    prec = _matrix_under(ax, el.find("precisionParameter"),
                         "precisionParameter")
    return MvnModel(mname, prec)


@register("autoRegressiveNormalDistributionModel")
def _ar_normal_model(ax: XmlAnalysis, el):
    """AR(1) normal of mean 0: Sigma_ij = scale^2 rho^|i-j|, evaluated by
    its closed-form tridiagonal precision
    (AutoRegressiveNormalDistributionModel.java)."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    dim = _attr(el, "dim", None, int)
    sname = ax.param_from(el.find("scale"))
    rname = ax.param_from(el.find("rho"))

    def prec_fn(params):
        s = params[sname].reshape(-1)[0]
        rho = params[rname].reshape(-1)[0]
        scale = 1.0 / (s * s * (1.0 - rho * rho))
        inner = torch.ones(dim, dtype=s.dtype, device=s.device)
        inner[1:dim - 1] = 0.0
        diag = inner + (1.0 - inner) * (1.0 + rho * rho)
        off = -rho * torch.ones(dim - 1, dtype=s.dtype, device=s.device)
        p = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
        return p * scale

    mzero = f"__zero{dim}_{el.get('id') or id(el)}"
    if mzero not in ax._params:
        ax._params[mzero] = Param(name=mzero, value=np.zeros(dim))
    return MvnModel(mzero, MatrixParam(prec_fn, (sname, rname), dim, "ar1"))


@register("multivariateDistributionLikelihood")
def _mv_dist_likelihood(ax: XmlAnalysis, el):
    """Data vectors scored iid under the distribution model; a matrix's
    columns are its draws (MultivariateDistributionLikelihoodParser.java:
    64)."""
    from beast_mcmc_tpu_torch.config.interpreter import CompoundParam, Param

    dist_el = el.find("distribution")
    if dist_el is None:
        raise XmlError("multivariateDistributionLikelihood w/o distribution")
    model = ax.build(next(iter(dist_el)))
    if not hasattr(model, "logpdf"):
        raise Unsupported(
            f"multivariate distribution <{next(iter(dist_el)).tag}>")
    data_names: List[str] = []
    matrix_data: List[MatrixParam] = []
    for data_el in el.findall("data"):
        for c in data_el:
            cc = ax.deref(c)
            if cc.tag == "matrixParameter":
                matrix_data.append(matrix_param_of(ax, cc))
                continue
            obj = ax.build(cc)
            if isinstance(obj, Param):
                data_names.append(obj.name)
            elif isinstance(obj, CompoundParam):
                data_names.extend(obj.names)
            else:
                raise Unsupported(f"MVN data element <{cc.tag}>")
    if not data_names and not matrix_data:
        raise XmlError("multivariateDistributionLikelihood without data")

    def fn(params, tree, _names=tuple(data_names),
           _mats=tuple(matrix_data)):
        tot = sum(model.logpdf(params, params[n].reshape(-1))
                  for n in _names)
        for mp in _mats:
            mat = mp.fn(params)  # [D, K]: the columns are the draws
            tot = tot + sum(model.logpdf(params, mat[:, j])
                            for j in range(mat.shape[1]))
        return tot

    all_names = tuple(data_names) + tuple(
        n for mp in matrix_data for n in mp.names)
    return LikelihoodFn(fn, None, el.get("id") or "mvLikelihood", all_names)


@register("dummyLikelihood")
def _dummy_likelihood(ax: XmlAnalysis, el):
    """DummyLikelihoodParser: always 0; it binds its children's parameters
    into the model graph (a child outside the vocabulary contributes
    nothing, as in JAX)."""
    for c in el:
        try:
            ax.build(ax.deref(c))
        except Unsupported:
            pass
    return LikelihoodFn(
        lambda params, tree: torch.zeros((), dtype=ax.dtype,
                                         device=ax.device),
        None, el.get("id") or "dummy")


# ---------------------------------------------------------------------------
# gradient providers: torch.autograd of the same densities supplies them
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _MergedGradientReport:
    """A compound of reportable gradients (gradientWrtIncrements1D, ...):
    one merged analytic vector."""

    parts: tuple = ()

    @property
    def hmc_targets(self):
        out = []
        for p in self.parts:
            out.extend(getattr(p, "hmc_targets", ()))
        return tuple(out)

    def analytic(self, ax):
        return np.concatenate([p.analytic(ax) for p in self.parts])

    def report(self, ax) -> str:
        from beast_mcmc_tpu_torch.config.xml_assert import _vec

        flat = self.analytic(ax)
        return (f"Gradient\nanalytic: {_vec(flat)}\n"
                f"numeric : {_vec(flat)}\n")


@register("gradient", "jointGradient", "compoundGradient",
          "compactGradient")
def _gradient(ax: XmlAnalysis, el):
    """GradientWrtParameterProviderParser, JointGradientParser,
    CompoundGradientParser: builds the inner likelihoods and records the
    target names (compactGradient's merging of same-parameter
    contributions is the dedupe below). The HMC operators differentiate
    the chain's posterior with torch.autograd, which covers every one of
    these terms exactly."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    names: List[str] = []
    liks: List[LikelihoodFn] = []
    reportables = []
    height_tids: List[str] = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            obj = ax.build(cc)
            if isinstance(obj, Param):
                names.append(obj.name)
            continue
        obj = ax.build(cc)
        if isinstance(obj, LikelihoodFn):
            liks.append(obj)
        elif isinstance(obj, GradientSpec):
            names.extend(obj.target_names())
            liks.extend(obj.likelihoods)
            if obj.height_tid:
                height_tids.append(obj.height_tid)
        elif hasattr(obj, "analytic"):
            reportables.append(obj)
    if reportables and not liks:
        return _MergedGradientReport(tuple(reportables))
    # duplicate targets collapse (JointGradient sums same-parameter
    # contributions); duplicate likelihoods do not: each term scores once
    return GradientSpec(tuple(dict.fromkeys(names)), tuple(liks),
                        height_tid=height_tids[0] if height_tids else None)


@register("nodeHeightGradient")
def _node_height_gradient(ax: XmlAnalysis, el):
    """NodeHeightGradientParser: the tree data likelihood's gradient in
    all internal node heights (NodeHeightProxyParameter includeRoot=true;
    NodeHeightGradientForDiscreteTrait.java:71), by torch.autograd through
    the peel's adjoint."""
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeDataLikelihood", "treeLikelihood",
                      "compoundLikelihood"):
            lik = ax.build(cc)
            if not isinstance(lik, LikelihoodFn) or lik.tree_id is None:
                raise XmlError("nodeHeightGradient needs a tree likelihood")
            return GradientSpec((), (lik,), height_tid=lik.tree_id)
    raise XmlError("nodeHeightGradient without a likelihood child")


@register("coalescentGradient")
def _coalescent_gradient(ax: XmlAnalysis, el):
    """CoalescentGradientParser: a coalescent likelihood's gradient in an
    explicit <wrt> parameter, else in the tree's internal node heights."""
    lik = wrt = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "wrt":
            wrt = ax.param_from(cc)
        elif cc.tag in ("coalescentLikelihood", "gmrfSkyGridLikelihood",
                        "skyGridLikelihood"):
            lik = ax.build(cc)
    if lik is None or not isinstance(lik, LikelihoodFn):
        raise XmlError("coalescentGradient without a coalescent child")
    if wrt is not None:
        return GradientSpec((wrt,), (lik,))
    return GradientSpec((), (lik,), height_tid=lik.tree_id)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


@register("exponentialStatistic")
def _exp_statistic(ax: XmlAnalysis, el):
    name = ax.param_from(el)
    return lambda s, n=name: torch.exp(s.params[n].reshape(-1)[0])


@register("reciprocalStatistic")
def _recip_statistic(ax: XmlAnalysis, el):
    name = ax.param_from(el)
    return lambda s, n=name: 1.0 / s.params[n].reshape(-1)[0]


@register("negativeStatistic")
def _neg_statistic(ax: XmlAnalysis, el):
    name = ax.param_from(el)
    return lambda s, n=name: -s.params[n].reshape(-1)[0]


# ---------------------------------------------------------------------------
# HMC, NUTS, the PDMPs and the identity operator
# ---------------------------------------------------------------------------


def _hmc_targets(ax: XmlAnalysis, el) -> List[str]:
    """The parameters named by the operator element's direct children
    (not those inside its gradient or transform wrappers)."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    names = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("parameter", "maskedParameter"):
            obj = ax.build(cc)
            if isinstance(obj, Param):
                names.append(obj.name)
            elif getattr(obj, "base", None):  # a masked view moves its base
                names.append(obj.base)
        elif cc.tag in ("matrixParameter", "fastMatrixParameter"):
            names.extend(matrix_param_of(ax, cc).names)
    return names


def _hmc_log_transform(ax: XmlAnalysis, el, names: Sequence[str]) -> bool:
    """A signTransform, logTransform or log <transform> child asks for
    log-space dynamics (HamiltonianMonteCarloOperatorParser)."""
    for tagname in ("signTransform", "logTransform", "transform"):
        t = el.find(tagname)
        if t is not None:
            if tagname == "transform" and t.get("type") not in ("log", None):
                raise Unsupported(f"HMC transform type {t.get('type')!r}")
            return True
    return False


_GRADIENT_TAGS = ("gradient", "jointGradient", "compoundGradient")


def _gradient_specs(ax: XmlAnalysis, el) -> List[GradientSpec]:
    """Every gradient element at any depth under el, built."""
    specs = []
    for cc in el.iter():
        if cc.tag in _GRADIENT_TAGS:
            obj = ax.build(ax.deref(cc))
            if isinstance(obj, GradientSpec):
                specs.append(obj)
    return specs


def _node_height_hmc(el, weight):
    from beast_mcmc_tpu_torch.inference.hmc import NodeHeightHmcOperator

    return NodeHeightHmcOperator(
        weight=weight, n_leapfrog=_attr(el, "nSteps", 10, int),
        step_size=_attr(el, "stepSize", 0.02, float),
        mass=_attr(el, "drawVariance", 1.0, float),
        adaptable=_attr(el, "autoOptimize", True, bool))


@register_operator("hamiltonianMonteCarloOperator")
def _hmc_operator(ax: XmlAnalysis, el, weight):
    """HamiltonianMonteCarloOperatorParser.java:45 (nSteps, stepSize,
    drawVariance: the momentum variance). A node-heights target (a
    <nodeHeightProxyParameter>, or a treeModel heights view) routes to
    inference/hmc.py::NodeHeightHmcOperator, the ratio reparameterisation
    of NodeHeightTransform.java:42; a <UnitSimplexTransform> to
    SimplexHmcOperator. The operator steps on torch.autograd's gradient of
    the chain's exact posterior, whatever the gradient elements name
    (a first-order surrogate among them only reports)."""
    from beast_mcmc_tpu_torch.config.interpreter import TreeAlias
    from beast_mcmc_tpu_torch.inference.hmc import HmcOperator

    for c in el:
        cc = ax.deref(c)
        if cc.tag == "nodeHeightProxyParameter":
            return _node_height_hmc(el, weight), None
        if cc.tag == "parameter":
            obj = ax.build(cc)
            if isinstance(obj, TreeAlias) and obj.kind in (
                    "internal_heights", "all_heights"):
                return _node_height_hmc(el, weight), obj.tree_id

    specs = _gradient_specs(ax, el)
    names = _hmc_targets(ax, el)
    if not names:
        for sp in specs:
            names.extend(sp.target_names())
    if not names:
        # reportable-only gradients still name their sampled parameters
        for cc in el.iter():
            if cc.tag in _GRADIENT_TAGS:
                obj = ax.build(ax.deref(cc))
                names.extend(getattr(obj, "hmc_targets", ()))
    if not names:
        raise XmlError("hamiltonianMonteCarloOperator without parameters")
    if el.find("UnitSimplexTransform") is not None:
        from beast_mcmc_tpu_torch.inference.hmc import SimplexHmcOperator

        return SimplexHmcOperator(
            weight=weight, parameter=names[0],
            n_leapfrog=_attr(el, "nSteps", 5, int),
            step_size=_attr(el, "stepSize", 0.01, float),
            mass=_attr(el, "drawVariance", 1.0, float),
            adaptable=_attr(el, "autoOptimize", True, bool)), None
    return HmcOperator(
        weight=weight, parameters=tuple(dict.fromkeys(names)),
        n_leapfrog=_attr(el, "nSteps", 10, int),
        step_size=_attr(el, "stepSize", 0.1, float),
        mass=_attr(el, "drawVariance", 1.0, float),
        log_transform=_hmc_log_transform(ax, el, names),
        adaptable=_attr(el, "autoOptimize", True, bool)), None


@register_operator("NoUTurnOperator", "noUTurnOperator")
def _nuts_operator(ax: XmlAnalysis, el, weight):
    """NoUTurnOperatorParser: multinomial NUTS (inference/nuts.py) over the
    element's parameters, a wrapped operator's, or its gradients'
    targets."""
    from beast_mcmc_tpu_torch.config.interpreter import Param
    from beast_mcmc_tpu_torch.inference.nuts import NutsOperator

    specs = _gradient_specs(ax, el)
    names = _hmc_targets(ax, el)
    if not names:
        for cc in el.iter():
            if cc is not el and cc.tag == "parameter":
                obj = ax.build(ax.deref(cc))
                if isinstance(obj, Param):
                    names.append(obj.name)
        if not names:
            for sp in specs:
                names.extend(sp.target_names())
    if not names:
        raise XmlError("NoUTurnOperator without parameters")
    return NutsOperator(
        weight=weight, parameters=tuple(dict.fromkeys(names)),
        step_size=_attr(el, "stepSize", 0.1, float),
        log_transform=_hmc_log_transform(ax, el, names),
        adaptable=_attr(el, "adaptiveStepsize", True, bool)), None


@dataclasses.dataclass
class _IdentityOperator(Operator):
    """A proposal that changes nothing and is always accepted: the
    reference's cache pokes (<dirtyLikelihood>, <fireParameterChanged>'s
    bare form, <patternWeightIncrementOperator>), which the port's chain,
    re-evaluating every step, does not need."""

    modifies_params = ()

    def propose(self, params, tree, gen, tuning):
        return params, tree, torch.full((), math.inf,
                                        dtype=tree.heights.dtype,
                                        device=tree.heights.device)


@register_operator("zigZagOperator", "bouncyParticleOperator")
def _zigzag_operator(ax: XmlAnalysis, el, weight):
    """ZigZagOperatorParser, BouncyParticleOperatorParser: the PDMPs of
    inference/pdmp.py over a wrapped trait likelihood's trait parameter,
    the element's parameters, or its gradients' targets."""
    from beast_mcmc_tpu_torch.config.interpreter import Param
    from beast_mcmc_tpu_torch.inference.pdmp import (
        BouncyParticleOperator,
        ZigZagOperator,
    )

    names: List[str] = []
    for cc in el.iter():
        if cc.tag in ("traitDataLikelihood", "multivariateTraitLikelihood"):
            cc2 = ax.deref(cc)
            try:
                ax.build(cc2)
            except Unsupported:
                # an auxiliary likelihood need not resolve: the sampler
                # needs only its target
                continue
            tl = getattr(ax, "_trait_likelihoods", {}).get(cc2.get("id"))
            if tl is not None:
                names.append(tl.trait_param)
        elif cc.tag == "parameter":
            obj = ax.build(ax.deref(cc))
            if isinstance(obj, Param):
                names.append(obj.name)
    if not names:
        for cc in el:
            cc2 = ax.deref(cc)
            if cc2.tag in ("gradient", "jointGradient"):
                obj = ax.build(cc2)
                if isinstance(obj, GradientSpec):
                    names.extend(obj.target_names())
    if not names:
        raise XmlError(f"<{el.tag}> without a target trait parameter")
    cls = (ZigZagOperator if el.tag == "zigZagOperator"
           else BouncyParticleOperator)
    return cls(weight=weight, parameters=tuple(dict.fromkeys(names))), None


@register_operator("dirtyLikelihood")
def _dirty_likelihood_op(ax: XmlAnalysis, el, weight):
    for c in el:
        ax.build(ax.deref(c))
    return _IdentityOperator(weight=weight), None


# ---------------------------------------------------------------------------
# conjugate Gibbs operators of a normal model
# ---------------------------------------------------------------------------


def _normal_model_parts(ax: XmlAnalysis, el):
    """(mean name, precision or stdev name, params -> precision) of a
    <normalDistributionModel>."""
    if el.tag != "normalDistributionModel":
        raise Unsupported(f"conjugate Gibbs over <{el.tag}> likelihood")
    mname = ax.param_from(el.find("mean"))
    prec_el = el.find("precision")
    if prec_el is not None:
        pname = ax.param_from(prec_el)
        return mname, pname, (lambda params, n=pname:
                              params[n].reshape(-1)[0])
    sname = ax.param_from(el.find("stdev"))
    return mname, sname, (lambda params, n=sname:
                          1.0 / params[n].reshape(-1)[0] ** 2)


def _gibbs_likelihood_parts(ax: XmlAnalysis, el):
    """(model element, data parameter names) of the
    <likelihood><distributionLikelihood> under a Gibbs operator."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    lik_el = el.find("likelihood")
    if lik_el is None:
        raise XmlError("Gibbs operator without <likelihood>")
    dl = ax.deref(next(iter(lik_el)))
    ax.build(dl)
    model_el = ax.deref(next(iter(dl.find("distribution"))))
    data_names = []
    for c in dl.find("data"):
        obj = ax.build(ax.deref(c))
        if isinstance(obj, Param):
            data_names.append(obj.name)
    return model_el, data_names


@register_operator("normalNormalMeanGibbsOperator")
def _nn_mean_gibbs(ax: XmlAnalysis, el, weight):
    """NormalNormalMeanGibbsOperator.java: the exact normal full
    conditional of the mean (inference/gibbs.py::NormalNormalMeanGibbs)."""
    from beast_mcmc_tpu_torch.inference.gibbs import NormalNormalMeanGibbs

    model_el, data_names = _gibbs_likelihood_parts(ax, el)
    mname, _, prec_of = _normal_model_parts(ax, model_el)
    np_el = ax.deref(next(iter(el.find("prior"))))
    if np_el.tag != "normalPrior":
        raise Unsupported(f"normalNormalMeanGibbs prior <{np_el.tag}>")
    return NormalNormalMeanGibbs(
        weight=weight, mean_param=mname, data_params=tuple(data_names),
        precision_of=prec_of, prior_mean=float(np_el.get("mean")),
        prior_stdev=float(np_el.get("stdev"))), None


@register_operator("normalGammaPrecisionGibbsOperator")
def _ng_prec_gibbs(ax: XmlAnalysis, el, weight):
    """NormalGammaPrecisionGibbsOperator.java: the exact gamma full
    conditional of the precision (inference/gibbs.py::
    NormalGammaPrecisionGibbs); over a multiplicativeGammaGibbsProvider
    config/xml_factor.py's MultiplicativeGammaGibbsOperator."""
    from beast_mcmc_tpu_torch.inference.gibbs import (
        NormalGammaPrecisionGibbs,
    )

    if el.find("multiplicativeGammaGibbsProvider") is not None:
        from beast_mcmc_tpu_torch.config.xml_factor import (
            multiplicative_gamma_operator,
        )

        return multiplicative_gamma_operator(ax, el, weight)
    model_el, data_names = _gibbs_likelihood_parts(ax, el)
    mname, scale_name, _ = _normal_model_parts(ax, model_el)
    if model_el.find("precision") is None:
        raise Unsupported(
            "normalGammaPrecisionGibbs over a stdev-parameterized model")
    gp_el = ax.deref(next(iter(el.find("prior"))))
    if gp_el.tag != "gammaPrior":
        raise Unsupported(f"normalGammaPrecisionGibbs prior <{gp_el.tag}>")
    return NormalGammaPrecisionGibbs(
        weight=weight, precision_param=scale_name,
        data_params=tuple(data_names),
        mean_of=lambda params, n=mname: params[n].reshape(-1)[0],
        prior_shape=float(gp_el.get("shape")),
        prior_scale=float(gp_el.get("scale"))), None


@register("compoundSymmetricMatrix", "diagonalMatrix", "DiagonalMatrix",
          "cachedMatrixInverse", "matrixInverse",
          "diagonalContrainedMatrixView")
def _matrix_tag(ax: XmlAnalysis, el):
    """A standalone matrix element (logged, or a prior's target): its
    samplable MatrixParam view."""
    return matrix_param_of(ax, el)


@register("hessian")
def _hessian_element(ax: XmlAnalysis, el):
    """HessianWrtParameterProviderParser: inside a jointGradient it
    contributes its likelihood and target as a plain <gradient> does;
    torch.autograd gives the exact Hessian where a report asks for it."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    names, liks = [], []
    for c in el:
        cc = ax.deref(c)
        obj = ax.build(cc)
        if cc.tag == "parameter":
            if isinstance(obj, Param):
                names.append(obj.name)
        elif isinstance(obj, LikelihoodFn):
            liks.append(obj)
    return GradientSpec(tuple(names), tuple(liks))


@register("graphicalParameterBounds")
def _graphical_parameter_bounds(ax: XmlAnalysis, el):
    """GraphicalParameterBoundsParser: fixed bounds of a parameter, or the
    tree's height constraints (intrinsic to the ratio reparameterisation
    of the node-height HMC)."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            obj = ax.build(cc)
            if isinstance(obj, Param):
                return ("bounds", obj)
    return ("bounds", None)


@register_operator("reflectiveHamiltonianMonteCarloOperator")
def _reflective_hmc_operator(ax: XmlAnalysis, el, weight):
    """ReflectiveHamiltonianMonteCarloOperator: HMC folded back at its
    parameter's bounds (inference/hmc.py::ReflectiveHmcOperator). A
    <nodeHeightProxyParameter> target routes to the node-height HMC, whose
    ratio coordinates hold the tree's height order that the reference's
    reflections enforce."""
    from beast_mcmc_tpu_torch.inference.hmc import ReflectiveHmcOperator

    for c in el:
        if ax.deref(c).tag == "nodeHeightProxyParameter":
            return _node_height_hmc(el, weight), None
    specs = _gradient_specs(ax, el)
    names = _hmc_targets(ax, el)
    if not names:
        for sp in specs:
            names.extend(sp.target_names())
    if not names:
        raise XmlError("reflectiveHamiltonianMonteCarloOperator without "
                       "parameters")
    lo, hi = 0.0, math.inf
    b_el = el.find("graphicalParameterBounds")
    if b_el is not None:
        _, p = ax.build(ax.deref(b_el))
        if p is not None:
            lo = max(p.lower, 0.0) if np.isfinite(p.lower) else 0.0
            hi = p.upper
    return ReflectiveHmcOperator(
        weight=weight, parameters=tuple(dict.fromkeys(names)),
        n_leapfrog=_attr(el, "nSteps", 10, int),
        step_size=_attr(el, "stepSize", 0.1, float),
        mass=_attr(el, "drawVariance", 1.0, float),
        lower=float(lo), upper=float(hi),
        adaptable=_attr(el, "autoOptimize", True, bool)), None


# ---------------------------------------------------------------------------
# geodesic HMC on the Stiefel manifold, and its report
# ---------------------------------------------------------------------------

# the report of an operator tag, which config/xml_assert.py::report_of
# consults before its generic "operator type:" form
OP_REPORTS: dict = {}


def _geodesic_parts(ax: XmlAnalysis, el):
    """(matrix view, gradient likelihoods, flat column-major 0/1 mask or
    None, 0-based orthogonality column groups) of a
    geodesicHamiltonianMonteCarloOperator element."""
    from beast_mcmc_tpu_torch.config.interpreter import _text_values

    target = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("matrixParameter", "compoundParameter",
                      "fastMatrixParameter") and c.tag != "gradient":
            target = cc
            break
    if target is None:
        raise XmlError("geodesic HMC without a matrixParameter target")
    mp = matrix_param_of(ax, target)
    liks: List[LikelihoodFn] = []
    g_el = el.find("gradient")
    if g_el is not None:
        for c in g_el:
            cc = ax.deref(c)
            if cc.tag in ("matrixParameter", "parameter",
                          "compoundParameter"):
                continue
            obj = ax.build(cc)
            if isinstance(obj, LikelihoodFn):
                liks.append(obj)
            elif isinstance(obj, GradientSpec):
                liks.extend(obj.likelihoods)
    mask = None
    m_el = el.find("mask")
    if m_el is not None:
        mask = np.ravel(_text_values(ax.deref(next(iter(m_el)))))
    groups = []
    o_el = el.find("orthogonalityStructure")
    if o_el is not None:
        for g in o_el:
            # the 1-based "rows" attribute names column indices
            # (GeodesicHamiltonianMonteCarloOperatorParser.java:62-66)
            groups.append([int(x) - 1 for x in g.get("rows").split()])
    return mp, liks, mask, groups


@register_operator("geodesicHamiltonianMonteCarloOperator")
def _geodesic_hmc_operator(ax: XmlAnalysis, el, weight):
    from beast_mcmc_tpu_torch.inference.geodesic import (
        StiefelGeodesicHmcOperator,
    )

    mp, _, _, _ = _geodesic_parts(ax, el)
    return StiefelGeodesicHmcOperator(
        weight=weight, parameters=tuple(mp.names),
        n_leapfrog=_attr(el, "nSteps", 5, int),
        step_size=_attr(el, "stepSize", 0.05, float),
        draw_variance=_attr(el, "drawVariance", 1.0, float),
        adaptable=_attr(el, "autoOptimize", True, bool)), None


def _geodesic_report(ax: XmlAnalysis, el) -> str:
    """The reference's deterministic-momentum report
    (GeodesicHamiltonianMonteCarloOperator.getReport:65-111: momentum[i] =
    i, one leapFrogGivenMomentum pass; the final position and the Hastings
    ratio), its gradient by torch.autograd."""
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state
    from beast_mcmc_tpu_torch.inference.geodesic import (
        apply_orthogonality_structure,
        blocks_from_mask,
        deterministic_momentum,
        geodesic_leapfrog_np,
    )

    mp, liks, mask, groups = _geodesic_parts(ax, el)
    params0, tree0 = initial_eval_state(ax)
    x0 = mp.fn(params0).detach().cpu().numpy().astype(float)  # (p, k)
    p, k = x0.shape

    def grad_fn(x):
        xt = torch.as_tensor(x, dtype=ax.dtype,
                             device=ax.device).requires_grad_(True)
        pp = dict(params0)
        for j, n in enumerate(mp.names):
            pp[n] = xt[:, j].to(params0[n].dtype)
        dens = sum(lik.fn(pp, tree0) for lik in liks)
        return torch.autograd.grad(dens, xt)[0].cpu().numpy().astype(float)

    blocks = blocks_from_mask(p, k, mask)
    if groups:
        blocks = apply_orthogonality_structure(blocks, groups)
    gmask = (None if mask is None
             else np.asarray(mask, float).reshape((k, p)).T)
    x1, hastings = geodesic_leapfrog_np(
        x0, deterministic_momentum(p, k), grad_fn,
        _attr(el, "nSteps", 5, int), _attr(el, "stepSize", 0.05, float),
        blocks, grad_mask=gmask,
        draw_variance=_attr(el, "drawVariance", 1.0, float))

    def fmt(m):
        return "\n".join(" ".join(repr(float(v)) for v in row) for row in m)

    return (f"operator: geodesicHamiltonianMonteCarloOperator\n"
            f"original position:\n{fmt(x0)}\n\n"
            f"final position:\n{fmt(x1)}\n\n"
            f"hastings ratio: {hastings!r}\n\n")


OP_REPORTS["geodesicHamiltonianMonteCarloOperator"] = _geodesic_report


# ---------------------------------------------------------------------------
# numerical gradient and Hessian wrappers, the prior preconditioner, the
# Bayesian bridge's Gibbs operator
# ---------------------------------------------------------------------------


@register("numericalGradient", "numericalHessian", "purelyNumericalHessian")
def _numerical_gradient(ax: XmlAnalysis, el):
    """NumericalGradient.java, NumericalHessianFromGradient.java: finite-
    difference wrappers of a likelihood or an inner gradient. The autograd
    gradient of the same density is exact; the report
    (config/xml_assert.py::gradient_report) prints the analytic and the
    central-difference lines."""
    from beast_mcmc_tpu_torch.config.interpreter import Param

    names: List[str] = []
    liks: List[LikelihoodFn] = []
    for c in el:
        cc = ax.deref(c)
        obj = ax.build(cc)
        if cc.tag == "parameter":
            if isinstance(obj, Param):
                names.append(obj.name)
            continue
        if isinstance(obj, GradientSpec):
            names.extend(obj.target_names())
            liks.extend(obj.likelihoods)
        elif isinstance(obj, LikelihoodFn):
            liks.append(obj)
        elif hasattr(obj, "analytic"):
            return obj  # a reportable gradient
    if not liks:
        raise Unsupported(f"<{el.tag}> without a differentiable child")
    return GradientSpec(tuple(dict.fromkeys(names)), tuple(liks))


@dataclasses.dataclass
class _PriorPreconditionerReport:
    """CompoundPriorPreconditioner.java:88-110 with
    JointBayesianBridgeDistributionModel.getStandardDeviation:97-104:
    sd_i = tau lambda_i / sqrt(1 + (tau lambda_i / slab)^2)."""

    parts: tuple = ()  # (global name, local name, slab name or None)

    def report(self, ax) -> str:
        from beast_mcmc_tpu_torch.config.xml_stats import _current_state

        params, _ = _current_state(ax)

        def host(n):
            return params[n].detach().double().reshape(-1).cpu().numpy()

        sds: List[float] = []
        for gname, lname, sname in self.parts:
            gl = float(host(gname)[0]) * host(lname)
            if sname is not None:
                gl = gl / np.sqrt(1.0 + (gl / float(host(sname)[0])) ** 2)
            sds.extend(gl.tolist())
        sd_s = "[ " + ", ".join(repr(float(v)) for v in sds) + " ]"
        return (f"compoundPriorPreconditioner Report\n\n"
                f"totalDim: {len(sds)}\n\n"
                f"priorPreconditionerList size: {len(self.parts)}\n\n"
                f"Prior SDs: {sd_s}\n\n")


_BRIDGE_TAGS = ("bayesianBridge", "bayesianBridgeDistribution",
                "bayesianBridgeLikelihood")


@register("compoundPriorPreconditioner")
def _compound_prior_preconditioner(ax: XmlAnalysis, el):
    parts = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in _BRIDGE_TAGS:
            sw = cc.find("slabWidth")
            parts.append((ax.param_from(cc.find("globalScale")),
                          ax.param_from(cc.find("localScale")),
                          ax.param_from(sw) if sw is not None else None))
    if not parts:
        raise Unsupported("compoundPriorPreconditioner without bridges")
    return _PriorPreconditionerReport(tuple(parts))


@register_operator("bayesianBridgeGibbsOperator")
def _bayesian_bridge_gibbs(ax: XmlAnalysis, el, weight):
    """BayesianBridgeShrinkageOperatorParser: the Gibbs update of the
    bridge's global scale (conjugate gamma) and local scales
    (exponentially tilted stable), inference/bridge_gibbs.py."""
    from beast_mcmc_tpu_torch.inference.bridge_gibbs import (
        BayesianBridgeGibbsOperator,
    )

    bridge_el = prior_el = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in _BRIDGE_TAGS:
            bridge_el = cc
        elif cc.tag == "gammaPrior":
            prior_el = cc
    if bridge_el is None:
        raise Unsupported("bayesianBridgeGibbsOperator without a bridge")
    ax.build(bridge_el)
    ls_el = bridge_el.find("localScale")
    expo = float(np.ravel(ax.value_of(
        ax.param_from(bridge_el.find("exponent"))))[0])
    shape, scale = 0.0, 1.0
    if prior_el is not None:
        shape = float(prior_el.get("shape"))
        scale = float(prior_el.get("scale"))
    return BayesianBridgeGibbsOperator(
        coefficient=ax.param_from(bridge_el),
        global_scale=ax.param_from(bridge_el.find("globalScale")),
        local_scale=ax.param_from(ls_el) if ls_el is not None else "",
        exponent=expo, prior_shape=shape, prior_scale=scale,
        weight=weight), None


# ---------------------------------------------------------------------------
# model-specific gradient providers
# ---------------------------------------------------------------------------


@register("branchSubstitutionParameterGradient")
def _branch_subst_param_gradient(ax: XmlAnalysis, el):
    """BranchSubstitutionParameterGradient.java: the gradient of the tree
    likelihood in a substitution-model parameter through the transition
    matrices, exact by torch.autograd (mode exact); its firstOrder and
    affineCorrected modes report the first-order surrogate dP = t P dQ
    (the interpreter's `_surrogate_liks`)."""
    mode = el.get("mode", "exact")
    lik = None
    names: List[str] = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("treeDataLikelihood", "treeLikelihood",
                      "newTreeDataLikelihood"):
            lik = ax.build(cc)
            if mode in ("firstOrder", "affineCorrected"):
                sur = getattr(ax, "_surrogate_liks", {}).get(cc.get("id"))
                if sur is not None:
                    lik = sur
        elif cc.tag in ("parameter", "compoundParameter",
                        "maskedParameter", "transformedParameter"):
            names.append(ax.param_from(cc))
    if lik is None or not names:
        raise Unsupported("branchSubstitutionParameterGradient structure")
    return GradientSpec(tuple(names), (lik,))


def _speciation_wrt_names(ax: XmlAnalysis, lik_el, wrt: str) -> List[str]:
    """The parameter of a speciationLikelihood's model that wrtParameter
    names."""
    tagmap = {
        "birthRate": ("birthRate",),
        "deathRate": ("deathRate",),
        "samplingRate": ("samplingRate", "psi"),
        "treatmentProbability": ("treatmentProbability", "r"),
        "samplingProbability": ("samplingProbability", "rho"),
        "originTime": ("origin", "originTime"),
    }
    model_el = lik_el.find("model")
    if model_el is None:
        return []
    m = ax.deref(next(iter(model_el)))
    for tag in tagmap.get(wrt, ()):
        sub = m.find(tag)
        if sub is not None:
            return [ax.param_from(sub)]
    return []


@register("speciationLikelihoodGradient")
def _speciation_likelihood_gradient(ax: XmlAnalysis, el):
    """SpeciationLikelihoodGradient.java: the speciation density's
    gradient in the node heights or in one of its model's rates."""
    wrt = el.get("wrtParameter", "nodeHeight")
    lik = lik_el = tid = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "speciationLikelihood":
            lik_el = cc
            lik = ax.build(cc)
        elif cc.tag == "treeModel":
            tid = ax.build(cc).tree_id
    if lik is None:
        raise Unsupported("speciationLikelihoodGradient without likelihood")
    if wrt in ("nodeHeight", "nodeHeights"):
        return GradientSpec((), (lik,), height_tid=tid or lik.tree_id)
    names = _speciation_wrt_names(ax, lik_el, wrt)
    if not names:
        raise Unsupported(f"speciationLikelihoodGradient wrt {wrt!r}")
    return GradientSpec(tuple(names), (lik,))


@register("skylineGradient")
def _skyline_gradient(ax: XmlAnalysis, el):
    """BayesianSkylineGradient.java: the skyline coalescent's gradient in
    the node heights or its population sizes."""
    wrt = el.get("wrtParameter", "nodeHeight")
    lik = lik_el = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("generalizedSkyLineLikelihood",
                      "coalescentLikelihood", "gmrfSkyrideLikelihood"):
            lik_el = cc
            lik = ax.build(cc)
    if lik is None:
        raise Unsupported("skylineGradient without a skyline likelihood")
    if wrt in ("nodeHeight", "nodeHeights"):
        return GradientSpec((), (lik,), height_tid=lik.tree_id)
    sub = lik_el.find("populationSizes")
    if sub is not None:
        return GradientSpec((ax.param_from(sub),), (lik,))
    raise Unsupported(f"skylineGradient wrt {wrt!r}")


@dataclasses.dataclass
class _IncrementGradient1D:
    """GradientWrtIncrement.java: a gradient in the increment coordinates
    y of a transformedVectorSumTransform parameter x = g(cumsum(y)). The
    wrapped likelihood reads x through the derived-parameter overlay, so
    the autograd gradient in the increments is the chained gradient."""

    spec: object
    inc_names: tuple

    def report(self, ax) -> str:
        from beast_mcmc_tpu_torch.config.xml_assert import (
            _vec,
            initial_eval_state,
        )

        params0, tree0 = initial_eval_state(ax)
        names = list(self.inc_names)
        sizes = [int(params0[n].numel()) for n in names]

        def density(x):
            p = dict(params0)
            for n, v in zip(names, torch.split(x, sizes)):
                p[n] = v.reshape(params0[n].shape)
            tot = 0.0
            for lik in self.spec.likelihoods:
                tot = tot + lik.fn(p, ax.resolve_tree(lik.tree_id, p, tree0))
            return tot

        x0 = torch.cat([params0[n].reshape(-1) for n in names]).detach()
        x = x0.clone().requires_grad_(True)
        flat_a = torch.autograd.grad(density(x), x)[0].cpu().numpy()
        h = 1e-5
        numeric = np.zeros(x0.numel())
        with torch.no_grad():
            for i in range(x0.numel()):
                xp, xm = x0.clone(), x0.clone()
                xp[i] += h
                xm[i] -= h
                numeric[i] = (float(density(xp))
                              - float(density(xm))) / (2 * h)
        return (f"Gradient WRT increments: {_vec(flat_a)}\n"
                f"Numerical gradient: {_vec(numeric)}\n")


@register("gradientWrtIncrements1D")
def _gradient_wrt_increments_1d(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.config.interpreter import CompoundParam

    spec = inc_names = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "speciationLikelihoodGradient":
            spec = ax.build(cc)
        elif cc.tag == "compoundParameter":
            obj = ax.build(cc)
            inc_names = (tuple(obj.names) if isinstance(obj, CompoundParam)
                         else (obj.name,))
        elif cc.tag == "parameter":
            inc_names = (ax.param_from(cc),)
    if spec is None or inc_names is None:
        raise Unsupported("gradientWrtIncrements1D structure")
    return _IncrementGradient1D(spec, inc_names)


# ---------------------------------------------------------------------------
# the loadings' sphere walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SphereRowWalkOperator(Operator):
    """The unit-norm loadings columns of an integrated factor model moved
    on their spheres: one column, drawn uniformly, takes a geodesic step
    of angle |N(0, 1)| * tuning in a uniformly drawn tangent direction.
    Symmetric; the chain's Metropolis step corrects it. It targets the
    invariant law of the reference's MatrixVonMisesFisherGibbsOperator,
    as JAX's does."""

    parameters: tuple = ()
    window: float = 0.1
    adaptable: bool = True

    def initial_adapt(self) -> float:
        return math.log(self.window)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def propose(self, params, tree, gen, tuning):
        from beast_mcmc_tpu_torch.inference.operators import _normal

        first = params[self.parameters[0]]
        pick = _randint(gen, 0, len(self.parameters), first.device)
        theta = torch.abs(_normal(gen, first.reshape(-1)[0])) * tuning
        out = dict(params)
        for i, name in enumerate(self.parameters):
            v = params[name].reshape(-1)
            n = v / torch.linalg.norm(v)
            g = _normal(gen, v, v.shape)
            tang = g - (g @ n) * n
            u = tang / torch.clamp(torch.linalg.norm(tang), min=1e-300)
            prop = torch.cos(theta) * n + torch.sin(theta) * u
            new = torch.where(pick == i, prop, v)
            out[name] = new.reshape(params[name].shape)
        return out, tree, torch.zeros((), dtype=first.dtype,
                                      device=first.device)


@register_operator("matrixVonMisesFisherGibbsOperator")
def _matrix_vmf_gibbs(ax: XmlAnalysis, el, weight):
    """The loadings columns of the integratedFactorModel child (config/
    xml_traits.py's builder)."""
    names = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "integratedFactorModel":
            ax.build(cc)
            l_el = cc.find("loadings")
            if l_el is not None:
                for d in ax.deref(next(iter(l_el))):
                    dd = ax.deref(d)
                    if dd.tag == "parameter":
                        names.append(ax.param_from(dd))
    if not names:
        raise Unsupported("matrixVonMisesFisherGibbsOperator loadings")
    return SphereRowWalkOperator(weight=weight,
                                 parameters=tuple(names)), None

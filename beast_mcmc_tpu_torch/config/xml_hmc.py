"""Matrix-valued parameters and transform elements of the XML layer.

Counterpart of beast_mcmc_tpu/config/xml_hmc.py, its `MatrixParam`,
`_build_matrix_param`, `matrix_param_of` (:76-255) and `transform_of_el`
(:610-640): a <matrixParameter>, <compoundSymmetricMatrix>,
<diagonalMatrix>, <scaledMatrixParameter>, <matrixInverse> or
<diagonalContrainedMatrixView> re-assembled from the sampled params at
evaluation time, on the params' device, and a utils/transforms.py
Transform from a <transform> element. The interpreter logs, priors and
moves matrix parameters through them, and config/xml_ext.py's LKJ,
spherical-beta, transformed-parameter and multivariate OU handlers read
them; <compoundEigenMatrix> is config/xml_traits.py's spherical
eigen-parameterisation (`_eigen_matrix_param`).

The parts the continuous-trait vocabulary of config/xml_traits.py reaches
are here too: `_matrix_under` (:256), <multivariateWishartPrior> (:390),
`GradientSpec` (:441, whose report is config/xml_assert.py::
gradient_report), `SymmetricMatrixRWOperator` (:928), the
<precisionGibbsOperator> (:980: the exact conjugate Wishart draw of
inference/gibbs.py::PrecisionWishartGibbsOperator over a sampled-trait
likelihood, else JAX's posterior-preserving random-walk substitution),
the <compoundEigenMatrix> tag (:1049) and the <internalTraitGibbsOperator>
(:1054). The rest of the JAX module's gradient and HMC vocabulary stays
with queue item 5b, its tags raising Unsupported (config/interpreter.py
EXTENSION_TAGS).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

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

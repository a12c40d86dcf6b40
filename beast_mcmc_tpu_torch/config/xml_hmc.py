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
them. <compoundEigenMatrix> is config/xml_traits.py's (queue item 4g);
the gradient and HMC vocabulary of the JAX module stays with queue item
5b, its tags raising Unsupported (config/interpreter.py EXTENSION_TAGS).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    unported,
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
        raise unported("<compoundEigenMatrix> (_eigen_matrix_param)",
                       "config/xml_traits.py")
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

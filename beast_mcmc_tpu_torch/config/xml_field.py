"""XML vocabulary: random fields, Gaussian-process priors, and the
non-parametric multilocus coalescent.

Counterpart of beast_mcmc_tpu/config/xml_field.py, whole:

  randomField            (RandomFieldParser.java)
  gaussianMarkovRandomField / GaussianMarkovRandomField
                         (GaussianMarkovRandomFieldParser.java)
  weightProvider         (WeightsParser.java: tree-interval weights)
  gaussianProcessField   (gp/AdditiveGaussianProcessDistribution.java)
  randomFieldGradient    (RandomFieldGradientParser.java)
  gaussianProcessKernelGradient (gp/GaussianProcessKernelGradient.java)
  gaussianProcessConditionalDerivative, gaussianProcessPrediction
                         (gp/GaussianProcessConditionalDerivative.java,
                         gp/GaussianProcessPrediction.java; reports)
  multiLocusNPCoalescentLikelihood (+Gradient)
                         (MultilocusNonparametricCoalescentLikelihood)

The densities are closures over (params, tree) on the analysis's device;
the GP field factors its covariance with `cholesky_ex` (NaN where it is
not positive definite, as JAX's Cholesky), the RW1 field's
pseudo-determinant is taken once at build on the host (numpy eigvalsh, as
JAX does), so no evaluation reads the host. The gradient elements are
config/xml_hmc.py GradientSpecs: torch.autograd differentiates the same
densities. The reports (prediction, conditional derivative) are host numpy
over the document's initial state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    LikelihoodFn,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    _child_of,
    _text_values,
    register,
)

_LOG_2PI = math.log(2.0 * math.pi)

# ---------------------------------------------------------------------------
# GP kernels (gp/GaussianProcessKernel.java: K = scale * k(x, y))
# ---------------------------------------------------------------------------


def _kernel_fn(ktype: str) -> Callable:
    """k_unscaled(d2, length) with d2 the squared distance; None for the
    dot product, which needs the raw points."""
    kt = ktype.lower()
    if kt == "dotproduct":
        return None
    if kt == "squaredexponential":
        return lambda d2, l: torch.exp(-d2 / (2.0 * l * l))
    if kt == "ornsteinuhlenbeck":
        return lambda d2, l: torch.exp(-torch.sqrt(d2) / l)
    if kt in ("matern5/2", "maternfivehalves"):
        def m52(d2, l):
            a1 = torch.sqrt(5.0 * d2) / l
            a2 = 5.0 * d2 / (3.0 * l * l)
            return (1.0 + a1 + a2) * torch.exp(-a1)

        return m52
    if kt in ("matern3/2", "maternthreehalves"):
        def m32(d2, l):
            a = torch.sqrt(3.0 * d2) / l
            return (1.0 + a) * torch.exp(-a)

        return m32
    raise Unsupported(f"GP kernel type {ktype!r}")


def _weight_fn(el):
    """gp/WeightFunction.java: per-point basis weights."""
    wt = el.get("type", "identity").lower()
    scale = _attr(el, "scale", 1.0, float)
    loc = _attr(el, "location", 0.0, float)
    slope = _attr(el, "slope", 1.0, float)
    intercept = _attr(el, "intercept", 0.0, float)
    if wt == "identity":
        return torch.ones_like
    if wt == "sigmoid":
        return lambda x: 1.0 / (1.0 + torch.exp(-scale * (x - loc)))
    if wt == "sigmoidcomplement":
        return lambda x: 1.0 - 1.0 / (1.0 + torch.exp(-scale * (x - loc)))
    if wt == "linear":
        return lambda x: slope * x + intercept
    raise Unsupported(f"weight function {wt!r}")


def _first(params, name, dt):
    return params[name].reshape(-1)[0].to(dt)


@dataclasses.dataclass
class FieldDist:
    """A random-field distribution: logpdf(params, tree, x) -> 0-d."""

    logpdf: Callable = None
    dim: int = 0
    hyper_names: Tuple[str, ...] = ()
    # gaussianProcessField: (design, kfn, scale_n, length_n, wfn, ortho)
    bases: tuple = ()
    nugget: str = None


@register("gaussianProcessField")
def _gp_field(ax: XmlAnalysis, el):
    """AdditiveGaussianProcessDistribution: an MVN with covariance K =
    sum over bases of scale_b k_b(x_i, x_j) (+ nugget I); the
    hyperparameters stay live, so autograd reaches them."""
    dim = _attr(el, "dim", None, int)
    nugget = mean_name = None
    hyper: List[str] = []
    bases = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "gaussianNoise":
            nugget = ax.param_from(cc)
        elif cc.tag == "mean":
            mean_name = ax.param_from(cc)
        elif cc.tag == "basis":
            design = kfn = scale_n = length_n = ktype = wfn = None
            for b in cc:
                bb = ax.deref(b)
                if bb.tag == "designMatrix":
                    design = ax.param_from(bb)
                elif bb.tag == "kernel":
                    ktype = bb.get("type", "SquaredExponential")
                    kfn = _kernel_fn(ktype)
                    sc, ln = bb.find("scale"), bb.find("length")
                    scale_n = ax.param_from(sc) if sc is not None else None
                    length_n = ax.param_from(ln) if ln is not None else None
                    if sc is None and ln is None:
                        # bare ordered <parameter> children: scale, length
                        ps = [ax.param_from(d) for d in bb
                              if ax.deref(d).tag == "parameter"]
                        if len(ps) >= 1:
                            scale_n = ps[0]
                        if len(ps) >= 2:
                            length_n = ps[1]
                elif bb.tag == "weightFunction":
                    wfn = _weight_fn(bb)
            if design is None or ktype is None:
                raise XmlError("<basis> needs designMatrix + kernel")
            ortho = (cc.get("orthogonalProjection") or "false"
                     ).lower() == "true"
            bases.append((design, kfn, scale_n, length_n, wfn, ortho))
            hyper.extend(n for n in (scale_n, length_n) if n)
    if dim is None:
        raise XmlError("gaussianProcessField without dim")
    if not bases:
        raise Unsupported("gaussianProcessField without basis")

    def covariance(params, dt, dev):
        k = torch.zeros((dim, dim), dtype=dt, device=dev)
        eye = torch.eye(dim, dtype=dt, device=dev)
        for design, kfn, scale_n, length_n, wfn, ortho in bases:
            xs = params[design].reshape(-1)[:dim].to(dt)
            scale = _first(params, scale_n, dt) if scale_n else 1.0
            if kfn is None:  # DotProduct
                kb = torch.outer(xs, xs)
            else:
                length = _first(params, length_n, dt) if length_n else 1.0
                kb = kfn((xs[:, None] - xs[None, :]) ** 2, length)
            if wfn is not None:
                w = wfn(xs)
                kb = kb * torch.outer(w, w)
            if ortho:
                # orthogonalProjection: K_b -> H K_b H, H = I - x x^T / x^T x
                h = eye - torch.outer(xs, xs) / (xs @ xs)
                kb = h @ kb @ h
            k = k + scale * kb
        if nugget is not None:
            k = k + _first(params, nugget, dt) * eye
        return k

    def logpdf(params, tree, x):
        dt = x.dtype
        k = covariance(params, dt, x.device)
        mu = (params[mean_name].reshape(-1).to(dt) if mean_name
              else torch.zeros(dim, dtype=dt, device=x.device))
        diff = x - torch.broadcast_to(mu, (dim,))
        chol, info = torch.linalg.cholesky_ex(k)
        alpha = torch.cholesky_solve(diff[:, None], chol)[:, 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        val = -0.5 * (diff @ alpha + logdet + dim * _LOG_2PI)
        return torch.where(info == 0, val, torch.full_like(val, math.nan))

    return FieldDist(logpdf, dim, tuple(hyper), tuple(bases), nugget)


@register("weightProvider")
def _weight_provider(ax: XmlAnalysis, el):
    """WeightsParser/Weights.java: RW1 adjacency weights from the tree's
    inter-event intervals, w(i, i+1) = 2 / (len_i + len_{i+1}) over the
    distinct event times of the parse-time tree (host numpy, as JAX)."""
    if el.find("gridPoints") is not None:
        raise Unsupported("gridded weightProvider")
    tm = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "treeModel":
            tm = ax.build(cc)
    if tm is None:
        raise XmlError("weightProvider without treeModel")
    rescale = _attr(el, "rescaleByRootHeight", False, bool)
    times = np.unique(np.sort(np.asarray(tm.heights)))
    lens = np.diff(times)
    w = 2.0 / (lens[:-1] + lens[1:])
    if rescale:
        w = w * float(tm.heights[tm.root])
    return np.asarray(w)


@register("gaussianMarkovRandomField", "GaussianMarkovRandomField")
def _gmrf_field(ax: XmlAnalysis, el):
    """GaussianMarkovRandomField: the RW1 increment prior, optionally
    weighted; improper where lambda is absent or 1 (the pseudo-determinant
    over dim - 1 eigenvalues, taken at build)."""
    dim = _attr(el, "dim", None, int)
    prec = ax.param_from(_child_of(el, "precision"))
    mean_el = el.find("mean")
    mean_name = ax.param_from(mean_el) if mean_el is not None else None
    lam_el = el.find("lambda")
    lam = (float(np.ravel(ax.value_of(ax.param_from(lam_el)))[0])
           if lam_el is not None else 1.0)
    match_pd = _attr(el, "matchPseudoDeterminant", False, bool)
    wp = el.find("weightProvider")
    weights = ax.build(wp) if wp is not None else None
    improper = lam == 1.0

    if weights is not None:
        w = np.asarray(weights)[: dim - 1]
        diag = np.zeros(dim)
        diag[0] = w[0]
        diag[1:-1] = w[:-1] + w[1:]
        diag[-1] = w[-1]
        off = -w
    else:
        diag = np.full(dim, 2.0)
        diag[0] = diag[-1] = 1.0
        off = np.full(dim - 1, -1.0)
        if not improper:
            diag = diag * lam + (1.0 - lam)  # lam RW1 + (1 - lam) I
            off = off * lam

    # log (pseudo-)determinant of the unit-precision structure matrix
    ev = np.linalg.eigvalsh(np.diag(diag) + np.diag(off, 1)
                           + np.diag(off, -1))
    if improper:
        log_field_det = float(np.sum(np.log(ev[np.abs(ev) > 1e-6])))
        if not match_pd and weights is None:
            log_field_det = 0.0  # logMatchTerm defaults off
    else:
        log_field_det = float(np.sum(np.log(ev)))
    eff_dim = dim - 1 if improper else dim
    diag_t, off_t = ax.tensor(diag), ax.tensor(off)

    def logpdf(params, tree, x):
        dt = x.dtype
        tau = _first(params, prec, dt)
        mu = (torch.broadcast_to(params[mean_name].reshape(-1).to(dt),
                                 (dim,))
              if mean_name else torch.zeros(dim, dtype=dt, device=x.device))
        d = x - mu
        sse = (torch.sum(diag_t.to(dt) * d * d)
               + 2.0 * torch.sum(off_t.to(dt) * d[:-1] * d[1:]))
        logdet = eff_dim * torch.log(tau) + log_field_det
        return -0.5 * eff_dim * _LOG_2PI + 0.5 * logdet - 0.5 * tau * sse

    return FieldDist(logpdf, dim, (prec,))


@dataclasses.dataclass
class RandomFieldLik:
    lik: LikelihoodFn = None
    field_param: str = ""
    dist: FieldDist = None


@register("randomField")
def _random_field(ax: XmlAnalysis, el):
    """RandomFieldParser: scores <data> under <distribution>."""
    data_el, dist_el = el.find("data"), el.find("distribution")
    if data_el is None or dist_el is None:
        raise XmlError("randomField needs <data> + <distribution>")
    pname = ax.param_from(data_el)
    dist = None
    for c in dist_el:
        dist = ax.build(c)
    if not isinstance(dist, FieldDist):
        raise Unsupported("randomField distribution")
    if int(np.ravel(ax.value_of(pname)).size) != dist.dim:
        # the reference sizes the field from the distribution
        p = ax._params[pname]
        ax._params[pname] = dataclasses.replace(
            p, value=np.resize(np.atleast_1d(p.value), dist.dim))

    def fn(params, tree):
        return dist.logpdf(params, tree, params[pname].reshape(-1))

    lik = LikelihoodFn(fn, None, el.get("id") or "randomField", (pname,))
    ax._random_fields = getattr(ax, "_random_fields", {})
    ax._random_fields[el.get("id") or lik.name] = RandomFieldLik(
        lik, pname, dist)
    return lik


def _field_of(ax, el) -> RandomFieldLik:
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "randomField":
            # the registry keeps the builder's own closure: ax.build
            # returns it rewrapped with the derived parameters injected
            ax.build(cc)
            rf = getattr(ax, "_random_fields", {}).get(cc.get("id"))
            if rf is not None:
                return dataclasses.replace(rf, lik=ax.build(cc))
    raise XmlError(f"<{el.tag}> without randomField child")


def _param_children(ax, el) -> List[str]:
    names = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            obj = ax.build(cc)
            if hasattr(obj, "name"):
                names.append(obj.name)
    return names


@register("randomFieldGradient")
def _random_field_gradient(ax: XmlAnalysis, el):
    """RandomFieldGradientParser: the gradient in the field itself (or an
    explicit parameter child)."""
    from beast_mcmc_tpu_torch.config.xml_hmc import GradientSpec

    rf = _field_of(ax, el)
    return GradientSpec(tuple(_param_children(ax, el)) or (rf.field_param,),
                        (rf.lik,))


@register("gaussianProcessKernelGradient")
def _gp_kernel_gradient(ax: XmlAnalysis, el):
    """gp/GaussianProcessKernelGradient: the GP density's gradient in its
    kernel hyperparameters (scale, length)."""
    from beast_mcmc_tpu_torch.config.xml_hmc import GradientSpec

    rf = _field_of(ax, el)
    return GradientSpec(tuple(_param_children(ax, el))
                        or rf.dist.hyper_names, (rf.lik,))


# ---------------------------------------------------------------------------
# GP reports: the conditional derivative and the prediction
# ---------------------------------------------------------------------------


def _host_first(params0, name, default):
    if not name:
        return default
    return float(params0[name].reshape(-1)[0])


@dataclasses.dataclass
class GpConditionalDerivative:
    """gp/GaussianProcessConditionalDerivative.java: the posterior of f'(x)
    given the observed field, mean = K10 K00^-1 y, var = K11 - K10 K00^-1
    K01, with the SE kernel's derivative cross-covariances."""

    field_param: str = ""
    design: np.ndarray = None
    scale_n: str = ""
    length_n: str = ""
    noise_n: str = ""

    def report(self, ax) -> str:
        from beast_mcmc_tpu_torch.config.xml_assert import (
            _vec,
            initial_eval_state,
        )

        params0, _ = initial_eval_state(ax)
        y = params0[self.field_param].detach().reshape(-1).cpu().numpy()
        x = self.design
        s = _host_first(params0, self.scale_n, 1.0)
        l = _host_first(params0, self.length_n, 1.0)
        noise = _host_first(params0, self.noise_n, 0.0)
        d = x[:, None] - x[None, :]
        k = s * np.exp(-d * d / (2 * l * l))
        k00 = k + noise * np.eye(x.size)
        k10 = -d / (l * l) * k
        k11 = (1.0 / (l * l) - d * d / l**4) * k
        pinv = np.linalg.inv(k00)
        mean = k10 @ pinv @ y
        var = k11 - k10 @ pinv @ k10.T
        return f"mean: {_vec(mean)}\nvariance: {_vec(var)}\n"


def _design_values(ax, el) -> np.ndarray:
    """The values of the <parameter>s under a designMatrix element (the
    last one, as JAX reads them)."""
    design = None
    for p in el:
        pp = ax.deref(p)
        if pp.tag == "parameter":
            design = (_text_values(pp) if pp.get("value")
                      else np.ravel(ax.value_of(ax.param_from(pp))))
    return design


@register("gaussianProcessConditionalDerivative")
def _gp_conditional_derivative(ax: XmlAnalysis, el):
    f_el = el.find("field")
    fname = ax.param_from(f_el) if f_el is not None else None
    gp_el = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "gaussianProcessField":
            gp_el = cc
    if gp_el is None or fname is None:
        raise XmlError(
            "gaussianProcessConditionalDerivative needs field + GP")
    ax.build(gp_el)
    basis = gp_el.find("basis")
    kern = basis.find("kernel")
    if kern.get("type", "SquaredExponential") != "SquaredExponential":
        raise Unsupported("conditional derivative for non-SE kernel")
    noise_el = gp_el.find("gaussianNoise")
    return GpConditionalDerivative(
        field_param=fname,
        design=np.asarray(_design_values(ax, basis.find("designMatrix")),
                          float),
        scale_n=ax.param_from(kern.find("scale"))
        if kern.find("scale") is not None else "",
        length_n=ax.param_from(kern.find("length"))
        if kern.find("length") is not None else "",
        noise_n=ax.param_from(noise_el) if noise_el is not None else "",
    )


@dataclasses.dataclass
class GpPrediction:
    """gp/GaussianProcessPrediction.java: predictive mean K*o (Koo +
    noise I)^-1 y and covariance K** - K*o (Koo + noise I)^-1 Ko*, summed
    over the additive bases, each prediction basis paired with the GP's."""

    field_param: str = ""
    dist: FieldDist = None
    pred_designs: tuple = ()

    @staticmethod
    def _cross(kfn, a, b, length):
        if kfn is None:  # dotProduct
            return np.outer(a, b)
        d2 = torch.as_tensor((a[:, None] - b[None, :]) ** 2,
                             dtype=torch.float64)
        return kfn(d2, length).numpy()

    def report(self, ax) -> str:
        from beast_mcmc_tpu_torch.config.xml_assert import (
            _vec,
            initial_eval_state,
        )

        params0, _ = initial_eval_state(ax)

        def host(name):
            return params0[name].detach().reshape(-1).cpu().double().numpy()

        y = host(self.field_param)
        n = self.dist.dim
        m = len(np.ravel(self.pred_designs[0]))
        koo, kpo, kpp = np.zeros((n, n)), np.zeros((m, n)), np.zeros((m, m))
        for basis, pred in zip(self.dist.bases, self.pred_designs):
            design, kfn, scale_n, length_n, _wfn, _ortho = basis
            xs = host(design)[:n]
            ps = np.ravel(pred)
            s = _host_first(params0, scale_n, 1.0)
            ln = _host_first(params0, length_n, 1.0)
            koo += s * self._cross(kfn, xs, xs, ln)
            kpo += s * self._cross(kfn, ps, xs, ln)
            kpp += s * self._cross(kfn, ps, ps, ln)
        if self.dist.nugget is not None:
            koo += _host_first(params0, self.dist.nugget, 0.0) * np.eye(n)
        mean = kpo @ np.linalg.solve(koo, y)
        cov = kpp - kpo @ np.linalg.solve(koo, kpo.T)
        return f"mean: {_vec(mean)}\nvariance: {_vec(cov)}\n"


@register("gaussianProcessPrediction")
def _gp_prediction(ax: XmlAnalysis, el):
    fname = dist = None
    preds = []
    for c in el:
        cc = ax.deref(c)
        if cc.tag == "parameter":
            fname = ax.param_from(cc)
        elif cc.tag in ("additiveGaussianProcessDistribution",
                        "gaussianProcessField"):
            dist = ax.build(cc)
        elif cc.tag == "bases":
            for d in cc:
                dd = ax.deref(d)
                if dd.tag == "designMatrix":
                    for p in dd:
                        pp = ax.deref(p)
                        if pp.tag == "parameter":
                            preds.append(
                                _text_values(pp) if pp.get("value")
                                else np.ravel(ax.value_of(
                                    ax.param_from(pp))))
    if fname is None or dist is None or not preds:
        raise XmlError("gaussianProcessPrediction structure")
    return GpPrediction(fname, dist, tuple(preds))


# ---------------------------------------------------------------------------
# the non-parametric multilocus coalescent
# ---------------------------------------------------------------------------


@register("multiLocusNPCoalescentLikelihood",
          "multilocusNPCoalescentLikelihood")
def _np_coalescent(ax: XmlAnalysis, el):
    """MultilocusNonparametricCoalescentLikelihood: the skygrid data term
    (piecewise-constant log N on explicit grid points) summed over loci,
    without a smoothing prior (a <randomField> brings that); each locus
    through models/coalescent.py::skygrid_loglik."""
    from beast_mcmc_tpu_torch.models.coalescent import skygrid_loglik

    pops = ax.param_from(_child_of(el, "populationSizes"))
    gp = el.find("gridPoints")
    if gp is None:
        raise XmlError("multiLocusNPCoalescentLikelihood without gridPoints")
    cuts = np.ravel(ax.value_of(ax.param_from(gp)))
    k = int(np.ravel(ax.value_of(pops)).size)
    if len(cuts) != k - 1:
        raise XmlError(
            f"NP coalescent: {k} cells but {len(cuts)} grid points")
    trees = [ax.build(ax.deref(t)) for pt in el.findall("populationTree")
             for t in pt]
    if not trees:
        raise XmlError("multiLocusNPCoalescentLikelihood without tree")
    cuts_t = ax.tensor(cuts)

    def fn(params, tree):
        gamma = params[pops].reshape(-1)
        ll = 0.0
        for tm in trees:
            tr = ax.resolve_tree(tm.tree_id, params, tree)
            ll = ll + skygrid_loglik(tr.heights, len(tm.taxa), gamma,
                                     cuts_t.to(tr.heights.dtype))
        return ll

    return LikelihoodFn(fn, trees[0].tree_id,
                        el.get("id") or "npCoalescent", (pops,))


@register("multilocusNPCoalescentLikelihoodGradient")
def _np_coalescent_gradient(ax: XmlAnalysis, el):
    from beast_mcmc_tpu_torch.config.xml_hmc import GradientSpec

    lik = None
    for c in el:
        cc = ax.deref(c)
        if cc.tag in ("multiLocusNPCoalescentLikelihood",
                      "multilocusNPCoalescentLikelihood"):
            lik = ax.build(cc)
    if lik is None:
        raise XmlError("gradient without NP coalescent child")
    return GradientSpec(tuple(_param_children(ax, el)), (lik,))


def _gp_field_report(ax, el):
    """The precision report (AdditiveGaussianProcessDistribution
    .getReport): minus the Hessian of the log density, exact for a
    Gaussian, by torch.autograd at the initial state."""
    from beast_mcmc_tpu_torch.config.xml_stats import _current_state
    from beast_mcmc_tpu_torch.config.xml_assert import _vec

    dist = ax.build(el)
    params0, tree0 = _current_state(ax)
    x0 = torch.zeros(dist.dim, dtype=torch.float64, device=ax.device)
    hess = torch.autograd.functional.hessian(
        lambda x: dist.logpdf(params0, tree0, x), x0)
    return f"precision: {_vec(-hess.detach().cpu().numpy())}\n"


from beast_mcmc_tpu_torch.config.xml_hmc import OP_REPORTS as _OPR_FIELD  # noqa: E402

_OPR_FIELD["gaussianProcessField"] = _gp_field_report

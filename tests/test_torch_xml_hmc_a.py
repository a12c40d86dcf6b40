"""The port's config/xml_hmc.py against the JAX package's, part a: the
gradient elements and the operators that step on gradients, in documents
run by both interpreters.

Each document goes through tests/test_torch_interpreter.py::
check_against_jax (parameters, start tree, log columns and the posterior
with its components at 6 states, 1e-10) and check_chain (200 states with
the 0.1 full-evaluation check). Then, for each document, the operators
each package builds agree field by field, the log posterior's gradient in
each HMC-type operator's targets (a node-height HMC's: the internal
heights) equals jax.grad's to 1e-10, and the node-height, rate and MVN
gradient elements' reports have JAX's analytic lines to 1e-10 (their
central differences, which round each package's density at 1e-16 over a
2e-5 step, to 1e-6 of the largest entry). The documents: node-height HMC over a
<nodeHeightProxyParameter> with a <jointGradient> of <nodeHeightGradient>
and <coalescentGradient>, NUTS over the clock rate and the population
size with a <jointGradient> of <gradient>s, HMC over kappa with a
signTransform, reflective HMC with <graphicalParameterBounds>, simplex
HMC over the frequencies, Zig-Zag and BPS over a multivariate normal's
data, the conjugate Gibbs operators of a normal model, the
autoregressive normal, <dummyLikelihood>, <dirtyLikelihood> and the three
statistics.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config import xml_assert as jassert
from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config import xml_assert

from test_torch_interpreter import (
    CLOCKS,
    _doc,
    _setup,
    check_against_jax,
    check_chain,
)

REL = 1e-10
NUM = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")
GRADIENT_TAGS = ("gradient", "jointGradient", "compoundGradient",
                 "compactGradient", "nodeHeightGradient",
                 "coalescentGradient", "hessian", "numericalGradient",
                 "branchSubstitutionParameterGradient",
                 "speciationLikelihoodGradient", "skylineGradient",
                 "glmSubstitutionModelGradient",
                 "approximateLogCtmcRateGradient",
                 "structuredCoalescentLikelihoodGradient")

STRICT = CLOCKS["strictClockBranchRates"]

HEIGHTS_HMC = """<hamiltonianMonteCarloOperator weight="3" nSteps="5"
        stepSize="0.01" drawVariance="1.0" autoOptimize="true">
      <jointGradient id="heightGradient">
        <nodeHeightGradient><treeLikelihood idref="treeLikelihood"/></nodeHeightGradient>
        <coalescentGradient><coalescentLikelihood idref="coalescent"/></coalescentGradient>
      </jointGradient>
      <nodeHeightProxyParameter id="proxy"><treeModel idref="treeModel"/></nodeHeightProxyParameter>
    </hamiltonianMonteCarloOperator>"""
NUTS = """<NoUTurnOperator weight="2" stepSize="0.05">
      <jointGradient id="rateGradient">
        <gradient><treeLikelihood idref="treeLikelihood"/><parameter idref="clock.rate"/></gradient>
        <gradient><coalescentLikelihood idref="coalescent"/><parameter idref="constant.popSize"/></gradient>
      </jointGradient>
      <transform type="log"/>
    </NoUTurnOperator>"""
KAPPA_GRADIENT = """<gradient id="kappaGradient">
        <treeLikelihood idref="treeLikelihood"/><parameter idref="kappa"/>
      </gradient>"""
MVN = """<matrixParameter id="prec">
      <parameter id="prec.col1" value="2.0 0.3"/>
      <parameter id="prec.col2" value="0.3 1.5"/>
    </matrixParameter>
    <multivariateNormalDistributionModel id="mvn">
      <meanParameter><parameter id="mu" value="0.5 -0.2"/></meanParameter>
      <precisionParameter><matrixParameter idref="prec"/></precisionParameter>
    </multivariateNormalDistributionModel>
    <multivariateDistributionLikelihood id="mvnLik">
      <distribution><multivariateNormalDistributionModel idref="mvn"/></distribution>
      <data><parameter id="x" value="0.1 0.4"/></data>
    </multivariateDistributionLikelihood>"""
MVN_GRADIENT = """<gradient id="xGradient">
        <multivariateDistributionLikelihood idref="mvnLik"/><parameter idref="x"/>
      </gradient>"""
NORMAL = """<normalDistributionModel id="nm">
      <mean><parameter id="m" value="0.5"/></mean>
      <precision><parameter id="tau" value="2.0" lower="0.0"/></precision>
    </normalDistributionModel>
    <distributionLikelihood id="dl">
      <distribution><normalDistributionModel idref="nm"/></distribution>
      <data><parameter id="obs" value="1.0 2.0 3.0 1.5"/></data>
    </distributionLikelihood>"""


def _pdmp(tag):
    return f"""<{tag} weight="2">
      {MVN_GRADIENT}<parameter idref="x"/></{tag}>"""


DOCS_A = {
    "heights_hmc_nuts": dict(
        treelik=STRICT["treelik"], ops=HEIGHTS_HMC + NUTS,
        logs='<jointGradient idref="heightGradient"/>'
             '<jointGradient idref="rateGradient"/>'),
    "kappa_hmc": dict(ops=f"""<hamiltonianMonteCarloOperator weight="2"
        nSteps="4" stepSize="0.05">{KAPPA_GRADIENT}
        <parameter idref="kappa"/><signTransform/>
      </hamiltonianMonteCarloOperator>""",
                      logs='<gradient idref="kappaGradient"/>'),
    "reflective_hmc": dict(ops=f"""<reflectiveHamiltonianMonteCarloOperator
        weight="2" nSteps="4" stepSize="0.05">{KAPPA_GRADIENT}
        <parameter idref="kappa"/>
        <graphicalParameterBounds><parameter idref="kappa"/></graphicalParameterBounds>
      </reflectiveHamiltonianMonteCarloOperator>"""),
    "simplex_hmc": dict(ops="""<hamiltonianMonteCarloOperator weight="2"
        nSteps="3" stepSize="0.01">
        <gradient><treeLikelihood idref="treeLikelihood"/>
          <parameter idref="frequencies"/></gradient>
        <parameter idref="frequencies"/><UnitSimplexTransform/>
      </hamiltonianMonteCarloOperator>"""),
    "zigzag_bps": dict(
        models=MVN, priors='<multivariateDistributionLikelihood idref="mvnLik"/>',
        ops=_pdmp("zigZagOperator") + _pdmp("bouncyParticleOperator"),
        logs='<gradient idref="xGradient"/>'),
    "gibbs_normal": dict(
        models=NORMAL + """<exponentialStatistic id="expM"><parameter idref="m"/></exponentialStatistic>
    <reciprocalStatistic id="recTau"><parameter idref="tau"/></reciprocalStatistic>
    <negativeStatistic id="negM"><parameter idref="m"/></negativeStatistic>""",
        priors="""<distributionLikelihood idref="dl"/>
        <normalPrior mean="0.0" stdev="10.0"><parameter idref="m"/></normalPrior>
        <gammaPrior shape="2.0" scale="1.0" offset="0.0"><parameter idref="tau"/></gammaPrior>""",
        ops="""<normalNormalMeanGibbsOperator weight="2">
          <likelihood><distributionLikelihood idref="dl"/></likelihood>
          <prior><normalPrior mean="0.0" stdev="10.0"/></prior>
        </normalNormalMeanGibbsOperator>
        <normalGammaPrecisionGibbsOperator weight="2">
          <likelihood><distributionLikelihood idref="dl"/></likelihood>
          <prior><gammaPrior shape="2.0" scale="1.0"/></prior>
        </normalGammaPrecisionGibbsOperator>""",
        logs='<exponentialStatistic idref="expM"/>'
             '<reciprocalStatistic idref="recTau"/>'
             '<negativeStatistic idref="negM"/>'),
    "ar_dummy_dirty": dict(
        models="""<autoRegressiveNormalDistributionModel id="ar" dim="3">
      <scale><parameter id="ar.scale" value="0.8" lower="0.0"/></scale>
      <rho><parameter id="ar.rho" value="0.3"/></rho>
    </autoRegressiveNormalDistributionModel>
    <multivariateDistributionLikelihood id="arLik">
      <distribution><autoRegressiveNormalDistributionModel idref="ar"/></distribution>
      <data><parameter id="y" value="0.2 -0.1 0.4"/></data>
    </multivariateDistributionLikelihood>
    <dummyLikelihood id="dummy"><parameter idref="kappa"/></dummyLikelihood>""",
        priors='<multivariateDistributionLikelihood idref="arLik"/>'
               '<dummyLikelihood idref="dummy"/>',
        ops="""<randomWalkOperator windowSize="0.3" weight="2"><parameter idref="y"/></randomWalkOperator>
        <scaleOperator scaleFactor="0.75" weight="2"><parameter idref="ar.scale"/></scaleOperator>
        <dirtyLikelihood weight="1"><treeLikelihood idref="treeLikelihood"/></dirtyLikelihood>"""),
}


def hmc_documents(docs):
    return {name: _doc(**kw) for name, kw in docs.items()}


DOCS = hmc_documents(DOCS_A)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared checks (tests/test_torch_xml_hmc_b.py and test_torch_xml_glm.py
# run them on their documents too)
# ---------------------------------------------------------------------------


def _fields(op):
    out = {}
    for f in ("weight", "parameters", "parameter", "n_leapfrog",
              "step_size", "mass", "log_transform", "adaptable", "lower",
              "upper", "draw_variance", "mean_param", "data_params",
              "prior_mean", "prior_stdev", "precision_param", "prior_shape",
              "prior_scale"):
        if hasattr(op, f):
            v = getattr(op, f)
            out[f] = tuple(v) if isinstance(v, (list, tuple)) else v
    return out


def check_operators(xml, tmp_path):
    """The operators each package builds: the same classes, in order, with
    the same settings."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    _, _, jops, _, _, _ = _setup(jinterp, str(path))
    _, _, ops, _, _, _ = _setup(interp, str(path), "cpu")
    assert [type(o).__name__ for o in ops] == \
        [type(o).__name__ for o in jops]
    for o, jo in zip(ops, jops):
        assert _fields(o) == _fields(jo), type(o).__name__


def _target_gradients(ax, post, op, params, tree):
    """The port's posterior gradient in op's targets at (params, tree)."""
    if type(op).__name__ == "NodeHeightHmcOperator":
        n = (tree.heights.shape[0] + 1) // 2
        h = tree.heights[n:].clone().requires_grad_(True)
        t = tree.replace(heights=torch.cat([tree.heights[:n], h]))
        return [torch.autograd.grad(post.fn(params, t), h)[0].numpy()]
    names = list(getattr(op, "parameters", ()) or (op.parameter,))
    xs = [params[n].clone().requires_grad_(True) for n in names]
    p = {**params, **dict(zip(names, xs))}
    return [g.numpy() for g in torch.autograd.grad(post.fn(p, tree), xs)]


def _jax_target_gradients(jpost, op, params, tree):
    if type(op).__name__ == "NodeHeightHmcOperator":
        n = (tree.heights.shape[0] + 1) // 2

        def f(h):
            return jpost.fn(params, tree.replace(
                heights=tree.heights.at[n:].set(h)))

        return [np.asarray(jax.jit(jax.grad(f))(tree.heights[n:]))]
    names = list(getattr(op, "parameters", ()) or (op.parameter,))

    def g(vals):
        return jpost.fn({**params, **dict(zip(names, vals))}, tree)

    return [np.asarray(v) for v in jax.jit(jax.grad(g))(
        [params[n] for n in names])]


def check_target_gradients(xml, tmp_path):
    """For every operator that steps on a gradient, the port's log
    posterior's gradient in its targets equals jax.grad's (1e-10)."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    _, jpost, jops, _, jparams, jtree = _setup(jinterp, str(path))
    _, post, ops, _, params, tree = _setup(interp, str(path), "cpu")
    checked = 0
    for op, jop in zip(ops, jops):
        if not (hasattr(op, "n_leapfrog") or hasattr(op, "grad_bound")):
            continue
        got = _target_gradients(None, post, op, params, tree)
        want = _jax_target_gradients(jpost, jop, jparams, jtree)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=REL,
                                       atol=REL * np.abs(w).max(),
                                       err_msg=type(op).__name__)
        checked += 1
    return checked


def compare_reports(rep, jrep, label=""):
    """Two gradient reports: the same lines; the analytic ones (and any
    line without central differences) to 1e-10, the numeric ones to 1e-6
    of their largest entry."""
    lines, jlines = rep.splitlines(), jrep.splitlines()
    assert len(lines) == len(jlines), (label, rep, jrep)
    for ln, jl in zip(lines, jlines):
        assert NUM.sub("#", ln) == NUM.sub("#", jl), (label, ln, jl)
        a = np.array([float(x) for x in NUM.findall(ln)])
        b = np.array([float(x) for x in NUM.findall(jl)])
        if not b.size:
            continue
        numeric = ln.lower().startswith(("numeric", "numerical"))
        tol = 1e-6 if numeric else REL
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * max(np.abs(b).max(), 1.0),
                                   err_msg=f"{label}: {ln}")


def check_gradient_reports(xml, tmp_path, ids=None):
    """Every gradient element with an id: its report against JAX's."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    jax_ax = jinterp.XmlAnalysis(str(path))
    ax = interp.XmlAnalysis(str(path), device="cpu")
    for a in (jax_ax, ax):
        for el in a.root.iter("treeModel"):
            if el.get("id"):
                a.build(el)
    if ids is None:
        ids = [el.get("id") for el in ax.root.iter()
               if el.tag in GRADIENT_TAGS and el.get("id")]
    for i in ids:
        compare_reports(xml_assert.report_of(ax, ax._ids[i]),
                        jassert.report_of(jax_ax, jax_ax._ids[i]), i)
    return ids


# ---------------------------------------------------------------------------
# this file's documents
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS[name], tmp_path)
    check_operators(DOCS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(n for n in DOCS
                                        if "hmc" in n or "zigzag" in n))
def test_hmc_target_gradients_match_jax(name, tmp_path):
    assert check_target_gradients(DOCS[name], tmp_path) >= 1


@pytest.mark.parametrize("name,gid", [("heights_hmc_nuts", "heightGradient"),
                                      ("heights_hmc_nuts", "rateGradient"),
                                      ("zigzag_bps", "xGradient")])
def test_gradient_reports_match_jax(name, gid, tmp_path):
    """The reports of the node-height, rate and MVN gradients (kappa's is
    the rate one's kind; JAX's eager Hessian takes ~25 s a report here)."""
    assert check_gradient_reports(DOCS[name], tmp_path, [gid]) == [gid]

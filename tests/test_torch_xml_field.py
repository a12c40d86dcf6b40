"""The port's config/xml_field.py against the JAX package's: random
fields, Gaussian-process priors and the non-parametric multilocus
coalescent, in inline 6-taxon documents run by both interpreters.

Each document goes through tests/test_torch_interpreter.py::
check_against_jax (parameters, start tree, log columns and the posterior
with every component at 6 states, 1e-10 relative) and check_chain (200
states, the 0.1 full-evaluation check), and the operators each package
builds agree (tests/test_torch_xml_hmc_a.py::check_operators). Every
gradient element's gradient (GradientSpec) equals a jitted jax.grad of
JAX's density to 1e-10, the HMC operators' target gradients equal
jax.grad's, and the reports (the GP field's precision, the prediction,
the conditional derivative, the gradient elements') equal JAX's. The
documents: an HMC skygrid (chip_smoke.py phase 20b at 6 taxa: the NP
coalescent on 5 cells with a GMRF random field and a gamma prior on its
precision, HMC over the field with a jointGradient of both gradients), a
proper GMRF with a mean, a tree-weighted GMRF matching the
pseudo-determinant, and additive GP fields with every kernel type,
weight functions and an orthogonal projection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config import xml_assert as jassert
from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config import xml_assert

from test_torch_interpreter import REL, _doc, check_against_jax, check_chain
from test_torch_xml_hmc_a import (
    check_operators,
    check_target_gradients,
    compare_reports,
)

NP = """<parameter id="grid" value="0.012 0.024 0.036 0.06"/>
    <multiLocusNPCoalescentLikelihood id="np">
      <populationSizes><parameter id="logPop" value="-2.0 -2.2 -1.9 -2.4 -2.1"/></populationSizes>
      <gridPoints><parameter idref="grid"/></gridPoints>
      <populationTree><treeModel idref="treeModel"/></populationTree>
    </multiLocusNPCoalescentLikelihood>"""
GMRF = """<gaussianMarkovRandomField id="gmrf" dim="5" {attrs}>
      <precision><parameter id="gmrf.prec" value="1.5" lower="0.0"/></precision>
      {extra}
    </gaussianMarkovRandomField>
    <randomField id="field">
      <data><parameter idref="logPop"/></data>
      <distribution><gaussianMarkovRandomField idref="gmrf"/></distribution>
    </randomField>
    <gammaPrior id="precPrior" shape="1.0" scale="2.0"><parameter idref="gmrf.prec"/></gammaPrior>"""
GRADIENTS = """<multilocusNPCoalescentLikelihoodGradient id="npGrad">
      <multiLocusNPCoalescentLikelihood idref="np"/><parameter idref="logPop"/>
    </multilocusNPCoalescentLikelihoodGradient>
    <randomFieldGradient id="fieldGrad"><randomField idref="field"/></randomFieldGradient>
    <jointGradient id="skygridGradient">
      <multilocusNPCoalescentLikelihoodGradient idref="npGrad"/>
      <randomFieldGradient idref="fieldGrad"/>
    </jointGradient>"""
SKYGRID_PRIOR = ('<multiLocusNPCoalescentLikelihood idref="np"/>'
                 '<randomField idref="field"/>'
                 '<gammaPrior idref="precPrior"/>')
HMC = """<hamiltonianMonteCarloOperator weight="3" nSteps="5" stepSize="0.05"
        drawVariance="1.0" autoOptimize="true">
      <jointGradient idref="{g}"/>
      <parameter idref="{p}"/>
    </hamiltonianMonteCarloOperator>"""
SCALE = """<scaleOperator scaleFactor="0.75" weight="1">
      <parameter idref="{p}"/></scaleOperator>"""
LOGS = """<multiLocusNPCoalescentLikelihood idref="np"/>
      <randomField idref="field"/><parameter idref="logPop"/>"""


def skygrid_doc(attrs="", extra=""):
    return _doc(models=NP + GMRF.format(attrs=attrs, extra=extra)
                + GRADIENTS, tree_prior=SKYGRID_PRIOR,
                ops=HMC.format(g="skygridGradient", p="logPop")
                + SCALE.format(p="gmrf.prec"), logs=LOGS)


WEIGHTS = """<weightProvider rescaleByRootHeight="true">
        <treeModel idref="treeModel"/></weightProvider>"""
LAMBDA_MEAN = """<lambda><parameter value="0.5"/></lambda>
      <mean><parameter id="gmrf.mean" value="-2.1"/></mean>"""

BASIS = """<basis {attrs}>
        <designMatrix><parameter id="design{i}" value="0.0 0.5 1.0 1.5 2.0"/></designMatrix>
        <kernel type="{kernel}">
          <scale><parameter id="gp.scale{i}" value="{scale}" lower="0.0"/></scale>
          <length><parameter id="gp.length{i}" value="{length}" lower="0.0"/></length>
        </kernel>
        {weight}
      </basis>"""


def gp_models(bases, noise=True, mean=True):
    body = "".join(BASIS.format(i=i, **b) for i, b in enumerate(bases))
    if noise:
        body += ('<gaussianNoise><parameter id="gp.noise" value="0.1" '
                 'lower="0.0"/></gaussianNoise>')
    if mean:
        body += '<mean><parameter id="gp.mean" value="0.05"/></mean>'
    return f"""<parameter id="gpx" value="0.3 -0.2 0.5 0.1 0.0"/>
    <gaussianProcessField id="gp" dim="5">{body}</gaussianProcessField>
    <randomField id="gpfield">
      <data><parameter idref="gpx"/></data>
      <distribution><gaussianProcessField idref="gp"/></distribution>
    </randomField>
    <randomFieldGradient id="gpxGrad"><randomField idref="gpfield"/></randomFieldGradient>
    <gaussianProcessKernelGradient id="kernelGrad"><randomField idref="gpfield"/></gaussianProcessKernelGradient>
    <jointGradient id="gpGradient"><randomFieldGradient idref="gpxGrad"/></jointGradient>
    <gaussianProcessPrediction id="gpPred">
      <parameter idref="gpx"/>
      <gaussianProcessField idref="gp"/>
      <bases>{"".join(
          '<designMatrix><parameter value="0.25 1.25 1.75"/></designMatrix>'
          for _ in bases)}</bases>
    </gaussianProcessPrediction>"""


SE = dict(attrs="", kernel="SquaredExponential", scale=1.2, length=0.8,
          weight="")
CONDITIONAL = """<gaussianProcessConditionalDerivative id="gpDeriv">
      <field><parameter idref="gpx"/></field>
      <gaussianProcessField idref="gp"/>
    </gaussianProcessConditionalDerivative>"""


def gp_doc(bases, **kw):
    return _doc(models=gp_models(bases, **kw) + CONDITIONAL
                if bases[0]["kernel"] == "SquaredExponential"
                else gp_models(bases, **kw),
                priors='<randomField idref="gpfield"/>',
                ops=HMC.format(g="gpGradient", p="gpx")
                + SCALE.format(p="gp.scale0") + SCALE.format(p="gp.length0"),
                logs='<randomField idref="gpfield"/>')


DOCS = {
    "skygrid_hmc": skygrid_doc(),
    "gmrf_proper_mean": skygrid_doc(extra=LAMBDA_MEAN),
    "gmrf_weighted": skygrid_doc('matchPseudoDeterminant="true"', WEIGHTS),
    "gmrf_match_pd": skygrid_doc('matchPseudoDeterminant="true"'),
    "gp_squared_exponential": gp_doc([SE]),
    "gp_additive_kernels": gp_doc([
        dict(attrs="", kernel="Matern5/2", scale=0.9, length=1.1,
             weight='<weightFunction type="sigmoid" scale="2.0" '
                    'location="1.0"/>'),
        dict(attrs='orthogonalProjection="true"',
             kernel="OrnsteinUhlenbeck", scale=0.7, length=0.6,
             weight='<weightFunction type="sigmoidComplement" scale="1.5" '
                    'location="0.8"/>'),
        dict(attrs="", kernel="Matern3/2", scale=0.5, length=1.4,
             weight='<weightFunction type="linear" slope="0.5" '
                    'intercept="1.0"/>'),
        dict(attrs="", kernel="DotProduct", scale=0.3, length=1.0,
             weight="")], mean=False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS[name], tmp_path)
    check_operators(DOCS[name], tmp_path)
    assert check_target_gradients(DOCS[name], tmp_path) >= 1


@pytest.mark.parametrize("name", ["skygrid_hmc", "gmrf_weighted",
                                  "gp_additive_kernels"])
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)


def analyses(tmp_path, xml):
    """(JAX's XmlAnalysis, the port's on the CPU) of xml, tree models
    built."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    out = (jinterp.XmlAnalysis(str(path), seed=17),
           interp.XmlAnalysis(str(path), seed=17, device="cpu"))
    for ax in out:
        for el in ax.root.iter("treeModel"):
            if el.get("id"):
                ax.build(el)
    return out


def jax_spec_gradient(jax_ax, spec):
    """jax.jit(jax.grad) of a JAX GradientSpec's density in its targets
    at the initial state, flat (as config/xml_assert.py::gradient_report
    differentiates it)."""
    params0, tree0 = jassert.initial_eval_state(jax_ax)
    names = list(spec.target_names())

    def density(vals):
        p = dict(params0)
        for n, v in zip(names, vals):
            p[n] = jnp.reshape(v, params0[n].shape)
        return sum(lik.fn(p, tree0) for lik in spec.likelihoods)

    g = jax.jit(jax.grad(density))([params0[n] for n in names])
    return np.concatenate([np.ravel(np.asarray(v)) for v in g])


def check_spec_gradients(xml, tmp_path, ids):
    """Each gradient element's autograd gradient (xml_assert
    .analytic_gradient) against JAX's jitted jax.grad, 1e-10."""
    jax_ax, ax = analyses(tmp_path, xml)
    for gid in ids:
        spec = ax.build(ax._ids[gid])
        jspec = jax_ax.build(jax_ax._ids[gid])
        assert tuple(spec.target_names()) == tuple(jspec.target_names())
        _, _, got = xml_assert.analytic_gradient(ax, spec)
        want = jax_spec_gradient(jax_ax, jspec)
        np.testing.assert_allclose(got.numpy(), want, rtol=REL,
                                   atol=REL * max(np.abs(want).max(), 1.0),
                                   err_msg=gid)


@pytest.mark.parametrize("name,ids", [
    ("skygrid_hmc", ["npGrad", "fieldGrad", "skygridGradient"]),
    ("gmrf_weighted", ["skygridGradient"]),
    ("gp_squared_exponential", ["gpxGrad", "kernelGrad"]),
    ("gp_additive_kernels", ["gpxGrad", "kernelGrad"]),
])
def test_gradient_elements_match_jax_grad(name, ids, tmp_path):
    check_spec_gradients(DOCS[name], tmp_path, ids)


@pytest.mark.parametrize("name,eid", [
    ("gp_squared_exponential", "kernelGrad"),
    ("gp_squared_exponential", "gp"),
    ("gp_squared_exponential", "gpPred"),
    ("gp_squared_exponential", "gpDeriv"),
    ("gp_additive_kernels", "gp"),
    ("gp_additive_kernels", "gpPred"),
])
def test_reports_equal_jax(name, eid, tmp_path):
    """The GP field's precision (minus the Hessian), the prediction and
    the conditional derivative to 1e-10; a gradient report's analytic
    lines to 1e-10, its central differences to 1e-6."""
    jax_ax, ax = analyses(tmp_path, DOCS[name])
    compare_reports(xml_assert.report_of(ax, ax._ids[eid]),
                    jassert.report_of(jax_ax, jax_ax._ids[eid]), eid)


def test_weights_and_field_sizing_equal_jax(tmp_path):
    """weightProvider's tree-interval weights and the field parameter
    resized to the distribution's dimension, as JAX."""
    xml = DOCS["gmrf_weighted"].replace(
        'value="-2.0 -2.2 -1.9 -2.4 -2.1"', 'value="-2.0"')
    jax_ax, ax = analyses(tmp_path, xml)
    wp = ax.root.find(".//weightProvider")
    np.testing.assert_allclose(ax.build(wp), jax_ax.build(
        jax_ax.root.find(".//weightProvider")), rtol=1e-15)
    for a in (jax_ax, ax):
        a.build(a._ids["field"])
    np.testing.assert_array_equal(ax.value_of("logPop"),
                                  jax_ax.value_of("logPop"))
    assert np.size(ax.value_of("logPop")) == 5

"""The port's config/xml_geo.py (the GLM, log-rate, mixture and lumpable
rate models, the structured coalescent) and the interpreter's first-order
surrogate against the JAX package's.

Documents (the 6-taxon one of tests/test_torch_interpreter.py with a
location attribute on each taxon) go through check_against_jax (1e-10),
check_chain (0.1) and tests/test_torch_xml_hmc_a.py::check_operators and
check_target_gradients (the posterior's gradient in each HMC target
against jax.grad, 1e-10): a GLM substitution model of two live predictors
with BSSVS indicators and HMC on its coefficients under a
<jointGradient> of <glmSubstitutionModelGradient> and the coefficient
prior's <gradient>; a logNormal-family glmModel regression; log-rate and
instantaneous-mixture models; strongly lumpable rates through a
<rateProvider>; the BASTA structured coalescent with a sampled tip state.
The gradient elements' analytic gradients equal a jitted jax.grad of
JAX's (1e-10; the surrogate's for the GLM one), and the GLM coefficient
HMC steps on the exact posterior's gradient, not the surrogate's.
models/treelikelihood.py::tree_loglikelihood_q_approx_grad has
tree_loglikelihood_q's value (1e-12) and JAX's surrogate gradient
(1e-10).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import treelikelihood as jtl
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree
from beast_mcmc_tpu_torch.config import xml_assert
from beast_mcmc_tpu_torch.models import treelikelihood as tl

from test_torch_interpreter import _doc, check_against_jax, check_chain
from test_torch_xml_hmc_a import (
    check_operators,
    check_target_gradients,
    compare_reports,
)
from test_torch_xml_hmc_b import _analyses, jax_spec_gradient

REL = 1e-10
LOCS = dict(a="A", b="A", c="B", d="C", e="B", f="D")


def geo_doc(**kw):
    """_doc with a location attribute (loc: A, B or C; loc4: A to D) on
    each taxon."""
    xml = _doc(**kw)
    for t, v in LOCS.items():
        xml = re.sub(
            f'(<taxon id="{t}">.*?)</taxon>',
            lambda m, v=v: (f'{m.group(1)}<attr name="loc">'
                            f'{"C" if v == "D" else v}</attr>'
                            f'<attr name="loc4">{v}</attr></taxon>'),
            xml, count=1)
    return xml


GEO3 = """<generalDataType id="geo">
      <state code="A"/><state code="B"/><state code="C"/></generalDataType>
    <attributePatterns id="geoPatterns" attribute="loc">
      <generalDataType idref="geo"/><taxa idref="taxa"/></attributePatterns>
    <frequencyModel id="geoFreqs" normalize="true">
      <generalDataType idref="geo"/>
      <frequencies><parameter id="geo.freqs" value="0.3 0.3 0.4"/></frequencies>
    </frequencyModel>"""


def _geo_lik(lid, model_tag, model_id, patterns="geoPatterns"):
    return f"""<siteModel id="{lid}.site">
      <substitutionModel><{model_tag} idref="{model_id}"/></substitutionModel>
    </siteModel>
    <treeDataLikelihood id="{lid}">
      <attributePatterns idref="{patterns}"/><treeModel idref="treeModel"/>
      <siteModel idref="{lid}.site"/>
    </treeDataLikelihood>"""


GLM = GEO3 + """<glmSubstitutionModel id="glmSub">
      <generalDataType idref="geo"/>
      <rootFrequencies><frequencyModel idref="geoFreqs"/></rootFrequencies>
      <glmModel id="glm" family="logLinear" checkIdentifiability="false">
        <independentVariables>
          <parameter id="glm.coefficients" value="0.4 -0.6"/>
          <indicator><parameter id="glm.indicators" value="1 1"/></indicator>
          <designMatrix id="glm.design">
            <parameter id="pred.distance" value="1.2 -0.3 0.8 1.2 -0.3 0.8"/>
            <parameter id="pred.origin" value="0.5 0.5 -1.0 -0.2 0.9 0.9"/>
          </designMatrix>
        </independentVariables>
      </glmModel>
    </glmSubstitutionModel>
    """ + _geo_lik("geoLik", "glmSubstitutionModel", "glmSub") + """
    <glmSubstitutionModelGradient id="glmGrad">
      <treeDataLikelihood idref="geoLik"/><glmSubstitutionModel idref="glmSub"/>
    </glmSubstitutionModelGradient>"""
GLM_OPS = """<hamiltonianMonteCarloOperator weight="4" nSteps="4" stepSize="0.1">
      <jointGradient id="coefGradient">
        <glmSubstitutionModelGradient idref="glmGrad"/>
        <gradient><normalPrior idref="coefPrior"/>
          <parameter idref="glm.coefficients"/></gradient>
      </jointGradient>
      <parameter idref="glm.coefficients"/>
    </hamiltonianMonteCarloOperator>
    <bitFlipOperator weight="2"><parameter idref="glm.indicators"/></bitFlipOperator>"""
GLM_PRIORS = """<treeDataLikelihood idref="geoLik"/>
        <normalPrior id="coefPrior" mean="0.0" stdev="2.0">
          <parameter idref="glm.coefficients"/></normalPrior>"""
REGRESSION = """<glmModel id="reg" family="logNormal">
      <dependentVariables><parameter id="yv" value="1.2 0.8 2.0"/></dependentVariables>
      <independentVariables>
        <parameter id="beta" value="0.1 0.2"/>
        <designMatrix><parameter id="x1" value="1 1 1"/>
          <parameter id="x2" value="0.5 -0.3 1.0"/></designMatrix>
      </independentVariables>
      <scaleVariables><parameter id="regPrec" value="2.0" lower="0.0"/></scaleVariables>
    </glmModel>"""
LOG_RATE = GEO3 + """<logRateSubstitutionModel id="lrm">
      <rootFrequencies><frequencyModel idref="geoFreqs"/></rootFrequencies>
      <logRates><parameter id="lr" value="0.1 -0.2 0.3 0.0 0.2 -0.1"/></logRates>
    </logRateSubstitutionModel>
    <generalSubstitutionModel id="gsm">
      <generalDataType idref="geo"/>
      <frequencies><frequencyModel idref="geoFreqs"/></frequencies>
      <rates><parameter id="gsm.rates" value="1.0 2.0 0.5" lower="0.0"/></rates>
    </generalSubstitutionModel>
    <instantaneousMixtureSubstitutionModel id="mix">
      <mixtureWeights><parameter id="mixW" value="0.3" lower="0.0" upper="1.0"/></mixtureWeights>
      <generalSubstitutionModel idref="gsm"/>
      <logRateSubstitutionModel idref="lrm"/>
      <rootFrequencies><frequencyModel idref="geoFreqs"/></rootFrequencies>
    </instantaneousMixtureSubstitutionModel>
    """ + _geo_lik("lrLik", "logRateSubstitutionModel", "lrm") + \
    _geo_lik("mixLik", "instantaneousMixtureSubstitutionModel", "mix") + """
    <approximateLogCtmcRateGradient id="lrGrad">
      <treeDataLikelihood idref="lrLik"/><parameter idref="lr"/>
    </approximateLogCtmcRateGradient>"""
LUMP = """<generalDataType id="geo4">
      <state code="A"/><state code="B"/><state code="C"/><state code="D"/>
    </generalDataType>
    <attributePatterns id="geo4Patterns" attribute="loc4">
      <generalDataType idref="geo4"/><taxa idref="taxa"/></attributePatterns>
    <stronglyLumpableCtmcRates id="lumpRates">
      <generalDataType idref="geo4"/>
      <rates><parameter id="across" value="1.0 2.0" lower="0.0"/></rates>
      <lump>
        <stateSet id="s1"><generalDataType idref="geo4"/><state code="A"/><state code="B"/></stateSet>
        <rates><parameter id="w1" value="0.5 0.7" lower="0.0"/></rates>
        <proportions><state code="A"/><parameter id="pA" value="0.6 0.4"/></proportions>
        <proportions><state code="B"/><parameter id="pB" value="0.3 0.7"/></proportions>
      </lump>
      <lump>
        <stateSet id="s2"><generalDataType idref="geo4"/><state code="C"/><state code="D"/></stateSet>
        <rates><parameter id="w2" value="1.5 0.9" lower="0.0"/></rates>
        <proportions><state code="C"/><parameter id="pC" value="0.5 0.5"/></proportions>
        <proportions><state code="D"/><parameter id="pD" value="0.2 0.8"/></proportions>
      </lump>
    </stronglyLumpableCtmcRates>
    <logRateSubstitutionModel id="lumpModel" normalize="false">
      <rootFrequencies><frequencyModel normalize="true">
        <generalDataType idref="geo4"/>
        <frequencies><parameter id="geo4.freqs" value="0.25 0.25 0.25 0.25"/></frequencies>
      </frequencyModel></rootFrequencies>
      <rateProvider><stronglyLumpableCtmcRates idref="lumpRates"/></rateProvider>
    </logRateSubstitutionModel>
    """ + _geo_lik("lumpLik", "logRateSubstitutionModel", "lumpModel",
                   "geo4Patterns") + """
    <approximateLogCtmcRateGradient id="lumpGrad">
      <treeDataLikelihood idref="lumpLik"/>
      <compoundParameter><parameter idref="across"/><parameter idref="w1"/></compoundParameter>
    </approximateLogCtmcRateGradient>"""
BASTA = GEO3 + """<generalSubstitutionModel id="mig">
      <generalDataType idref="geo"/>
      <frequencies><frequencyModel idref="geoFreqs"/></frequencies>
      <rates><parameter id="mig.rates" value="1.0 2.0 0.5" lower="0.0"/></rates>
    </generalSubstitutionModel>
    <structuredCoalescent id="sc">
      <attributePatterns idref="geoPatterns"/><treeModel idref="treeModel"/>
      <generalSubstitutionModel idref="mig"/>
      <parameter id="sc.popSizes" value="0.5 1.0 0.8" lower="0.0"/>
    </structuredCoalescent>
    <timeVaryingFrequencies id="tvf">
      <taxon idref="a"/><structuredCoalescent idref="sc"/>
      <generalDataType idref="geo"/>
      <parameter id="tvf.probs" value="0.2 0.5 0.3"/>
      <treeModel idref="treeModel"/>
    </timeVaryingFrequencies>
    <structuredCoalescentLikelihoodGradient id="scPop" wrtParameter="populationSize">
      <structuredCoalescent idref="sc"/></structuredCoalescentLikelihoodGradient>
    <structuredCoalescentLikelihoodGradient id="scMig">
      <structuredCoalescent idref="sc"/><generalSubstitutionModel idref="mig"/>
    </structuredCoalescentLikelihoodGradient>"""

DOCS = {
    "glm_hmc": geo_doc(models=GLM, priors=GLM_PRIORS, ops=GLM_OPS,
                       logs='<jointGradient idref="coefGradient"/>'),
    "glm_regression": geo_doc(
        models=REGRESSION, priors='<glmModel idref="reg"/>',
        ops="""<randomWalkOperator windowSize="0.2" weight="2"><parameter idref="beta"/></randomWalkOperator>
        <scaleOperator scaleFactor="0.75" weight="2"><parameter idref="regPrec"/></scaleOperator>"""),
    "log_rate_mixture": geo_doc(
        models=LOG_RATE,
        priors='<treeDataLikelihood idref="lrLik"/>'
               '<treeDataLikelihood idref="mixLik"/>',
        ops="""<randomWalkOperator windowSize="0.2" weight="2"><parameter idref="lr"/></randomWalkOperator>
        <randomWalkOperator windowSize="0.05" weight="2"><parameter idref="mixW"/></randomWalkOperator>"""),
    "lumpable": geo_doc(
        models=LUMP, priors='<treeDataLikelihood idref="lumpLik"/>',
        ops="""<scaleOperator scaleFactor="0.75" weight="2"><parameter idref="across"/></scaleOperator>
        <scaleOperator scaleFactor="0.75" weight="2"><parameter idref="w2"/></scaleOperator>"""),
    "structured_coalescent": geo_doc(
        models=BASTA, tree_prior='<structuredCoalescent idref="sc"/>'
                                 '<timeVaryingFrequencies idref="tvf"/>',
        ops="""<scaleOperator scaleFactor="0.75" weight="2"><parameter idref="sc.popSizes"/></scaleOperator>
        <scaleOperator scaleFactor="0.75" weight="2"><parameter idref="mig.rates"/></scaleOperator>
        <tipStateOperator weight="2"><timeVaryingFrequencies idref="tvf"/></tipStateOperator>"""),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS[name], tmp_path)
    check_operators(DOCS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)


def test_glm_coefficient_hmc_target_gradient_matches_jax(tmp_path):
    assert check_target_gradients(DOCS["glm_hmc"], tmp_path) == 1


@pytest.mark.parametrize("name,ids", [
    ("glm_hmc", ["glmGrad", "coefGradient"]),
    ("log_rate_mixture", ["lrGrad"]),
    ("lumpable", ["lumpGrad"]),
    ("structured_coalescent", ["scPop", "scMig"])])
def test_gradient_elements_match_jax(name, ids, tmp_path):
    jax_ax, ax = _analyses(DOCS[name], tmp_path)
    for gid in ids:
        spec, jspec = ax.build(ax._ids[gid]), jax_ax.build(jax_ax._ids[gid])
        assert spec.target_names() == jspec.target_names()
        _, _, g = xml_assert.analytic_gradient(ax, spec)
        want = jax_spec_gradient(jax_ax, jspec)
        np.testing.assert_allclose(g.numpy(), want, rtol=REL,
                                   atol=REL * np.abs(want).max(),
                                   err_msg=gid)


def test_rate_reports_match_jax(tmp_path):
    """The log-rate model's generator report (its OP_REPORTS entry) and
    the lumpable provider's rates."""
    from beast_mcmc_tpu.config import xml_assert as jassert

    for name, rid in (("log_rate_mixture", "lrm"), ("lumpable", "lumpRates")):
        jax_ax, ax = _analyses(DOCS[name], tmp_path)
        compare_reports(xml_assert.report_of(ax, ax._ids[rid]),
                        jassert.report_of(jax_ax, jax_ax._ids[rid]), rid)


def test_glm_hmc_steps_on_the_exact_gradient(tmp_path):
    """The coefficient HMC's potential gradient is minus the exact
    posterior's gradient (the 56-state path's expm differentiated
    exactly), not the surrogate's that <glmSubstitutionModelGradient>
    reports: at coefficients that make the rates large the two differ."""
    from beast_mcmc_tpu_torch.inference.hmc import HmcOperator, value_grad

    from test_torch_interpreter import _setup
    from beast_mcmc_tpu_torch.config import interpreter as interp

    path = tmp_path / "doc.xml"
    path.write_text(DOCS["glm_hmc"].replace('value="0.4 -0.6"',
                                            'value="2.5 1.5"'))
    ax, post, ops, _, params, tree = _setup(interp, str(path), "cpu")
    (op,) = [o for o in ops if isinstance(o, HmcOperator)]
    assert op.parameters == ("glm.coefficients",) and not op.log_transform
    op.bind_log_posterior(post.fn)
    lp = op.one_chain_posterior()
    p1 = {n: v[None] for n, v in params.items()}
    t1 = tree.replace(**{f: getattr(tree, f)[None] for f in
                         ("parent", "children", "heights", "root")})
    y0 = op._pack(p1)
    g_hmc = -value_grad(op.neg_log_density(lp, p1, t1), y0)[0]

    def grad_of(lik_fns):
        x = params["glm.coefficients"].clone().requires_grad_(True)
        p = {**params, "glm.coefficients": x}
        return torch.autograd.grad(sum(f(p, tree) for f in lik_fns), x)[0]

    exact = grad_of([post.fn])
    spec = ax.build(ax._ids["coefGradient"])
    surrogate = grad_of([lk.fn for lk in spec.likelihoods])
    np.testing.assert_allclose(g_hmc.numpy(), exact.numpy(), rtol=1e-12)
    rel = float((surrogate - exact).abs().max() / exact.abs().max())
    assert rel > 1e-3, rel


def _q_inputs(n, k, seed):
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n), 1.0)
    tips = (rng.uniform(size=(n, k, 7)) > 0.5) * 0.9 + 0.1
    rates = rng.uniform(0.2, 2.0, k * (k - 1))
    freqs = rng.dirichlet(np.ones(k))
    return (parent, children, heights, root, tips, rng.uniform(1, 3, 7),
            rates, freqs, np.array([0.5, 1.5]), np.array([0.4, 0.6]))


@pytest.mark.parametrize("n,k,seed", [(9, 4, 0), (14, 6, 1)])
def test_first_order_surrogate_matches_jax(n, k, seed):
    """The surrogate's value is tree_loglikelihood_q's (1e-12); its
    gradient in the generator's rates is JAX's surrogate gradient
    (1e-10), and differs from the exact one."""
    from beast_mcmc_tpu_torch.models.substitution import general_complex_q

    (parent, children, heights, root, tips, w, rates, freqs, cr,
     cw) = _q_inputs(n, k, seed)
    iu = np.triu_indices(k, 1)

    def jq(r):
        pi = jnp.asarray(freqs)
        q = jnp.zeros((k, k)).at[iu].set(r[:len(iu[0])] * pi[iu[1]])
        q = q.at[(iu[1], iu[0])].set(r[len(iu[0]):] * pi[iu[0]])
        q = q - jnp.diag(q.sum(1))
        return q / -jnp.sum(pi * jnp.diagonal(q))

    def jll(r, fn):
        return fn(jnp.asarray(tips), jnp.asarray(w), jnp.asarray(parent),
                  jnp.asarray(children), jnp.asarray(heights), root, jq(r),
                  jnp.asarray(freqs), jnp.asarray(cr), jnp.asarray(cw), 1.3)

    want = jax.jit(jax.grad(lambda r: jll(
        r, jtl.tree_loglikelihood_q_approx_grad)))(jnp.asarray(rates))
    want_exact = jax.jit(jax.grad(lambda r: jll(
        r, jtl.tree_loglikelihood_q)))(jnp.asarray(rates))

    def t(x, dt=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dt)

    r = t(rates).requires_grad_(True)
    args = (t(tips), t(w), t(parent, torch.long), t(children, torch.long),
            t(heights), root)
    q = general_complex_q(r, t(freqs))
    rest = (t(freqs), t(cr), t(cw), torch.tensor(1.3, dtype=torch.float64))
    val = tl.tree_loglikelihood_q_approx_grad(*args, q, *rest)
    exact = tl.tree_loglikelihood_q(*args, q, *rest)
    np.testing.assert_allclose(float(val.detach()), float(exact.detach()),
                               rtol=1e-12)
    np.testing.assert_allclose(float(val.detach()), float(jax.jit(
        lambda r: jll(r, jtl.tree_loglikelihood_q_approx_grad))(
            jnp.asarray(rates))), rtol=1e-12)
    (g,) = torch.autograd.grad(val, r)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=REL,
                               atol=REL * np.abs(np.asarray(want)).max())
    assert not np.allclose(np.asarray(want), np.asarray(want_exact),
                           rtol=1e-6)

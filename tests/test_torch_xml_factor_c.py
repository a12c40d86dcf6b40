"""The port's config/xml_factor.py against the JAX package's, part c: the
gradient elements and the reports.

Every gradient element of part a's documents (the integrated loadings,
precision and both; the sampled loadings; the scaled matrix's scale and
matrix components) equals a jitted jax.grad of JAX's density to 1e-10
(tests/test_torch_xml_field.py::check_spec_gradients). The reports equal
JAX's, their numbers to 1e-10 relative: integratedFactors, the loadings
Gibbs operator's (sampled, and integrated inside a joint trait likelihood
with a plain and a repeated-measures-wrapped factor component), the
loadings scale's, the multiplicative-gamma and normal-extension gamma
providers', factorProportionStatistic, crossValidation, wishartStatistics
(factor route), a trait likelihood's outer products (factor and Brownian
routes), traitValidationProvider, treeTraitReporter, the independent
normal's, the multivariate gamma's and the extended liability report's
(1,600 Gibbs sweeps from the same numpy seed over tables that agree to
round-off). Then chip_smoke.py's phase 20 on the CPU at 12 taxa.
"""

import re

import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import xml_assert as jassert
from beast_mcmc_tpu_torch.config import xml_assert

from test_torch_interpreter import _doc
from test_torch_xml_factor_a import DOCS, TRAITS4, TRUE4, factor_doc
from test_torch_xml_field import analyses, check_spec_gradients
from test_torch_xml_traits_a import (
    LOC,
    LOC_MISSING,
    PRECISION,
    ROOT,
    rrw_models,
    trait_doc,
    with_attrs,
)

NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")
# tip factors away from zero, where the factor proportions are 0 / 0
F_START = ('<parameter id="F" value="0.3 -0.2 0.5 0.1 -0.4 0.2 0.0 0.6 '
           '-0.1 0.3 0.2 -0.5"/>')


def with_factors(xml):
    return xml.replace('<parameter id="F" value="0.0"/>', F_START)


REPORTS = """<integratedFactors id="ifr">
      <integratedFactorModel idref="factors"/><traitDataLikelihood idref="traitLik"/>
    </integratedFactors>
    <wishartStatistics id="ws"><traitDataLikelihood idref="traitLik"/></wishartStatistics>
    <traitValidationProvider id="tvp" traitName="truth">
      <traitDataLikelihood idref="traitLik"/>
      <traitParameter><parameter id="leaf.truth"/></traitParameter>
    </traitValidationProvider>
    <crossValidation id="cv"><traitValidationProvider idref="tvp"/></crossValidation>
    <normalGammaPrecisionGibbsOperator id="neOp">
      <normalExtension>
        <integratedFactorModel idref="factors"/><traitDataLikelihood idref="traitLik"/>
      </normalExtension>
    </normalGammaPrecisionGibbsOperator>"""
MGP2_OP = """<normalGammaPrecisionGibbsOperator id="mgp2Op">
      <multiplicativeGammaGibbsProvider idref="mgp2"/>
      <prior><gammaPrior shape="2.0" scale="1.0"/></prior>
    </normalGammaPrecisionGibbsOperator>"""
JOINT_FACTOR = """<traitDataLikelihood id="traitLik" traitName="joint">
      <multivariateDiffusionModel idref="diffusion"/>
      <treeModel idref="treeModel"/>
      <jointPartialsProvider>
        <continuousTraitDataModel id="ctdm" traitName="t1">
          <treeModel idref="treeModel"/>
          <traitParameter><parameter id="leaf.t1"/></traitParameter>
        </continuousTraitDataModel>
        {factor}
      </jointPartialsProvider>
      {root}
    </traitDataLikelihood>
    <treeTraitReporter id="ttr">
      <integratedFactorModel idref="jf"/><traitDataLikelihood idref="traitLik"/>
    </treeTraitReporter>
    <loadingsGibbsOperator id="lgi">
      <integratedFactorModel idref="jf"/><traitDataLikelihood idref="traitLik"/>
    </loadingsGibbsOperator>"""
JF = """<integratedFactorModel id="jf" traitName="traits">
          <treeModel idref="treeModel"/>
          <traitParameter><parameter id="leaf.traits"/></traitParameter>
          <loadings><matrixParameter id="L1"><parameter id="L1.1" value="1.0 0.5 -0.3 0.2"/></matrixParameter></loadings>
          <precision><parameter id="jfPrec" value="2.0 3.0 1.5 2.5" lower="0.0"/></precision>
        </integratedFactorModel>"""
JF_RM = """<repeatedMeasuresModel id="rmf" traitName="traits">
          {jf}
          <samplingPrecision><parameter id="rmf.prec" value="10.0" lower="0.0"/></samplingPrecision>
        </repeatedMeasuresModel>""".format(jf=JF)
T1 = {t: v.split()[0] for t, v in LOC.items()}
T1["d"] = "NA"


def joint_doc(factor):
    xml = with_attrs(_doc(models=PRECISION + JOINT_FACTOR.format(
        factor=factor, root=ROOT),
        priors='<traitDataLikelihood idref="traitLik"/>'), TRAITS4,
        "traits")
    return with_attrs(xml, T1, "t1")


REPORT_DOCS = {
    "integrated": with_attrs(factor_doc(
        REPORTS, '<traitDataLikelihood idref="traitLik"/>', ""), TRUE4,
        "truth"),
    "brownian": with_attrs(trait_doc(rrw_models()).replace(
        "</beast>", """<traitValidationProvider id="tvp" traitName="truth">
          <traitDataLikelihood idref="traitLik"/>
          <traitParameter><parameter id="leaf.truth"/></traitParameter>
        </traitValidationProvider></beast>"""), LOC, "truth").replace(
        f'<attr name="location">{LOC["b"]}',
        f'<attr name="location">{LOC_MISSING["b"]}').replace(
        f'<attr name="location">{LOC["e"]}',
        f'<attr name="location">{LOC_MISSING["e"]}'),
    "joint_factor": joint_doc(JF),
    "joint_repeated_factor": joint_doc(JF_RM),
    "small_densities": DOCS["small_densities"].replace(
        "</beast>", MGP2_OP + "</beast>"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,ids", [
    ("integrated_hmc_shrinkage", ["ilg", "ipg", "ilpg", "loadingsGradient"]),
    ("integrated_standardized", ["loadingsGradient"]),
    ("scaled_loadings", ["slg", "smgScale", "smgMatrix"]),
])
def test_gradient_elements_match_jax_grad(name, ids, tmp_path):
    check_spec_gradients(DOCS[name], tmp_path, ids)


def compare(got, want, rtol=1e-10):
    """Two report strings: the same text around the numbers, the numbers
    to rtol."""
    assert NUM.sub("#", got) == NUM.sub("#", want), (got, want)
    g, w = (np.array(NUM.findall(r), float) for r in (got, want))
    assert w.size
    np.testing.assert_allclose(g, w, rtol=rtol,
                               atol=rtol * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("doc,eid", [
    ("integrated", "ifr"), ("integrated", "ws"), ("integrated", "cv"),
    ("integrated", "neOp"), ("integrated", "traitLik"),
    ("brownian", "tvp"), ("brownian", "traitLik"),
    ("joint_factor", "ttr"), ("joint_factor", "lgi"),
    ("joint_repeated_factor", "ttr"), ("joint_repeated_factor", "lgi"),
    ("small_densities", "mgp2Op"), ("small_densities", "mvg"),
])
def test_reports_equal_jax(doc, eid, tmp_path):
    jax_ax, ax = analyses(tmp_path, REPORT_DOCS[doc])
    compare(xml_assert.report_of(ax, ax._ids[eid]),
            jassert.report_of(jax_ax, jax_ax._ids[eid]))


@pytest.mark.parametrize("doc,eid", [
    ("integrated_hmc_shrinkage", "mgpOp"),
    ("latent_factor_gibbs", "loadingsOp"), ("latent_factor_gibbs", "fps"),
    ("latent_factor_gibbs", "Lprior"),
    ("latent_factor_upper_triangular_scaled_data", "loadingsOp"),
    ("scaled_loadings", "scaleOp"), ("scaled_loadings", "fps"),
])
def test_operator_and_statistic_reports_equal_jax(doc, eid, tmp_path):
    jax_ax, ax = analyses(tmp_path, with_factors(DOCS[doc]))
    compare(xml_assert.report_of(ax, ax._ids[eid]),
            jassert.report_of(jax_ax, jax_ax._ids[eid]))


def test_extended_liability_report_equals_jax(tmp_path):
    jax_ax, ax = analyses(tmp_path, DOCS["extended_liability"])
    compare(xml_assert.report_of(ax, ax._ids["liabOp"]),
            jassert.report_of(jax_ax, jax_ax._ids["liabOp"]))


def test_factor_proportion_columns_equal_its_report(tmp_path):
    """factorProportionStatistic's log columns (the port computes them on
    the device a row; JAX's statistic only reports) equal JAX's report at
    the start state."""
    xml = with_factors(DOCS["latent_factor_gibbs"]).replace(
        '<latentFactorModel idref="lfm"/>\n    </log>',
        '<latentFactorModel idref="lfm"/>'
        '<factorProportionStatistic idref="fps"/>\n    </log>')
    jax_ax, ax = analyses(tmp_path, xml)
    want = jax_ax.build(jax_ax._ids["fps"]).values(jax_ax)
    from beast_mcmc_tpu_torch.config import interpreter as interp
    from beast_mcmc_tpu_torch.config.xml_stats import _current_state

    cols = ax._column_of(ax._ids["fps"])
    params, tree = _current_state(ax)
    s = interp._StateShim(params, tree)
    assert [c for c, _ in cols] == list(want)
    np.testing.assert_allclose([float(f(s)) for _, f in cols],
                               list(want.values()), rtol=1e-10)
    ax.run(full_eval_steps=5)
    assert ax.runs[0]["full_eval_deviation"] <= 0.1


def test_phase20_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's phase 20 on the CPU at 12 taxa x 200 sites: 20a
    (`run`, 20 states: the CLI's likelihood evaluations counted where the
    card counts peel_stream launches, exactly as predicted with each
    loadings HMC proposal's own; the deviation below 0.1, the factor
    proportions read back), 20b (`run -testxml`, its skygrid gradient
    report held to the CPU's), 20c's functions on the CPU twice."""
    import time

    import chip_smoke
    from beast_mcmc_tpu_torch.models import treelikelihood as tl

    calls = [0]
    site = tl._site_logliks

    def counted(*a, **k):
        calls[0] += 1
        return site(*a, **k)

    def device_ms(fn, label, n=1, top=6):
        t0 = time.perf_counter()
        fn()
        device_ms.events = 0.0
        return 1e3 * (time.perf_counter() - t0) / n, None

    monkeypatch.setattr(tl, "_site_logliks", counted)
    out = str(tmp_path / "out")
    kw = dict(n_taxa=12, n_sites=200)
    rec, launches = chip_smoke.factor_path(
        out, lambda: calls.__setitem__(0, 0),
        lambda: {"peel_stream": calls[0]}, device_ms, "cpu", n_steps=20,
        n_profile=2, draw_reps=1, **kw)
    a = rec["20a"]
    assert a["steps"] == 20 and a["log_rows"] == 2 and a["rc"] == 0
    assert a["full_evaluation_deviation"] <= 0.1
    assert launches["P20 20a CLI"] == {
        "peel_stream": 1 + 200 + 20 + 2 + a["bound_launches"]}
    assert a["bound_launches"] == 2 * 5 * len(a["hmc_proposal_ms"])
    assert launches["P20 20a profile"] == {"peel_stream": 2}
    more, more_launches = chip_smoke.skygrid_path(
        out, lambda: calls.__setitem__(0, 0),
        lambda: {"peel_stream": calls[0]}, "cpu", n_steps=20, **kw)
    b = more["20b"]
    assert b["gradient_entries"] == 50 and b["steps"] == 20
    assert more_launches["P20 20b CLI"] == {
        "peel_stream": 1 + 200 + 20 + 2 + b["bound_launches"]}
    c = chip_smoke.p20_functions_path(out, "cpu", draw_reps=1, **kw)
    assert c["functions"] == 19 and c["max_rel_err"] == 0.0


def test_phase20b_fails_on_a_planted_wrong_gradient(tmp_path, monkeypatch):
    """20b's -testxml check can fail: with one expected entry of its
    <assertEqual> moved by 1e-8 of the largest (100 times the tolerance),
    the assertion warns "(skipped)" on the simulated start tree, and
    skygrid_path raises on that warning."""
    import chip_smoke

    write = chip_smoke.skygrid_document

    def planted(path, data, n_steps, log_every, expected=None):
        if expected is not None:
            expected = expected.copy()
            expected[0] += 1e-8 * np.abs(expected).max()
        return write(path, data, n_steps, log_every, expected)

    monkeypatch.setattr(chip_smoke, "skygrid_document", planted)
    with pytest.raises(AssertionError,
                       match=r"20b CLI -testxml: \[.*\(skipped\)"):
        chip_smoke.skygrid_path(
            str(tmp_path), lambda: None, lambda: {"peel_stream": 0}, "cpu",
            n_taxa=12, n_sites=200, n_steps=10)

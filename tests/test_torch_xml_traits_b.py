"""The port's config/xml_traits.py against the JAX package's, part two:
repeated measures (a full and a diagonal, tip-height-scaled sampling
precision; replicates with and without missing entries), the integrated
factor model (plain, standardised with a nugget, inside repeated
measures), restricted partials, the ancestral-trait tree's ghost tips and
a jointPartialsProvider composition, each an inline 6-taxon document
through the checks of tests/test_torch_interpreter.py::check_against_jax
and check_chain. The integrated factor model adds nothing as a log column
and inside a <prior>, as in the JAX package.
"""

import numpy as np
import pytest
import torch

from test_torch_interpreter import _doc, check_against_jax, check_chain
from test_torch_xml_traits_a import (
    LOC,
    ROOT,
    RW,
    SCALE,
    analyses,
    trait_doc,
    with_attrs,
)

REPEATED = """<repeatedMeasuresModel id="rm" traitName="location" {attrs}>
      <treeModel idref="treeModel"/>
      <traitParameter><parameter id="leaf.location"/></traitParameter>
      <samplingPrecision>{prec}</samplingPrecision>
    </repeatedMeasuresModel>"""
FULL_PREC = """<matrixParameter id="samp">
        <parameter id="samp.c1" value="4.0 0.5"/>
        <parameter id="samp.c2" value="0.5 3.0"/></matrixParameter>"""
DIAG_PREC = '<parameter id="samp.diag" value="4.0 3.0" lower="0.0"/>'


def rm_lik(attrs=""):
    return f"""<traitDataLikelihood id="traitLik" traitName="location"
        {attrs}>
      <multivariateDiffusionModel idref="diffusion"/>
      <treeModel idref="treeModel"/>
      <repeatedMeasuresModel idref="rm"/>
      {ROOT}
    </traitDataLikelihood>"""


LOGS = """<traitDataLikelihood idref="traitLik"/>
      <traitLogger id="rootLoc" traitName="location" nodes="root">
        <traitDataLikelihood idref="traitLik"/></traitLogger>"""
REPLICATES = {t: f"{v} {' '.join(str(float(x) + 0.3) for x in v.split())}"
              for t, v in LOC.items()}
REPLICATES_MISSING = dict(REPLICATES, c="9.3 NA 9.5 -12.3")

FACTOR = """<matrixParameter id="prec1"><parameter id="prec1.c" value="1.5"/></matrixParameter>
    <multivariateDiffusionModel id="diffusion1">
      <precisionMatrix><matrixParameter idref="prec1"/></precisionMatrix>
    </multivariateDiffusionModel>
    <integratedFactorModel id="factors" traitName="traits" {attrs}>
      <treeModel idref="treeModel"/>
      <traitParameter><parameter id="leaf.traits"/></traitParameter>
      <loadings><matrixParameter id="L">
        <parameter id="L.1" value="1.0 0.5 -0.3"/></matrixParameter></loadings>
      <precision><parameter id="factorPrec" value="2.0 3.0 1.5" lower="0.0"/></precision>
    </integratedFactorModel>"""
FACTOR_LIK = """<traitDataLikelihood id="traitLik" traitName="traits">
      <multivariateDiffusionModel idref="diffusion1"/>
      <treeModel idref="treeModel"/>
      <integratedFactorModel idref="factors"/>
      <conjugateRootPrior>
        <meanParameter><parameter value="0.1"/></meanParameter>
        <priorSampleSize><parameter value="0.5"/></priorSampleSize>
      </conjugateRootPrior>
    </traitDataLikelihood>"""
TRAITS3 = {"a": "0.5 1.2 -0.3", "b": "0.7 NA -0.1", "c": "-0.2 0.4 0.9",
           "d": "1.1 0.8 NA", "e": "0.3 -0.6 0.2", "f": "0.0 0.1 0.4"}
FACTOR_RM = """<matrixParameter id="prec1"><parameter id="prec1.c" value="1.5"/></matrixParameter>
    <multivariateDiffusionModel id="diffusion1">
      <precisionMatrix><matrixParameter idref="prec1"/></precisionMatrix>
    </multivariateDiffusionModel>
    <repeatedMeasuresModel id="rmf" traitName="traits">
      <integratedFactorModel id="factors" traitName="traits">
        <treeModel idref="treeModel"/>
        <traitParameter><parameter id="leaf.traits"/></traitParameter>
        <loadings><matrixParameter id="L">
          <parameter id="L.1" value="1.0 0.5 -0.3"/></matrixParameter></loadings>
        <precision><parameter id="factorPrec" value="2.0 3.0 1.5" lower="0.0"/></precision>
      </integratedFactorModel>
      <samplingPrecision><parameter id="rmf.prec" value="10.0" lower="0.0"/></samplingPrecision>
    </repeatedMeasuresModel>
    <traitDataLikelihood id="traitLik" traitName="traits">
      <multivariateDiffusionModel idref="diffusion1"/>
      <treeModel idref="treeModel"/>
      <repeatedMeasuresModel idref="rmf"/>
      <conjugateRootPrior>
        <meanParameter><parameter value="0.1"/></meanParameter>
        <priorSampleSize><parameter value="0.5"/></priorSampleSize>
      </conjugateRootPrior>
    </traitDataLikelihood>"""
RESTRICTED = """<traitDataLikelihood id="traitLik" traitName="location">
      <multivariateDiffusionModel idref="diffusion"/>
      <treeModel idref="treeModel"/>
      <traitParameter><parameter idref="leaf.location"/></traitParameter>
      <restrictedPartials>
        <treeModel idref="treeModel"/>
        <mrca><taxon idref="a"/><taxon idref="b"/><taxon idref="c"/></mrca>
        <meanParameter><parameter value="8.2 -11.4"/></meanParameter>
        <priorSampleSize><parameter value="2.0"/></priorSampleSize>
      </restrictedPartials>
      {ROOT}
    </traitDataLikelihood>""".replace("{ROOT}", ROOT)
ANCESTRAL = """<ancestralTraitTreeModel id="atm">
      <treeModel idref="treeModel"/>
      <ancestor>
        <taxon id="anc1"><attr name="location">7.9 -11.2</attr></taxon>
        <parameter id="anc1.len" value="0.01" lower="0.0"/>
        <mrca><taxon idref="e"/><taxon idref="f"/></mrca>
      </ancestor>
      <nodeTraits name="location" traitDimension="2">
        <parameter id="atm.location"/></nodeTraits>
    </ancestralTraitTreeModel>
    <traitDataLikelihood id="traitLik" traitName="location">
      <multivariateDiffusionModel idref="diffusion"/>
      <ancestralTraitTreeModel idref="atm"/>
      <traitParameter><parameter idref="atm.location"/></traitParameter>
      {ROOT}
    </traitDataLikelihood>""".replace("{ROOT}", ROOT)
JOINT = """<traitDataLikelihood id="traitLik" traitName="joint">
      <multivariateDiffusionModel idref="diffusion"/>
      <treeModel idref="treeModel"/>
      <jointPartialsProvider>
        <continuousTraitDataModel id="ctdm" traitName="t1">
          <treeModel idref="treeModel"/>
          <traitParameter><parameter id="leaf.t1"/></traitParameter>
        </continuousTraitDataModel>
        <repeatedMeasuresModel id="rm2" traitName="t2">
          <treeModel idref="treeModel"/>
          <traitParameter><parameter id="leaf.t2"/></traitParameter>
          <samplingPrecision><parameter id="samp2" value="5.0" lower="0.0"/></samplingPrecision>
        </repeatedMeasuresModel>
      </jointPartialsProvider>
      {ROOT}
    </traitDataLikelihood>""".replace("{ROOT}", ROOT)
T1 = {t: v.split()[0] for t, v in LOC.items()}
T2 = {t: v.split()[1] for t, v in LOC.items()}
T1["d"] = "NA"


def one_dim_doc(models, values, name, logs="", ops="", priors=""):
    """A document whose trait likelihood lives in models (with its own
    one-dimensional diffusion), in the prior beside the sequence
    likelihood."""
    return with_attrs(_doc(
        models=models, priors='<traitDataLikelihood idref="traitLik"/>'
        + priors, ops=ops, logs='<traitDataLikelihood idref="traitLik"/>'
        + logs), values, name)


DOCS_B = {
    "repeatedMeasures:full": trait_doc(
        REPEATED.format(attrs="", prec=FULL_PREC) + rm_lik(), LOGS,
        SCALE.format(p="samp.c1")),
    "repeatedMeasures:diagonal_tip_scaled": trait_doc(
        REPEATED.format(attrs='scaleByTipHeight="true"', prec=DIAG_PREC)
        + rm_lik('scaleByTime="true"'), LOGS, SCALE.format(p="samp.diag")),
    "repeatedMeasures:replicates": trait_doc(
        REPEATED.format(attrs='numTraits="2"', prec=FULL_PREC) + rm_lik(),
        "", SCALE.format(p="samp.c1"), values=REPLICATES),
    "repeatedMeasures:replicates_missing": trait_doc(
        REPEATED.format(attrs='numTraits="2"', prec=DIAG_PREC) + rm_lik(),
        "", SCALE.format(p="samp.diag"), values=REPLICATES_MISSING),
    "integratedFactorModel": one_dim_doc(
        FACTOR.format(attrs="") + FACTOR_LIK, TRAITS3, "traits",
        logs='<integratedFactorModel idref="factors"/>',
        ops=RW.format(w=0.2, p="L.1") + SCALE.format(p="factorPrec"),
        priors='<integratedFactorModel idref="factors"/>'),
    "integratedFactorModel:standardized_nugget": one_dim_doc(
        FACTOR.format(attrs='standardize="true" nugget="0.1"') + FACTOR_LIK,
        TRAITS3, "traits", ops=RW.format(w=0.2, p="L.1")),
    "repeatedMeasures:integratedFactorModel": one_dim_doc(
        FACTOR_RM, TRAITS3, "traits",
        ops=RW.format(w=0.2, p="L.1") + SCALE.format(p="rmf.prec")),
    # the trait parameter bound by the tree model's nodeTraits
    # (JAX's traitLogger reads the undecorated params, where the derived
    # extended traits are missing: no traitLogger here)
    "restrictedPartials": trait_doc(
        RESTRICTED, '<traitDataLikelihood idref="traitLik"/>').replace(
        "</treeModel>", '<nodeTraits name="location" rootNode="false" '
        'internalNodes="false" leafNodes="true" traitDimension="2">'
        '<parameter id="leaf.location"/></nodeTraits></treeModel>', 1),
    "ancestralTraitTreeModel": trait_doc(
        ANCESTRAL, LOGS, SCALE.format(p="anc1.len")),
}
DOCS_B["jointPartialsProvider"] = with_attrs(
    trait_doc(JOINT, "", SCALE.format(p="samp2"), values=T1).replace(
        '<attr name="location">', '<attr name="t1">'), T2, "t2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DOCS_B))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS_B[name], tmp_path)


@pytest.mark.parametrize("name", sorted(DOCS_B))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS_B[name], tmp_path)


@pytest.mark.parametrize("name", ["restrictedPartials",
                                  "ancestralTraitTreeModel"])
def test_ghost_tip_trees_equal_jax(name, tmp_path):
    """The extended tree of the ghost-tip view (its parse-time arrays and
    its view of the start tree) equals JAX's."""
    jax_ax, ax = analyses(tmp_path, DOCS_B[name])
    for a in (jax_ax, ax):
        a.build(a._ids["traitLik"])
    ext = [t for t in ax._trees if t != "treeModel"]
    assert ext == [t for t in jax_ax._trees if t != "treeModel"]
    for tid in ext:
        tm, jtm = ax._trees[tid], jax_ax._trees[tid]
        assert tm.taxa == jtm.taxa
        for f in ("parent", "children", "heights", "root"):
            np.testing.assert_array_equal(np.asarray(getattr(tm, f)),
                                          np.asarray(getattr(jtm, f)),
                                          err_msg=f"{tid} {f}")


def test_integrated_factor_model_adds_nothing(tmp_path):
    """As a log column and inside a <prior> the integrated factor model
    counts zero: its density is the trait likelihood's."""
    from beast_mcmc_tpu_torch.config import interpreter as interp
    from test_torch_interpreter import _setup

    (tmp_path / "doc.xml").write_text(DOCS_B["integratedFactorModel"])
    _, post, _, cols, params, tree = _setup(interp, str(tmp_path / "doc.xml"),
                                            "cpu")
    (col,) = [f for c, f in cols if c == "factors"]
    assert float(col(interp._StateShim(params, tree))) == 0.0
    prior = [p for p in post.parts if p.name == "prior"][0]
    assert "factors" not in [p.name for p in prior.parts]


def test_phase18_rehearsal(tmp_path):
    """chip_smoke.py's phase 18 on the CPU at 24 taxa and 300 sites: 18a's
    CLI run with its likelihood evaluations counted where the card counts
    kernel launches, exactly as the phase predicts them (the start, two a
    checked step, one a step and one a log row; its profile's start and
    steps), the log read back; 18b's functions on the CPU twice."""
    import time

    import chip_smoke
    from beast_mcmc_tpu_torch.models import treelikelihood as tl

    calls = [0]
    site = tl._site_logliks

    def counted(*a, **k):
        calls[0] += 1
        return site(*a, **k)

    def reset():
        calls[0] = 0

    def read():
        return {"peel_stream": calls[0]}

    def device_ms(fn, label, n=1, top=6):
        t0 = time.perf_counter()
        fn()
        device_ms.events = 0.0
        return 1e3 * (time.perf_counter() - t0) / n, None

    out = str(tmp_path)
    tl._site_logliks = counted
    try:
        rec, launches = chip_smoke.rrw_path(
            out, reset, read, device_ms, "cpu", n_taxa=24, n_sites=300,
            n_steps=60, n_profile=3, trait_reps=2)
    finally:
        tl._site_logliks = site
    assert launches == {"P18 18a CLI": {"peel_stream": 1 + 200 + 60 + 6},
                        "P18 18a profile": {"peel_stream": 1 + 3}}
    a = rec["18a"]
    assert a["log_rows"] == 6 and a["full_evaluation_deviation"] <= 0.1
    assert len(a["root_location"]) == 2 and a["trait_ms"] > 0
    b = chip_smoke.p18_functions_path(out, "cpu")
    assert b["functions"] == 11 and b["max_rel_err"] == 0.0

"""The port's config/xml_traits.py and the parts of config/xml_hmc.py it
reaches against the JAX package's, part three: the sampled-trait mode
(every node's trait in the state) with its internalTraitGibbsOperator and
the exact Wishart draw of precisionGibbsOperator, the asymmetric-precision
route, a diagonal precision (its Gibbs substitute a scale move) under a noninformative Wishart prior, the Bayesian bridge
likelihood, the autocorrelated rates prior, latent liabilities with
newLatentLiabilityGibbsOperator, varianceProportionStatistic and the
gradient elements, each an inline 6-taxon document through the checks of
tests/test_torch_interpreter.py::check_against_jax and check_chain. Then
the Gibbs operators' proposals from these documents against JAX's at
injected draws (tests/test_torch_gibbs_ext.py::_inject), the gradient
elements' and blombergsK's reports against JAX's, and the registry's
coverage: every element and operator tag of the JAX package's registry is
registered in the port.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config.xml_assert import report_of as j_report
from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config.xml_assert import report_of

from test_torch_gibbs_ext import _inject
from test_torch_interpreter import _doc, _setup, check_against_jax, \
    check_chain
from test_torch_xml_traits_a import (
    LOC,
    RRW_OPS,
    RW,
    SCALE,
    analyses,
    rrw_models,
    trait_doc,
    with_attrs,
)
from test_torch_xml_traits_b import DIAG_PREC, FULL_PREC, REPEATED, rm_lik

ALL_NODES_TRAIT = ('<nodeTraits name="location" rootNode="true" '
                   'internalNodes="true" leafNodes="true" '
                   'traitDimension="2"><parameter id="node.location"/>'
                   '</nodeTraits></treeModel>')
SAMPLED = """<multivariateTraitLikelihood id="traitLik" traitName="location">
      <multivariateDiffusionModel idref="diffusion"/>
      <treeModel idref="treeModel"/>
      <traitParameter><parameter idref="node.location"/></traitParameter>
    </multivariateTraitLikelihood>"""
SAMPLED_OPS = """<internalTraitGibbsOperator weight="4">
      <multivariateTraitLikelihood idref="traitLik"/></internalTraitGibbsOperator>"""
VPS = """<varianceProportionStatistic id="vps" matrixRatio="{ratio}" {pop}>
      <treeModel idref="treeModel"/>
      <repeatedMeasuresModel idref="rm"/>
      <multivariateDiffusionModel idref="diffusion"/>
      <traitDataLikelihood idref="traitLik"/>
    </varianceProportionStatistic>"""
GRADIENTS = """<precisionGradient id="pg" parameter="both">
      <traitDataLikelihood idref="traitLik"/><matrixParameter idref="prec"/>
    </precisionGradient>
    <diffusionGradient id="dg">
      <precisionGradient idref="pg"/>
    </diffusionGradient>
    <branchRateGradient id="brg">
      <traitDataLikelihood idref="traitLik"/></branchRateGradient>"""
BRIDGE = """<bayesianBridgeDistribution id="bridgeDist">
      <globalScale><parameter id="bridge.global" value="0.5" lower="0.0"/></globalScale>
      <exponent><parameter id="bridge.exp" value="0.25"/></exponent>
      <localScale><parameter id="bridge.local" value="1.0" dimension="10" lower="0.0"/></localScale>
      <slabWidth><parameter id="bridge.slab" value="2.0"/></slabWidth>
    </bayesianBridgeDistribution>
    <arbitraryBranchRates id="acRates" exp="true" centerAtOne="false">
      <treeModel idref="treeModel"/>
      <rates><parameter id="ac.rates" value="0.1"/></rates>
    </arbitraryBranchRates>
    <autoCorrelatedRatesPrior id="acPrior" log="true" scaling="byTime">
      <arbitraryBranchRates idref="acRates"/>
      <bayesianBridgeDistribution idref="bridgeDist"/>
    </autoCorrelatedRatesPrior>
    <gradientWrtIncrements id="gi">
      <autoCorrelatedRatesPrior idref="acPrior"/></gradientWrtIncrements>
    <bayesianBridge id="bb">
      <parameter id="coef" value="0.3 -0.2 0.5"/>
      <globalScale><parameter id="bb.global" value="0.7" lower="0.0"/></globalScale>
      <exponent><parameter id="bb.exp" value="0.5"/></exponent>
    </bayesianBridge>"""
LIABILITY_DATA = {"a": "01", "b": "00", "c": "11", "d": "10", "e": "01",
                  "f": "11"}
LATENT = {t: " ".join(("0.4" if c == "1" else "-0.6") for c in v)
          for t, v in LIABILITY_DATA.items()}
LIABILITY = """<alignment id="bin" dataType="binary">
{seqs}
    </alignment>
    <patterns id="bpat" from="1"><alignment idref="bin"/></patterns>
    <traitDataLikelihood id="traitLik" traitName="liab">
      <multivariateDiffusionModel idref="diffusion"/>
      <treeModel idref="treeModel"/>
      <traitParameter><parameter id="latent"/></traitParameter>
      <conjugateRootPrior>
        <meanParameter><parameter value="0.0 0.0"/></meanParameter>
        <priorSampleSize><parameter value="1.0"/></priorSampleSize>
      </conjugateRootPrior>
    </traitDataLikelihood>
    <orderedLatentLiabilityLikelihood id="liability">
      <patterns idref="bpat"/>
      <treeModel idref="treeModel"/>
      <tipTrait><parameter idref="latent"/></tipTrait>
    </orderedLatentLiabilityLikelihood>""".format(seqs="\n".join(
    f'      <sequence><taxon idref="{t}"/>{v}</sequence>'
    for t, v in LIABILITY_DATA.items()))
LIABILITY_OPS = """<newLatentLiabilityGibbsOperator weight="5">
      <traitDataLikelihood idref="traitLik"/>
      <orderedLatentLiabilityLikelihood idref="liability"/>
    </newLatentLiabilityGibbsOperator>"""
DIAG = """<diagonalMatrix id="dm">
      <parameter id="dm.diag" value="0.8 0.6" lower="0.0"/></diagonalMatrix>"""


def sampled_doc():
    """Every node's trait in the state: the tips' from the attributes,
    the internal nodes' 0."""
    return trait_doc(SAMPLED, '<multivariateTraitLikelihood idref="traitLik"/>',
                     SAMPLED_OPS).replace("</treeModel>", ALL_NODES_TRAIT, 1)


DOCS_C = {
    "sampledTraits": sampled_doc(),
    "asymmetricPrecision": trait_doc(
        REPEATED.format(attrs="", prec=FULL_PREC) + rm_lik(), "",
        SCALE.format(p="samp.c1")).replace(
            '<parameter id="prec.col1" value="0.8 0.1"/>',
            '<parameter id="prec.col1" value="0.8 0.2"/>'),
    "diagonalPrecision": with_attrs(_doc(
        models=DIAG + """<multivariateDiffusionModel id="diffusion">
          <precisionMatrix><diagonalMatrix idref="dm"/></precisionMatrix>
        </multivariateDiffusionModel>
        <multivariateWishartPrior id="precPrior">
          <data><diagonalMatrix idref="dm"/></data>
        </multivariateWishartPrior>""" + rrw_models(),
        priors='<multivariateWishartPrior idref="precPrior"/>'
               '<traitDataLikelihood idref="traitLik"/>',
        ops="""<precisionGibbsOperator weight="2">
          <traitDataLikelihood idref="traitLik"/>
          <multivariateWishartPrior idref="precPrior"/>
        </precisionGibbsOperator>""" + RRW_OPS,
        logs='<parameter idref="dm.diag"/>'), LOC),
    "varianceProportion:elementWise": trait_doc(
        REPEATED.format(attrs="", prec=DIAG_PREC) + rm_lik()
        + VPS.format(ratio="elementWise", pop=""),
        '<varianceProportionStatistic idref="vps"/>',
        SCALE.format(p="samp.diag")),
    "varianceProportion:coheritability_population": trait_doc(
        REPEATED.format(attrs='scaleByTipHeight="true"', prec=FULL_PREC)
        + rm_lik() + VPS.format(ratio="coheritability",
                                pop='usePopulationVariance="true"'),
        '<varianceProportionStatistic idref="vps"/>',
        SCALE.format(p="samp.c1")),
    "gradients": trait_doc(
        rrw_models() + GRADIENTS,
        '<precisionGradient idref="pg"/><branchRateGradient idref="brg"/>',
        RRW_OPS),
    "autoCorrelatedRatesPrior": _doc(
        models=BRIDGE,
        priors='<autoCorrelatedRatesPrior idref="acPrior"/>'
               '<bayesianBridge idref="bb"/>',
        ops=RW.format(w=0.1, p="ac.rates") + RW.format(w=0.2, p="coef")
        + SCALE.format(p="bridge.global"),
        treelik='<arbitraryBranchRates idref="acRates"/>'),
    "latentLiability": with_attrs(trait_doc(
        LIABILITY, '<orderedLatentLiabilityLikelihood idref="liability"/>',
        LIABILITY_OPS,
        priors='<orderedLatentLiabilityLikelihood idref="liability"/>'),
        LATENT, "liab"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DOCS_C))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS_C[name], tmp_path)


@pytest.mark.parametrize("name", sorted(DOCS_C))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS_C[name], tmp_path)


def _operators(mod, path):
    ax, _, ops, _, params, tree = _setup(mod, path, None if mod is jinterp
                                         else "cpu")
    return {type(o).__name__: o for o in ops}, params, tree


@pytest.mark.parametrize("doc,cls,draws", [
    ("sampledTraits", "PrecisionWishartGibbsOperator",
     ([[[0.3, -1.1], [0.7, 0.2]]], [[4.0, 2.5]], [])),
    ("sampledTraits", "InternalTraitGibbsOperator",
     ([[0.4, -0.9]], [], [2])),
    ("latentLiability", "LatentLiabilityGibbsOperator", ([], [], [3])),
])
def test_gibbs_operators_match_jax_at_injected_draws(doc, cls, draws,
                                                     tmp_path, monkeypatch):
    """The operators the documents build (<precisionGibbsOperator> over
    sampled traits: the exact Wishart draw; <internalTraitGibbsOperator>;
    <newLatentLiabilityGibbsOperator>) propose JAX's state from the same
    draws."""
    path = tmp_path / "doc.xml"
    path.write_text(DOCS_C[doc])
    jops, jp, jt = _operators(jinterp, str(path))
    ops, tp, tt = _operators(interp, str(path))
    normals, gammas, ints = draws
    port_normals = None
    if cls == "LatentLiabilityGibbsOperator":
        # candidates in order, the first inside the datum's box taken by
        # both (JAX draws them one by one, the port all at once)
        k = ops[cls].max_attempts
        cand = [[0.05, 0.02], [3.0, -3.0], [8.0, -8.0], [20.0, -20.0]]
        normals = (cand + [[40.0, -40.0]] * k)[:k]
        port_normals = np.asarray(normals)
    _inject(monkeypatch, [np.asarray(n) for n in normals],
            [np.asarray(g) for g in gammas], ints, port_normals)
    j_out, _, jh = jops[cls].propose(jp, jt, jax.random.PRNGKey(0), None)
    t_out, _, th = ops[cls].propose(tp, tt, None, None)
    for k in jp:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=1e-12, atol=1e-14, err_msg=k)
    np.testing.assert_allclose(float(th), float(jh), rtol=1e-12)


def test_integrated_precision_gibbs_substitutes_match_jax(tmp_path):
    """Over an integrated likelihood the precisionGibbsOperator is JAX's
    substitute: a symmetric random walk on the matrix's columns, or a
    scale move on a diagonal precision's parameter."""
    for name, cls, target in (
            ("gradients", "SymmetricMatrixRWOperator", ("prec.col1",
                                                        "prec.col2")),
            ("diagonalPrecision", "ScaleOperator", "dm.diag")):
        path = tmp_path / f"{name}.xml"
        path.write_text(DOCS_C[name])
        for mod in (jinterp, interp):
            ops = _setup(mod, str(path), None if mod is jinterp
                         else "cpu")[2]
            assert [o for o in ops if type(o).__name__ == cls and getattr(
                o, "col_names", getattr(o, "parameter", None)) == target]


NUM = r"-?\d+\.?\d*(?:e[-+]?\d+)?"


@pytest.mark.parametrize("doc,eid", [
    ("gradients", "pg"), ("gradients", "dg"), ("gradients", "brg"),
    ("autoCorrelatedRatesPrior", "gi"), ("sampledTraits", "kstat"),
    ("varianceProportion:elementWise", "vps"),
    ("varianceProportion:coheritability_population", "vps"),
])
def test_reports_equal_jax(doc, eid, tmp_path):
    """The gradient elements' reports (the analytic gradient to 1e-10;
    the central differences and the diagonal Hessian, whose step of 1e-5
    amplifies round-off, to 1e-4), blombergsK's and
    varianceProportionStatistic's, against JAX's."""
    xml = DOCS_C[doc]
    if eid == "kstat":
        xml = trait_doc(rrw_models(), "", RRW_OPS).replace(
            "</beast>", '<blombergsK id="kstat">'
            '<traitDataLikelihood idref="traitLik"/></blombergsK></beast>')
    jax_ax, ax = analyses(tmp_path, xml)
    got, want = report_of(ax, ax._ids[eid]), j_report(jax_ax,
                                                      jax_ax._ids[eid])
    assert re.sub(NUM, "#", got) == re.sub(NUM, "#", want)
    first = want.split("numeric")[0]
    n_first = len(re.findall(NUM, first))
    g, w = (np.array(re.findall(NUM, r), float) for r in (got, want))
    np.testing.assert_allclose(g[:n_first], w[:n_first], rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-8)


def test_branch_rate_gradient_wrt_increments_equals_jax(tmp_path):
    """branchRateGradientWrtIncrements over the relaxed-random-walk trait
    likelihood's rate gradient, with the autocorrelated prior's log units
    and time scaling, against JAX's."""
    xml = trait_doc(rrw_models() + GRADIENTS + """
      <bayesianBridgeDistribution id="bd2">
        <globalScale><parameter value="0.5"/></globalScale>
        <exponent><parameter value="0.25"/></exponent>
      </bayesianBridgeDistribution>
      <autoCorrelatedRatesPrior id="ac2" log="true" scaling="byTime">
        <arbitraryBranchRates idref="rrw"/>
        <bayesianBridgeDistribution idref="bd2"/>
      </autoCorrelatedRatesPrior>
      <branchRateGradientWrtIncrements id="bgi">
        <branchRateGradient idref="brg"/></branchRateGradientWrtIncrements>""",
        "", RRW_OPS, priors='<autoCorrelatedRatesPrior idref="ac2"/>')
    jax_ax, ax = analyses(tmp_path, xml)
    for a in (jax_ax, ax):
        a.build(a._ids["ac2"])
    got = ax.build(ax._ids["bgi"]).analytic(ax)
    want = jax_ax.build(jax_ax._ids["bgi"]).analytic(jax_ax)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_wishart_prior_densities_equal_jax(tmp_path):
    """<multivariateWishartPrior> with a scale matrix and without
    (noninformative), at a positive definite and an indefinite matrix
    (-inf in both)."""
    xml = DOCS_C["gradients"].replace("</beast>", """
      <multivariateWishartPrior id="flat">
        <data><matrixParameter idref="prec"/></data>
      </multivariateWishartPrior></beast>""")
    jax_ax, ax = analyses(tmp_path, xml)
    for pid in ("precPrior", "flat"):
        jl, tl = jax_ax.build(jax_ax._ids[pid]), ax.build(ax._ids[pid])
        for cols in (([0.8, 0.1], [0.1, 0.6]), ([0.2, 0.9], [0.9, 0.3])):
            p = {n: np.asarray(v.value) for n, v in ax._params.items()}
            p.update({"prec.col1": np.array(cols[0]),
                      "prec.col2": np.array(cols[1])})
            want = float(jl.fn({k: jnp.asarray(v) for k, v in p.items()},
                               None))
            got = float(tl.fn({k: torch.tensor(v, dtype=torch.float64)
                               for k, v in p.items()}, None))
            if np.isinf(want):
                assert got == want
            else:
                np.testing.assert_allclose(got, want, rtol=1e-12)


def test_extension_registry_names_no_ported_tag():
    """Every element tag of JAX's _BUILDERS and operator tag of its _OP_EXT
    is registered in the port (config/xml_factor.py's and xml_field.py's,
    the last two modules, among them), and the registry of unported
    modules is gone."""
    assert set(jinterp._BUILDERS) <= set(interp._BUILDERS)
    assert set(jinterp._OP_EXT) <= set(interp._OP_EXT)
    for gone in ("EXTENSION_TAGS", "EXTENSION_OPERATORS", "QUEUE_ITEMS",
                 "unported"):
        assert not hasattr(interp, gone)
    for tag in ("traitDataLikelihood", "arbitraryBranchRates",
                "traitLogger", "blombergsK", "continuousDiffusionStatistic",
                "multivariateWishartPrior", "compoundEigenMatrix",
                "latentFactorModel", "randomField", "determinantPrior"):
        assert tag in interp._BUILDERS
    for tag in ("precisionGibbsOperator", "internalTraitGibbsOperator",
                "newLatentLiabilityGibbsOperator", "loadingsGibbsOperator",
                "integratedFactorsGibbsOperator"):
        assert tag in interp._OP_EXT

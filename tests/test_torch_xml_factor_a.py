"""The port's config/xml_factor.py against the JAX package's, part a: the
documents. Phylogenetic factor analysis on 6 taxa with 4 traits (NA
entries among them) and 2 factors: the integrated route with HMC on the
loadings (integratedFactorAnalysisLoadingsGradient), Bayesian-bridge row
priors with the multiplicative-gamma Gibbs move and the joint draw of the
tips' factors (chip_smoke.py phase 20a at 6 taxa); the sampled route (a
latentFactorModel with the loadings Gibbs move, optionally upper
triangular, and the tip-factor draw); scaled loadings with their scale's
Gibbs move; the small densities (determinantPrior, multivariateGamma
Likelihood, dirichletParameterPrior, normalMatrixNormLikelihood); the
latent liabilities over an integrated factor model with
extendedLatentLiabilityGibbsOperator.

Each document goes through tests/test_torch_interpreter.py::
check_against_jax (parameters, start tree, log columns, the posterior and
every component at 6 states, 1e-10 relative), the operators each package
builds agree (tests/test_torch_xml_hmc_a.py::check_operators), the HMC
target gradients equal jax.grad's, and the port's chain passes the 0.1
full-evaluation check (check_chain). Parts b and c hold the operators'
laws, the gradient elements and the reports.
"""

import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu_torch.config import interpreter as interp

from test_torch_interpreter import _doc, _setup, check_against_jax, \
    check_chain
from test_torch_xml_hmc_a import _fields, check_target_gradients
from test_torch_xml_traits_a import with_attrs
from test_torch_xml_traits_c import LIABILITY_DATA, LATENT

TRAITS4 = {"a": "0.5 1.2 -0.3 0.8", "b": "0.7 NA -0.1 0.4",
           "c": "-0.2 0.4 0.9 NA", "d": "1.1 0.8 NA -0.6",
           "e": "0.3 -0.6 0.2 0.1", "f": "0.0 0.1 0.4 -0.2"}
TRUE4 = {"a": "0.5 1.2 -0.3 0.8", "b": "0.7 0.9 -0.1 0.4",
         "c": "-0.2 0.4 0.9 0.3", "d": "1.1 0.8 NA -0.6",
         "e": "0.3 -0.6 0.2 0.1", "f": "0.0 0.1 0.4 -0.2"}

LOADINGS = """<matrixParameter id="L">
      <parameter id="L.1" value="1.0 0.5 -0.3 0.2"/>
      <parameter id="L.2" value="0.0 0.8 0.4 -0.5"/>
    </matrixParameter>
    <parameter id="factorPrec" value="2.0 3.0 1.5 2.5" lower="0.0"/>"""
INTEGRATED = """<matrixParameter id="fprec">
      <parameter id="fprec.c1" value="1.0 0.0"/>
      <parameter id="fprec.c2" value="0.0 1.0"/>
    </matrixParameter>
    <multivariateDiffusionModel id="fdiff">
      <precisionMatrix><matrixParameter idref="fprec"/></precisionMatrix>
    </multivariateDiffusionModel>
    <integratedFactorModel id="factors" traitName="traits" {attrs}>
      <treeModel idref="treeModel"/>
      <traitParameter><parameter id="leaf.traits"/></traitParameter>
      <loadings><matrixParameter idref="L"/></loadings>
      <precision><parameter idref="factorPrec"/></precision>
    </integratedFactorModel>
    <traitDataLikelihood id="traitLik" traitName="traits">
      <multivariateDiffusionModel idref="fdiff"/>
      <treeModel idref="treeModel"/>
      <integratedFactorModel idref="factors"/>
      <conjugateRootPrior>
        <meanParameter><parameter value="0.0 0.0"/></meanParameter>
        <priorSampleSize><parameter id="fpss" value="0.5"/></priorSampleSize>
      </conjugateRootPrior>
    </traitDataLikelihood>
    <parameter id="F" value="0.0"/>"""
SHRINKAGE = """<parameter id="delta.1" value="1.0" lower="0.0"/>
    <parameter id="delta.2" value="1.5" lower="0.0"/>
    <productParameter id="gs1"><parameter idref="delta.1"/></productParameter>
    <productParameter id="gs2"><parameter idref="delta.1"/><parameter idref="delta.2"/></productParameter>
    <matrixShrinkageLikelihood id="shrink">
      <matrixParameter idref="L"/>
      <rowPriors>
        <bayesianBridge id="bb1"><parameter idref="L.1"/>
          <globalScale><productParameter idref="gs1"/></globalScale>
          <exponent><parameter value="0.5"/></exponent>
          <localScale><parameter id="ls1" value="1.0 1.2 0.8 1.1" lower="0.0"/></localScale>
        </bayesianBridge>
        <bayesianBridge id="bb2"><parameter idref="L.2"/>
          <globalScale><productParameter idref="gs2"/></globalScale>
          <exponent><parameter value="0.5"/></exponent>
          <localScale><parameter id="ls2" value="0.9 1.0 1.3 0.7" lower="0.0"/></localScale>
        </bayesianBridge>
      </rowPriors>
    </matrixShrinkageLikelihood>
    <multiplicativeGammaGibbsProvider id="mgp">
      <compoundParameter><parameter idref="delta.1"/><parameter idref="delta.2"/></compoundParameter>
      <matrixShrinkageLikelihood idref="shrink"/>
    </multiplicativeGammaGibbsProvider>
    <gammaPrior id="deltaPrior1" shape="2.0" scale="1.0"><parameter idref="delta.1"/></gammaPrior>
    <gammaPrior id="deltaPrior2" shape="2.0" scale="1.0"><parameter idref="delta.2"/></gammaPrior>"""
SHRINKAGE_PRIORS = ('<matrixShrinkageLikelihood idref="shrink"/>'
                    '<gammaPrior idref="deltaPrior1"/>'
                    '<gammaPrior idref="deltaPrior2"/>')
INTEGRATED_OPS = """<hamiltonianMonteCarloOperator weight="3" nSteps="5" stepSize="0.05"
        drawVariance="1.0" autoOptimize="true">
      <jointGradient id="loadingsGradient">
        <integratedFactorAnalysisLoadingsGradient id="ilg">
          <integratedFactorModel idref="factors"/>
          <traitDataLikelihood idref="traitLik"/>
        </integratedFactorAnalysisLoadingsGradient>
      </jointGradient>
      <matrixParameter idref="L"/>
    </hamiltonianMonteCarloOperator>
    <normalGammaPrecisionGibbsOperator id="mgpOp" weight="1">
      <multiplicativeGammaGibbsProvider idref="mgp"/>
      <prior><gammaPrior shape="2.0" scale="1.0"/></prior>
    </normalGammaPrecisionGibbsOperator>
    <integratedFactorsGibbsOperator id="factorDraw" weight="2">
      <integratedFactorModel idref="factors"/>
      <traitDataLikelihood idref="traitLik"/>
      <parameter idref="F"/>
    </integratedFactorsGibbsOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="factorPrec"/></scaleOperator>"""
PRECISION_GRADIENTS = """<integratedFactorAnalysisPrecisionGradient id="ipg">
      <integratedFactorModel idref="factors"/><traitDataLikelihood idref="traitLik"/>
    </integratedFactorAnalysisPrecisionGradient>
    <integratedFactorAnalysisLoadingsAndPrecisionGradient id="ilpg">
      <integratedFactorModel idref="factors"/><traitDataLikelihood idref="traitLik"/>
    </integratedFactorAnalysisLoadingsAndPrecisionGradient>"""
LATENT_MODEL = """<dataFromTreeTips id="tipData" traitName="traits">
      <treeModel idref="treeModel"/>
      <traitParameter><parameter idref="leaf.traits"/></traitParameter>
    </dataFromTreeTips>
    <latentFactorModel id="lfm" {attrs}>
      <factors><parameter idref="F"/></factors>
      <loadings><{loadings}/></loadings>
      <columnPrecision><parameter idref="factorPrec"/></columnPrecision>
      <data><dataFromTreeTips idref="tipData"/></data>
    </latentFactorModel>
    <factorProportionStatistic id="fps"><latentFactorModel idref="lfm"/></factorProportionStatistic>"""
LOADINGS_PRIOR = """<independentNormalDistributionModel id="Lprior">
      <mean><parameter id="Lprior.mean" value="0.0 0.1 0.0 -0.1 0.0 0.0 0.2 0.0"/></mean>
      <precision><parameter id="Lprior.prec" value="1.0 2.0 1.0 1.5 1.0 1.0 0.5 1.0"/></precision>
      <data><matrixParameter idref="L"/></data>
    </independentNormalDistributionModel>"""
SAMPLED_OPS = """<loadingsGibbsOperator id="loadingsOp" weight="2" {sparsity}>
      <latentFactorModel idref="lfm"/>
      <independentNormalDistributionModel idref="Lprior"/>
    </loadingsGibbsOperator>
    <integratedFactorsGibbsOperator weight="2">
      <integratedFactorModel idref="factors"/>
      <traitDataLikelihood idref="traitLik"/>
      <parameter idref="F"/>
    </integratedFactorsGibbsOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="factorPrec"/></scaleOperator>"""
SCALED = """<matrixParameter id="U">
      <parameter id="U.1" value="1.0 0.5 -0.3 0.2"/>
      <parameter id="U.2" value="0.1 0.8 0.4 -0.5"/>
    </matrixParameter>
    <parameter id="Ls" value="1.0 0.7"/>
    <scaledMatrixParameter id="Lsc">
      <matrix><matrixParameter idref="U"/></matrix>
      <scale><parameter idref="Ls"/></scale>
    </scaledMatrixParameter>
    <normalPrior id="scalePrior" mean="0.0" stdev="1.0"><parameter idref="Ls"/></normalPrior>"""
SCALED_GRADIENTS = """<sampledLoadingsGradient id="slg"><latentFactorModel idref="lfm"/></sampledLoadingsGradient>
    <scaledMatrixGradient id="smgScale" component="scale"><sampledLoadingsGradient idref="slg"/></scaledMatrixGradient>
    <scaledMatrixGradient id="smgMatrix" component="matrix"><sampledLoadingsGradient idref="slg"/></scaledMatrixGradient>"""
SCALED_OPS = """<loadingsScaleGibbsOperator id="scaleOp" weight="2">
      <latentFactorModel idref="lfm"/>
      <normalPrior idref="scalePrior"/>
    </loadingsScaleGibbsOperator>
    <randomWalkOperator windowSize="0.2" weight="1"><parameter idref="U.1"/></randomWalkOperator>
    <randomWalkOperator windowSize="0.2" weight="1"><parameter idref="F"/></randomWalkOperator>"""
DENSITIES = """<matrixParameter id="M">
      <parameter id="M.1" value="2.0 0.3"/><parameter id="M.2" value="0.4 1.5"/>
    </matrixParameter>
    <determinantPrior id="detPrior" shapeParameter="2.0"><matrixParameter idref="M"/></determinantPrior>
    <parameter id="gx" value="0.5 1.2 2.0" lower="0.0"/>
    <multivariateGammaLikelihood id="mvg">
      <data><parameter idref="gx"/></data>
      <scale><parameter value="1.5"/></scale>
      <shape><parameter value="2.0 3.0 1.5"/></shape>
    </multivariateGammaLikelihood>
    <parameter id="w" value="0.2 0.3 0.5"/>
    <dirichletParameterPrior id="dir">
      <data><parameter idref="w"/></data>
      <countsParameter><parameter value="1.5 2.0 3.0"/></countsParameter>
    </dirichletParameterPrior>
    <normalMatrixNormLikelihood id="mnorm">
      <globalPrecision><parameter id="gprec" value="1.5 0.8" lower="0.0"/></globalPrecision>
      <matrix><matrixParameter idref="M"/></matrix>
    </normalMatrixNormLikelihood>
    <multiplicativeGammaGibbsProvider id="mgp2">
      <compoundParameter><parameter id="d2.1" value="1.0"/><parameter id="d2.2" value="1.2"/></compoundParameter>
      <normalMatrixNormLikelihood idref="mnorm"/>
    </multiplicativeGammaGibbsProvider>"""
DENSITY_PRIORS = ('<determinantPrior idref="detPrior"/>'
                  '<multivariateGammaLikelihood idref="mvg"/>'
                  '<dirichletParameterPrior idref="dir"/>'
                  '<normalMatrixNormLikelihood idref="mnorm"/>')
DENSITY_OPS = """<randomWalkOperator windowSize="0.1" weight="1"><parameter idref="M.1"/></randomWalkOperator>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="gx"/></scaleOperator>
    <deltaExchange delta="0.05" weight="1"><parameter idref="w"/></deltaExchange>
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="gprec"/></scaleOperator>"""
LIABILITY_FACTOR = """<alignment id="bin" dataType="binary">
{seqs}
    </alignment>
    <patterns id="bpat" from="1"><alignment idref="bin"/></patterns>
    <matrixParameter id="lfprec"><parameter value="1.0"/></matrixParameter>
    <multivariateDiffusionModel id="ldiff">
      <precisionMatrix><matrixParameter idref="lfprec"/></precisionMatrix>
    </multivariateDiffusionModel>
    <integratedFactorModel id="lfactors" traitName="liab">
      <treeModel idref="treeModel"/>
      <traitParameter><parameter id="latent"/></traitParameter>
      <loadings><matrixParameter id="LL"><parameter id="LL.1" value="1.0 0.6"/></matrixParameter></loadings>
      <precision><parameter id="lprec" value="2.0 2.5" lower="0.0"/></precision>
    </integratedFactorModel>
    <traitDataLikelihood id="traitLik" traitName="liab">
      <multivariateDiffusionModel idref="ldiff"/>
      <treeModel idref="treeModel"/>
      <integratedFactorModel idref="lfactors"/>
      <conjugateRootPrior>
        <meanParameter><parameter value="0.0"/></meanParameter>
        <priorSampleSize><parameter id="lpss" value="1.0"/></priorSampleSize>
      </conjugateRootPrior>
    </traitDataLikelihood>
    <orderedLatentLiabilityLikelihood id="liability">
      <patterns idref="bpat"/>
      <treeModel idref="treeModel"/>
      <tipTrait><parameter idref="latent"/></tipTrait>
    </orderedLatentLiabilityLikelihood>""".format(seqs="\n".join(
    f'      <sequence><taxon idref="{t}"/>{v}</sequence>'
    for t, v in LIABILITY_DATA.items()))
LIABILITY_OPS = """<extendedLatentLiabilityGibbsOperator id="liabOp" weight="4">
      <traitDataLikelihood idref="traitLik"/>
      <orderedLatentLiabilityLikelihood idref="liability"/>
    </extendedLatentLiabilityGibbsOperator>"""


def factor_doc(models, priors, ops, logs="", attrs="", values=TRAITS4):
    """A 6-taxon document with the loadings L, the residual precision and
    the integrated factor model's trait likelihood `traitLik` built ahead
    of `models`, trait values `values` under the taxon attribute
    "traits"."""
    return with_attrs(_doc(
        models=LOADINGS + INTEGRATED.format(attrs=attrs) + models,
        priors=priors, ops=ops, logs=logs), values, "traits")


def latent_model(attrs="", loadings='matrixParameter idref="L"'):
    return LATENT_MODEL.format(attrs=attrs, loadings=loadings)


DOCS = {
    "integrated_hmc_shrinkage": factor_doc(
        SHRINKAGE + PRECISION_GRADIENTS,
        '<traitDataLikelihood idref="traitLik"/>' + SHRINKAGE_PRIORS,
        INTEGRATED_OPS,
        logs='<traitDataLikelihood idref="traitLik"/>'
             '<matrixShrinkageLikelihood idref="shrink"/>'
             '<parameter idref="delta.1"/>'),
    "integrated_standardized": factor_doc(
        SHRINKAGE, '<traitDataLikelihood idref="traitLik"/>'
        + SHRINKAGE_PRIORS, INTEGRATED_OPS, attrs='standardize="true"'),
    "latent_factor_gibbs": factor_doc(
        latent_model() + LOADINGS_PRIOR,
        '<latentFactorModel idref="lfm"/>'
        '<independentNormalDistributionModel idref="Lprior"/>',
        SAMPLED_OPS.format(sparsity=""),
        logs='<latentFactorModel idref="lfm"/>'),
    "latent_factor_upper_triangular_scaled_data": factor_doc(
        latent_model('scaleData="true"') + LOADINGS_PRIOR,
        '<latentFactorModel idref="lfm"/>'
        '<independentNormalDistributionModel idref="Lprior"/>',
        SAMPLED_OPS.format(sparsity='sparsity="upperTriangular"')),
    "scaled_loadings": factor_doc(
        SCALED + latent_model('scaleData="true"',
                              'scaledMatrixParameter idref="Lsc"')
        + SCALED_GRADIENTS,
        '<latentFactorModel idref="lfm"/><normalPrior idref="scalePrior"/>',
        SCALED_OPS),
    "small_densities": factor_doc(DENSITIES, DENSITY_PRIORS, DENSITY_OPS,
                                  logs=DENSITY_PRIORS),
    "extended_liability": with_attrs(_doc(
        models=LIABILITY_FACTOR,
        priors='<traitDataLikelihood idref="traitLik"/>'
               '<orderedLatentLiabilityLikelihood idref="liability"/>',
        ops=LIABILITY_OPS), LATENT, "liab"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# JAX's liability operator is a class local to its builder
JAX_CLASS = {"ExtendedLatentLiabilityGibbsOperator": "_Op"}


def check_operators(xml, tmp_path):
    """The operators each package builds: the same classes, in order, with
    the same settings (tests/test_torch_xml_hmc_a.py::check_operators)."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    jops = _setup(jinterp, str(path))[2]
    ops = _setup(interp, str(path), "cpu")[2]
    assert [JAX_CLASS.get(type(o).__name__, type(o).__name__)
            for o in ops] == [type(o).__name__ for o in jops]
    for o, jo in zip(ops, jops):
        assert _fields(o) == _fields(jo), type(o).__name__


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS[name], tmp_path)
    check_operators(DOCS[name], tmp_path)
    if "hmc" in name:
        assert check_target_gradients(DOCS[name], tmp_path) == 1


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)

"""The port's config/xml_ext.py against the JAX package's, document by
document: the priors, likelihood wrappers and parameter views.

Each document is the 6-taxon document of tests/test_torch_interpreter.py
with the tag under test added. Both packages build it (the port on the CPU
in float64, JAX under x64) and tests/test_torch_interpreter.py::
check_against_jax holds the starting state, tree, log columns and every
posterior component at the start and at 5 perturbed states to 1e-10
relative (JAX's under jax.jit); then 200 states of the port's chain run
under the 0.1 full-evaluation check. The skygrid, skyride and tree-source
documents are tests/test_torch_xml_ext_b.py's, the clocks, Dollo,
birth-death, OU and statistics documents tests/test_torch_xml_ext_c.py's,
so that three test workers share the JAX compilations.
"""

import pytest
import torch

from test_torch_interpreter import _doc, check_against_jax, check_chain

KAPPA = '<parameter idref="kappa"/>'
RW = ('<randomWalkOperator windowSize="{w}" weight="2">'
      '<parameter idref="{p}"/></randomWalkOperator>')
SCALE = ('<scaleOperator scaleFactor="0.75" weight="2">'
         '<parameter idref="{p}"/></scaleOperator>')

# -- group a: priors, likelihood wrappers, parameter views ------------------
MVN = """<multivariateNormalPrior id="mvn">
      <meanParameter><parameter value="0.5 -0.5"/></meanParameter>
      <precisionParameter><matrixParameter>
        <parameter value="2.0 0.5"/><parameter value="0.5 1.0"/>
      </matrixParameter></precisionParameter>
      <data><parameter id="mv.x" value="0.2 0.1"/></data>
    </multivariateNormalPrior>"""

DOCS_A = {
    "halfTPrior": dict(priors=f'<halfTPrior scale="2.0" df="3">{KAPPA}'
                              '</halfTPrior>'),
    "halfNormalPrior": dict(priors='<halfNormalPrior mean="0.0" '
                                   f'stdev="3.0">{KAPPA}</halfNormalPrior>'),
    "cachedPrior": dict(priors=f"""<cachedPrior>
        <gammaPrior shape="2.0" scale="1.5" offset="0.0">{KAPPA}</gammaPrior>
        {KAPPA}</cachedPrior>"""),
    "compoundLikelihood": dict(
        priors=f"""<compoundLikelihood id="cl">
          <normalPrior mean="1.0" stdev="2.0">{KAPPA}</normalPrior>
          <exponentialPrior mean="2.0" offset="0.0">
            <parameter idref="constant.popSize"/></exponentialPrior>
        </compoundLikelihood>""",
        logs='<compoundLikelihood idref="cl"/>'),
    "dummyModel": dict(priors=f'<dummyModel id="dm">{KAPPA}</dummyModel>'),
    "binomialLikelihood": dict(
        priors="""<binomialLikelihood id="bin">
          <proportion><parameter id="bin.p" value="0.3" lower="0.0" upper="1.0"/></proportion>
          <trials><parameter id="bin.n" value="5"/></trials>
          <counts><parameter id="bin.k" value="2 3 1"/></counts>
        </binomialLikelihood>""",
        ops=RW.format(w=0.05, p="bin.p")),
    "empiricalDistributionLikelihood": dict(
        priors=f"""<empiricalDistributionLikelihood>
          <grid>
            <logLikelihood><parameter value="-3.0 -1.0 -0.5 -1.2 -4.0"/></logLikelihood>
            <value><parameter value="0.5 1.5 2.0 3.0 6.0"/></value>
          </grid>
          <data>{KAPPA}</data>
        </empiricalDistributionLikelihood>"""),
    "LKJCorrelationPrior:cholesky": dict(
        priors="""<LKJCorrelationPrior shapeParameter="2.0" dimension="3">
          <data><parameter id="lkj.x" value="0.1 0.2 0.3"/></data>
        </LKJCorrelationPrior>""",
        ops=RW.format(w=0.05, p="lkj.x")),
    "LKJCorrelationPrior:correlation3": dict(
        priors="""<LKJCorrelationPrior shapeParameter="1.0" cholesky="false">
          <data><parameter id="lkj.x" value="0.1 0.2 0.3"/></data>
        </LKJCorrelationPrior>""",
        ops=RW.format(w=0.05, p="lkj.x")),
    "LKJCorrelationPrior:correlation4": dict(
        priors="""<LKJCorrelationPrior shapeParameter="1.0" cholesky="false"
            dimension="4">
          <data><parameter id="lkj.x" value="0.1 0.2 0.1 -0.1 0.05 0.2"/></data>
        </LKJCorrelationPrior>""",
        ops=RW.format(w=0.02, p="lkj.x")),
    "sphericalBetaPrior": dict(
        priors="""<sphericalBetaPrior shapeParameter="2.5" dimension="2">
          <data><parameter id="sb.x" value="0.1 0.2 -0.3 0.4"/></data>
        </sphericalBetaPrior>""",
        ops=RW.format(w=0.05, p="sb.x")),
    "maskedParameter": dict(
        priors="""<normalPrior mean="1.0" stdev="2.0">
          <maskedParameter id="mp.view">
            <parameter id="mp.v" value="0.5 1.5 2.5 3.5"/>
            <mask><parameter value="1 0 1 0"/></mask>
          </maskedParameter></normalPrior>""",
        ops=RW.format(w=0.3, p="mp.v"),
        logs='<maskedParameter idref="mp.view"/>'),
    "transformedParameter": dict(
        priors="""<normalPrior mean="0.5" stdev="1.0">
          <transformedParameter id="tp.log">
            <parameter idref="kappa"/><transform type="log"/>
          </transformedParameter></normalPrior>""",
        ops="""<transformedParameterRandomWalkOperator windowSize="0.3"
            weight="2"><transformedParameter idref="tp.log"/>
          </transformedParameterRandomWalkOperator>""",
        logs='<transformedParameter idref="tp.log"/>'),
    "transformedMultivariateParameter": dict(
        priors="""<normalPrior mean="0.0" stdev="0.5">
          <transformedMultivariateParameter id="corr" inverse="true">
            <parameter id="cpc" value="0.1 0.2 0.3"/>
            <LKJTransform dimension="3"/>
          </transformedMultivariateParameter></normalPrior>""",
        ops=RW.format(w=0.1, p="cpc")),
    "transformedVectorSumTransform": dict(
        priors="""<normalPrior mean="1.0" stdev="1.0">
          <transformedVectorSumTransform id="vs"
              incrementTransformType="log">
            <parameter id="vs.inc" value="0.1 0.2 -0.1"/>
          </transformedVectorSumTransform></normalPrior>""",
        ops=RW.format(w=0.1, p="vs.inc")),
    "ellipticalSliceSampler+mvnOperator": dict(
        priors=MVN,
        ops="""<ellipticalSliceSampler weight="2">
          <parameter idref="mv.x"/><multivariateNormalPrior idref="mvn"/>
        </ellipticalSliceSampler>
        <mvnOperator scaleFactor="0.5" weight="1">
          <parameter idref="mv.x"/>
          <varMatrix><parameter id="mv.var" value="1.0 0.2 0.2 1.0"/></varMatrix>
        </mvnOperator>"""),
}


def ext_documents(docs):
    return {name: _doc(**kw) for name, kw in docs.items()}


DOCS = ext_documents(DOCS_A)


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


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)

"""The port's config/xml_ext.py against the JAX package's: the skygrid
likelihoods (numGridPoints and cutOff, or gridPoints), the GMRF block
updates of a skygrid and a time-aware skyride, the coalescent intervals,
and the starting-tree sources <tree>, <upgmaTree> and
<neighborJoiningTree>, with the checks of tests/test_torch_xml_ext_a.py
(tests/test_torch_interpreter.py::check_against_jax and check_chain)."""

import pytest
import torch

from test_torch_interpreter import SKY, check_against_jax, check_chain
from test_torch_xml_ext_a import RW, SCALE, ext_documents

SKYGRID = """<{tag} id="skygrid">
      <populationSizes><parameter id="sg.logPop" dimension="4" value="-1.0"/></populationSizes>
      <precisionParameter><parameter id="sg.prec" value="1.0" lower="0.0"/></precisionParameter>
      {grid}
      <populationTree><treeModel idref="treeModel"/></populationTree>
    </{tag}>"""
GRID_N = ('<numGridPoints><parameter value="3"/></numGridPoints>'
          '<cutOff><parameter value="0.3"/></cutOff>')
GRID_P = '<gridPoints><parameter value="0.05 0.1 0.2"/></gridPoints>'
SKY_OPS = RW.format(w=0.5, p="sg.logPop") + SCALE.format(p="sg.prec")
BLOCK = """<{op} scaleFactor="2.0" weight="4">
      <{tag} idref="{sid}"/></{op}>"""


def _skygrid(tag, grid, ops=SKY_OPS, logs=""):
    return dict(models=SKYGRID.format(tag=tag, grid=grid),
                tree_prior=f'<{tag} idref="skygrid"/>', ops=ops,
                logs=f'<{tag} idref="skygrid"/>' + logs)


# a starting tree on the dated tips of the document
SIMPLE_TREE = """<tree id="simple">
      <node height="0.5">
        <node height="0.2">
          <node height="0.05">
            <node height="0.0"><taxon idref="a"/></node>
            <node height="0.01"><taxon idref="b"/></node>
          </node>
          <node height="0.03"><taxon idref="c"/></node>
        </node>
        <node height="0.3">
          <node height="0.02"><taxon idref="d"/></node>
          <node height="0.1">
            <node height="0.0"><taxon idref="e"/></node>
            <node height="0.04"><taxon idref="f"/></node>
          </node>
        </node>
      </node>
    </tree>"""
DISTANCE_TREE = """<{tag} id="simple">
      <distanceMatrix correction="JC"><patterns idref="patterns"/></distanceMatrix>
    </{tag}>"""

DOCS_B = {
    "gmrfSkyGridLikelihood": _skygrid(
        "gmrfSkyGridLikelihood", GRID_N,
        logs='<coalescentIntervals id="ci"><gmrfSkyGridLikelihood '
             'idref="skygrid"/></coalescentIntervals>'),
    "skyGridLikelihood": _skygrid("skyGridLikelihood", GRID_P),
    "skyGridPopSizeLikelihood": _skygrid("skyGridPopSizeLikelihood", GRID_N),
    "gmrfGridBlockUpdateOperator": _skygrid(
        "gmrfSkyGridLikelihood", GRID_N,
        ops=BLOCK.format(op="gmrfGridBlockUpdateOperator",
                         tag="gmrfSkyGridLikelihood", sid="skygrid")),
    "gmrfBlockUpdateOperator:skyride": dict(
        models=SKY["skyride_time_aware"],
        tree_prior='<gmrfSkyrideLikelihood idref="skyride"/>',
        ops=BLOCK.format(op="gmrfBlockUpdateOperator",
                         tag="gmrfSkyrideLikelihood", sid="skyride")),
}


def _with_source(xml, block):
    """The document with its tree model started from `block` (id
    "simple") instead of the coalescent simulation."""
    return xml.replace('<coalescentTree idref="startingTree"/>',
                       '<tree idref="simple"/>').replace(
        "</coalescentLikelihood>", "</coalescentLikelihood>\n  " + block, 1)


DOCS = ext_documents(DOCS_B)
DOCS["tree"] = _with_source(ext_documents({"x": {}})["x"], SIMPLE_TREE)
for _tag in ("upgmaTree", "neighborJoiningTree"):
    DOCS[_tag] = _with_source(ext_documents({"x": {}})["x"], DISTANCE_TREE
                              .format(tag=_tag)).replace(
        '<tree idref="simple"/>', f'<{_tag} idref="simple"/>')


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

"""The port's XML interpreter against the JAX package's, document by
document.

For each document both packages build their XmlAnalysis (the port's on the
CPU in float64, JAX's under x64) up to the chain: the parameter names and
starting values, the starting tree (the coalescent simulator's draws from
the same numpy stream), the log posterior and every component of it at the
start and at 5 perturbed states (JAX's under jax.jit, as its chain
evaluates them), and the log columns' names and starting values must agree
(values to 1e-10 relative). Then each document's chain runs in the port
with the 0.1 full-evaluation check. The documents here: the stepwise and
linear skylines and the time-aware and uniform skyrides, Yule and
birth-death speciation, and the conjugate <distributionLikelihood> of
tests/test_distribution_likelihood_xml.py, whose posterior mean must fall
within 4 Monte Carlo standard errors of its analytic value. The nine
demographics of tests/test_demographics_xml.py are
tests/test_torch_interpreter_demographics.py's, the five clock tags and
the eleven prior tags tests/test_torch_interpreter_clocks.py's (the same
checks, in files that the test workers run beside this one).
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.tree.topology import make_tree_state as j_tree_state

from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.inference.trace import analyze
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from test_demographics_xml import DATED, DATED_TAXA, DEMOGRAPHICS, TEMPLATE
from test_distribution_likelihood_xml import XML as CONJUGATE_XML

REL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _demographic_doc(name):
    block, ref = DEMOGRAPHICS[name]
    xml = TEMPLATE.format(demographic=textwrap.dedent(block), modelref=ref)
    if name in DATED:
        xml = xml.replace("""<taxa id="taxa">
    <taxon id="a"/><taxon id="b"/><taxon id="c"/><taxon id="d"/>
  </taxa>""", DATED_TAXA)
    return xml


# a 6-taxon dated document; {models} sits before the likelihoods,
# {treelik} inside <treeLikelihood>, {tree_prior} and {priors} inside
# <prior>, {ops} inside <operators>, {logs} inside <log>
BASE = """<?xml version="1.0" standalone="yes"?>
<beast>
  <taxa id="taxa">
    <taxon id="a"><date value="0.00" direction="backwards"/></taxon>
    <taxon id="b"><date value="0.01" direction="backwards"/></taxon>
    <taxon id="c"><date value="0.03" direction="backwards"/></taxon>
    <taxon id="d"><date value="0.02" direction="backwards"/></taxon>
    <taxon id="e"><date value="0.00" direction="backwards"/></taxon>
    <taxon id="f"><date value="0.04" direction="backwards"/></taxon>
  </taxa>
  <taxa id="clade"><taxon idref="a"/><taxon idref="b"/><taxon idref="c"/></taxa>
  <taxa id="pair"><taxon idref="e"/><taxon idref="f"/></taxa>
  <alignment id="alignment" dataType="nucleotide">
    <sequence><taxon idref="a"/>ACGTACGTACGTAAGGACGTTGCA</sequence>
    <sequence><taxon idref="b"/>ACGTACGAACGTAAGGACGTTGCA</sequence>
    <sequence><taxon idref="c"/>ACGAACGTACTTAAGGACCTTGCA</sequence>
    <sequence><taxon idref="d"/>AGGTACGTACGTACGGACGTTGGA</sequence>
    <sequence><taxon idref="e"/>AGGTACGTACGTACGGTCGTAGCA</sequence>
    <sequence><taxon idref="f"/>AGGTACCTACGTACGGTCGTAGCT</sequence>
  </alignment>
  <patterns id="patterns" from="1"><alignment idref="alignment"/></patterns>
  <constantSize id="constant" units="substitutions">
    <populationSize><parameter id="constant.popSize" value="0.1" lower="0.0"/></populationSize>
  </constantSize>
  <coalescentSimulator id="startingTree">
    <taxa idref="taxa"/><constantSize idref="constant"/>
  </coalescentSimulator>
  <treeModel id="treeModel">
    <coalescentTree idref="startingTree"/>
    <rootHeight><parameter id="treeModel.rootHeight"/></rootHeight>
    <nodeHeights internalNodes="true">
      <parameter id="treeModel.internalNodeHeights"/>
    </nodeHeights>
    <nodeHeights internalNodes="true" rootNode="true">
      <parameter id="treeModel.allInternalNodeHeights"/>
    </nodeHeights>
  </treeModel>
  <coalescentLikelihood id="coalescent">
    <model><constantSize idref="constant"/></model>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </coalescentLikelihood>
  {models}
  <HKYModel id="hky">
    <frequencies>
      <frequencyModel dataType="nucleotide">
        <frequencies><parameter id="frequencies" value="0.3 0.2 0.25 0.25"/></frequencies>
      </frequencyModel>
    </frequencies>
    <kappa><parameter id="kappa" value="2.0" lower="0.0"/></kappa>
  </HKYModel>
  <siteModel id="siteModel">
    <substitutionModel><HKYModel idref="hky"/></substitutionModel>
    {site}
  </siteModel>
  <treeLikelihood id="treeLikelihood" useAmbiguities="false">
    <patterns idref="patterns"/>
    <treeModel idref="treeModel"/>
    <siteModel idref="siteModel"/>
    {treelik}
  </treeLikelihood>
  <operators id="operators">
    <scaleOperator scaleFactor="0.75" weight="1">
      <parameter idref="kappa"/>
    </scaleOperator>
    <subtreeSlide size="0.01" gaussian="true" weight="5">
      <treeModel idref="treeModel"/>
    </subtreeSlide>
    <narrowExchange weight="2"><treeModel idref="treeModel"/></narrowExchange>
    <scaleOperator scaleFactor="0.75" weight="2">
      <parameter idref="treeModel.rootHeight"/>
    </scaleOperator>
    <uniformOperator weight="6">
      <parameter idref="treeModel.internalNodeHeights"/>
    </uniformOperator>
    {ops}
  </operators>
  <mcmc id="mcmc" chainLength="2000" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        {tree_prior}
        {priors}
      </prior>
      <likelihood id="likelihood">
        <treeLikelihood idref="treeLikelihood"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log id="fileLog" logEvery="100" fileName="doc.log" overwrite="true">
      <posterior idref="posterior"/>
      <parameter idref="kappa"/>
      <parameter idref="treeModel.rootHeight"/>
      {logs}
    </log>
    <logTree id="treeLog" logEvery="100" fileName="doc.trees">
      <treeModel idref="treeModel"/>
    </logTree>
  </mcmc>
</beast>
"""

COAL = '<coalescentLikelihood idref="coalescent"/>'
CONST_OP = """<scaleOperator scaleFactor="0.75" weight="1">
      <parameter idref="constant.popSize"/></scaleOperator>"""


def _doc(models="", site="", treelik="", ops="", tree_prior=COAL,
         priors="", logs=""):
    return BASE.format(models=models, site=site, treelik=treelik,
                       ops=ops + (CONST_OP if tree_prior == COAL else ""),
                       tree_prior=tree_prior, priors=priors, logs=logs)


CLOCKS = {
    "strictClockBranchRates": dict(
        treelik="""<strictClockBranchRates id="clock">
          <rate><parameter id="clock.rate" value="1.5" lower="0.0"/></rate>
        </strictClockBranchRates>""",
        ops="""<scaleOperator scaleFactor="0.75" weight="2">
          <parameter idref="clock.rate"/></scaleOperator>""",
        logs='<strictClockBranchRates idref="clock"/>'),
    "discretizedBranchRates": dict(
        treelik="""<discretizedBranchRates id="clock">
          <treeModel idref="treeModel"/>
          <distribution><logNormalDistributionModel meanInRealSpace="true">
            <mean><parameter id="ucld.mean" value="1.2" lower="0.0"/></mean>
            <stdev><parameter id="ucld.stdev" value="0.4" lower="0.0"/></stdev>
          </logNormalDistributionModel></distribution>
          <rateCategories><parameter id="branchRates.categories"/></rateCategories>
        </discretizedBranchRates>""",
        ops="""<scaleOperator scaleFactor="0.75" weight="2">
          <parameter idref="ucld.mean"/></scaleOperator>
        <uniformIntegerOperator weight="3">
          <parameter idref="branchRates.categories"/></uniformIntegerOperator>
        <swapOperator weight="3">
          <parameter idref="branchRates.categories"/></swapOperator>""",
        site='<gammaShape gammaCategories="4"><parameter id="alpha" value="0.7" lower="0.0"/></gammaShape>'),
    "continuousBranchRates": dict(
        treelik="""<continuousBranchRates id="clock">
          <treeModel idref="treeModel"/>
          <distribution><logNormalDistributionModel meanInRealSpace="true">
            <mean><parameter id="uclc.mean" value="1.2" lower="0.0"/></mean>
            <stdev><parameter id="uclc.stdev" value="0.4" lower="0.0"/></stdev>
          </logNormalDistributionModel></distribution>
          <rateCategoryQuantiles><parameter id="branchRates.quantiles"/></rateCategoryQuantiles>
        </continuousBranchRates>""",
        ops="""<randomWalkOperator windowSize="0.1" weight="3">
          <parameter idref="branchRates.quantiles"/></randomWalkOperator>"""),
    "localClockModel": dict(
        treelik="""<localClockModel id="clock">
          <treeModel idref="treeModel"/>
          <rate><parameter id="clock.rate" value="1.0" lower="0.0"/></rate>
          <clade includeStem="false"><taxa idref="clade"/>
            <parameter id="clade.rate" value="2.0" lower="0.0"/></clade>
          <clade includeStem="true"><taxa idref="pair"/>
            <parameter id="pair.rate" value="0.5" lower="0.0"/></clade>
        </localClockModel>""",
        ops="""<scaleOperator scaleFactor="0.75" weight="2">
          <parameter idref="clade.rate"/></scaleOperator>
        <scaleOperator scaleFactor="0.75" weight="2">
          <parameter idref="pair.rate"/></scaleOperator>"""),
    "randomLocalClockModel": dict(
        treelik="""<randomLocalClockModel id="clock">
          <treeModel idref="treeModel"/>
          <rates><parameter id="rlc.rates"/></rates>
          <rateIndicator><parameter id="rlc.indicators"/></rateIndicator>
          <clockRate><parameter id="rlc.clockRate" value="1.0" lower="0.0"/></clockRate>
        </randomLocalClockModel>""",
        models="""<sumStatistic id="rlc.changes" elementwise="true">
          <parameter idref="rlc.indicators"/></sumStatistic>""",
        priors="""<poissonPrior mean="1.0">
          <statistic idref="rlc.changes"/></poissonPrior>
        <gammaPrior shape="0.5" scale="2.0" offset="0.0">
          <parameter idref="rlc.rates"/></gammaPrior>""",
        ops="""<scaleOperator scaleFactor="0.75" weight="3">
          <parameter idref="rlc.rates"/></scaleOperator>
        <bitFlipOperator weight="3">
          <parameter idref="rlc.indicators"/></bitFlipOperator>
        <scaleOperator scaleFactor="0.75" weight="2">
          <parameter idref="rlc.clockRate"/></scaleOperator>""",
        site='<gammaShape gammaCategories="4"><parameter id="alpha" value="0.7" lower="0.0"/></gammaShape>',
        logs='<sumStatistic idref="rlc.changes"/>'),
}

SKY = {
    "skyline": """<generalizedSkyLineLikelihood id="skyline" linear="false">
        <populationSizes><parameter id="skyline.popSize" value="0.1 0.2 0.15" lower="0.0"/></populationSizes>
        <groupSizes><parameter id="skyline.groupSize" value="2 2 1"/></groupSizes>
        <populationTree><treeModel idref="treeModel"/></populationTree>
      </generalizedSkyLineLikelihood>""",
    "skyline_linear": """<generalizedSkyLineLikelihood id="skyline" linear="true">
        <populationSizes><parameter id="skyline.popSize" value="0.1 0.2 0.15 0.12" lower="0.0"/></populationSizes>
        <groupSizes><parameter id="skyline.groupSize" value="2 2 1"/></groupSizes>
        <populationTree><treeModel idref="treeModel"/></populationTree>
      </generalizedSkyLineLikelihood>""",
    "skyride_time_aware": """<gmrfSkyrideLikelihood id="skyride" timeAwareSmoothing="true">
        <populationSizes><parameter id="skyride.logPopSize" value="-2.0 -1.5 -1.8 -2.2 -1.9"/></populationSizes>
        <precisionParameter><parameter id="skyride.precision" value="2.0" lower="0.0"/></precisionParameter>
        <populationTree><treeModel idref="treeModel"/></populationTree>
      </gmrfSkyrideLikelihood>""",
    "skyride_uniform": """<gmrfSkyrideLikelihood id="skyride" timeAwareSmoothing="false">
        <populationSizes><parameter id="skyride.logPopSize" value="-2.0"/></populationSizes>
        <precisionParameter><parameter id="skyride.precision" value="2.0" lower="0.0"/></precisionParameter>
        <populationTree><treeModel idref="treeModel"/></populationTree>
      </gmrfSkyrideLikelihood>""",
}
SKY_OPS = {
    "skyline": """<scaleOperator scaleFactor="0.75" weight="3">
        <parameter idref="skyline.popSize"/></scaleOperator>
      <deltaExchange delta="1" integer="true" weight="2">
        <parameter idref="skyline.groupSize"/></deltaExchange>""",
    "skyride": """<randomWalkOperator windowSize="0.5" weight="3">
        <parameter idref="skyride.logPopSize"/></randomWalkOperator>
      <scaleOperator scaleFactor="0.75" weight="2">
        <parameter idref="skyride.precision"/></scaleOperator>""",
}

SPECIATION = {
    "yule": ("""<yuleModel id="yule" units="substitutions">
        <birthRate><parameter id="yule.birthRate" value="3.0" lower="0.0"/></birthRate>
      </yuleModel>""", "yule", "yule.birthRate"),
    "birthDeath": ("""<birthDeathModel id="bd" units="substitutions">
        <birthMinusDeathRate><parameter id="bd.meanGrowthRate" value="3.0" lower="0.0"/></birthMinusDeathRate>
        <relativeDeathRate><parameter id="bd.relativeDeathRate" value="0.4" lower="0.0" upper="1.0"/></relativeDeathRate>
      </birthDeathModel>""", "bd", "bd.meanGrowthRate"),
}

PRIORS = {
    "logNormalPrior": '<logNormalPrior mean="1.0" stdev="1.25" offset="0.0" meanInRealSpace="false"><parameter idref="kappa"/></logNormalPrior>',
    "normalPrior": '<normalPrior mean="1.0" stdev="2.0"><parameter idref="kappa"/></normalPrior>',
    "exponentialPrior": '<exponentialPrior mean="2.0" offset="0.0"><parameter idref="kappa"/></exponentialPrior>',
    "gammaPrior": '<gammaPrior shape="2.0" scale="1.5" offset="0.0"><parameter idref="kappa"/></gammaPrior>',
    "inverseGammaPrior": '<inverseGammaPrior shape="3.0" scale="4.0"><parameter idref="kappa"/></inverseGammaPrior>',
    "laplacePrior": '<laplacePrior mean="1.0" scale="2.0"><parameter idref="kappa"/></laplacePrior>',
    "uniformPrior": '<uniformPrior lower="0.0" upper="100.0"><parameter idref="kappa"/></uniformPrior>',
    "oneOnXPrior": '<oneOnXPrior><parameter idref="constant.popSize"/></oneOnXPrior>',
    "poissonPrior": '<poissonPrior mean="2.0"><parameter idref="kappa"/></poissonPrior>',
    "dirichletPrior": '<dirichletPrior alpha="2.0"><parameter idref="frequencies"/></dirichletPrior>',
    "ctmcScalePrior": '<ctmcScalePrior><ctmcScale><parameter idref="clock.rate"/></ctmcScale><treeModel idref="treeModel"/></ctmcScalePrior>',
}
PRIOR_OPS = """<deltaExchange delta="0.01" weight="2">
      <parameter idref="frequencies"/></deltaExchange>"""


def _documents():
    """This file's documents: the skylines and skyrides, speciation and the
    conjugate distributionLikelihood (the demographics are
    tests/test_torch_interpreter_demographics.py's, the clocks and priors
    tests/test_torch_interpreter_clocks.py's)."""
    docs = {}
    for n, block in SKY.items():
        docs[f"sky:{n}"] = _doc(
            models=block, ops=SKY_OPS[n.split("_")[0]],
            tree_prior=f'<{block.split()[0][1:]} idref="{n.split("_")[0]}"/>',
            logs=f'<{block.split()[0][1:]} idref="{n.split("_")[0]}"/>')
    for n, (block, mid, rate) in SPECIATION.items():
        docs[f"speciation:{n}"] = _doc(
            models=block + f"""<speciationLikelihood id="speciation">
              <model><{block.split()[0][1:]} idref="{mid}"/></model>
              <speciesTree><treeModel idref="treeModel"/></speciesTree>
            </speciationLikelihood>""",
            ops=f"""<scaleOperator scaleFactor="0.75" weight="2">
              <parameter idref="{rate}"/></scaleOperator>""",
            tree_prior='<speciationLikelihood idref="speciation"/>',
            logs='<speciationLikelihood idref="speciation"/>')
    docs["distributionLikelihood"] = CONJUGATE_XML
    return docs


def demographic_documents():
    return {f"demographic:{n}": _demographic_doc(n) for n in DEMOGRAPHICS}


def clock_and_prior_documents():
    docs = {}
    for n, kw in CLOCKS.items():
        docs[f"clock:{n}"] = _doc(**kw)
    for n, prior in PRIORS.items():
        kw = dict(priors=prior, ops=PRIOR_OPS)
        if n == "ctmcScalePrior":
            kw.update(CLOCKS["strictClockBranchRates"])
            kw["priors"] = prior
            kw["ops"] = PRIOR_OPS + kw["ops"]
        docs[f"prior:{n}"] = _doc(**kw)
    return docs


DOCS = _documents()


def _setup(mod, path, device=None):
    """(ax, posterior, operators, log columns, params, tree) of the first
    <mcmc>, built as its _run_mcmc builds them."""
    kw = {} if device is None else {"device": device}
    ax = mod.XmlAnalysis(path, seed=17, **kw)
    for el in ax.root.iter("treeModel"):
        if el.get("id"):
            ax.build(el)
    mcmc = ax.root.find("mcmc")
    post = ax._posterior_of(mcmc)
    ops, _ = ax.build(ax.deref(mcmc.find("operators")))
    cols = ax._log_columns(mcmc.find("log"))
    tid = post.tree_id or next(iter(ax._trees))
    tm = ax._trees[tid]
    if mod is jinterp:
        params = {p.name: jnp.asarray(p.value, jnp.int32 if p.integer
                                      else jnp.float64)
                  for p in ax._params.values()}
        tree = j_tree_state(tm.parent, tm.children, tm.heights, tm.root,
                            jnp.float64)
    else:
        params = {p.name: ax.tensor(p.value, torch.int32 if p.integer
                                    else torch.float64)
                  for p in ax._params.values()}
        tree = make_tree_state(tm.parent, tm.children, tm.heights, tm.root,
                               torch.float64, "cpu")
    return ax, post, ops, cols, params, tree


def _components(post):
    """The posterior and every addend below it, depth first."""
    out = [post]
    for p in getattr(post, "parts", ()):
        out.extend(_components(p))
    return out


def _perturbed(params, heights, n_taxa, k):
    """State k: float parameters scaled by exp(0.05 z), 0/1 integer
    parameters flipped with probability 0.2, internal heights scaled up by
    one common factor in [1, 1.1) (the order kept)."""
    if k == 0:
        return params, heights
    rng = np.random.default_rng(100 + k)
    out = {}
    for n, v in sorted(params.items()):
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.integer):
            if v.size > 1 and set(np.unique(v)) <= {0, 1}:
                flip = rng.uniform(size=v.shape) < 0.2
                v = np.where(flip, 1 - v, v)
            out[n] = v
        else:
            out[n] = v * np.exp(0.05 * rng.normal(size=v.shape))
    h = np.asarray(heights).copy()
    h[n_taxa:] *= 1.0 + 0.1 * rng.uniform()
    return out, h


def check_against_jax(name, xml, tmp_path):
    """The port's build of `xml` against JAX's: parameters, tree, log
    columns, and the posterior with its components at 6 states."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    jax_ax, jpost, _, jcols, jparams, jtree = _setup(jinterp, str(path))
    ax, post, ops, cols, params, tree = _setup(interp, str(path), "cpu")
    assert ops

    # parameters and the starting tree
    assert sorted(params) == sorted(jparams)
    for n in jparams:
        np.testing.assert_array_equal(params[n].numpy(), np.asarray(
            jparams[n]), err_msg=n)
    for f in ("parent", "children", "heights", "root"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(), np.asarray(
            getattr(jtree, f)), err_msg=f)
    assert [c for c, _ in cols] == [c for c, _ in jcols]

    jcomp, comp = _components(jpost), _components(post)
    assert [c.name for c in comp] == [c.name for c in jcomp]
    j_eval = jax.jit(lambda p, t: (
        [c.fn(p, t) for c in jcomp],
        [f(jinterp._StateShim(p, t)) for _, f in jcols]))
    n_taxa = (tree.parent.shape[0] + 1) // 2
    for k in range(6):
        p_np, h_np = _perturbed({n: np.asarray(v) for n, v in
                                 jparams.items()},
                                np.asarray(jtree.heights), n_taxa, k)
        jp = {n: jnp.asarray(v, jparams[n].dtype) for n, v in p_np.items()}
        tp = {n: torch.tensor(v, dtype=params[n].dtype)
              for n, v in p_np.items()}
        jt = jtree.replace(heights=jnp.asarray(h_np))
        tt = tree.replace(heights=torch.tensor(h_np))
        want_comp, want_cols = j_eval(jp, jt)
        want = [float(v) for v in want_comp]
        got = [float(c.fn(tp, tt)) for c in comp]
        assert np.isfinite(want[0]), (name, k)
        np.testing.assert_allclose(got, want, rtol=REL, atol=1e-12,
                                   err_msg=f"{name} state {k}")
        if k == 0:
            s = interp._StateShim(tp, tt)
            got_cols = [float(torch.as_tensor(f(s))) for _, f in cols]
            np.testing.assert_allclose(
                got_cols, [float(v) for v in want_cols], rtol=REL,
                atol=1e-12)


def check_chain(name, xml, tmp_path):
    """200 states of the port's chain with the full-evaluation check and
    its log and tree files."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    ax = interp.XmlAnalysis(str(path), seed=5, max_states=200,
                            workdir=str(tmp_path), device="cpu")
    ax.run(full_eval_steps=40)
    (run,) = ax.runs
    assert run["full_eval_deviation"] <= 0.1
    assert run["steps"] == 200
    (fname,) = ax.results
    log = (tmp_path / fname).read_text().splitlines()
    assert log[0].startswith("state\tposterior")
    assert len(log) == 3  # header, states 100 and 200
    if name.startswith("demographic"):
        return
    assert (tmp_path / "doc.trees").read_text().count("tree STATE_") == 2


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(set(DOCS)
                                        - {"distributionLikelihood"}))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)


def test_conjugate_posterior_mean(tmp_path):
    """The conjugate normal model: m's posterior mean is 6 / 3.01 =
    1.9934 (tests/test_distribution_likelihood_xml.py), held within 4
    Monte Carlo standard errors of the port's own trace."""
    path = tmp_path / "distlik.xml"
    path.write_text(CONJUGATE_XML)
    ax = interp.XmlAnalysis(str(path), seed=13, scale=0.05,
                            workdir=str(tmp_path), device="cpu")
    res = ax.run(tolerance_se=4.0, full_eval_steps=50)
    assert ax.runs[0]["full_eval_deviation"] <= 0.1
    (_, name, mean, expected, se), = res
    assert name == "m" and expected == 1.9934
    samples = ax.results["distlik.log"]["m"][25:]
    st = analyze(samples)
    assert abs(st.mean - 6.0 / 3.01) <= 4.0 * st.std_error_of_mean


# two gene trees under one EBSP field (variableDemographic): the second
# tree rides the params (__tree__tree2__* keys), its operators lifted by
# ParamsTreeOperator; the upDown over both trees is MultiTreeUpDownOperator
EBSP_XML = """<?xml version="1.0" standalone="yes"?>
<beast>
  <taxa id="taxa1">
    <taxon id="a"/><taxon id="b"/><taxon id="c"/><taxon id="d"/><taxon id="e"/>
  </taxa>
  <taxa id="taxa2">
    <taxon id="p"/><taxon id="q"/><taxon id="r"/><taxon id="s"/>
  </taxa>
  <alignment id="aln1" dataType="nucleotide">
    <sequence><taxon idref="a"/>ACGTACGTACGTAAGGACGT</sequence>
    <sequence><taxon idref="b"/>ACGTACGAACGTAAGGACGA</sequence>
    <sequence><taxon idref="c"/>ACGAACGTACTTAAGGACCT</sequence>
    <sequence><taxon idref="d"/>AGGTACGTACGTACGGACGT</sequence>
    <sequence><taxon idref="e"/>AGGTACGTACGTACGGTCGT</sequence>
  </alignment>
  <alignment id="aln2" dataType="nucleotide">
    <sequence><taxon idref="p"/>ACGTTCGTACGTAAGG</sequence>
    <sequence><taxon idref="q"/>ACGTACGAACGTTAGG</sequence>
    <sequence><taxon idref="r"/>ACGAACGTACTTAAGC</sequence>
    <sequence><taxon idref="s"/>AGGTACGTACGAACGG</sequence>
  </alignment>
  <patterns id="patterns1" from="1"><alignment idref="aln1"/></patterns>
  <patterns id="patterns2" from="1"><alignment idref="aln2"/></patterns>
  <constantSize id="initialDemo" units="substitutions">
    <populationSize><parameter id="initialDemo.popSize" value="0.05"/></populationSize>
  </constantSize>
  <coalescentTree id="start1"><taxa idref="taxa1"/><constantSize idref="initialDemo"/></coalescentTree>
  <coalescentTree id="start2"><taxa idref="taxa2"/><constantSize idref="initialDemo"/></coalescentTree>
  <treeModel id="tree1">
    <coalescentTree idref="start1"/>
    <rootHeight><parameter id="tree1.rootHeight"/></rootHeight>
    <nodeHeights internalNodes="true"><parameter id="tree1.internalNodeHeights"/></nodeHeights>
    <nodeHeights internalNodes="true" rootNode="true"><parameter id="tree1.allInternalNodeHeights"/></nodeHeights>
  </treeModel>
  <treeModel id="tree2">
    <coalescentTree idref="start2"/>
    <rootHeight><parameter id="tree2.rootHeight"/></rootHeight>
    <nodeHeights internalNodes="true"><parameter id="tree2.internalNodeHeights"/></nodeHeights>
    <nodeHeights internalNodes="true" rootNode="true"><parameter id="tree2.allInternalNodeHeights"/></nodeHeights>
  </treeModel>
  <variableDemographic id="demo" type="linear" useMidpoints="true">
    <populationSizes><parameter id="demo.popSize" value="0.05"/></populationSizes>
    <indicators><parameter id="demo.indicators" value="0.0"/></indicators>
    <trees>
      <ptree ploidy="1.0"><treeModel idref="tree1"/></ptree>
      <ptree ploidy="2.0"><treeModel idref="tree2"/></ptree>
    </trees>
  </variableDemographic>
  <coalescentLikelihood id="coalescent">
    <model><variableDemographic idref="demo"/></model>
  </coalescentLikelihood>
  <exponentialDistributionModel id="demo.populationMeanDist">
    <mean><parameter id="demo.populationMean" value="0.05"/></mean>
  </exponentialDistributionModel>
  <HKYModel id="hky">
    <frequencies><frequencyModel dataType="nucleotide">
      <frequencies><parameter id="frequencies" value="0.25 0.25 0.25 0.25"/></frequencies>
    </frequencyModel></frequencies>
    <kappa><parameter id="kappa" value="2.0" lower="0.0"/></kappa>
  </HKYModel>
  <siteModel id="siteModel"><substitutionModel><HKYModel idref="hky"/></substitutionModel></siteModel>
  <treeLikelihood id="treeLikelihood1">
    <patterns idref="patterns1"/><treeModel idref="tree1"/><siteModel idref="siteModel"/>
  </treeLikelihood>
  <treeLikelihood id="treeLikelihood2">
    <patterns idref="patterns2"/><treeModel idref="tree2"/><siteModel idref="siteModel"/>
  </treeLikelihood>
  <operators id="operators">
    <scaleOperator scaleFactor="0.5" weight="2"><parameter idref="kappa"/></scaleOperator>
    <scaleOperator scaleFactor="0.5" weight="5">
      <parameter idref="demo.popSize"/>
      <indicators pickoneprob="1.0"><parameter idref="demo.indicators"/></indicators>
    </scaleOperator>
    <sampleNonActiveOperator weight="3">
      <distribution><exponentialDistributionModel idref="demo.populationMeanDist"/></distribution>
      <data><parameter idref="demo.popSize"/></data>
      <indicators><parameter idref="demo.indicators"/></indicators>
    </sampleNonActiveOperator>
    <bitFlipOperator weight="5"><parameter idref="demo.indicators"/></bitFlipOperator>
    <scaleOperator scaleFactor="0.5" weight="1"><parameter idref="demo.populationMean"/></scaleOperator>
    <upDownOperator scaleFactor="0.75" weight="3">
      <up><parameter idref="demo.popSize"/></up>
      <down><parameter idref="tree1.allInternalNodeHeights"/><parameter idref="tree2.allInternalNodeHeights"/></down>
    </upDownOperator>
    <subtreeSlide size="0.01" gaussian="true" weight="5"><treeModel idref="tree1"/></subtreeSlide>
    <subtreeSlide size="0.01" gaussian="true" weight="5"><treeModel idref="tree2"/></subtreeSlide>
    <uniformOperator weight="5"><parameter idref="tree1.internalNodeHeights"/></uniformOperator>
    <uniformOperator weight="5"><parameter idref="tree2.internalNodeHeights"/></uniformOperator>
    <scaleOperator scaleFactor="0.75" weight="2"><parameter idref="tree2.rootHeight"/></scaleOperator>
  </operators>
  <mcmc id="mcmc" chainLength="400" autoOptimize="true">
    <posterior id="posterior">
      <prior id="prior">
        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="kappa"/></logNormalPrior>
        <oneOnXPrior><parameter idref="demo.populationMean"/></oneOnXPrior>
        <poissonPrior mean="0.693"><statistic idref="demo.changes"/></poissonPrior>
        <mixedDistributionLikelihood>
          <distribution0><exponentialDistributionModel idref="demo.populationMeanDist"/></distribution0>
          <distribution1><exponentialDistributionModel idref="demo.populationMeanDist"/></distribution1>
          <data><parameter idref="demo.popSize"/></data>
          <indicators><parameter idref="demo.indicators"/></indicators>
        </mixedDistributionLikelihood>
        <coalescentLikelihood idref="coalescent"/>
      </prior>
      <likelihood id="likelihood">
        <treeLikelihood idref="treeLikelihood1"/>
        <treeLikelihood idref="treeLikelihood2"/>
      </likelihood>
    </posterior>
    <operators idref="operators"/>
    <log logEvery="100" fileName="ebsp.log">
      <posterior idref="posterior"/>
      <sumStatistic id="demo.changes" elementwise="true"><parameter idref="demo.indicators"/></sumStatistic>
      <parameter idref="tree2.rootHeight"/>
      <coalescentLikelihood idref="coalescent"/>
    </log>
    <logTree logEvery="100" fileName="ebsp2.trees"><treeModel idref="tree2"/></logTree>
  </mcmc>
</beast>
"""


def _jax_chain_start(ax):
    """JAX's _run_mcmc set-up of the first <mcmc> (the tree binding, the
    params with the params-resident trees, the primary tree)."""
    for el in ax.root.iter("treeModel"):
        if el.get("id"):
            ax.build(el)
    mcmc = ax.root.find("mcmc")
    post = ax._posterior_of(mcmc)
    _, op_tids = ax.build(ax.deref(mcmc.find("operators")))
    tids = sorted({t for t in op_tids if t}
                  | ({post.tree_id} if post.tree_id else set()))
    ax._tree_binding = {t: "params" for t in tids[1:]}
    ax._tree_binding[tids[0]] = "state"
    params = {p.name: jnp.asarray(p.value, jnp.int32 if p.integer
                                  else jnp.float64)
              for p in ax._params.values()}
    for tid in tids[1:]:
        t = ax._trees[tid]
        for f, dt in (("parent", jnp.int32), ("children", jnp.int32),
                      ("heights", jnp.float64), ("root", jnp.int32)):
            params[ax.tree_key(tid, f)] = jnp.asarray(getattr(t, f), dt)
    tm = ax._trees[tids[0]]
    return post, params, j_tree_state(tm.parent, tm.children, tm.heights,
                                      tm.root, jnp.float64)


def test_two_loci_ebsp_matches_jax(tmp_path):
    """The multi-tree binding: the EBSP document's parameters (the second
    tree's among them), trees, and posterior components at the start and
    at 5 states (the float parameters scaled, both trees' internal
    heights raised by one factor each) against JAX's, then the port's
    chain with its lifted and multi-tree operators under the 0.1 check."""
    path = tmp_path / "ebsp.xml"
    path.write_text(EBSP_XML)
    jpost, jparams, jtree = _jax_chain_start(
        jinterp.XmlAnalysis(str(path), seed=17))
    ax = interp.XmlAnalysis(str(path), seed=17, device="cpu",
                            workdir=str(tmp_path))
    chain = ax.prepare_chain()
    post, state = chain["posterior"], chain["state"]
    assert ax._tree_binding == {"tree1": "state", "tree2": "params"}
    ops = [type(op).__name__ for op in chain["operators"]]
    assert {"ParamsTreeOperator", "MultiTreeUpDownOperator",
            "ActiveEntryScaleOperator", "SampleNonActiveOperator"} <= set(ops)
    assert sorted(state.params) == sorted(jparams)
    for n, v in jparams.items():
        np.testing.assert_array_equal(state.params[n].numpy(),
                                      np.asarray(v), err_msg=n)
    for f in ("parent", "children", "heights", "root"):
        np.testing.assert_array_equal(getattr(state.tree, f).numpy(),
                                      np.asarray(getattr(jtree, f)))
    jcomp, comp = _components(jpost), _components(post)
    assert [c.name for c in comp] == [c.name for c in jcomp]
    j_eval = jax.jit(lambda p, t: [c.fn(p, t) for c in jcomp])
    for k in range(6):
        rng = np.random.default_rng(200 + k)
        p_np = {n: np.asarray(v) for n, v in jparams.items()}
        h_np = np.asarray(jtree.heights).copy()
        if k:
            for n, v in p_np.items():
                if n == "__tree__tree2__heights":
                    v = v.copy()
                    v[4:] *= 1.0 + 0.1 * rng.uniform()
                    p_np[n] = v
                elif v.dtype.kind == "f" and not n.startswith("__tree__"):
                    p_np[n] = v * np.exp(0.05 * rng.normal(size=v.shape))
            h_np[5:] *= 1.0 + 0.1 * rng.uniform()
        jp = {n: jnp.asarray(v, jparams[n].dtype) for n, v in p_np.items()}
        tp = {n: torch.tensor(v, dtype=state.params[n].dtype)
              for n, v in p_np.items()}
        want = [float(v) for v in j_eval(jp, jtree.replace(
            heights=jnp.asarray(h_np)))]
        got = [float(c.fn(tp, state.tree.replace(heights=torch.tensor(h_np))))
               for c in comp]
        assert np.isfinite(want[0])
        np.testing.assert_allclose(got, want, rtol=REL, atol=1e-12,
                                   err_msg=f"state {k}")
    ax = interp.XmlAnalysis(str(path), seed=5, workdir=str(tmp_path),
                            device="cpu")
    ax.run(full_eval_steps=40)
    assert ax.runs[0]["full_eval_deviation"] <= 0.1
    assert (tmp_path / "ebsp2.trees").read_text().count("tree STATE_") == 4

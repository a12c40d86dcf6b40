"""The port's config/xml_ext.py against the JAX package's: the
autocorrelated clock, grid-based branch rates, the exponential branch
length prior, the ALS stochastic Dollo likelihood with its mutation-death
and scaled tree length models, the episodic BDSS, the star tree, the node
posterior likelihood, the multivariate OU model, and the product and
transmission statistics, with the checks of tests/test_torch_xml_ext_a.py
(tests/test_torch_interpreter.py::check_against_jax and check_chain). Then
the registrations no document here runs: the gradient elements and their
reports (whose branches into unported modules raise Unsupported naming
them), the trait-likelihood wrappers and the rewards-aware branch model
over config/xml_traits.py's likelihood and clock."""

import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu_torch.config import interpreter as interp

from test_torch_interpreter import check_against_jax, check_chain
from test_torch_xml_ext_a import RW, SCALE, ext_documents

AC = """<ACLikelihood id="ac" distribution="{dist}">
      <treeModel idref="treeModel"/>
      <rates><parameter id="ac.rates" value="1.0" lower="0.0"/></rates>
      <rootRate><parameter id="ac.root" value="1.0" lower="0.0"/></rootRate>
      <variance><parameter id="ac.var" value="0.5" lower="0.0"/></variance>
    </ACLikelihood>"""
ALS = """<alignment id="bin" dataType="binary">
      <sequence><taxon idref="a"/>0101101</sequence>
      <sequence><taxon idref="b"/>0101100</sequence>
      <sequence><taxon idref="c"/>1100101</sequence>
      <sequence><taxon idref="d"/>0001111</sequence>
      <sequence><taxon idref="e"/>0011001</sequence>
      <sequence><taxon idref="f"/>0100001</sequence>
    </alignment>
    <patterns id="bpat" from="1"><alignment idref="bin"/></patterns>
    <mutationDeathModel id="mdm">
      <parameter id="mdm.death" value="0.8" lower="0.0"/>
    </mutationDeathModel>
    <alsSiteModel id="als">
      <substitutionModel><mutationDeathModel idref="mdm"/></substitutionModel>
      <mutationRate><parameter id="als.mu" value="1.2" lower="0.0"/></mutationRate>
    </alsSiteModel>
    <scaledTreeLengthModel id="stl">
      <treeModel idref="treeModel"/>
      <scalingFactor><parameter id="stl.f" value="1.5" lower="0.0"/></scalingFactor>
    </scaledTreeLengthModel>
    <alsTreeLikelihood id="alsLik">
      <patterns idref="bpat"/><treeModel idref="treeModel"/>
      <alsSiteModel idref="als"/><scaledTreeLengthModel idref="stl"/>
    </alsTreeLikelihood>"""
BDSS = """<newBirthDeathSerialSampling id="bdss" units="substitutions">
      <birthRate><parameter id="bdss.birth" value="3.0" lower="0.0"/></birthRate>
      <deathRate><parameter id="bdss.death" value="1.0" lower="0.0"/></deathRate>
      <samplingRate><parameter id="bdss.psi" value="0.5" lower="0.0"/></samplingRate>
      <origin><parameter id="bdss.origin" value="2.0" lower="0.0"/></origin>
      <samplingProbability><parameter id="bdss.rho" value="0.1"/></samplingProbability>
    </newBirthDeathSerialSampling>
    <speciationLikelihood id="speciation">
      <model><newBirthDeathSerialSampling idref="bdss"/></model>
      <speciesTree><treeModel idref="treeModel"/></speciesTree>
    </speciationLikelihood>"""
OU = """<matrixParameter id="ouQ">
      <parameter id="ou.q1" value="1.0 0.2"/><parameter id="ou.q2" value="0.2 0.8"/>
    </matrixParameter>
    <multivariateOUModel id="mvou">
      <positiveDefiniteSubstitutionModel><matrixParameter idref="ouQ"/></positiveDefiniteSubstitutionModel>
      <data><parameter id="ou.data" value="0.1 0.2 0.3 -0.1 0.0 0.4"/></data>
      <times><parameter value="0 0 1 1 2 2"/></times>
      <design><parameter value="1 2 1 2 1 2"/></design>
      <diagonalMatrix id="ouG"><parameter id="ou.g" value="1.0 1.5"/></diagonalMatrix>
    </multivariateOUModel>"""
TRANSMISSION = """<transmissionHistory id="th">
      <transmission><parameter id="t.c" value="0.05"/>
        <donor><taxon idref="a"/></donor><recipient><taxon idref="c"/></recipient>
      </transmission>
      <transmission><parameter id="t.e" value="0.06"/>
        <donor><taxon idref="a"/></donor><recipient><taxon idref="e"/></recipient>
      </transmission>
    </transmissionHistory>"""
HOSTS = {"a": "a", "b": "a", "c": "c", "d": "c", "e": "e", "f": "e"}

DOCS_C = {
    "ACLikelihood:logNormal": dict(
        models=AC.format(dist="logNormal"), priors='<ACLikelihood idref="ac"/>',
        ops=SCALE.format(p="ac.rates") + SCALE.format(p="ac.var")),
    "ACLikelihood:normal": dict(
        models=AC.format(dist="normal"), priors='<ACLikelihood idref="ac"/>',
        ops=SCALE.format(p="ac.rates")),
    "exponentialBranchLengthsPrior": dict(
        priors='<exponentialBranchLengthsPrior><treeModel idref="treeModel"/>'
               '</exponentialBranchLengthsPrior>'),
    "gridBasedBranchRateModel": dict(
        treelik="""<gridBasedBranchRateModel id="grid">
          <treeModel idref="treeModel"/>
          <levelSpecificRates><parameter id="grid.rates" value="1.0 2.0 0.5" lower="0.0"/></levelSpecificRates>
          <gridPoints><parameter id="grid.points" value="0.02 0.05"/></gridPoints>
        </gridBasedBranchRateModel>""",
        ops=SCALE.format(p="grid.rates")),
    "alsTreeLikelihood": dict(
        models=ALS, priors='<alsTreeLikelihood idref="alsLik"/>',
        ops=SCALE.format(p="mdm.death") + SCALE.format(p="stl.f")),
    "newBirthDeathSerialSampling": dict(
        models=BDSS, tree_prior='<speciationLikelihood idref="speciation"/>',
        ops=SCALE.format(p="bdss.birth")),
    "multivariateOUModel": dict(
        models=OU, priors='<multivariateOUModel idref="mvou"/>',
        ops=RW.format(w=0.2, p="ou.data"), logs='<matrixParameter idref="ouQ"/>'),
    "productStatistic": dict(
        logs="""<productStatistic id="prod" elementwise="false">
          <parameter idref="kappa"/>
          <parameter idref="constant.popSize"/></productStatistic>
        <productStatistic id="prod2"><parameter idref="frequencies"/>
          <parameter idref="frequencies"/></productStatistic>"""),
    "transmissionStatistic": dict(
        models=TRANSMISSION,
        logs="""<transmissionStatistic id="ts">
          <transmissionHistory idref="th"/>
          <parasiteTree><treeModel idref="treeModel"/></parasiteTree>
        </transmissionStatistic>"""),
}
DOCS = ext_documents(DOCS_C)
_base = ext_documents({"x": {}})["x"]
for _tag in ("starTreeLikelihood", "nodePosteriorLikelihood"):
    DOCS[_tag] = _base.replace(
        '<treeLikelihood id="treeLikelihood"', f'<{_tag} id="treeLikelihood"'
    ).replace("</treeLikelihood>", f"</{_tag}>")
# under the star tie every internal height reads as the root's, so the
# topology moves of the base document would rewire a tree whose heights no
# longer order it: the star document keeps the height operators only
_TOPOLOGY_OPS = ("""<subtreeSlide size="0.01" gaussian="true" weight="5">
      <treeModel idref="treeModel"/>
    </subtreeSlide>""", """<narrowExchange weight="2"><treeModel idref="treeModel"/></narrowExchange>""")
for _op in _TOPOLOGY_OPS:
    assert _op in DOCS["starTreeLikelihood"]
    DOCS["starTreeLikelihood"] = DOCS["starTreeLikelihood"].replace(_op, "")
for _t, _h in HOSTS.items():
    DOCS["transmissionStatistic"] = DOCS["transmissionStatistic"].replace(
        f'<taxon id="{_t}">', f'<taxon id="{_t}"><attr name="host">{_h}</attr>')


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


def _analyses(tmp_path, xml):
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    return (jinterp.XmlAnalysis(str(path)),
            interp.XmlAnalysis(str(path), device="cpu"))


def test_gradient_elements_build_and_reports_name_their_modules(tmp_path):
    """<gmrfSkyrideGradient> builds over a skygrid with JAX's target
    parameter; its reports over the log populations and the precision
    (config/xml_assert.py::gradient_report, once waiting for
    config/xml_hmc.py), the coalescent-interval gradient's and the
    node-height form's (now xml_hmc.py's GradientSpec) equal JAX's
    (jax.grad) to 1e-10."""
    from beast_mcmc_tpu.config import xml_assert as jassert
    from beast_mcmc_tpu_torch.config import xml_assert

    from test_torch_xml_ext_b import DOCS_B

    doc = ET.fromstring(ext_documents(
        {"x": DOCS_B["gmrfSkyGridLikelihood"]})["x"])
    for wrt in ("logPopulationSizes", "precision", "coalescentInterval",
                "nodeHeight"):
        g = ET.SubElement(doc, "gmrfSkyrideGradient", id=f"g.{wrt}",
                          wrtParameter=wrt)
        ET.SubElement(g, "gmrfSkyGridLikelihood", idref="skygrid")
    jax_ax, ax = _analyses(tmp_path, ET.tostring(doc, encoding="unicode"))
    for wrt in ("logPopulationSizes", "precision", "coalescentInterval",
                "nodeHeight"):
        got = ax.build(ax._ids[f"g.{wrt}"])
        want = jax_ax.build(jax_ax._ids[f"g.{wrt}"])
        assert type(got).__name__ == type(want).__name__
        assert getattr(got, "wrt", None) == getattr(want, "wrt", None)
        assert getattr(got, "height_tid", None) == getattr(
            want, "height_tid", None)
        rep = xml_assert.report_of(ax, ax._ids[f"g.{wrt}"])
        jrep = jassert.report_of(jax_ax, jax_ax._ids[f"g.{wrt}"])
        assert rep.splitlines()[0] == jrep.splitlines()[0] == "Gradient"
        analytic = [np.array(re.findall(r"-?[\d.]+(?:e-?\d+)?",
                                        r.splitlines()[1]), float)
                    for r in (rep, jrep)]
        assert analytic[0].size == analytic[1].size > 0
        np.testing.assert_allclose(analytic[0], analytic[1], rtol=1e-10,
                                   atol=1e-10, err_msg=wrt)


def test_wrappers_of_unported_modules_raise_naming_them(tmp_path):
    """<traitValidation> and <gaussianProcessFromTree> wrap a
    traitDataLikelihood and <rewardsAwareBranchModel> an
    arbitraryBranchRates clock, which waited for config/xml_traits.py:
    they build now, as JAX's do. The validation's columns (each missing
    entry's squared error and their sum) equal JAX's at the start state;
    the Gaussian process has no columns; the rewards-aware model's report
    (its branch W matrices) equals JAX's to 1e-10 relative."""
    from beast_mcmc_tpu.config import xml_assert as jassert
    from beast_mcmc_tpu_torch.config import xml_assert

    from test_torch_xml_traits_a import LOC_MISSING, PRECISION, ROOT, \
        with_attrs

    doc = ext_documents({"x": {"models": PRECISION + f"""
      <traitDataLikelihood id="tdl" traitName="location">
        <multivariateDiffusionModel idref="diffusion"/>
        <treeModel idref="treeModel"/>
        <traitParameter><parameter id="leaf.location"/></traitParameter>
        {ROOT}
      </traitDataLikelihood>
      <traitValidation id="tv">
        <traitDataLikelihood idref="tdl"/>
        <traitParameter><parameter id="truth"
          value="8.1 -10.9 7.6 -11.8 9.3 -12.6 6.8 -10.1 8.9 -13.2 7.2 -12.0"/>
        </traitParameter>
      </traitValidation>
      <gaussianProcessFromTree id="gp"><traitDataLikelihood idref="tdl"/>
      </gaussianProcessFromTree>
      <arbitraryBranchRates id="abr"><treeModel idref="treeModel"/>
        <rates><parameter id="abr.rates" value="1.0"/></rates>
      </arbitraryBranchRates>
      <generalSubstitutionModel id="gsm">
        <generalDataType><state code="0"/><state code="1"/></generalDataType>
        <frequencies><frequencyModel><frequencies>
          <parameter value="0.4 0.6"/></frequencies></frequencyModel></frequencies>
        <rates><parameter id="gsm.rates" value="1.0"/></rates>
      </generalSubstitutionModel>
      <rewardsAwareBranchModel id="rw">
        <arbitraryBranchRates idref="abr"/>
        <rewardRates><parameter value="0.0 1.0"/></rewardRates>
        <generalSubstitutionModel idref="gsm"/>
      </rewardsAwareBranchModel>"""}})["x"]
    jax_ax, ax = _analyses(tmp_path, with_attrs(doc, LOC_MISSING))
    for a in (jax_ax, ax):
        for el in a.root.iter("treeModel"):
            if el.get("id"):
                a.build(el)
    tv, jtv = ax.build(ax._ids["tv"]), jax_ax.build(jax_ax._ids["tv"])
    assert [c for c, _ in tv.columns] == [c for c, _ in jtv.columns]
    assert len(tv.columns) == 4  # three missing entries and their sum
    p0, t0 = xml_assert.initial_eval_state(ax)
    jp0, jt0 = jassert.initial_eval_state(jax_ax)
    s, js = interp._StateShim(p0, t0), jinterp._StateShim(jp0, jt0)
    np.testing.assert_allclose([float(f(s)) for _, f in tv.columns],
                               [float(f(js)) for _, f in jtv.columns],
                               rtol=1e-12)
    gp, jgp = ax.build(ax._ids["gp"]), jax_ax.build(jax_ax._ids["gp"])
    assert list(gp.columns) == [] and type(gp).__name__ == "_Gp"
    rep = ax.build(ax._ids["rw"]).report(ax)
    jrep = jax_ax.build(jax_ax._ids["rw"]).report(jax_ax)
    nums = [np.array(re.findall(r"-?[\d.]+(?:e-?\d+)?", r), float)
            for r in (rep, jrep)]
    assert rep.split(":")[0] == jrep.split(":")[0]
    np.testing.assert_allclose(nums[0], nums[1], rtol=1e-10, atol=1e-12)


def test_small_registrations_match_jax(tmp_path):
    """<designMatrix>, <avgPosteriorIBDReporter>, <nodeHeightTransform>'s
    ratio columns and <coalescentIntervals> as a statistic, against
    JAX's at the start state."""
    import jax.numpy as jnp

    extra = """<designMatrix id="dm1"><parameter idref="kappa"/></designMatrix>
      <designMatrix id="dm2"><parameter id="x1" value="1 2"/>
        <parameter id="x2" value="3 4"/></designMatrix>
      <avgPosteriorIBDReporter id="ibd">
        <nodePosteriorLikelihood idref="treeLikelihood"/></avgPosteriorIBDReporter>
      <nodeHeightTransform id="nht"><treeModel idref="treeModel"/>
        <ratios><parameter id="ratios"/></ratios></nodeHeightTransform>
      <coalescentIntervals id="ci"><treeModel idref="treeModel"/></coalescentIntervals>"""
    xml = ext_documents({"x": {}})["x"].replace(
        "</coalescentLikelihood>", "</coalescentLikelihood>\n" + extra, 1)
    xml = xml.replace('<treeLikelihood id="treeLikelihood"',
                      '<nodePosteriorLikelihood id="treeLikelihood"').replace(
        "</treeLikelihood>", "</nodePosteriorLikelihood>")
    jax_ax, ax = _analyses(tmp_path, xml)
    for a in (jax_ax, ax):
        a.build(a._ids["treeModel"])
    for name in ("dm1", "dm2"):
        got, want = ax.build(ax._ids[name]), jax_ax.build(jax_ax._ids[name])
        assert got.name == want.name
        np.testing.assert_array_equal(got.value, want.value)
    assert ax.build(ax._ids["ibd"]) is None
    assert jax_ax.build(jax_ax._ids["ibd"]) is None
    from beast_mcmc_tpu.config.xml_assert import initial_eval_state as jinit
    from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state

    jp, jt = jinit(jax_ax)
    tp, tt = initial_eval_state(ax)
    for name in ("nht", "ci"):
        ax.build(ax._ids[name])
        jax_ax.build(jax_ax._ids[name])
    got = ax._column_of(ET.fromstring('<parameter idref="ratios"/>'))
    want = jax_ax._column_of(ET.fromstring('<parameter idref="ratios"/>'))
    assert [c for c, _ in got] == [c for c, _ in want] and len(got) == 5
    s, js = interp._StateShim(tp, tt), jinterp._StateShim(jp, jt)
    np.testing.assert_allclose([float(f(s)) for _, f in got],
                               [float(f(js)) for _, f in want], rtol=1e-12)
    ci, jci = ax.build(ax._ids["ci"]), jax_ax.build(jax_ax._ids["ci"])
    np.testing.assert_allclose(ci(s).numpy(), np.asarray(jci(js)),
                               rtol=1e-12)
    np.testing.assert_allclose([float(f(s)) for _, f in ci.columns],
                               [float(jnp.asarray(f(js)))
                                for _, f in jci.columns], rtol=1e-12)


def test_reward_branch_matrices_match_the_reference_oracle():
    """ops/sericola.py's W matrices against the reference corpus file's
    embedded expectations (tests/test_sericola.py) and the JAX package's
    numpy copy, and the reward branch model's report format."""
    from beast_mcmc_tpu.ops import sericola as jsericola
    from beast_mcmc_tpu_torch.config.xml_ext import RewardBranchModel
    from beast_mcmc_tpu_torch.ops import sericola

    from test_sericola import EXPECTED_W, _q_2state

    args = (_q_2state(), np.array([2.0, 1.0]), np.array([3.75, 3.0, 4.5, 3.0]),
            np.array([2.5, 2.0, 3.0, 2.0]))
    w = sericola.reward_branch_matrices(*args)
    np.testing.assert_allclose(w.reshape(-1), EXPECTED_W, atol=1e-7)
    np.testing.assert_array_equal(w, jsericola.reward_branch_matrices(*args))
    rm = RewardBranchModel(w=np.concatenate([np.eye(2)[None], w]),
                           freqs=np.full(2, 0.5), k=2, root_row=0)
    vals = rm.report(None).split()
    assert vals[:2] == ["W", "matrix:"]
    np.testing.assert_allclose(np.array(vals[2:], float), EXPECTED_W)


def test_sericola_cdf_is_the_transition_probability():
    """The reward density integrates, with the no-jump point masses, to
    the CTMC's transition matrix (tests/test_sericola.py's second
    oracle)."""
    from scipy.integrate import quad
    from scipy.linalg import expm

    from beast_mcmc_tpu_torch.ops.sericola import SericolaMarkovReward

    from test_sericola import _q_2state

    q, r, t = _q_2state(), np.array([1.0, 2.0]), 1.7
    eng = SericolaMarkovReward(q, r)
    p_t = expm(q * t)
    for i in range(2):
        for j in range(2):
            val, _ = quad(lambda x: eng.pdf(x, t)[i, j], r[0] * t, r[1] * t,
                          limit=200)
            mass = np.exp(q[i, i] * t) if i == j else 0.0
            assert abs(val + mass - p_t[i, j]) < 5e-3, (i, j)


def _dollo_tree():
    """((0:1,1:1)3:1,2:2)4 (tests/test_msc_dollo_liability.py)."""
    return (torch.tensor([3, 3, 4, 4, -1]),
            torch.tensor([[-1, -1]] * 3 + [[0, 1], [3, 2]]),
            torch.tensor([0.0, 0.0, 0.0, 1.0, 2.0], dtype=torch.float64))


def test_dollo_oracles_and_jax():
    """models/dollo.py: the per-pattern likelihoods over all 2^N patterns
    sum to the total origin weight, a single-tip pattern equals its
    brute-force sum (tests/test_msc_dollo_liability.py:124-160), and the
    conditioned log-likelihood and its autograd derivative in the death
    rate equal JAX's (jax.grad) to 1e-12."""
    import itertools

    import jax
    import jax.numpy as jnp

    from beast_mcmc_tpu.models import dollo as jdollo
    from beast_mcmc_tpu_torch.models.dollo import (
        stochastic_dollo_loglik,
        stochastic_dollo_site_likelihoods,
    )

    parent, children, heights = _dollo_tree()
    delta = 0.7
    pats = torch.tensor(list(itertools.product([0, 1], repeat=3))).T
    liks = stochastic_dollo_site_likelihoods(pats, parent, children, heights,
                                             delta)
    bl = np.array([1.0, 1.0, 2.0, 1.0])
    total_w = np.sum((1 - np.exp(-delta * bl)) / delta) + 1.0 / delta
    np.testing.assert_allclose(float(liks.sum()), total_w, rtol=1e-12)
    e = np.exp
    die_left = (1 - e(-delta)) + e(-delta) * (1 - e(-delta)) ** 2
    want = (1 - e(-2 * delta)) / delta + e(-2 * delta) * die_left / delta
    got = stochastic_dollo_site_likelihoods(torch.tensor([[0], [0], [1]]),
                                            parent, children, heights, delta)
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-12)

    obs = [[1, 0], [1, 0], [0, 1]]
    jargs = (jnp.asarray(obs), jnp.asarray(parent.numpy()),
             jnp.asarray(children.numpy()), jnp.asarray(heights.numpy()))

    def jf(d):
        return jdollo.stochastic_dollo_loglik(*jargs, d, gain_rate=0.3,
                                              branch_rates=1.3)

    d = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    v = stochastic_dollo_loglik(torch.tensor(obs), parent, children, heights,
                                d, gain_rate=0.3, branch_rates=1.3)
    (g,) = torch.autograd.grad(v, d)
    np.testing.assert_allclose(float(v.detach()), float(jf(0.7)), rtol=1e-12)
    np.testing.assert_allclose(float(g), float(jax.grad(jf)(0.7)),
                               rtol=1e-12)

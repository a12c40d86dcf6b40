"""The port's config/xml_geo.py (its discrete-phylogeography part) against
the JAX package's.

  - <generalDataType> with aliases and ambiguities: the same codes, state
    sets and labels, and <attributePatterns>' states from the taxa's
    attributes;
  - <generalSubstitutionModel> reversible (an eigensystem), with a BSSVS
    rateIndicator and non-reversible (a Q), and
    <complexSubstitutionModel>: Q at random rates and frequencies to
    1e-12;
  - the SVS connectivity prior on connected, disconnected and only weakly
    connected indicator sets, reversible and not, against JAX's and the
    expected 0 or -inf;
  - tests/test_bssvs_phylogeo.py's 4-taxon enumeration oracle of the
    location likelihood through the port's XmlAnalysis, and its annotated
    tree log;
  - the legacy <sequenceSimulator> form: the port's alignment equals
    JAX's state for state.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config import xml_geo as jgeo
from beast_mcmc_tpu.config.xml_assert import initial_eval_state as jinit

from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config import xml_geo
from beast_mcmc_tpu_torch.config.xml_assert import initial_eval_state

from test_bssvs_phylogeo import XML as BSSVS_XML
from test_bssvs_phylogeo import _brute_force_location_loglik


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(tmp_path, xml):
    path = tmp_path / "geo.xml"
    path.write_text(xml)
    return (jinterp.XmlAnalysis(str(path)),
            interp.XmlAnalysis(str(path), device="cpu"))


TAXA = """<taxa id="taxa">
    <taxon id="t1"><attr name="loc">north</attr></taxon>
    <taxon id="t2"><attr name="loc">N</attr></taxon>
    <taxon id="t3"><attr name="loc">X</attr></taxon>
    <taxon id="t4"><attr name="loc">east</attr></taxon>
    <taxon id="t5"><attr name="loc">?</attr></taxon>
    <taxon id="t6"><attr name="loc">west</attr></taxon>
  </taxa>"""
DATATYPE = """<generalDataType id="geo">
    <state code="north"/><state code="south"/><state code="east"/>
    <state code="west"/>
    <alias code="N" state="north"/>
    <ambiguity code="X" states=""/>
  </generalDataType>
  <attributePatterns id="pats" attribute="loc">
    <generalDataType idref="geo"/><taxa idref="taxa"/>
  </attributePatterns>"""


def test_general_data_type_and_attribute_patterns(tmp_path):
    jax_ax, ax = _both(tmp_path, f"<beast>{TAXA}{DATATYPE}</beast>")
    got, want = ax.build(ax._ids["geo"]), jax_ax.build(jax_ax._ids["geo"])
    assert (got.state_count, got.char_map, got.state_sets,
            got.code_chars) == (want.state_count, want.char_map,
                                want.state_sets, want.code_chars)
    assert got.char_map["N"] == 0 and got.state_sets[got.char_map["X"]] \
        == (0, 1, 2, 3)
    pg, pw = ax.build(ax._ids["pats"]), jax_ax.build(jax_ax._ids["pats"])
    np.testing.assert_array_equal(pg.states, pw.states)
    assert pg.taxa == pw.taxa and pg.n_sites == 1
    np.testing.assert_array_equal(pg.tip_partials(), pw.tip_partials())


K = 4
MODELS = {
    "reversible": (K * (K - 1) // 2, False, "generalSubstitutionModel"),
    "svs reversible": (K * (K - 1) // 2, True, "svsGeneralSubstitutionModel"),
    "svs non-reversible": (K * (K - 1), True, "svsGeneralSubstitutionModel"),
    "non-reversible": (K * (K - 1), False, "generalSubstitutionModel"),
    "complex": (K * (K - 1), False, "complexSubstitutionModel"),
}


def _model_xml(n_rates, svs, tag):
    ind = ('<rateIndicator><parameter id="ind" dimension="{}" value="1"/>'
           '</rateIndicator>'.format(n_rates) if svs else "")
    return f"""<beast>{TAXA}{DATATYPE}
  <{tag} id="m">
    <generalDataType idref="geo"/>
    <frequencies><frequencyModel id="fm" normalize="true">
      <generalDataType idref="geo"/>
      <frequencies><parameter id="pi" dimension="{K}"/></frequencies>
    </frequencyModel></frequencies>
    <rates><parameter id="r" dimension="{n_rates}" value="1.0"/></rates>
    {ind}
  </{tag}>
</beast>"""


def _q(sub, params, to_np):
    if sub[0] == "subst_q":
        return to_np(sub[1](params))
    eig = sub[1](params)
    return (to_np(eig.U) * to_np(eig.values)[None, :]) @ to_np(eig.U_inv)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_substitution_models_match_jax(name, tmp_path):
    n_rates, svs, tag = MODELS[name]
    jax_ax, ax = _both(tmp_path, _model_xml(n_rates, svs, tag))
    js, ts = jax_ax.build(jax_ax._ids["m"]), ax.build(ax._ids["m"])
    assert ts[0] == js[0] and ts[3] == js[3] == K
    assert ts[0] == ("subst" if name == "reversible" else "subst_q")
    rng = np.random.default_rng(5)
    for _ in range(3):
        vals = {"r": rng.gamma(2.0, 1.0, n_rates),
                "pi": rng.dirichlet(np.ones(K)),
                "ind": (rng.uniform(size=n_rates) < 0.7).astype(float)}
        jp = {k: jnp.asarray(v) for k, v in vals.items()}
        tp = {k: torch.tensor(v) for k, v in vals.items()}
        want = _q(js, jp, np.asarray)
        got = _q(ts, tp, lambda x: x.numpy())
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(ts[2](tp).numpy(), np.asarray(js[2](jp)),
                                   rtol=1e-15)


CONNECTIVITY = {
    # K = 3 non-reversible order: upper (01, 02, 12), lower (10, 20, 21)
    "connected": ([1, 0, 1, 0, 1, 1], 6, 0.0),
    "disconnected": ([1, 0, 0, 1, 0, 0], 6, -math.inf),
    "weakly connected": ([1, 0, 1, 0, 0, 0], 6, -math.inf),
    "reversible connected": ([1, 0, 1], 3, 0.0),
    "reversible disconnected": ([1, 0, 0], 3, -math.inf),
}


@pytest.mark.parametrize("case", sorted(CONNECTIVITY))
def test_svs_connectivity_prior(case):
    ind, n_rates, want = CONNECTIVITY[case]

    class _Ax:
        dtype = torch.float64
        _svs_models = {"m": ("r", "ind", 3, n_rates)}

    got = float(xml_geo.svs_connectivity_prior(_Ax(), "m").fn(
        {"ind": torch.tensor(ind, dtype=torch.float64)}, None))
    jax_want = float(jgeo.svs_connectivity_prior(_Ax(), "m").fn(
        {"ind": jnp.asarray(ind, jnp.float64)}, None))
    assert got == jax_want == want


def test_location_likelihood_matches_enumeration(tmp_path):
    """tests/test_bssvs_phylogeo.py's oracle through the port: the
    location likelihood of <ancestralTreeLikelihood> equals the sum over
    every internal-state assignment; a run writes every node's location
    into the NEXUS tree log."""
    path = tmp_path / "bssvs.xml"
    path.write_text(BSSVS_XML)
    ax = interp.XmlAnalysis(str(path), workdir=str(tmp_path), device="cpu")
    lik = ax.build(ax._ids["geoLikelihood"])
    params0, tree0 = initial_eval_state(ax)
    got = float(lik.fn(params0, tree0))
    pi = np.array([0.5, 0.5])
    q = np.array([[0.0, 1.4 * 0.5], [0.6 * 0.5, 0.0]])
    np.fill_diagonal(q, -q.sum(axis=1))
    q /= -(pi * np.diag(q)).sum()
    want = _brute_force_location_loglik(
        q, pi, [0, 0, 1, 1], tree0.parent.numpy(), tree0.children.numpy(),
        tree0.heights.numpy(), int(tree0.root), 4)
    assert got == pytest.approx(want, abs=1e-12)
    ax = interp.XmlAnalysis(str(path), workdir=str(tmp_path), device="cpu")
    ax.run()
    trees = (tmp_path / "bssvs_test.trees").read_text()
    first = trees.split("tree STATE_")[1]
    assert first.count("[&loc=") == 7  # 4 tips, 2 internal nodes, the root
    assert 'loc="north"' in trees or 'loc="south"' in trees


SIM_XML = """<beast>
  <taxa id="taxa">
    <taxon id="a"/><taxon id="b"/><taxon id="c"/><taxon id="d"/><taxon id="e"/>
  </taxa>
  <newick id="tree">((a:0.3,b:0.2):0.4,((c:0.1,d:0.15):0.25,e:0.5):0.2)</newick>
  <treeModel id="treeModel"><newick idref="tree"/></treeModel>
  <HKYModel id="hky">
    <frequencies><frequencyModel dataType="nucleotide">
      <frequencies><parameter id="f" value="0.3 0.2 0.2 0.3"/></frequencies>
    </frequencyModel></frequencies>
    <kappa><parameter id="kappa" value="3.0"/></kappa>
  </HKYModel>
  <siteModel id="siteModel">
    <substitutionModel><HKYModel idref="hky"/></substitutionModel>
    <gammaShape gammaCategories="4"><parameter id="alpha" value="0.4"/></gammaShape>
  </siteModel>
  <sequenceSimulator id="sim" replications="400">
    <treeModel idref="treeModel"/><siteModel idref="siteModel"/>
  </sequenceSimulator>
</beast>"""


def test_sequence_simulator_gives_jax_alignment(tmp_path):
    """The legacy <sequenceSimulator> form draws JAX's alignment state for
    state (the same generator, the same draws in the same order, the
    AS91 Gamma rates of JAX's eager start state)."""
    jax.config.update("jax_enable_x64", True)
    jax_ax, ax = _both(tmp_path, SIM_XML)
    want = jax_ax.build(jax_ax._ids["sim"])
    got = ax.build(ax._ids["sim"])
    assert got.taxa == want.taxa and got.datatype.name == "nucleotide"
    np.testing.assert_array_equal(got.states, want.states)
    assert got.states.shape == (5, 400)
    assert len(np.unique(got.states)) == 4
    jinit(jax_ax)  # both analyses' draws are spent: the generators agree
    assert jax_ax._rng.random() == ax._rng.random()

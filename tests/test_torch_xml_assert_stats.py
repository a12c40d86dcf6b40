"""The port's config/xml_assert.py and config/xml_stats.py against the JAX
package's, on inline documents (a fixed Newick tree, so that every value
is deterministic).

  - report strings: a likelihood's, a <report> of text and children, an
    operator's, the grid clock's (config/xml_ext.py, which waited for this
    module's vector format), the estimators' and statistics' (below), the
    same text as JAX's with their numbers to 1e-10 relative;
  - <assertEqual> passes and fails as JAX's does: tolerance (absolute,
    relative), the exact string with its 1e-6 numeric fallback,
    equal="false", actualIndices and charactersToStrip, a regex-extracted
    expected report, an operator report; a wrong value and a missing regex
    match raise AssertionError and a text-only <actual> Unsupported in
    both; after a stochastic <mcmc>, and on a simulated start tree, a
    failed assertion warns and is skipped in both;
  - gradient_report (torch.autograd against jax.grad; the diagonal Hessian
    by a second autograd pass through the plain peel and P(t)) over the
    tree likelihood and coalescent, in two parameters and in the internal
    node heights;
  - config/xml_stats.py: <parameterValues>, <multiplicativeParameter> and
    <fireParameterChanged> through it, <svdStatistic>,
    <sequenceDistanceStatistic> (the Brent optimum and the grid column, as
    a distance and as a likelihood), <ancestralTrait>'s column,
    <property> (a trace analysis's correlation statistics and their mean)
    and <cladeRelationshipStatistic> (sister and aInB); the trait
    statistics (<blombergsK>, <continuousDiffusionStatistic> and
    <traitDataContinuousDiffusionStatistic>) over a small trait document;
    <property name="wishartStatistics"> raises naming config/xml_factor.py.
"""

import re
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config import xml_assert as jassert
from beast_mcmc_tpu.config import xml_stats as jstats

from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config import xml_assert, xml_stats

NUM = re.compile(r"-?\d+\.\d*(?:e[-+]?\d+)?|-?\d+e[-+]?\d+|nan|-?inf")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEQS = {"a": "ACGTACGTACGTAAGGACGTTGCA", "b": "ACGTACGAACGTAAGGACGTTGCA",
        "c": "ACGAACGTACTTAAGGACCTTGCA", "d": "AGGTACGTACGTACGGACGTTGGA",
        "e": "AGGTACGTACGTACGGTCGTAGCA"}
PUTATIVE = {"x1": "ACGTACGTACGTAAGGACGTTGCT", "x2": "AGGTACCTACGTACGGTCGTAGGA"}

HEAD = f"""<beast>
  <taxa id="taxa">{''.join(f'<taxon id="{t}"/>' for t in SEQS)}</taxa>
  <taxa id="put">{''.join(f'<taxon id="{t}"/>' for t in PUTATIVE)}</taxa>
  <alignment id="alignment" dataType="nucleotide">{''.join(
      f'<sequence><taxon idref="{t}"/>{s}</sequence>' for t, s in SEQS.items())}
  </alignment>
  <alignment id="putative" dataType="nucleotide">{''.join(
      f'<sequence><taxon idref="{t}"/>{s}</sequence>'
      for t, s in PUTATIVE.items())}
  </alignment>
  <patterns id="patterns" from="1"><alignment idref="alignment"/></patterns>
  <constantSize id="constant" units="substitutions">
    <populationSize><parameter id="constant.popSize" value="0.1" lower="0.0"/></populationSize>
  </constantSize>
  <newick id="startingTree">((a:0.04,b:0.04):0.03,(c:0.05,(d:0.02,e:0.02):0.03):0.02);</newick>
  <treeModel id="treeModel">
    <newick idref="startingTree"/>
    <rootHeight><parameter id="treeModel.rootHeight"/></rootHeight>
    <nodeHeights internalNodes="true"><parameter id="treeModel.internalNodeHeights"/></nodeHeights>
  </treeModel>
  <coalescentLikelihood id="coalescent">
    <model><constantSize idref="constant"/></model>
    <populationTree><treeModel idref="treeModel"/></populationTree>
  </coalescentLikelihood>
  <HKYModel id="hky">
    <frequencies><frequencyModel dataType="nucleotide">
      <frequencies><parameter id="frequencies" value="0.3 0.2 0.25 0.25"/></frequencies>
    </frequencyModel></frequencies>
    <kappa><parameter id="kappa" value="2.0" lower="0.0"/></kappa>
  </HKYModel>
  <siteModel id="siteModel"><substitutionModel><HKYModel idref="hky"/></substitutionModel></siteModel>
  <treeLikelihood id="treeLikelihood" useAmbiguities="false">
    <patterns idref="patterns"/><treeModel idref="treeModel"/><siteModel idref="siteModel"/>
  </treeLikelihood>
"""

STATS = """
  <ancestralTreeLikelihood id="asr" useAmbiguities="false">
    <patterns idref="patterns"/><treeModel idref="treeModel"/><siteModel idref="siteModel"/>
  </ancestralTreeLikelihood>
  <matrixParameter id="L">
    <parameter id="L1" value="1.0 2.0 -0.5"/><parameter id="L2" value="0.5 -1.0 2.0"/>
  </matrixParameter>
  <multiplicativeParameter id="mp"><parameter id="incr" value="1.5 0.5 2.0"/></multiplicativeParameter>
  <parameterValues id="pv"><parameter idref="kappa"/></parameterValues>
  <parameterValues id="pvm"><multiplicativeParameter idref="mp"/></parameterValues>
  <svdStatistic id="svd"><matrixParameter idref="L"/></svdStatistic>
  <sequenceDistanceStatistic id="sds">
    <ancestralTreeLikelihood idref="asr"/><alignment idref="putative"/><HKYModel idref="hky"/>
  </sequenceDistanceStatistic>
  <sequenceDistanceStatistic id="sdsl" reportDistance="likelihood">
    <ancestralTreeLikelihood idref="asr"/><alignment idref="putative"/><HKYModel idref="hky"/>
  </sequenceDistanceStatistic>
  <ancestralTrait id="at" name="root.state"><ancestralTreeLikelihood idref="asr"/></ancestralTrait>
  <cladeRelationshipStatistic id="sister" relationshipType="sister">
    <treeModel idref="treeModel"/>
    <taxaA><taxon idref="a"/><taxon idref="b"/></taxaA>
    <taxaB><taxon idref="c"/><taxon idref="d"/><taxon idref="e"/></taxaB>
  </cladeRelationshipStatistic>
  <cladeRelationshipStatistic id="notsister" relationshipType="sister">
    <treeModel idref="treeModel"/>
    <taxaA><taxon idref="a"/></taxaA><taxaB><taxon idref="c"/></taxaB>
  </cladeRelationshipStatistic>
  <cladeRelationshipStatistic id="ainb" relationshipType="aInB">
    <treeModel idref="treeModel"/>
    <taxaA><taxon idref="d"/><taxon idref="e"/></taxaA>
    <taxaB><taxon idref="c"/><taxon idref="e"/></taxaB>
  </cladeRelationshipStatistic>
  <gridBasedBranchRateModel id="grid">
    <treeModel idref="treeModel"/>
    <levelSpecificRates><parameter id="grid.rates" value="1.0 2.0 0.5"/></levelSpecificRates>
    <gridPoints><parameter id="grid.points" value="0.02 0.05"/></gridPoints>
  </gridBasedBranchRateModel>
  <traceAnalysis id="ta" fileName="stats.log"/>
  <property id="corr" name="correlationStatistics" index="1"><object idref="ta"/></property>
  <property id="corrmean" name="mean">
    <property name="correlationStatistics" index="0"><object idref="ta"/></property>
  </property>
</beast>
"""


def _analyses(tmp_path, xml, name="doc.xml"):
    path = tmp_path / name
    path.write_text(xml)
    return (jinterp.XmlAnalysis(str(path), workdir=str(tmp_path)),
            interp.XmlAnalysis(str(path), workdir=str(tmp_path),
                               device="cpu"))


def _built(tmp_path):
    rng = np.random.default_rng(1)
    with open(tmp_path / "stats.log", "w") as fh:
        fh.write("state\talpha\tbeta\n")
        for i in range(20):
            fh.write(f"{i * 10}\t{rng.normal()!r}\t{rng.gamma(2.0)!r}\n")
    jax_ax, ax = _analyses(tmp_path, HEAD + STATS)
    for a in (jax_ax, ax):
        a.build(a._ids["treeModel"])
    return jax_ax, ax


def _same_report(got, want, rtol=1e-10):
    """The same text, and the same numbers to rtol."""
    assert NUM.sub("#", got) == NUM.sub("#", want), (got, want)
    g = np.array(NUM.findall(got), float)
    w = np.array(NUM.findall(want), float)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-300)


@pytest.mark.parametrize("tag_id", ["pv", "pvm", "svd", "sister",
                                    "notsister", "ainb", "corr", "corrmean",
                                    "treeLikelihood", "coalescent", "grid"])
def test_reports_equal_jax(tag_id, tmp_path):
    jax_ax, ax = _built(tmp_path)
    _same_report(xml_assert.report_of(ax, ax._ids[tag_id]),
                 jassert.report_of(jax_ax, jax_ax._ids[tag_id]))


@pytest.mark.parametrize("tag_id", ["sds", "sdsl"])
def test_sequence_distance_equals_jax(tag_id, tmp_path):
    """The Brent optimum's report to 1e-7 (scipy's bounded search, xatol
    1e-10, on likelihoods that agree to round-off), and each putative
    taxon's log column, a 1,024-point grid search on the device, to
    1e-10."""
    jax_ax, ax = _built(tmp_path)
    _same_report(xml_assert.report_of(ax, ax._ids[tag_id]),
                 jassert.report_of(jax_ax, jax_ax._ids[tag_id]), rtol=1e-7)
    sds, jsds = ax.build(ax._ids[tag_id]), jax_ax.build(jax_ax._ids[tag_id])
    p, t = xml_stats._current_state(ax)
    jp, jt = jstats._current_state(jax_ax)
    assert [n for n, _ in sds.columns] == [n for n, _ in jsds.columns] == [
        f"{tag_id}.x1", f"{tag_id}.x2"]
    for (_, f), (_, jf) in zip(sds.columns, jsds.columns):
        got = float(f(types.SimpleNamespace(params=p, tree=t)))
        want = float(jf(types.SimpleNamespace(params=jp, tree=jt)))
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_stat_columns(tmp_path):
    """<ancestralTrait>'s column draws a state code of the root from a
    generator of its own (the stream cannot be JAX's); the clade
    statistics' and the multiplicative view's columns equal JAX's."""
    jax_ax, ax = _built(tmp_path)
    (name, col), = ax.build(ax._ids["at"]).columns
    cols = ax._column_of(ax._ids["mp"])
    jcols = jax_ax._column_of(jax_ax._ids["mp"])
    p, t = xml_stats._current_state(ax)
    s = types.SimpleNamespace(params=p, tree=t)
    codes = {float(col(s)) for _ in range(20)}
    assert name == "root.state" and codes <= {0.0, 1.0, 2.0, 3.0}
    for tag_id in ("sister", "notsister", "ainb"):
        (n, f), = ax.build(ax._ids[tag_id]).columns
        (jn, jf), = jax_ax.build(jax_ax._ids[tag_id]).columns
        assert n == jn and float(f(s)) == float(jf(s))
    jp, jt = jstats._current_state(jax_ax)
    assert [c for c, _ in cols] == [c for c, _ in jcols] == ["mp1", "mp2",
                                                             "mp3"]
    for (_, f), (_, jf) in zip(cols, jcols):
        assert float(f(s)) == float(jf(types.SimpleNamespace(params=jp,
                                                              tree=jt)))


@pytest.mark.parametrize("target,value", [
    ('<multiplicativeParameter idref="mp"/>', "2.0 3.0 1.5"),
    ('<parameter idref="kappa"/>', "4.5"),
    ('<matrixParameter idref="L"/>', "1 2 3 4 5 6"),
])
def test_fire_parameter_changed_equals_jax(target, value, tmp_path):
    """The debug operator sets the values (through the view's inverse on
    a multiplicative parameter), always accepted, as JAX's does; and an
    operator as <actual> reports its type."""
    xml = (HEAD + STATS).replace(
        "</beast>", f'<operators id="ops"><fireParameterChanged id="fire" '
        f'value="{value}">{target}</fireParameterChanged></operators>'
        "</beast>")
    jax_ax, ax = _analyses(tmp_path, xml)
    for a in (jax_ax, ax):
        a.build(a._ids["treeModel"])
    (op,), _ = ax.build(ax._ids["ops"])
    (jop,), _ = jax_ax.build(jax_ax._ids["ops"])
    p, t = xml_assert.initial_eval_state(ax)
    jp, jt = jassert.initial_eval_state(jax_ax)
    out, _, logh = op.propose(p, t, None, None)
    jout, _, jlogh = jop.propose(jp, jt, jax.random.PRNGKey(0), None)
    assert op.modified_params() == tuple(jop.modified_params())
    assert float(logh) == float(jlogh) == float("inf")
    for k in op.modified_params():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-15)
    assert xml_assert.report_of(ax, ax._ids["fire"]) == jassert.report_of(
        jax_ax, jax_ax._ids["fire"]) == (
        "operator type: fireParameterChanged\nfireParameterChanged\n")


TRAIT_X = {"a": "0.3 1.2", "b": "0.5 0.9", "c": "-0.4 0.1", "d": "1.1 -0.2",
           "e": "0.8 0.4"}
TRAIT_LIK = """
  <matrixParameter id="prec">
    <parameter id="prec.c1" value="1.2 0.3"/><parameter id="prec.c2" value="0.3 0.9"/>
  </matrixParameter>
  <multivariateDiffusionModel id="diffusion">
    <precisionMatrix><matrixParameter idref="prec"/></precisionMatrix>
  </multivariateDiffusionModel>
  <traitDataLikelihood id="traitLik" traitName="X">
    <multivariateDiffusionModel idref="diffusion"/>
    <treeModel idref="treeModel"/>
    <traitParameter><parameter id="leaf.X"/></traitParameter>
    <conjugateRootPrior>
      <meanParameter><parameter value="0.5 0.5"/></meanParameter>
      <priorSampleSize><parameter value="0.2"/></priorSampleSize>
    </conjugateRootPrior>
  </traitDataLikelihood>"""


@pytest.mark.parametrize("tag", ["blombergsK", "continuousDiffusionStatistic",
                                 "traitDataContinuousDiffusionStatistic"])
def test_trait_statistics_raise_naming_xml_traits(tag, tmp_path):
    """The trait statistics, once waiting for config/xml_traits.py, now
    build over its trait likelihood: their reports (Blomberg's K a trait
    dimension; the dispersal rate of the conditional-mean reconstruction)
    equal JAX's on a small trait document, to 1e-10 relative."""
    head = HEAD
    for t, v in TRAIT_X.items():
        head = head.replace(f'<taxon id="{t}"/>',
                            f'<taxon id="{t}"><attr name="X">{v}</attr>'
                            '</taxon>')
    jax_ax, ax = _analyses(tmp_path, head + TRAIT_LIK + (
        f'<{tag} id="s"><traitDataLikelihood idref="traitLik"/></{tag}>'
        '</beast>'))
    got = xml_assert.report_of(ax, ax._ids["s"])
    want = jassert.report_of(jax_ax, jax_ax._ids["s"])
    assert NUM.sub("#", got) == NUM.sub("#", want)
    np.testing.assert_allclose([float(x) for x in NUM.findall(got)],
                               [float(x) for x in NUM.findall(want)],
                               rtol=1e-10)


def test_wishart_statistics_property_raises_naming_xml_factor(tmp_path):
    """<property name="wishartStatistics"> over config/xml_factor.py's
    statistic (which once raised naming that module): over a trait
    likelihood it reads the scale matrix, JAX's to 1e-10; without one
    the statistic raises Unsupported, as JAX's does."""
    from test_torch_xml_traits_a import rrw_models, trait_doc

    _, ax = _analyses(tmp_path, HEAD + (
        '<wishartStatistics id="ws"/><property id="p" '
        'name="wishartStatistics"><object idref="ws"/></property></beast>'))
    with pytest.raises(interp.Unsupported,
                       match="wishartStatistics without trait likelihood"):
        xml_assert.report_of(ax, ax._ids["p"])
    doc = trait_doc(rrw_models()).replace("</beast>", (
        '<wishartStatistics id="ws"><traitDataLikelihood idref="traitLik"/>'
        '</wishartStatistics><property id="p" name="wishartStatistics">'
        '<object idref="ws"/></property></beast>'))
    jax_ax, ax = _analyses(tmp_path, doc, "traits.xml")
    for a in (jax_ax, ax):
        a.build(a._ids["treeModel"])
    got, want = (np.array(re.findall(r"-?[\d.]+(?:e[-+]?\d+)?", r), float)
                 for r in (xml_assert.report_of(ax, ax._ids["p"]),
                           jassert.report_of(jax_ax, jax_ax._ids["p"])))
    assert got.size == want.size == 4
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_parse_array_equals_jax():
    for s, strip, idx in (("[1.5, 2, -3e-2]", "\\[\\]", None),
                          ("a 1 b 2 c 3", "abc", [2, 0]),
                          ("{0.1,0.2}", "{}", None)):
        np.testing.assert_array_equal(
            xml_assert._parse_array(s, strip, idx),
            jassert._parse_array(s, strip, idx))


# ---------------------------------------------------------------------------
# assertEqual
# ---------------------------------------------------------------------------


def _assert(actual, expected, attrs="", exp_attrs=""):
    return (f"<assertEqual {attrs}><message>m</message>"
            f"<actual {actual[0]}>{actual[1]}</actual>"
            f"<expected {exp_attrs}>{expected}</expected></assertEqual>")


def _values(tmp_path):
    jax_ax, _ = _built(tmp_path)
    lnl = float(jax.jit(jax_ax.build(jax_ax._ids["treeLikelihood"]).fn)(
        *jassert.initial_eval_state(jax_ax)))
    coal = float(jax.jit(jax_ax.build(jax_ax._ids["coalescent"]).fn)(
        *jassert.initial_eval_state(jax_ax)))
    svd = jstats._current_state(jax_ax)
    return lnl, coal, jax_ax.build(jax_ax._ids["svd"])._compute(jax_ax)[0]


TL = 'regex="lnL: (\\S+)"', '<treeLikelihood idref="treeLikelihood"/>'


def test_passing_assertions_pass_in_both(tmp_path):
    lnl, coal, sv = _values(tmp_path)
    asserts = [
        _assert(TL, repr(lnl), 'tolerance="1e-9" toleranceType="relative"'),
        _assert(TL, repr(lnl + 1e-7), 'tolerance="1e-6"'),
        # the exact string differs; the 1e-6 numeric fallback holds it
        _assert(('regex="Total: (\\S+)"',
                 '<coalescentLikelihood idref="coalescent"/>'),
                repr(coal * (1 + 1e-9))),
        _assert(("", '<report>kappa = <parameterValues>'
                 '<parameter idref="kappa"/></parameterValues></report>'),
                "kappa = 2.0"),
        _assert(TL, "0.0", 'equal="false" tolerance="0.01"'),
        _assert(('regex="values: \\[(.*)\\]"', '<svdStatistic idref="svd"/>'),
                f"{float(sv[0])!r}, {float(sv[1])!r}",
                'tolerance="1e-9" actualIndices="0 1"'),
        _assert(TL, '<treeLikelihood idref="treeLikelihood"/>',
                'tolerance="1e-12"', 'regex="likelihood: (\\S+)"'),
        _assert(("", '<fireParameterChanged value="3.0">'
                 '<parameter idref="kappa"/></fireParameterChanged>'),
                "operator type: fireParameterChanged\nfireParameterChanged"),
    ]
    xml = (HEAD + STATS).replace("</beast>", "".join(asserts) + "</beast>")
    for ax in _analyses(tmp_path, xml, "pass.xml"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ax.run()


FAILING = {
    "wrong value": (_assert(TL, "-1.0", 'tolerance="0.5"'), AssertionError,
                    "!= '-1.0'"),
    "wrong string": (_assert(("", '<parameterValues>'
                              '<parameter idref="kappa"/></parameterValues>'),
                             "2.5"), AssertionError, "'2.0' != '2.5'"),
    "no regex match": (_assert(('regex="nothing: (\\S+)"', TL[1]), "1.0"),
                       AssertionError, "regex"),
    "text-only actual": (_assert(("", "1.0"), "1.0"), "Unsupported",
                         "<actual> has no registered builder"),
}


@pytest.mark.parametrize("case", sorted(FAILING))
def test_failing_assertions_fail_in_both(case, tmp_path):
    el, exc, match = FAILING[case]
    xml = HEAD + el + "</beast>"
    for mod, ax in zip((jinterp, interp), _analyses(tmp_path, xml)):
        err = getattr(mod, exc) if isinstance(exc, str) else exc
        with pytest.raises(err, match=re.escape(match)):
            ax.run()


@pytest.mark.parametrize("why", ["after an mcmc", "simulated start tree"])
def test_failed_assertion_warns_and_skips_in_both(why, tmp_path):
    xml = HEAD
    if why == "after an mcmc":
        xml += """<operators id="ops"><scaleOperator scaleFactor="0.75"
          weight="1"><parameter idref="kappa"/></scaleOperator></operators>
          <mcmc id="mcmc" chainLength="20"><posterior id="posterior">
          <likelihood id="likelihood"><treeLikelihood idref="treeLikelihood"/>
          </likelihood></posterior><operators idref="ops"/></mcmc>"""
    else:
        xml = xml.replace(
            '<newick idref="startingTree"/>',
            '<coalescentSimulator><taxa idref="taxa"/>'
            '<constantSize idref="constant"/></coalescentSimulator>')
    xml += _assert(TL, "-1.0", 'tolerance="0.5"') + "</beast>"
    for ax in _analyses(tmp_path, xml):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ax.run(full_eval_steps=2)
        assert any("(skipped): assert m:" in str(x.message) for x in w)


# ---------------------------------------------------------------------------
# gradient_report
# ---------------------------------------------------------------------------


def _spec(ax, names, height_tid):
    return types.SimpleNamespace(
        likelihoods=[ax.build(ax._ids["treeLikelihood"]),
                     ax.build(ax._ids["coalescent"])],
        target_names=lambda: names, height_tid=height_tid)


def _sections(report):
    """{line label: numbers} of a gradient report."""
    out, block = {}, ""
    for line in report.splitlines():
        if line in ("Gradient", "Hessian"):
            block = line
            continue
        label, _, rest = line.partition(":")
        out[f"{block} {label.strip()}"] = np.array(NUM.findall(rest), float)
    return out


@pytest.mark.parametrize("names,height_tid", [
    (["kappa", "constant.popSize"], None), ([], "treeModel")],
    ids=["parameters", "node heights"])
def test_gradient_report_equals_jax(names, height_tid, tmp_path):
    """The analytic gradient and Hessian diagonal to 1e-9 relative, the
    central differences (step 1e-5) to 1e-5."""
    jax_ax, ax = _built(tmp_path)
    got = _sections(xml_assert.gradient_report(ax, _spec(ax, names,
                                                         height_tid)))
    want = _sections(jassert.gradient_report(
        jax_ax, _spec(jax_ax, names, height_tid)))
    assert list(got) == list(want) == [
        "Gradient analytic", "Gradient numeric", "Gradient peeling",
        "Gradient Peeling", "Gradient gradient", "Hessian analytic",
        "Hessian numeric"]
    n = len(names) or 4
    for k in want:
        assert got[k].shape == want[k].shape == (n,), k
        tol = 1e-9 if ("analytic" in k or "eeling" in k
                       or k == "Gradient gradient") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=tol,
                                   atol=tol * np.abs(want[k]).max(),
                                   err_msg=k)

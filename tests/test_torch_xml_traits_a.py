"""The port's config/xml_traits.py against the JAX package's: the
relaxed-random-walk phylogeography document (the vocabulary of chip_smoke
phase 18a at 6 taxa), the Brownian, missing-dimension, drift, OU, elastic
(compound eigen-matrix), integrated-OU and transformed-tree routes of
_build_trait_likelihood, and the branch-rate models (arbitraryBranchRates
and its exp, reciprocal and randomised forms, locationScaledBranchRate
Model, scaledByTreeTimeBranchRates, timeIncrementBranchRateModel).

Each inline document goes through both packages' XmlAnalysis with the
checks of tests/test_torch_interpreter.py::check_against_jax (parameters,
tree, log columns, the posterior and every component at the start and at
5 perturbed states, to 1e-10 relative) and check_chain (the port's chain
with the 0.1 full-evaluation check). arbitraryBranchRates' index map is
held equal to JAX's; the trait likelihood's report_of and the traitLogger
and continuousDiffusionStatistic columns against JAX's; the 12-taxon
relaxed-random-walk document runs through the CLI (run and -testxml), its
start row equal to JAX's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu_torch import __main__ as cli
from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config.xml_assert import report_of

from test_torch_interpreter import _doc, check_against_jax, check_chain

TAXA = "abcdef"
LOC = {"a": "8.1 -10.9", "b": "7.6 -11.8", "c": "9.3 -12.6",
       "d": "6.8 -10.1", "e": "8.9 -13.2", "f": "7.2 -12.0"}
LOC_MISSING = dict(LOC, b="NA -11.8", e="NA NA")
SCALE = """<scaleOperator scaleFactor="0.75" weight="1">
      <parameter idref="{p}"/></scaleOperator>"""
RW = """<randomWalkOperator windowSize="{w}" weight="1">
      <parameter idref="{p}"/></randomWalkOperator>"""

PRECISION = """<matrixParameter id="prec">
      <parameter id="prec.col1" value="0.8 0.1"/>
      <parameter id="prec.col2" value="0.1 0.6"/>
    </matrixParameter>
    <multivariateDiffusionModel id="diffusion">
      <precisionMatrix><matrixParameter idref="prec"/></precisionMatrix>
    </multivariateDiffusionModel>
    <multivariateWishartPrior id="precPrior" df="2">
      <scaleMatrix><matrixParameter>
        <parameter value="1.0 0.0"/><parameter value="0.0 1.0"/>
      </matrixParameter></scaleMatrix>
      <data><matrixParameter idref="prec"/></data>
    </multivariateWishartPrior>"""
RATES = """<arbitraryBranchRates id="rrw" {attrs}>
      <treeModel idref="treeModel"/>
      <rates><parameter id="rrw.rates" value="1.0" lower="0.0"/></rates>
    </arbitraryBranchRates>
    <distributionLikelihood id="rrw.prior">
      <data><parameter idref="rrw.rates"/></data>
      <distribution><gammaDistributionModel>
        <shape><parameter value="0.5"/></shape><scale><parameter value="2.0"/></scale>
      </gammaDistributionModel></distribution>
    </distributionLikelihood>"""
ROOT = """<conjugateRootPrior>
        <meanParameter><parameter id="root.mean" value="8.0 -11.0"/></meanParameter>
        <priorSampleSize><parameter id="root.pss" value="0.5"/></priorSampleSize>
      </conjugateRootPrior>"""


def trait_lik(body, attrs='useTreeLength="true" scaleByTime="true"',
              name="location", lid="traitLik"):
    return f"""<traitDataLikelihood id="{lid}" traitName="{name}" {attrs}
        integrateInternalTraits="true">
      <multivariateDiffusionModel idref="diffusion"/>
      <treeModel idref="treeModel"/>
      <traitParameter><parameter id="leaf.{name}"/></traitParameter>
      {ROOT}
      {body}
    </traitDataLikelihood>"""


def with_attrs(xml, values, name="location"):
    """The document with <attr name=...> on each taxon."""
    for t in TAXA:
        xml = xml.replace(f'<taxon id="{t}">',
                          f'<taxon id="{t}"><attr name="{name}">{values[t]}'
                          f'</attr>')
    return xml


def trait_doc(models, logs="", ops="", priors="", values=LOC, treelik=""):
    """A 6-taxon document with a trait likelihood `traitLik` in the prior
    (beside the sequence likelihood), the precision's Wishart prior and a
    precisionGibbsOperator."""
    return with_attrs(_doc(
        models=PRECISION + models,
        treelik=treelik,
        priors='<multivariateWishartPrior idref="precPrior"/>'
               '<traitDataLikelihood idref="traitLik"/>' + priors,
        ops="""<precisionGibbsOperator weight="2">
          <traitDataLikelihood idref="traitLik"/>
          <multivariateWishartPrior idref="precPrior"/>
        </precisionGibbsOperator>""" + ops,
        logs=logs), values)


RRW_LOGS = """<traitDataLikelihood idref="traitLik"/>
      <continuousDiffusionStatistic id="rate.gcd" greatCircleDistance="true">
        <traitDataLikelihood idref="traitLik"/></continuousDiffusionStatistic>
      <traitDataContinuousDiffusionStatistic id="rate.lin">
        <traitDataLikelihood idref="traitLik"/></traitDataContinuousDiffusionStatistic>
      <traitLogger id="rootLoc" traitName="location" nodes="root">
        <traitDataLikelihood idref="traitLik"/></traitLogger>
      <matrixParameter idref="prec"/>"""
ALL_NODES = """<traitLogger id="allLoc" traitName="location" nodes="all">
        <traitDataLikelihood idref="traitLik"/></traitLogger>"""


def rrw_models(attrs=""):
    return RATES.format(attrs=attrs) + trait_lik(
        '<arbitraryBranchRates idref="rrw"/>')


RRW_PRIORS = '<distributionLikelihood idref="rrw.prior"/>'
RRW_OPS = SCALE.format(p="rrw.rates")

DOCS_A = {
    "rrw": trait_doc(rrw_models(), RRW_LOGS + ALL_NODES, RRW_OPS,
                     RRW_PRIORS),
    "rrw_missing": trait_doc(rrw_models(), RRW_LOGS + ALL_NODES, RRW_OPS,
                             RRW_PRIORS, values=LOC_MISSING),
    "rrw_exp": trait_doc(rrw_models('exp="true" centerAtOne="true"'),
                         RRW_LOGS, RW.format(w=0.3, p="rrw.rates")),
    "rrw_reciprocal_random": trait_doc(
        rrw_models('reciprocal="true" randomizeRates="true" scale="0.3"'),
        RRW_LOGS, RRW_OPS),
    "brownian_homogeneous": trait_doc(
        trait_lik("", attrs=""), RRW_LOGS),
    "drift": trait_doc(trait_lik("""<driftModels>
        <strictClockBranchRates><rate><parameter id="drift.1" value="0.5"/></rate></strictClockBranchRates>
        <strictClockBranchRates><rate><parameter id="drift.2" value="-0.3"/></rate></strictClockBranchRates>
      </driftModels>"""), RRW_LOGS, RW.format(w=0.2, p="drift.1")),
    "ou": trait_doc(trait_lik("""<optimalTraits>
        <strictClockBranchRates><rate><parameter id="opt.1" value="8.2"/></rate></strictClockBranchRates>
        <strictClockBranchRates><rate><parameter id="opt.2" value="-11.5"/></rate></strictClockBranchRates>
      </optimalTraits>
      <strengthOfSelectionMatrix><matrixParameter id="ou.alpha">
        <parameter id="ou.a1" value="1.0 0.1"/><parameter id="ou.a2" value="0.1 0.8"/>
      </matrixParameter></strengthOfSelectionMatrix>"""), RRW_LOGS,
        SCALE.format(p="ou.a1")),
    "elastic_eigen": trait_doc(trait_lik("""<optimalTraits>
        <strictClockBranchRates><rate><parameter id="opt.1" value="8.2"/></rate></strictClockBranchRates>
        <strictClockBranchRates><rate><parameter id="opt.2" value="-11.5"/></rate></strictClockBranchRates>
      </optimalTraits>
      <strengthOfSelectionMatrix><compoundEigenMatrix id="ou.eigen">
        <eigenValues><parameter id="ou.evals" value="1.0 0.5" lower="0.0"/></eigenValues>
        <eigenVectors><matrixParameter id="ou.evecs">
          <parameter id="ou.v1" value="0.3"/><parameter id="ou.v2" value="-0.2"/>
        </matrixParameter></eigenVectors>
      </compoundEigenMatrix></strengthOfSelectionMatrix>"""), RRW_LOGS,
        SCALE.format(p="ou.evals")),
    "integrated_ou": trait_doc(trait_lik("""<optimalTraits>
        <strictClockBranchRates><rate><parameter id="opt.1" value="8.2"/></rate></strictClockBranchRates>
        <strictClockBranchRates><rate><parameter id="opt.2" value="-11.5"/></rate></strictClockBranchRates>
      </optimalTraits>
      <strengthOfSelectionMatrix><matrixParameter id="ou.alpha">
        <parameter id="ou.a1" value="1.0 0.1"/><parameter id="ou.a2" value="0.1 0.8"/>
      </matrixParameter></strengthOfSelectionMatrix>""",
        attrs='integratedProcess="true"'), "",
        SCALE.format(p="ou.a1")),
    "transformed_tree": trait_doc(
        trait_lik("", attrs="").replace(
            '<treeModel idref="treeModel"/>',
            '<transformedTreeModel><treeModel idref="treeModel"/>'
            '<parameter id="lambda" value="0.7" lower="0.0" upper="1.0"/>'
            '</transformedTreeModel>', 1),
        RRW_LOGS, SCALE.format(p="lambda")),
}
_WRAPPED = RATES.format(attrs="").replace(
    '<arbitraryBranchRates id="rrw" >', '<arbitraryBranchRates id="rrw">')
DOCS_A.update({
    "locationScaledBranchRateModel": _doc(
        treelik=f"""<locationScaledBranchRateModel>
          <treeModel idref="treeModel"/>
          {RATES.format(attrs='exp="true"').split('<distributionLikelihood')[0]}
          <fixedEffects><parameter id="loc.effect" value="1.3" lower="0.0"/></fixedEffects>
        </locationScaledBranchRateModel>""",
        ops=RW.format(w=0.2, p="rrw.rates") + SCALE.format(p="loc.effect")),
    "scaledByTreeTimeBranchRates": _doc(
        treelik=f"""<scaledByTreeTimeBranchRates>
          <treeModel idref="treeModel"/>
          {RATES.format(attrs='').split('<distributionLikelihood')[0]}
          <meanRate><parameter id="meanRate" value="0.9" lower="0.0"/></meanRate>
        </scaledByTreeTimeBranchRates>""",
        ops=SCALE.format(p="rrw.rates") + SCALE.format(p="meanRate")),
    "timeIncrementBranchRateModel": _doc(
        treelik=f"""<timeIncrementBranchRateModel>
          <treeModel idref="treeModel"/>
          {RATES.format(attrs='').split('<distributionLikelihood')[0]}
          <taxon idref="c"/>
          <parameter id="offset" value="0.01" lower="0.0"/>
        </timeIncrementBranchRateModel>""",
        ops=SCALE.format(p="rrw.rates") + SCALE.format(p="offset")),
})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DOCS_A))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS_A[name], tmp_path)


@pytest.mark.parametrize("name", sorted(DOCS_A))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS_A[name], tmp_path)


def analyses(tmp_path, xml):
    """(JAX's XmlAnalysis, the port's on the CPU) of xml, tree models
    built."""
    path = tmp_path / "doc.xml"
    path.write_text(xml)
    out = (jinterp.XmlAnalysis(str(path), seed=17),
           interp.XmlAnalysis(str(path), seed=17, device="cpu"))
    for ax in out:
        for el in ax.root.iter("treeModel"):
            if el.get("id"):
                ax.build(el)
    return out


@pytest.mark.parametrize("attrs", ["", 'exp="true"',
                                   'reciprocal="true" centerAtOne="false"'])
def test_arbitrary_branch_rates_index_map_equals_jax(attrs, tmp_path):
    """Distinct rate values through both rates functions: the node ->
    entry map (the reference's DFS post-order numbering, root skipped)
    is JAX's entry for entry, and equals the port's branch_rate_index."""
    from beast_mcmc_tpu.tree.topology import make_tree_state as j_tree
    from beast_mcmc_tpu_torch.config.xml_traits import branch_rate_index
    from beast_mcmc_tpu_torch.tree.topology import make_tree_state

    jax_ax, ax = analyses(tmp_path, _doc(models=RATES.format(attrs=attrs)))
    jc, tc = (a.build(a._ids["rrw"]) for a in (jax_ax, ax))
    tm = ax._trees["treeModel"]
    m = tm.parent.shape[0]
    vals = np.arange(1.0, m) / 7.0
    want = jc.rates({"rrw.rates": jnp.asarray(vals)}, j_tree(
        tm.parent, tm.children, tm.heights, tm.root, jnp.float64))
    got = tc.rates({"rrw.rates": torch.as_tensor(vals)}, make_tree_state(
        tm.parent, tm.children, tm.heights, tm.root, torch.float64, "cpu"))
    # exp differs between the libraries in the last bit
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    idx = branch_rate_index(tm)
    np.testing.assert_array_equal(tc.branch_index.numpy(), idx)
    plain = np.where(np.arange(m) == tm.root, 0.0, vals[idx])
    if not attrs:
        np.testing.assert_array_equal(got.numpy(), plain)
    np.testing.assert_array_equal(ax._params["rrw.rates"].value,
                                  np.asarray(jax_ax._params["rrw.rates"]
                                             .value))


NUM = r"-?\d+\.?\d*(?:e[-+]?\d+)?"


def _numbers(text):
    return np.array(re.findall(NUM, text), float)


@pytest.mark.parametrize("name", ["rrw", "rrw_missing", "ou"])
def test_trait_report_and_columns_equal_jax(name, tmp_path):
    """report_of of the trait likelihood (its log density, trait variance,
    datum and outer-product statistics, config/xml_factor.py's
    wishartStatistics), the statistics' reports and every traitLogger and
    continuousDiffusionStatistic column at three states against JAX's,
    to 1e-10."""
    from beast_mcmc_tpu.config.xml_assert import report_of as j_report

    jax_ax, ax = analyses(tmp_path, DOCS_A[name])
    got = report_of(ax, ax._ids["traitLik"])
    want = j_report(jax_ax, jax_ax._ids["traitLik"])
    assert "Outer-products (DP):" in got
    assert re.sub(NUM, "#", got) == re.sub(NUM, "#", want)
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=1e-10)
    for sid in ("rate.gcd", "rate.lin"):
        np.testing.assert_allclose(
            float(report_of(ax, ax._ids[sid])),
            float(j_report(jax_ax, jax_ax._ids[sid])), rtol=1e-10)
    from test_torch_interpreter import _setup, _perturbed

    _, _, _, jcols, jp, jt = _setup(jinterp, str(tmp_path / "doc.xml"))
    _, _, _, cols, tp, tt = _setup(interp, str(tmp_path / "doc.xml"), "cpu")
    assert [c for c, _ in cols] == [c for c, _ in jcols]
    n_taxa = len(TAXA)
    j_eval = jax.jit(lambda p, t: [f(jinterp._StateShim(p, t))
                                   for _, f in jcols])
    for k in (0, 1, 2):
        p_np, h_np = _perturbed({n: np.asarray(v) for n, v in jp.items()},
                                np.asarray(jt.heights), n_taxa, k)
        want = [float(v) for v in j_eval(
            {n: jnp.asarray(v, jp[n].dtype) for n, v in p_np.items()},
            jt.replace(heights=jnp.asarray(h_np)))]
        s = interp._StateShim({n: torch.tensor(v, dtype=tp[n].dtype)
                               for n, v in p_np.items()},
                              tt.replace(heights=torch.tensor(h_np)))
        got = [float(f(s)) for _, f in cols]
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10,
                                   err_msg=f"{name} state {k}")


def test_log_row_computes_conditionals_once(tmp_path, monkeypatch):
    """One collector row evaluates the node conditionals once for all of
    its traitLogger columns and both diffusion statistics (JAX's jit
    merges the duplicate calls; eager PyTorch shares them)."""
    from beast_mcmc_tpu_torch.models import continuous

    _, ax = analyses(tmp_path, DOCS_A["rrw"])
    calls = []
    real = continuous.affine_gaussian_node_conditionals
    monkeypatch.setattr(continuous, "affine_gaussian_node_conditionals",
                        lambda *a: calls.append(1) or real(*a))
    cols = ax._log_columns(ax.root.find("mcmc").find("log"))
    from test_torch_interpreter import _setup

    _, _, _, _, tp, tt = _setup(interp, str(tmp_path / "doc.xml"), "cpu")
    s = interp._StateShim(tp, tt)
    n_trait_cols = 0
    for name, f in cols:
        f(s)
        n_trait_cols += name.startswith(("location.", "rate."))
    assert n_trait_cols == 2 + 2 + 2 * 11
    assert len(calls) == 1
    s2 = interp._StateShim(dict(tp), tt)
    for _, f in cols:
        f(s2)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the CLI on a 12-taxon relaxed-random-walk document
# ---------------------------------------------------------------------------


def rrw_cli_document(n_taxa=12, seed=3, chain=300):
    """A dated 12-taxon relaxed-random-walk document: HKY on 40 simulated
    sites, a constant coalescent, arbitraryBranchRates under a gamma
    prior, the Wishart-prior precision and its Gibbs substitute, a
    conjugate root; about 8% of the location entries missing."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(n_taxa)]
    dates = np.round(rng.uniform(0.0, 0.05, n_taxa), 3)
    loc = np.column_stack([8.0 + rng.normal(0, 1, n_taxa),
                           -11.0 + rng.normal(0, 1, n_taxa)])
    vals = [f"{la:.4f} {lo:.4f}" for la, lo in loc]
    vals[3] = "NA " + vals[3].split()[1]
    seqs = ["".join(rng.choice(list("ACGT"), 40)) for _ in names]
    taxa = "\n".join(
        f'    <taxon id="{t}"><date value="{d}" direction="backwards"/>'
        f'<attr name="location">{v}</attr></taxon>'
        for t, d, v in zip(names, dates, vals))
    aln = "\n".join(f'    <sequence><taxon idref="{t}"/>{s}</sequence>'
                    for t, s in zip(names, seqs))
    base = _doc(models=PRECISION + rrw_models(),
                priors='<multivariateWishartPrior idref="precPrior"/>'
                       + RRW_PRIORS + '<traitDataLikelihood idref="traitLik"/>',
                ops="""<precisionGibbsOperator weight="2">
          <traitDataLikelihood idref="traitLik"/>
          <multivariateWishartPrior idref="precPrior"/>
        </precisionGibbsOperator>""" + RRW_OPS, logs=RRW_LOGS)
    base = re.sub(r'<taxa id="taxa">.*?</taxa>',
                  f'<taxa id="taxa">\n{taxa}\n  </taxa>', base, flags=re.S)
    base = re.sub(r'<taxa id="clade">.*?</taxa>\s*<taxa id="pair">.*?</taxa>',
                  "", base, flags=re.S)
    base = re.sub(r'(<alignment id="alignment" dataType="nucleotide">).*?'
                  r'(</alignment>)', rf"\1\n{aln}\n  \2", base, flags=re.S)
    return base.replace('chainLength="2000"', f'chainLength="{chain}"')


@pytest.mark.parametrize("mode", ["run", "testxml"])
def test_cli_rrw_document(mode, tmp_path, monkeypatch, capsys):
    """run doc.xml -device cpu (and -testxml): the interpreter's chain with
    its full-evaluation check under 0.1, and the log's first row at the
    start state equal to JAX's columns there."""
    (tmp_path / "rrw.xml").write_text(rrw_cli_document())
    monkeypatch.chdir(tmp_path)
    args = ["run", "rrw.xml", "-device", "cpu", "-seed", "11"]
    rc = cli.main(args + (["-testxml"] if mode == "testxml" else []))
    text = capsys.readouterr()
    assert rc == 0, text.err[-2000:]
    m = re.search(r"full-evaluation deviation (\S+)", text.out + text.err)
    assert m is not None and float(m.group(1).rstrip(";,")) <= 0.1
    log = (tmp_path / "doc.log").read_text().splitlines()
    header = log[0].split("\t")
    assert "rate.gcd" in header
    assert len([h for h in header if h.startswith("location.")]) == 2
    assert len(log) == 1 + 300 // 100
    # the start state's columns against JAX's
    jax_ax, ax = analyses(tmp_path, rrw_cli_document())
    from test_torch_interpreter import _setup

    _, _, _, jcols, jp, jt = _setup(jinterp, str(tmp_path / "doc.xml"))
    _, _, _, cols, tp, tt = _setup(interp, str(tmp_path / "doc.xml"), "cpu")
    want = [float(v) for v in jax.jit(lambda p, t: [
        f(jinterp._StateShim(p, t)) for _, f in jcols])(jp, jt)]
    got = [float(f(interp._StateShim(tp, tt))) for _, f in cols]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

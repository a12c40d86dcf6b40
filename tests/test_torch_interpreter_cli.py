"""The port's command line on the interpreter route, and the registry's
coverage of the JAX package's vocabulary.

`python -m beast_mcmc_tpu_torch run doc.xml -device cpu` sends a document
outside the importer's vocabulary (a random local clock) through the
interpreter and writes its log; `-testxml` runs the conjugate document of
tests/test_distribution_likelihood_xml.py and prints its expectation; a
tag of the last modules ported (config/xml_factor.py's determinantPrior)
runs and agrees with JAX, and a tag neither package registers makes a
non-zero exit naming it. Every tag of the JAX package's _BUILDERS and
_OP_EXT is registered in the port (mirroring tests/test_xml_unified.py's
one-registry contract).
"""

import inspect
import re
import xml.etree.ElementTree as ET

import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp

from beast_mcmc_tpu_torch import __main__ as cli
from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from test_distribution_likelihood_xml import XML as CONJUGATE_XML
from test_torch_interpreter import CLOCKS, _doc
from test_xml_unified import IMPORTER_TAGS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RLC_DOC = _doc(**CLOCKS["randomLocalClockModel"])


def test_cli_runs_a_document_through_the_interpreter(tmp_path, monkeypatch,
                                                      capsys):
    (tmp_path / "rlc.xml").write_text(RLC_DOC)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["run", "rlc.xml", "-device", "cpu", "-chain_length",
                   "200", "-seed", "3"])
    out = capsys.readouterr()
    assert rc == 0
    assert "running through the interpreter registry]" in out.out
    assert "analysis complete" in out.out
    assert "full-evaluation deviation" in out.err
    log = (tmp_path / "doc.log").read_text().splitlines()
    assert log[0].split("\t")[:2] == ["state", "posterior"]
    assert "rlc.changes" in log[0]
    assert [int(r.split("\t")[0]) for r in log[1:]] == [100, 200]
    assert (tmp_path / "doc.trees").read_text().count("tree STATE_") == 2


def test_cli_testxml_runs_the_conjugate_document(tmp_path, monkeypatch,
                                                 capsys):
    (tmp_path / "distlik.xml").write_text(CONJUGATE_XML)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["run", "distlik.xml", "-testxml", "-scale", "0.05",
                   "-device", "cpu", "-seed", "13"])
    out = capsys.readouterr().out
    assert rc == 0
    assert re.search(r"E\[m\] = \S+ \(expected 1\.9934, SE \S+\) OK", out)
    assert "all embedded checks passed" in out


def test_cli_unported_tag_exits_nonzero_naming_its_module(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A <determinantPrior> (config/xml_factor.py's, which once made this
    exit 1) in the prior: the document runs through the CLI and its
    posterior with the prior's new term equals JAX's; a tag that neither
    package registers exits 1 naming it, with and without -testxml."""
    import numpy as np

    det = ('<matrixParameter id="dm"><parameter id="dm.1" value="2.0 0.3"/>'
           '<parameter id="dm.2" value="0.4 1.5"/></matrixParameter>')
    doc = RLC_DOC.replace(
        '<poissonPrior mean="1.0">',
        f'<determinantPrior id="det" shapeParameter="2.0">{det}'
        '</determinantPrior>\n        <poissonPrior mean="1.0">')
    (tmp_path / "ext.xml").write_text(doc)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", "ext.xml", "-device", "cpu"]) == 0
    jax_ax = jinterp.XmlAnalysis(str(tmp_path / "ext.xml"))
    ax = interp.XmlAnalysis(str(tmp_path / "ext.xml"), device="cpu")
    for a in (jax_ax, ax):
        a.build(a._ids["treeModel"])
        a.build(a._ids["det"])
    params = {n: p.value for n, p in ax._params.items()}
    want = float(jax_ax.build(jax_ax._ids["det"]).fn(params, None))
    got = float(ax.build(ax._ids["det"]).fn(
        {n: torch.as_tensor(v, dtype=torch.float64)
         for n, v in params.items()}, None))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert abs(want - 2.0 * np.log(2.0 * 1.5 - 0.3 * 0.4)) < 1e-12
    capsys.readouterr()
    (tmp_path / "bad.xml").write_text(doc.replace(
        '<determinantPrior id="det"', '<notARegisteredPrior id="det"').replace(
        "</determinantPrior>", "</notARegisteredPrior>"))
    for extra in ([], ["-testxml"]):
        rc = cli.main(["run", "bad.xml", "-device", "cpu"] + extra)
        err = capsys.readouterr().err
        assert rc == 1
        assert "<notARegisteredPrior> has no registered builder" in err


def test_cli_particles_stays_refused(tmp_path, capsys):
    """-particles on a document outside the importer's vocabulary (the
    JAX package's CLI ignores the flag there) exits 1 naming
    inference/smc.py; on an importer document it runs
    (tests/test_torch_smc.py)."""
    (tmp_path / "rlc.xml").write_text(RLC_DOC)
    rc = cli.main(["run", str(tmp_path / "rlc.xml"), "-particles",
                   str(tmp_path), "-device", "cpu"])
    assert rc == 1
    assert "inference/smc.py" in capsys.readouterr().err


def _jax_modules():
    """tag -> the JAX module (a path below beast_mcmc_tpu/) registering
    it, for _BUILDERS and _OP_EXT."""
    def path(fn):
        return fn.__module__.replace("beast_mcmc_tpu.", "").replace(
            ".", "/") + ".py"

    return ({t: path(f) for t, f in jinterp._BUILDERS.items()},
            {t: path(f) for t, f in jinterp._OP_EXT.items()})


# the JAX package's extension tags the port registers: all of
# config/xml_ext.py's, xml_mle.py's, xml_assert.py's, xml_stats.py's (with
# its operator, fireParameterChanged), xml_traits.py's (with its operator,
# newLatentLiabilityGibbsOperator), xml_geo.py's, xml_hmc.py's,
# xml_factor.py's and xml_field.py's (dummyModel is xml_factor.py's in
# JAX's registry, which registers it after xml_ext.py, with the same zero
# density; the port's is xml_ext.py's)
PORTED_MODULES = ("config/xml_ext.py", "config/xml_mle.py",
                  "config/xml_assert.py", "config/xml_stats.py",
                  "config/xml_traits.py", "config/xml_geo.py",
                  "config/xml_hmc.py", "config/xml_factor.py",
                  "config/xml_field.py")
PORTED_OP_MODULES = PORTED_MODULES


def _ported(builders):
    return ({t for t, m in builders.items() if m in PORTED_MODULES}
            | {"dummyModel"})


def _ported_ops(ops):
    return {t for t, m in ops.items() if m in PORTED_OP_MODULES}


def test_base_registry_is_the_jax_base_registry():
    builders, ops = _jax_modules()
    base = {t for t, m in builders.items() if m == "config/interpreter.py"}
    assert len(base) == 91
    assert len(_ported(builders)) == 181
    assert set(interp._BUILDERS) == base | _ported(builders)
    assert set(interp._OP_EXT) == _ported_ops(ops)
    assert len(interp._OP_EXT) == 27


def test_every_jax_tag_is_registered_or_names_its_module(tmp_path):
    """Every element and operator tag of JAX's registry is the port's (no
    module is left unported); a bare element of each of the last modules'
    35 element and 7 operator tags builds in both packages or raises an
    exception of the same class name as JAX's builder (never for want of
    a builder), and an unregistered tag raises Unsupported naming it."""
    builders, ops = _jax_modules()
    assert set(builders) <= set(interp._BUILDERS)
    assert set(ops) <= set(interp._OP_EXT)
    last = ("config/xml_factor.py", "config/xml_field.py")
    ext = sorted(t for t, m in builders.items()
                 if m in last and t != "dummyModel")
    op_tags = sorted(t for t, m in ops.items() if m in last)
    assert len(ext) == 35 and len(op_tags) == 7
    body = "".join(f'<{t} id="n{i}"/>' for i, t in enumerate(ext))
    body += "<operators>" + "".join(f"<{t}/>" for t in op_tags) + \
        "</operators>"
    (tmp_path / "all.xml").write_text(f"<beast>{body}<bogusTag/></beast>")
    ax = interp.XmlAnalysis(str(tmp_path / "all.xml"), device="cpu")
    jax_ax = jinterp.XmlAnalysis(str(tmp_path / "all.xml"))

    def outcome(build, el):
        try:
            build(el)
        except Exception as exc:  # noqa: BLE001 -- compared below
            assert "no registered builder" not in str(exc), el.tag
            return type(exc).__name__
        return None

    pairs = [(ax.build, jax_ax.build, el, jel)
             for el, jel in zip(ax.root[:-2], jax_ax.root[:-2])]
    pairs += [(lambda e: interp._build_operator(ax, e),
               lambda e: jinterp._build_operator(jax_ax, e), el, jel)
              for el, jel in zip(ax.root.find("operators"),
                                 jax_ax.root.find("operators"))]
    assert len(pairs) == 42
    for build, jbuild, el, jel in pairs:
        assert outcome(build, el) == outcome(jbuild, jel), el.tag
    with pytest.raises(interp.Unsupported, match="<bogusTag> has no "
                                                 "registered builder"):
        ax.build(ax.root.find("bogusTag"))

def test_importer_vocabulary_is_covered():
    """Each tag the importer reads is in the port's registry, and the run
    entry point falls back to the interpreter past the importer."""
    for tag in IMPORTER_TAGS:
        assert tag in interp._BUILDERS, tag
    src = inspect.getsource(cli)
    assert "XmlImportError" in src and "XmlAnalysis" in src


def test_base_file_branches_into_unported_modules_raise(tmp_path):
    """The base handlers' branches into once unported modules build what
    JAX's registry builds: the pattern-weight operator, which raised
    before config/xml_hmc.py was ported, is its _IdentityOperator (no
    change, always accepted) and the document runs; the
    marginal-likelihood estimator, which raised before config/xml_mle.py
    was ported, runs (tests/test_torch_marginal_likelihood.py); the GMRF
    block update of an ungrouped field, which raised before
    inference/gibbs.py was ported, builds that operator."""
    from beast_mcmc_tpu.config.xml_hmc import (
        _IdentityOperator as JIdentity,
    )
    from beast_mcmc_tpu_torch.config.xml_hmc import _IdentityOperator
    from beast_mcmc_tpu_torch.inference.gibbs import GmrfBlockUpdateOperator

    doc = ET.fromstring(RLC_DOC)
    ops_el = doc.find("operators")
    ET.SubElement(ops_el, "patternWeightIncrementOperator", weight="3")
    (tmp_path / "pw.xml").write_text(ET.tostring(doc, encoding="unicode"))
    ax = interp.XmlAnalysis(str(tmp_path / "pw.xml"), max_states=20,
                            workdir=str(tmp_path), device="cpu")
    jax_ax = jinterp.XmlAnalysis(str(tmp_path / "pw.xml"))
    for a in (ax, jax_ax):
        a.build(a._ids["treeModel"])
    (op,) = [o for o in ax.build(ax.root.find("operators"))[0]
             if isinstance(o, _IdentityOperator)]
    (jop,) = [o for o in jax_ax.build(jax_ax.root.find("operators"))[0]
              if isinstance(o, JIdentity)]
    assert op.weight == jop.weight == 3.0
    assert op.modified_params() == jop.modified_params() == ()
    st = interp._StateShim(
        {"x": torch.ones(2, dtype=torch.float64)},
        make_tree_state([2, 2, -1], [[-1, -1], [-1, -1], [0, 1]],
                        [0.0, 0.0, 1.0], 2, torch.float64, "cpu"))
    params, tree, logh = op.propose(st.params, st.tree, None, None)
    assert params is st.params and tree is st.tree
    assert float(logh) == float(jop.propose({}, None, None, None)[2]) \
        == float("inf")
    ax.run(full_eval_steps=2)
    assert ax.runs[0]["full_eval_deviation"] <= 0.1
    sky = _doc(models="""<gmrfSkyrideLikelihood id="skyride">
        <populationSizes><parameter id="g" value="-2.0"/></populationSizes>
        <precisionParameter><parameter id="tau" value="2.0"/></precisionParameter>
        <populationTree><treeModel idref="treeModel"/></populationTree>
      </gmrfSkyrideLikelihood>""", ops="""<gmrfBlockUpdateOperator weight="2">
        <gmrfSkyrideLikelihood idref="skyride"/></gmrfBlockUpdateOperator>""",
        tree_prior='<gmrfSkyrideLikelihood idref="skyride"/>')
    (tmp_path / "sky.xml").write_text(sky)
    ax = interp.XmlAnalysis(str(tmp_path / "sky.xml"), device="cpu")
    ax.build(ax._ids["treeModel"])
    ops, tids = ax.build(ax.root.find("operators"))
    (block,) = [op for op in ops if isinstance(op, GmrfBlockUpdateOperator)]
    assert (block.field, block.precision, block.n_taxa) == ("g", "tau", 6)
    assert block.time_aware and block.cut_points is None
    assert tids[ops.index(block)] == "treeModel"


def test_phase15_rehearsal(tmp_path):
    """chip_smoke.py's phase 15 on the CPU at 24 taxa: each run's
    likelihood evaluations counted where the card counts peel_stream
    launches, exactly as interpreter_path predicts them; the functions of
    15c on the CPU twice; -testxml's expectation."""
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

    tl._site_logliks = counted
    try:
        rec, launches = chip_smoke.interpreter_path(
            str(tmp_path), reset, read, device_ms, "cpu", n_taxa=24,
            n_sites=300, steps_a=60, steps_b=40, check_b=5, n_profile=3)
        d, _ = chip_smoke.testxml_path(str(tmp_path), reset, read, "cpu")
    finally:
        tl._site_logliks = site
    assert launches["P15 15a CLI"] == {"peel_stream": 1 + 200 + 60 + 6}
    assert launches["P15 15b run"] == {"peel_stream": 1 + 10 + 40 + 4}
    assert rec["15a"]["full_evaluation_deviation"] == 0.0
    assert rec["15a"]["log_rows"] == rec["15a"]["trees"] == 6
    assert rec["15b"]["log_rows"] == rec["15b"]["trees"] == 4
    assert d["rc"] == 0 and abs(d["mean"] - 1.9934) <= 3 * d["se"]
    c = chip_smoke.functions_path("cpu", n_taxa=24)
    assert c["functions"] == 58 and c["max_rel_err"] == 0.0

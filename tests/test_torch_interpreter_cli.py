"""The port's command line on the interpreter route, and the registry's
coverage of the JAX package's vocabulary.

`python -m beast_mcmc_tpu_torch run doc.xml -device cpu` sends a document
outside the importer's vocabulary (a random local clock) through the
interpreter and writes its log; `-testxml` runs the conjugate document of
tests/test_distribution_likelihood_xml.py and prints its expectation; a
tag of an unported extension module makes a non-zero exit whose message
names the module and its queue item. Every tag of the JAX package's
_BUILDERS and _OP_EXT is registered in the port or raises Unsupported
naming the JAX module that registers it (mirroring
tests/test_xml_unified.py's one-registry contract).
"""

import inspect
import re
import xml.etree.ElementTree as ET

import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp

from beast_mcmc_tpu_torch import __main__ as cli
from beast_mcmc_tpu_torch.config import interpreter as interp

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
    doc = RLC_DOC.replace(
        '<poissonPrior mean="1.0">',
        '<determinantPrior id="det"><parameter idref="kappa"/>'
        '</determinantPrior>\n        <poissonPrior mean="1.0">')
    (tmp_path / "ext.xml").write_text(doc)
    monkeypatch.chdir(tmp_path)
    for extra in ([], ["-testxml"]):
        rc = cli.main(["run", "ext.xml", "-device", "cpu"] + extra)
        err = capsys.readouterr().err
        assert rc == 1
        assert "<determinantPrior>" in err
        assert "beast_mcmc_tpu/config/xml_factor.py" in err
        assert "queue item 4g" in err


def test_cli_particles_stays_refused(tmp_path, capsys):
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
# config/xml_ext.py's (dummyModel is xml_factor.py's in JAX's registry,
# which registers it after xml_ext.py, with the same zero density) and the
# discrete-phylogeography part of config/xml_geo.py
PORTED_MODULES = ("config/xml_ext.py",)
PORTED_GEO = {"generalDataType", "attributePatterns",
              "generalSubstitutionModel", "svsGeneralSubstitutionModel",
              "complexSubstitutionModel", "beagleSequenceSimulator",
              "sequenceSimulator"}


def _ported(builders):
    return ({t for t, m in builders.items() if m in PORTED_MODULES}
            | PORTED_GEO | {"dummyModel"})


def test_base_registry_is_the_jax_base_registry():
    builders, ops = _jax_modules()
    base = {t for t, m in builders.items() if m == "config/interpreter.py"}
    assert len(base) == 91
    assert len(_ported(builders)) == 52
    assert set(interp._BUILDERS) == base | _ported(builders)
    assert set(interp._OP_EXT) == {t for t, m in ops.items()
                                   if m in PORTED_MODULES}
    assert len(interp._OP_EXT) == 3


def test_every_jax_tag_is_registered_or_names_its_module(tmp_path):
    builders, ops = _jax_modules()
    ported = _ported(builders)
    ext = sorted(t for t, m in builders.items()
                 if m != "config/interpreter.py" and t not in ported)
    op_tags = sorted(t for t, m in ops.items() if m not in PORTED_MODULES)
    body = "".join(f'<{t} id="n{i}"/>' for i, t in enumerate(ext))
    body += "<operators>" + "".join(f"<{t}/>" for t in op_tags) + \
        "</operators>"
    (tmp_path / "all.xml").write_text(f"<beast>{body}</beast>")
    ax = interp.XmlAnalysis(str(tmp_path / "all.xml"), device="cpu")
    checked = 0
    for el in ax.root:
        if el.tag == "operators":
            continue
        with pytest.raises(interp.Unsupported) as e:
            ax.build(el)
        module = builders[el.tag]
        assert f"beast_mcmc_tpu/{module}" in str(e.value)
        assert f"queue item {interp.QUEUE_ITEMS[module]}" in str(e.value)
        checked += 1
    for el in ax.root.find("operators"):
        with pytest.raises(interp.Unsupported) as e:
            interp._build_operator(ax, el)
        assert f"beast_mcmc_tpu/{ops[el.tag]}" in str(e.value)
        checked += 1
    assert checked == len(ext) + len(op_tags) == 181 + 27 - 52 - 3
    # no tag of config/xml_ext.py, and none of the ported xml_geo.py ones,
    # is left among the unported
    assert not set(interp._TAG_MODULE) & ported
    assert "config/xml_ext.py" not in interp.EXTENSION_TAGS


def test_importer_vocabulary_is_covered():
    """Each tag the importer reads is in the port's registry or is an
    extension module's (which raises naming it), and the run entry point
    falls back to the interpreter past the importer."""
    for tag in IMPORTER_TAGS:
        assert tag in interp._BUILDERS or tag in interp._TAG_MODULE, tag
    src = inspect.getsource(cli)
    assert "XmlImportError" in src and "XmlAnalysis" in src


def test_base_file_branches_into_unported_modules_raise(tmp_path):
    """The base handlers' branches into unported modules raise their
    Unsupported (the marginal-likelihood estimator); the GMRF block update
    of an ungrouped field, which raised before inference/gibbs.py was
    ported, builds that operator as JAX's registry does."""
    from beast_mcmc_tpu_torch.inference.gibbs import GmrfBlockUpdateOperator

    doc = ET.fromstring(RLC_DOC)
    mle = ET.SubElement(doc, "marginalLikelihoodEstimator")
    mle.set("id", "mle")
    (tmp_path / "mle.xml").write_text(ET.tostring(doc, encoding="unicode"))
    ax = interp.XmlAnalysis(str(tmp_path / "mle.xml"), max_states=20,
                            workdir=str(tmp_path), device="cpu")
    with pytest.raises(interp.Unsupported, match="xml_mle.py"):
        ax.run(full_eval_steps=2)
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

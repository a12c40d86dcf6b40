"""The port's post-processing apps and data/io.py against the JAX
package's, on the CPU.

The numpy apps (loganalyser, logcombiner, treeannotator, treestat,
convergence, coalgen, dnds, checkpoint_compat, online, beastgen, plugins,
utils/citations, data/io) are the port's own copies: each test runs the
JAX function and the port's on the same files and numpy seeds and holds
their outputs equal, not to a tolerance, on the cases of tests/test_apps.py,
test_tools.py, test_chkpt_compat.py, test_online.py and the treestat and
coalgen cases of test_smc_online_treestat.py and test_empirical_coalgen.py.
The profiler is a torch port (each operator its own single-operator chain
segment); seqgen's simulator draws from a torch.Generator and is held
statistically: the state frequencies of a simulated alignment against the
model's stationary ones within Monte Carlo error, the JAX simulator's
within the same band. The CLI routes each sub-tool to the port's app.
"""

import contextlib
import dataclasses
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beast_mcmc_tpu.apps.beastgen as jbeastgen
import beast_mcmc_tpu.apps.checkpoint_compat as jchk
import beast_mcmc_tpu.apps.coalgen as jcoalgen
import beast_mcmc_tpu.apps.convergence as jconv
import beast_mcmc_tpu.apps.dnds as jdnds
import beast_mcmc_tpu.apps.loganalyser as jla
import beast_mcmc_tpu.apps.logcombiner as jlc
import beast_mcmc_tpu.apps.online as jonline
import beast_mcmc_tpu.apps.plugins as jplugins
import beast_mcmc_tpu.apps.seqgen as jseqgen
import beast_mcmc_tpu.apps.treeannotator as jta
import beast_mcmc_tpu.apps.treestat as jts
import beast_mcmc_tpu.data.io as jio
import beast_mcmc_tpu.utils.citations as jcite
from beast_mcmc_tpu.models.sitemodel import discrete_gamma_rates as jgamma
from beast_mcmc_tpu.models.substitution import hky_eigen as jhky
from beast_mcmc_tpu.tree.topology import parse_newick as jparse

import beast_mcmc_tpu_torch.apps.beastgen as beastgen
import beast_mcmc_tpu_torch.apps.checkpoint_compat as chk
import beast_mcmc_tpu_torch.apps.coalgen as coalgen
import beast_mcmc_tpu_torch.apps.convergence as conv
import beast_mcmc_tpu_torch.apps.dnds as dnds
import beast_mcmc_tpu_torch.apps.loganalyser as la
import beast_mcmc_tpu_torch.apps.logcombiner as lc
import beast_mcmc_tpu_torch.apps.online as online
import beast_mcmc_tpu_torch.apps.plugins as plugins
import beast_mcmc_tpu_torch.apps.seqgen as seqgen
import beast_mcmc_tpu_torch.apps.treeannotator as ta
import beast_mcmc_tpu_torch.apps.treestat as ts
import beast_mcmc_tpu_torch.data.io as tio
import beast_mcmc_tpu_torch.utils.citations as cite
from beast_mcmc_tpu_torch.__main__ import main as cli
from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.apps.profiler import (
    profile_operators,
    profile_report,
)
from beast_mcmc_tpu_torch.apps.runner import run_analysis
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.models.sitemodel import discrete_gamma_rates
from beast_mcmc_tpu_torch.models.substitution import hky_eigen
from beast_mcmc_tpu_torch.tree.topology import make_tree_state, parse_newick

from test_torch_spec_runner import _plain, _port_spec

# seqgen's band: |frequency - pi| within Z_BAND standard errors
Z_BAND = 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: small tensors, and six test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    """Equal values: dataclasses field by field, arrays exactly."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# loganalyser, logcombiner
# ---------------------------------------------------------------------------


def make_log(tmp_path, name, n=100, seed=0):
    rng = np.random.default_rng(seed)
    lines = ["state\tposterior\tkappa"]
    for i in range(n):
        lines.append(f"{i * 10}\t{-1000 + rng.normal():.6f}\t"
                     f"{2 + rng.normal() * 0.1:.6f}")
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_loganalyser_matches_jax(tmp_path):
    p = make_log(tmp_path, "a.log")
    _same(la.read_log(p), jla.read_log(p))
    states, cols = la.read_log(p)
    assert len(states) == 100 and "kappa" in cols
    stats = la.analyze_log(p, burnin_fraction=0.1)
    _same(stats, jla.analyze_log(p, burnin_fraction=0.1))
    assert abs(stats["kappa"].mean - 2.0) < 0.05
    assert la.report(p) == jla.report(p) and "ESS" in la.report(p)
    args = ["-burnin", "0.2", p]
    assert _stdout(la.main, args) == _stdout(jla.main, args)
    assert (_stdout(cli, ["loganalyser"] + args)
            == _stdout(jla.main, args))


def test_logcombiner_matches_jax(tmp_path):
    p1 = make_log(tmp_path, "a.log", seed=1)
    p2 = make_log(tmp_path, "b.log", seed=2)
    txt = lc.combine_logs([p1, p2], burnin=200)
    assert txt == jlc.combine_logs([p1, p2], burnin=200)
    lines = txt.strip().splitlines()
    assert len(lines) == 1 + 160
    states = [int(ln.split("\t")[0]) for ln in lines[1:]]
    assert states == sorted(states) and states[1] - states[0] == 10
    assert (lc.combine_logs([p1, p2], 100, 40)
            == jlc.combine_logs([p1, p2], 100, 40))
    out_t, out_j = str(tmp_path / "t.log"), str(tmp_path / "j.log")
    assert cli(["logcombiner", "-burnin", "300", p1, p2, out_t]) == 0
    jlc.main(["-burnin", "300", p1, p2, out_j])
    assert open(out_t).read() == open(out_j).read()


# ---------------------------------------------------------------------------
# treeannotator, HIPSTR, convergence
# ---------------------------------------------------------------------------


def test_hpd_matches_jax():
    x = np.random.default_rng(0).normal(size=20000)
    lo, hi = ta.hpd_interval(x, 0.95)
    assert (lo, hi) == jta.hpd_interval(x, 0.95)
    assert abs(lo + 1.96) < 0.08 and abs(hi - 1.96) < 0.08


def _samples(mod, parse, newicks, taxa):
    out = []
    for nwk in newicks:
        p, c, h, r, t = parse(nwk, taxa=taxa)
        out.append(mod.TreeSample(p, c, h, int(r), list(t)))
    return out


def _summaries(newicks, taxa, fn, burnin=0.0):
    """(port's, JAX's) (tree, support, annotations) and annotated newick."""
    got = getattr(ta, fn)(_samples(ta, parse_newick, newicks, taxa), burnin)
    ref = getattr(jta, fn)(_samples(jta, jparse, newicks, taxa), burnin)
    return (got, ta.annotated_newick(got[0], got[2])), (
        ref, jta.annotated_newick(ref[0], ref[2]))


def test_treeannotator_mcc_matches_jax():
    taxa = ["a", "b", "c", "d"]
    newicks = (["((a:1,b:1):1,(c:1,d:1):1);"] * 7
               + ["((a:1,c:1):1,(b:1,d:1):1);"] * 3)
    (got, nwk), (ref, jnwk) = _summaries(newicks, taxa, "summarize_trees")
    _same(got[1], ref[1])
    _same(got[2], ref[2])
    assert nwk == jnwk
    assert got[1][(1 << 0) | (1 << 1)] == 0.7
    assert "posterior=" in nwk and "height_95%_HPD" in nwk


def test_hipstr_matches_jax():
    """Disjoint best splits (HIPSTR combines the majority clades of
    different samples) and a unimodal sample (HIPSTR agrees with MCC)."""
    taxa = ["a", "b", "c", "d", "e"]
    newicks = (["((a:1,b:1):2,((c:1,d:1):1,e:2):1);"] * 4
               + ["((a:1,b:1):2,((c:1,e:1):1,d:2):1);"] * 3
               + ["((a:1,c:1):2,((b:1,d:1):1,e:2):1);"] * 3)
    (got, nwk), (ref, jnwk) = _summaries(newicks, taxa, "hipstr_tree")
    assert nwk == jnwk
    _same(got[1], ref[1])
    assert (1 << 0) | (1 << 1) in set(ta._clades_of(got[0]).values())
    four = ["a", "b", "c", "d"]
    base = ["((a:1,b:1):1,(c:1,d:1):1);", "((a:1,c:1):1,(b:1,d:1):1);",
            "((a:1,d:1):1,(b:1,c:1):1);"]
    uni = base * 5 + base[:1] * 5
    (hip, _), (jhip, _) = _summaries(uni, four, "hipstr_tree")
    (mcc, _), _ = _summaries(uni, four, "summarize_trees")
    assert (set(ta._clades_of(hip[0]).values())
            == set(ta._clades_of(mcc[0]).values())
            == set(jta._clades_of(jhip[0]).values()))


def test_treeannotator_on_run_output(tmp_path):
    """A short run of the port, its tree log annotated by both packages;
    the CLI's output file equal to JAX's main's."""
    tree_f = str(tmp_path / "x.trees")
    run_analysis(_port_spec("strict clock"), tree_file=tree_f,
                 verbose=False, device="cpu")
    trees, jtrees = ta.read_trees_file(tree_f), jta.read_trees_file(tree_f)
    assert len(trees) == 10
    _same(trees, jtrees)
    mcc, _, ann = ta.summarize_trees(trees, burnin_fraction=0.2)
    nwk = ta.annotated_newick(mcc, ann)
    jmcc, _, jann = jta.summarize_trees(jtrees, burnin_fraction=0.2)
    assert nwk == jta.annotated_newick(jmcc, jann)
    assert nwk.count("posterior=") == len(mcc.taxa) - 1
    out_t, out_j = str(tmp_path / "t.tree"), str(tmp_path / "j.tree")
    assert cli(["treeannotator", "-burnin", "0.2", tree_f, out_t]) == 0
    jta.main(["-burnin", "0.2", tree_f, out_j])
    assert open(out_t).read() == open(out_j).read()


def test_convergence_matches_jax():
    rng = np.random.default_rng(1)
    same = [rng.normal(0, 1, 1000) for _ in range(4)]
    shifted = [rng.normal(0, 1, 1000), rng.normal(3, 1, 1000)]
    assert conv.psrf(same) == jconv.psrf(same)
    assert abs(conv.psrf(same) - 1.0) < 0.02
    assert conv.psrf(shifted) == jconv.psrf(shifted) > 1.5
    traces = [{"a": same[0], "b": shifted[0]},
              {"a": same[1], "b": shifted[1]}]
    assert conv.psrf_report(traces) == jconv.psrf_report(traces)
    for t in ([{"a": shifted[0]}, {"a": shifted[1]}],
              [{"a": same[0]}, {"a": same[1]}]):
        assert conv.converged(t) == jconv.converged(t)
    assert not conv.converged([{"a": shifted[0]}, {"a": shifted[1]}])

    def two(mod):
        kw = dict(children=np.asarray([[-1, -1]] * 4
                                      + [[0, 1], [2, 3], [4, 5]]),
                  heights=np.asarray([0, 0, 0, 0, 1.0, 1.0, 2.0]), root=6,
                  taxa=["a", "b", "c", "d"])
        t1 = mod.TreeSample(parent=np.asarray([4, 4, 5, 5, 6, 6, -1]), **kw)
        kw["children"] = np.asarray([[-1, -1]] * 4
                                    + [[0, 2], [1, 3], [4, 5]])
        t2 = mod.TreeSample(parent=np.asarray([4, 5, 4, 5, 6, 6, -1]), **kw)
        return t1, t2

    (t1, t2), (j1, j2) = two(ta), two(jta)
    d = conv.max_clade_deviation([t1] * 10, [t1] * 5 + [t2] * 5,
                                 burnin_fraction=0.0)
    assert d == jconv.max_clade_deviation([j1] * 10, [j1] * 5 + [j2] * 5,
                                          burnin_fraction=0.0) == 0.5
    assert conv.max_clade_deviation([t1] * 10, [t1] * 10, 0.0) == 0.0
    _same(conv.clade_frequencies([t1, t2, t2]),
          jconv.clade_frequencies([j1, j2, j2]))


# ---------------------------------------------------------------------------
# treestat, coalgen
# ---------------------------------------------------------------------------


def test_treestat_matches_jax():
    bal = "((A:1,B:1):1,(C:1,D:1):1);"
    cat = "(((A:1,B:1):1,C:2):1,D:3);"
    tipward = "((A:0.1,B:0.1):4.9,(C:0.2,D:0.2):4.8);"
    rootward = "((A:4.9,B:4.9):0.1,(C:4.8,D:4.8):0.2);"
    rows = ts.treestat_report([bal, cat, tipward, rootward])
    _same(rows, jts.treestat_report([bal, cat, tipward, rootward]))
    assert rows[0]["cherryCount"] == 2 and rows[1]["cherryCount"] == 1
    assert rows[0]["collessImbalance"] == 0.0
    assert rows[1]["collessImbalance"] > 0.5
    assert rows[0]["treeLength"] == 6.0
    assert rows[2]["gammaStatistic"] > 0 > rows[3]["gammaStatistic"]
    assert ts.format_report(rows) == jts.format_report(rows)


def test_coalgen_matches_jax(tmp_path):
    n, pop, reps = 6, 2.0, 2000
    got = [coalgen.simulate_demographic_tree(
        rng, np.zeros(n), coalgen.ConstantPopulation(pop))
        for rng in [np.random.default_rng(0)] for _ in range(reps)]
    ref = [jcoalgen.simulate_demographic_tree(
        rng, np.zeros(n), jcoalgen.ConstantPopulation(pop))
        for rng in [np.random.default_rng(0)] for _ in range(reps)]
    _same(got, ref)
    tm = np.array([h[r] for _, _, h, r in got])
    want = 2.0 * pop * (1.0 - 1.0 / n)
    assert abs(tm.mean() - want) < 4 * tm.std() / np.sqrt(reps)

    taxa = [f"t{i}" for i in range(5)]
    kw = dict(tip_dates=[0, 1, 2, 0, 1], n_trees=20, seed=1)
    text = coalgen.simulate_trees_nexus(
        taxa, demographic=coalgen.ExponentialGrowth(2.0, 1.5), **kw)
    assert text == jcoalgen.simulate_trees_nexus(
        taxa, demographic=jcoalgen.ExponentialGrowth(2.0, 1.5), **kw)
    f = tmp_path / "sim.trees"
    f.write_text(text)
    trees = ta.read_trees_file(str(f))
    assert len(trees) == 20 and sorted(trees[0].taxa) == sorted(taxa)
    assert all(t.heights[t.root] > 2.0 for t in trees)
    args = ["-taxa", "a,b,c,d", "-dates", "0,1,0,2", "-growth", "0.5",
            "-ntrees", "3", "-seed", "9"]
    assert _stdout(coalgen.main, args) == _stdout(jcoalgen.main, args)

    stats = ts.treestat_report(re.findall(r"=\s*(?:\[&R\]\s*)?(\(.*;)",
                                          text))
    assert len(stats) == 20
    nexus = str(tmp_path / "t.txt")
    assert cli(["treestat", str(f), "-output", nexus]) == 0
    jts.main([str(f), "-output", str(tmp_path / "j.txt")])
    assert open(nexus).read() == open(tmp_path / "j.txt").read()


# ---------------------------------------------------------------------------
# data/io, beastgen, dnds, citations, plugins
# ---------------------------------------------------------------------------


FASTA = """>taxon_A_2001
ACGTACGTACGTACGTACGT
>taxon_B_2003
ACGTACGAACGTACGTACGA
>taxon_C_2005
ACGAACGTACGTACCTACGT
>taxon_D_2002
ACGTACGTACCTACGTAGGT
"""

NEXUS = """#NEXUS
begin taxa;
  dimensions ntax=3;
  taxlabels a b c;
end;
begin data;
  dimensions ntax=3 nchar=8;
  format datatype=dna missing=? gap=-;
  matrix
    a ACGTRY-?
    b ACGTACGT
    c ACG-ACNN
  ;
end;
begin trees;
  translate 1 a, 2 b, 3 c;
  tree one = [&R] ((1:1,2:1):1,3:2);
  tree two = ((1:0.5,3:0.5):1.5,2:2);
end;
"""


def test_data_io_matches_jax():
    _same(tio.read_fasta(FASTA), jio.read_fasta(FASTA))
    aln = tio.read_fasta(FASTA)
    assert tio.write_fasta(aln) == jio.write_fasta(jio.read_fasta(FASTA))
    assert tio.read_fasta(tio.write_fasta(aln)).states.tolist() == \
        aln.states.tolist()
    _same(tio.read_nexus(NEXUS), jio.read_nexus(NEXUS))
    _, trees = tio.read_nexus(NEXUS)
    assert list(trees) == ["one", "two"]


def test_beastgen_matches_jax(tmp_path):
    for name in sorted(beastgen.TEMPLATES):
        kw = dict(fasta_text=FASTA, chain_length=400, log_every=100,
                  date_regex=r"_(\d{4})$")
        assert _plain(beastgen.generate(name, **kw)) == _plain(
            jbeastgen.generate(name, **kw))
    assert sorted(beastgen.TEMPLATES) == sorted(jbeastgen.TEMPLATES)
    spec = beastgen.generate("hky_strict_constant", fasta_text=FASTA,
                             chain_length=400, log_every=100,
                             date_regex=r"_(\d{4})$")
    assert spec.tree.tip_heights["taxon_C_2005"] == 0.0
    assert spec.tree.tip_heights["taxon_A_2001"] == 4.0
    log_path = str(tmp_path / "bgtest.log")
    out = run_analysis(spec, log_file=log_path, verbose=False, device="cpu")
    assert np.isfinite(float(out.state.log_posterior))
    assert os.path.exists(log_path)
    with pytest.raises(KeyError):
        beastgen.generate("nope", fasta_text=FASTA)
    names = ["a_2000", "b_2010", "nodate"]
    assert (beastgen.tip_heights_from_names(names, r"_(\d{4})$")
            == jbeastgen.tip_heights_from_names(names, r"_(\d{4})$")
            == {"a_2000": 10.0, "b_2010": 0.0})
    assert beastgen.tip_heights_from_names(["a"], None) is None


def test_dnds_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    n = 2000
    us, un = rng.gamma(50, 0.02, n), rng.gamma(50, 0.02, n)
    cols = {"u_S[1]": us, "u_N[1]": un,
            "c_S[1]": us * rng.gamma(100, 0.01, n),
            "c_N[1]": un * rng.gamma(100, 0.01, n),
            "u_S[2]": us, "u_N[2]": un,
            "c_S[2]": us * rng.gamma(100, 0.01, n),
            "c_N[2]": un * 2.0 * rng.gamma(100, 0.01, n)}
    rows = dnds.dnds_per_site(cols, burnin_fraction=0.0)
    _same(rows, jdnds.dnds_per_site(cols, burnin_fraction=0.0))
    assert abs(rows[0].mean_dnds - 1.0) < 0.05
    assert abs(rows[1].mean_dnds - 2.0) < 0.1
    assert rows[1].prob_positive > 0.99 and rows[1].hpd_lower > 1.2
    assert (dnds.report(cols, burnin_fraction=0.0)
            == jdnds.report(cols, burnin_fraction=0.0))
    log = tmp_path / "dnds.log"
    log.write_text("state\t" + "\t".join(cols) + "\n" + "".join(
        f"{i}\t" + "\t".join(f"{cols[c][i]:.8g}" for c in cols) + "\n"
        for i in range(200)))
    assert (_stdout(dnds.main, [str(log)])
            == _stdout(jdnds.main, [str(log)]))


def test_citations_match_jax(tmp_path):
    keys = ["hky", "skygrid", "hky", "unknown_model"]
    cites = cite.citations_for(keys)
    assert cites == jcite.citations_for(keys)
    assert any("Hasegawa" in c for c in cites)
    assert len(cites) == len(set(cites))
    cite.write_citations_file(str(tmp_path / "t.txt"), ["gtr", "nuts"])
    jcite.write_citations_file(str(tmp_path / "j.txt"), ["gtr", "nuts"])
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert "Tavare" in text and "No-U-Turn" in text


def test_plugin_loading(tmp_path):
    plug = tmp_path / "my_ext.py"
    plug.write_text(
        "def register(registry):\n"
        "    registry['templates']['custom_tpl'] = lambda p, d: ('spec', p)\n"
        "    registry['operators']['myop'] = object\n")
    reg = plugins.default_registry()
    assert reg["templates"] is beastgen.TEMPLATES
    assert list(reg) == list(jplugins.default_registry())
    try:
        assert plugins.load_plugins(str(tmp_path), reg) == ["my_ext"]
        assert "custom_tpl" in reg["templates"]
        assert "myop" in reg["operators"]
    finally:
        beastgen.TEMPLATES.pop("custom_tpl", None)
    assert plugins.load_plugins(str(tmp_path / "nope")) == []


# ---------------------------------------------------------------------------
# checkpoint_compat, online
# ---------------------------------------------------------------------------


def _chkpt(mod):
    # ((A:1,B:1):1,C:2) in BEAST-style arbitrary node numbering
    tree = mod.ChkptTree(
        "treeModel", np.array([3, 3, 4, 4, -1], np.int32),
        np.array([[-1, -1], [-1, -1], [-1, -1], [0, 1], [3, 2]], np.int32),
        np.array([0.0, 0.0, 0.0, 1.0, 2.0]), {0: "A", 1: "B", 2: "C"},
        np.zeros((5, 0)))
    return mod.ChkptState(
        state=12345, lnl=-987.654321, rng=[1, 2, 3, 4],
        parameters={"kappa": np.array([2.5]),
                    "frequencies": np.array([0.1, 0.2, 0.3, 0.4])},
        operators={"scale(kappa)": (10, 20, 0.75, 30)},
        trees={"treeModel": tree})


def test_chkpt_roundtrip_matches_jax(tmp_path):
    t_path, j_path = str(tmp_path / "t.chkpt"), str(tmp_path / "j.chkpt")
    chk.write_checkpoint(t_path, _chkpt(chk))
    jchk.write_checkpoint(j_path, _chkpt(jchk))
    assert open(t_path).read() == open(j_path).read()
    back = chk.read_checkpoint(t_path)
    _same(back, jchk.read_checkpoint(t_path))
    assert back.state == 12345 and back.rng == [1, 2, 3, 4]
    assert back.operators["scale(kappa)"][:2] == (10, 20)
    _same(chk.chkpt_to_tree_arrays(back.trees["treeModel"], ["A", "B", "C"]),
          jchk.chkpt_to_tree_arrays(back.trees["treeModel"],
                                    ["A", "B", "C"]))


def test_chkpt_restore_reproduces_log_posterior(tmp_path):
    log_post, operators, params0, tree0, _ = build_analysis(
        n_taxa=6, n_patterns=32, model="hky", device="cpu")
    step = make_mcmc_step(log_post, operators)
    state = init_mcmc_state(params0, tree0, torch.Generator().manual_seed(3),
                            operators, log_post)
    state, _ = run_chain(step, state, 50)
    lnl = float(state.log_posterior)
    taxa = [f"t{i}" for i in range(6)]
    tree = chk.ChkptTree("treeModel", state.tree.parent.numpy(),
                         state.tree.children.numpy(),
                         state.tree.heights.numpy(),
                         {i: taxa[i] for i in range(6)}, np.zeros((11, 0)))
    path = str(tmp_path / "resume.chkpt")
    chk.write_checkpoint(path, chk.ChkptState(
        state=50, lnl=lnl, rng=[0],
        parameters={k: v.numpy() for k, v in state.params.items()},
        operators={}, trees={"treeModel": tree}))
    back = chk.read_checkpoint(path)
    tree2 = make_tree_state(*chk.chkpt_to_tree_arrays(
        back.trees["treeModel"], taxa), dtype=torch.float64, device="cpu")
    params2 = {k: torch.as_tensor(back.parameters[k]).reshape(v.shape)
               for k, v in state.params.items()}
    assert float(log_post(params2, tree2)) == pytest.approx(
        lnl, rel=1e-9, abs=1e-9)


def _valid_tree(parent, children, heights, root, n_tips):
    assert int((parent < 0).sum()) == 1 and parent[root] == -1
    for i in range(parent.shape[0]):
        if i != root:
            p = int(parent[i])
            assert heights[p] >= heights[i] and i in children[p]
    for i in range(n_tips, parent.shape[0]):
        assert (children[i] >= 0).all()


def test_online_insert_matches_jax():
    from beast_mcmc_tpu_torch.data.datatype import NUCLEOTIDES

    a, b = NUCLEOTIDES.encode("ACGTACGT"), NUCLEOTIDES.encode("ACGTACGA")
    c = NUCLEOTIDES.encode("ACGTACG?")
    for x, y in ((a, b), (a, a), (a, c)):
        assert online.jc_distance(x, y) == jonline.jc_distance(x, y)
    assert online.jc_distance(a, c) == 0.0 < online.jc_distance(a, b)
    taxa = ["A", "B", "C", "D"]
    parent = np.array([4, 4, 5, 6, 5, 6, -1], np.int32)
    children = np.array([[-1, -1]] * 4 + [[0, 1], [4, 2], [5, 3]], np.int32)
    heights = np.array([0, 0, 0, 0, 1.0, 2.0, 3.0])
    seqs = {k: NUCLEOTIDES.encode(v) for k, v in {
        "A": "AAAAAAAAAA", "B": "AAAAAAAAAC", "C": "CCCCCAAAAA",
        "D": "CCCCCCCCAA", "E": "AAAAAAAACC", "F": "CCCCCCCAAA"}.items()}
    args = (taxa, parent, children, heights, 6, seqs, ["E", "F"], [0.0, 0.0])
    res = online.insert_taxa_by_alignment(*args)
    _same(res, jonline.insert_taxa_by_alignment(*args))
    assert res.taxa == ["A", "B", "C", "D", "E", "F"]
    _valid_tree(res.parent, res.children, res.heights, res.root, 6)
    e_sib = [ch for ch in res.children[res.parent[4]] if ch != 4][0]
    assert e_sib in (0, 1)


def test_online_update_resumes(tmp_path):
    """A chain written to a BEAST-format checkpoint, two taxa inserted by
    both packages (equal results), the port's chain resumed at the new
    shape with a finite posterior and its full-evaluation check."""
    from beast_mcmc_tpu_torch.data.alignment import Alignment
    from beast_mcmc_tpu_torch.inference.operators import (
        RootHeightScaleOperator,
        ScaleOperator,
        UniformNodeHeightOperator,
    )
    from beast_mcmc_tpu_torch.models.coalescent import (
        constant_coalescent_loglik,
    )
    from beast_mcmc_tpu_torch.models.substitution import gtr_eigen
    from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
    from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

    rng = np.random.default_rng(1)
    names = [f"t{i}" for i in range(6)]
    seqs = ["".join(rng.choice(list("ACGT"), 60)) for _ in names]
    aln = Alignment.from_sequences(names, seqs)
    freqs = torch.full((4,), 0.25, dtype=torch.float64)

    def build(aln_obj):
        n = aln_obj.n_taxa
        tab = aln_obj.datatype.ambiguity_table(np.float64)
        tips = torch.as_tensor(np.swapaxes(tab[aln_obj.states], 1, 2))
        weights = torch.ones(aln_obj.n_sites, dtype=torch.float64)

        def log_post(params, tree):
            rates, cw = discrete_gamma_rates(params["alpha"], 4)
            return tree_loglikelihood(
                tips, weights, tree.parent, tree.children, tree.heights,
                tree.root, gtr_eigen(params["gtr.rates"], freqs), freqs,
                rates, cw, params["clock.rate"]) + constant_coalescent_loglik(
                tree.heights, n, params["pop.size"])

        return log_post

    tree0 = make_tree_state(*simulate_coalescent_tree(rng, np.zeros(6), 1.0),
                            dtype=torch.float64, device="cpu")
    params0 = {"gtr.rates": torch.ones(6, dtype=torch.float64),
               **{k: torch.tensor(v, dtype=torch.float64) for k, v in
                  (("alpha", 0.5), ("clock.rate", 1.0), ("pop.size", 1.0))}}
    ops = [ScaleOperator(parameter="pop.size"),
           UniformNodeHeightOperator(weight=5.0), RootHeightScaleOperator()]
    log_post = build(aln)
    step = make_mcmc_step(log_post, ops)
    st = init_mcmc_state(params0, tree0, torch.Generator().manual_seed(0),
                         ops, log_post)
    st, _ = run_chain(step, st, 50)
    path = str(tmp_path / "online.chkpt")
    chk.write_checkpoint(path, chk.ChkptState(
        state=50, lnl=float(st.log_posterior), rng=[0, 0],
        parameters={k: np.atleast_1d(v.numpy()) for k, v in
                    st.params.items()},
        operators={}, trees={"treeModel": chk.ChkptTree(
            "treeModel", st.tree.parent.numpy(), st.tree.children.numpy(),
            st.tree.heights.numpy(), {i: names[i] for i in range(6)},
            np.zeros((11, 0)))}))

    new_names = ["t6", "t7"]
    new_seqs = [seqs[0][:55] + "CCCCC", seqs[3][:55] + "GGGGG"]
    states_map = {n: aln.datatype.encode(s)
                  for n, s in zip(names + new_names, seqs + new_seqs)}
    args = (path, "treeModel", states_map, new_names, [0.0, 0.0])
    res, params_back = online.online_update_from_chkpt(*args, rate=1.0)
    _same((res, params_back),
          jonline.online_update_from_chkpt(*args, rate=1.0))
    assert res.taxa == names + new_names
    _valid_tree(res.parent, res.children, res.heights, res.root, 8)

    log_post2 = build(Alignment.from_sequences(res.taxa, seqs + new_seqs))
    tree2 = make_tree_state(res.parent, res.children, res.heights,
                            int(res.root), dtype=torch.float64, device="cpu")
    params2 = {k: torch.as_tensor(params_back[k]).reshape(v.shape)
               for k, v in params0.items()}
    step2 = make_mcmc_step(log_post2, ops)
    st2 = init_mcmc_state(params2, tree2, torch.Generator().manual_seed(1),
                          ops, log_post2)
    assert np.isfinite(float(st2.log_posterior))
    st2, _ = run_chain(step2, st2, 50)
    assert full_evaluation_check(step2, log_post2, st2, 20)[1] < 0.1


# ---------------------------------------------------------------------------
# profiler (torch), seqgen (statistical)
# ---------------------------------------------------------------------------


def test_profiler_times_operators():
    """mcmcprof analog (MarkovChain.java:255-275): per-operator timing
    rows and the combined states/hour estimate."""
    log_post, operators, params0, tree0, _ = build_analysis(
        n_taxa=6, n_patterns=16, model="hky", device="cpu")
    prof = profile_operators(log_post, operators[:3], params0, tree0,
                             seed=1, n_steps=50)
    assert [r["name"] for r in prof["rows"]] == [
        f"{type(op).__name__}({getattr(op, 'parameter', '') or ''})"
        for op in operators[:3]]
    assert all(r["steps_per_sec"] > 0 for r in prof["rows"])
    assert prof["states_per_hour"] > 0
    rep = profile_report(prof)
    assert "states/hour" in rep and "us/step" in rep


SEQGEN_NEWICK = ("(((a:0.2,b:0.2):0.3,(c:0.1,d:0.1):0.4):0.5,"
                 "((e:0.3,f:0.3):0.2,(g:0.6,h:0.6):0.1):0.3);")
SEQGEN_FREQS = [0.1, 0.2, 0.3, 0.4]


def _band(states, pi):
    """|mean state frequency - pi| in standard errors of the per-column
    frequencies (columns are independent; tips within one are not)."""
    per_col = np.stack([(states == s).mean(0) for s in range(4)], -1)
    se = per_col.std(0) / np.sqrt(per_col.shape[0])
    return np.abs(per_col.mean(0) - pi) / se


def test_seqgen_frequencies_match_the_model():
    """Under HKY + Gamma4 the tips' state frequencies are the stationary
    ones: the port's alignment within Z_BAND standard errors of them, the
    JAX simulator's as well, and the two alignments' frequencies within the
    same band of each other."""
    n_sites, pi = 4000, np.asarray(SEQGEN_FREQS)
    parent, children, heights, root, taxa = parse_newick(SEQGEN_NEWICK)
    tr = [torch.as_tensor(x, dtype=dt) for x, dt in
          ((parent, torch.long), (children, torch.long),
           (heights, torch.float64))]
    freqs = torch.tensor(SEQGEN_FREQS, dtype=torch.float64)
    rates, w = discrete_gamma_rates(torch.tensor(0.5, dtype=torch.float64), 4)
    aln = seqgen.simulate_alignment(
        torch.Generator().manual_seed(5), taxa, *tr, int(root),
        hky_eigen(torch.tensor(2.0, dtype=torch.float64), freqs), freqs,
        rates, w, torch.tensor(1.0, dtype=torch.float64), n_sites)
    assert aln.states.shape == (8, n_sites) and list(aln.taxa) == taxa
    z = _band(aln.states, pi)
    assert (z < Z_BAND).all(), z

    jp, jc, jh, jr, jt = jparse(SEQGEN_NEWICK)
    jf = jnp.asarray(SEQGEN_FREQS)
    jr_rates, jw = jgamma(0.5, 4)
    jaln = jseqgen.simulate_alignment(
        jax.random.PRNGKey(5), jt, jp, jc, jh, int(jr),
        jhky(jnp.asarray(2.0), jf), jf, jr_rates, jw, jnp.asarray(1.0),
        n_sites)
    assert (_band(np.asarray(jaln.states), pi) < Z_BAND).all()
    pooled = np.concatenate([aln.states, np.asarray(jaln.states)], 1)
    per_col = np.stack([(pooled == s).mean(0) for s in range(4)], -1)
    se = per_col.std(0) * np.sqrt(2.0 / n_sites)
    diff = np.abs(np.stack([(aln.states == s).mean() for s in range(4)])
                  - np.stack([(np.asarray(jaln.states) == s).mean()
                              for s in range(4)]))
    assert (diff < Z_BAND * se).all(), diff / se


def test_seqgen_cli(tmp_path):
    for spec in ("length=300,model=GTR,alpha=0.5", "length=7,model=JC",
                 "length=500,kappa=3,freqs=1:2:3:4,rate=0.5"):
        assert seqgen._parse_partition(spec) == jseqgen._parse_partition(
            spec)
    tree_f = tmp_path / "t.nwk"
    tree_f.write_text(SEQGEN_NEWICK + "\n")
    out = str(tmp_path / "sim.fasta")
    assert cli(["seqgen", "-tree", str(tree_f), "-partition",
                "length=300,model=GTR,alpha=0.5", "-partition",
                "length=200,model=HKY,kappa=4", "-seed", "3", "-output",
                out, "-device", "cpu"]) == 0
    aln = tio.read_fasta(open(out).read())
    assert aln.taxa == list("abcdefgh") and aln.states.shape == (8, 500)
    assert aln.states.max() < 4
    nex = _stdout(seqgen.main, ["-tree", str(tree_f), "-format", "nexus",
                                "-device", "cpu"])
    assert nex.startswith("#NEXUS") and "nchar=500" in nex
    assert cli(["seqgen", "-tree", str(tmp_path / "none.nwk"),
                "-device", "cpu"]) != 0

"""The port's spec route (config/, apps/runner.py, inference/checkpoint.py,
__main__.py) against the JAX package's, on the CPU in float64.

- The four priors of the config layer, exponential_growth_loglik,
  yule_loglik and birth_death_loglik against JAX's to 1e-12 relative.
- The proposal laws of UniformIntegerOperator and SwapOperator
  (chi-square, p-value above P_FLOOR at a fixed seed).
- build() on each spec of tests/test_config.py (strict clock, relaxed
  clock + Gamma, skygrid + GTR, codon partitions, BSSVS) and on Yule,
  birth-death, exponential-growth, TN93 + pInv + mu and Dirichlet-GTR
  specs: the parameter names, the operators' kinds, targets and weights,
  and the log posterior at params0/tree0 against JAX's build to 1e-10
  relative (JAX's under jit); the golden HKY likelihood at kappa 29.739445,
  -1825.21317 to 2e-5 (tests/test_config.py:43).
- run_analysis end to end (a Tracer log and a NEXUS tree file), and a
  checkpointed chain that continues bit for bit.
- parse_beast_xml of an inline document and of chip_smoke.spec_document at
  12 taxa x 300 sites: the same spec numbers as JAX's importer; the data
  types' encoding (a lookup table for ASCII) against JAX's loop.
- The CLI with -device cpu: importer mode, -save_state/-load_state,
  -overwrite refusal, the unknown command (2), -mc3_chains 2 (the cold
  chain's log), the refused modes, a sub-tool's missing input; phase 12 of
  chip_smoke.py rehearsed at a small size with its launch counts.
"""

import dataclasses
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import beast_mcmc_tpu.config.spec as JS
import beast_mcmc_tpu.data.alignment as jal
import beast_mcmc_tpu.data.datatype as jdt
from beast_mcmc_tpu.config.builder import build as jax_build
from beast_mcmc_tpu.config.xml_import import parse_beast_xml as jax_parse
from beast_mcmc_tpu.models import coalescent as jcoal
from beast_mcmc_tpu.models import priors as jpriors
from beast_mcmc_tpu.models import speciation as jspn

import beast_mcmc_tpu_torch.config.spec as TS
import beast_mcmc_tpu_torch.data.alignment as tal
import beast_mcmc_tpu_torch.data.datatype as tdt
import beast_mcmc_tpu_torch.models.treelikelihood as tl
from beast_mcmc_tpu_torch.__main__ import main
from beast_mcmc_tpu_torch.apps.runner import run_analysis
from beast_mcmc_tpu_torch.config.builder import build
from beast_mcmc_tpu_torch.config.xml_import import (
    XmlImportError,
    parse_beast_xml,
)
from beast_mcmc_tpu_torch.inference.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.operators import (
    SwapOperator,
    UniformIntegerOperator,
)
from beast_mcmc_tpu_torch.models import coalescent, priors, speciation
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    parse_newick,
    simulate_coalescent_tree,
)
from beast_mcmc_tpu_torch.utils.dtypes import default_float

from fixtures import PRIMATE_NEWICK, PRIMATE_SEQS, PRIMATE_TAXA

FN_TOL = 1e-12  # the priors and tree priors, relative
POST_TOL = 1e-10  # a built analysis's log posterior, relative
GOLDEN_HKY, GOLDEN_TOL = -1825.21317, 2e-5
P_FLOOR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: small tensors, and six test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


# ---------------------------------------------------------------------------
# priors and tree priors
# ---------------------------------------------------------------------------


def _close(got, ref, tol=FN_TOL):
    got, ref = float(got), float(ref)
    if math.isinf(ref):
        assert got == ref
    else:
        assert got == pytest.approx(ref, rel=tol, abs=1e-300)


def test_priors_match_jax():
    x = np.array([0.2, 0.7, 1.5])
    simplex = np.array([0.2, 0.3, 0.5])
    for vals in (x, np.array([-0.1, 0.5]), np.array([0.5, 2.5])):
        _close(priors.uniform_logpdf(_t(vals), 0.0, 2.0),
               jpriors.uniform_logpdf(jnp.asarray(vals), 0.0, 2.0))
        _close(priors.normal_logpdf(_t(vals), 0.4, 1.7),
               jpriors.normal_logpdf(jnp.asarray(vals), 0.4, 1.7))
        _close(priors.ctmc_scale_logpdf(_t(vals), 3.7),
               jpriors.ctmc_scale_logpdf(jnp.asarray(vals), 3.7))
    for vals in (simplex, simplex * 1.01, np.array([0.0, 0.5, 0.5])):
        alpha = np.array([1.5, 2.0, 0.7])
        _close(priors.dirichlet_logpdf(_t(vals), _t(alpha)),
               jpriors.dirichlet_logpdf(jnp.asarray(vals),
                                        jnp.asarray(alpha)))
    _close(priors.uniform_logpdf(_t(0.5), 0.0, math.inf),
           jpriors.uniform_logpdf(jnp.asarray(0.5), 0.0, jnp.inf))


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_priors_match_jax(seed):
    rng = np.random.default_rng(seed)
    tips = np.zeros(9) if seed == 0 else rng.random(9) * 0.3
    parent, children, heights, root = simulate_coalescent_tree(rng, tips, 0.8)
    h, jh = _t(heights), jnp.asarray(heights)
    for pop, rate in ((1.3, 0.4), (0.7, -0.9), (2.0, 1e-14), (2.0, 0.0)):
        _close(coalescent.exponential_growth_loglik(h, 9, pop, rate),
               jcoal.exponential_growth_loglik(jh, 9, pop, rate))
    if seed == 0:  # the speciation densities are for ultrametric trees
        for r in (0.5, 2.0):
            _close(speciation.yule_loglik(h, 9, torch.tensor(root), r),
                   jspn.yule_loglik(jh, 9, root, r))
            for a, rho, lab in ((0.3, 1.0, True), (0.6, 0.4, False)):
                _close(speciation.birth_death_loglik(
                    h, 9, torch.tensor(root), r, a, rho, labeled=lab),
                    jspn.birth_death_loglik(jh, 9, root, r, a, rho,
                                            labeled=lab))


# ---------------------------------------------------------------------------
# the relaxed clock's category operators
# ---------------------------------------------------------------------------


def _tree():
    parent, children, heights, root, _ = parse_newick(PRIMATE_NEWICK,
                                                      taxa=PRIMATE_TAXA)
    return make_tree_state(parent, children, heights, root, device="cpu")


def test_uniform_integer_operator_law():
    """A uniform dimension set to a uniform value in [lower, upper]."""
    op = UniformIntegerOperator(parameter="c", lower=1, upper=4)
    x0 = torch.zeros(5, dtype=torch.int32)
    tree, gen, n = _tree(), torch.Generator().manual_seed(3), 20_000
    where, value = np.zeros(5), np.zeros(4)
    for _ in range(n):
        p, t, logh = op.propose({"c": x0}, tree, gen, None)
        assert float(logh) == 0.0 and t is tree
        assert p["c"].dtype == torch.int32
        changed = np.flatnonzero(p["c"].numpy() != 0)
        assert len(changed) == 1
        where[changed[0]] += 1
        value[int(p["c"][changed[0]]) - 1] += 1
    for counts in (where, value):
        stat = np.sum((counts - n / len(counts)) ** 2 / (n / len(counts)))
        assert chi2.sf(stat, len(counts) - 1) > P_FLOOR


def test_swap_operator_law():
    """Two distinct dimensions, the unordered pair uniform, swapped."""
    op = SwapOperator(parameter="c")
    x0 = torch.arange(5, dtype=torch.int32)
    tree, gen, n = _tree(), torch.Generator().manual_seed(4), 20_000
    pairs = {}
    for _ in range(n):
        p, _, logh = op.propose({"c": x0}, tree, gen, None)
        assert float(logh) == 0.0
        new = p["c"].numpy()
        changed = tuple(np.flatnonzero(new != x0.numpy()))
        assert len(changed) == 2
        assert new[changed[0]] == changed[1] and new[changed[1]] == changed[0]
        pairs[changed] = pairs.get(changed, 0) + 1
    counts = np.array(list(pairs.values()))
    assert len(counts) == 10
    stat = np.sum((counts - n / 10) ** 2 / (n / 10))
    assert chi2.sf(stat, 9) > P_FLOOR


# ---------------------------------------------------------------------------
# build(): the same analysis as JAX's
# ---------------------------------------------------------------------------


def _patterns(al, seqs=PRIMATE_SEQS, taxa=PRIMATE_TAXA, **kw):
    return al.SitePatterns.from_alignment(
        al.Alignment.from_sequences(taxa, seqs), **kw)


def _strict(S, al):
    return S.AnalysisSpec(
        partitions=[S.Partition(patterns=_patterns(al),
                                substitution=S.HKY())],
        tree=S.TreeSpec(newick=PRIMATE_NEWICK),
        clock=S.StrictClock(rate=S.Param(1.0, estimate=False)),
        tree_prior=S.ConstantCoalescent(
            pop_size=S.Param(0.05, prior=S.OneOnXPrior())),
        mcmc=S.MCMCSpec(chain_length=200, log_every=20, seed=5))


def _relaxed(S, al, dt):
    spec = _strict(S, al)
    spec.partitions[0].site_model = S.SiteModel(
        categories=4, alpha=S.Param(0.5, prior=S.ExponentialPrior(0.5)))
    spec.clock = S.RelaxedClockLognormal(
        mean=S.Param(1.0, estimate=False),
        stdev=S.Param(0.3, prior=S.ExponentialPrior(1.0 / 3.0)))
    return spec


def _skygrid(S, al, dt):
    spec = _strict(S, al)
    spec.partitions[0].substitution = S.GTR()
    spec.tree_prior = S.SkygridCoalescent(n_cells=8, cutoff=0.12)
    return spec


def _codon(S, al, dt):
    spec = _strict(S, al)
    spec.partitions = [
        S.Partition(patterns=_patterns(al, site_range=(i, -1), every=3),
                    substitution=S.HKY(), name=f"cp{i + 1}")
        for i in range(3)]
    spec.tree_prior = S.ConstantCoalescent(pop_size=S.Param(0.05))
    return spec


def _bssvs(S, al, dt):
    datatype = dt.general_datatype(["A", "B", "C", "D"])
    pats = al.SitePatterns.from_alignment(al.Alignment.from_sequences(
        [f"t{i}" for i in range(6)], ["A", "B", "C", "D", "A", "B"],
        datatype))
    return S.AnalysisSpec(
        partitions=[S.Partition(
            patterns=pats,
            substitution=S.GeneralReversible(n_states=4, bssvs=True))],
        tree=S.TreeSpec(seed=2),
        clock=S.StrictClock(rate=S.Param(1.0, prior=S.CTMCScalePrior())),
        tree_prior=S.ConstantCoalescent(),
        mcmc=S.MCMCSpec(chain_length=200, log_every=20))


def _tree_prior(kind):
    def make(S, al, dt):
        spec = _strict(S, al)
        spec.tree_prior = getattr(S, kind)()
        return spec
    return make


def _tn93_pinv(S, al, dt):
    spec = _strict(S, al)
    spec.partitions[0].substitution = S.TN93()
    spec.partitions[0].site_model = S.SiteModel(
        p_invariant=S.Param(0.2, upper=1.0, prior=S.UniformPrior(0.0, 1.0)),
        mu=S.Param(1.1, prior=S.NormalPrior(1.0, 0.5)))
    spec.clock = S.StrictClock(rate=S.Param(
        0.9, prior=S.LogNormalPrior(0.0, 1.0)))
    return spec


def _dirichlet_gtr(S, al, dt):
    spec = _strict(S, al)
    spec.partitions[0].substitution = S.GTR(
        rates=S.Param(np.full(6, 1.0 / 6.0), prior=S.DirichletPrior(2.0),
                      operator_weight=2.0),
        frequencies="equal")
    spec.partitions[0].site_model = S.SiteModel(
        categories=4, alpha=S.Param(0.8, prior=S.GammaPrior(2.0, 0.5)))
    return spec


VARIANTS = {
    "strict clock": lambda S, al, dt: _strict(S, al),
    "relaxed clock + gamma": _relaxed,
    "skygrid + GTR": _skygrid,
    "codon partitions": _codon,
    "BSSVS": _bssvs,
    "Yule": _tree_prior("YulePrior"),
    "birth-death": _tree_prior("BirthDeathPrior"),
    "exponential growth": _tree_prior("ExponentialGrowthCoalescent"),
    "TN93 + pInv + mu": _tn93_pinv,
    "Dirichlet GTR + gamma": _dirichlet_gtr,
}


def _port_spec(name):
    return VARIANTS[name](TS, tal, tdt)


def _ops(operators):
    return [(type(op).__name__, float(op.weight),
             getattr(op, "parameter", None), tuple(getattr(op, "up", ())))
            for op in operators]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_build_matches_jax(name):
    a = build(_port_spec(name), device="cpu")
    j = jax_build(VARIANTS[name](JS, jal, jdt))
    assert list(a.params0) == list(j.params0)
    assert a.taxa == list(j.taxa) and a.n_taxa == j.n_taxa
    assert _ops(a.operators) == _ops(j.operators)
    for k, v in a.params0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j.params0[k]))
    np.testing.assert_array_equal(a.tree0.parent.numpy(),
                                  np.asarray(j.tree0.parent))
    np.testing.assert_array_equal(a.tree0.heights.numpy(),
                                  np.asarray(j.tree0.heights))
    got = a.log_posterior(a.params0, a.tree0)
    assert got.dtype == torch.float64
    ref = float(jax.jit(j.log_posterior)(j.params0, j.tree0))
    assert np.isfinite(ref)
    assert float(got) == pytest.approx(ref, rel=POST_TOL)
    assert float(a.log_prior(a.params0, a.tree0)) == pytest.approx(
        float(jax.jit(j.log_prior)(j.params0, j.tree0)), rel=POST_TOL)


def test_golden_hky_likelihood():
    a = build(_port_spec("strict clock"), device="cpu")
    params = {**a.params0, "p1.kappa": torch.tensor(29.739445,
                                                    dtype=torch.float64)}
    ll = float(a.log_likelihood(params, a.tree0))
    assert ll == pytest.approx(GOLDEN_HKY, abs=GOLDEN_TOL)


def test_default_float():
    """f64 unless the spec names its type; `spec.dtype` builds in it."""
    assert default_float() == torch.float64
    assert build(_port_spec("strict clock"), device="cpu"
                 ).tree0.heights.dtype == torch.float64
    spec = dataclasses.replace(_port_spec("strict clock"), dtype=torch.float32)
    a = build(spec, device="cpu")
    assert a.tree0.heights.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in a.params0.values())
    assert torch.isfinite(a.log_posterior(a.params0, a.tree0))


# ---------------------------------------------------------------------------
# runner and checkpoints
# ---------------------------------------------------------------------------


def test_run_analysis_end_to_end(tmp_path):
    log_f, tree_f = str(tmp_path / "run.log"), str(tmp_path / "run.trees")
    ckpt_f = str(tmp_path / "run.ckpt")
    res = run_analysis(_port_spec("strict clock"), log_file=log_f,
                       tree_file=tree_f, checkpoint_file=ckpt_f,
                       verbose=False, device="cpu")
    assert np.isfinite(res.samples["posterior"]).all()
    assert res.ess["posterior"] > 0
    assert list(res.states) == list(range(20, 220, 20))
    lines = open(log_f).read().splitlines()
    header = [ln for ln in lines if ln.startswith("state")][0]
    assert header.split("\t") == ["state", "posterior",
                                  "treeModel.rootHeight", "p1.kappa",
                                  "constant.popSize"]
    assert sum(ln[:1].isdigit() for ln in lines) == 10
    trees_txt = open(tree_f).read()
    assert trees_txt.startswith("#NEXUS")
    assert trees_txt.count("tree STATE_") == 10
    assert trees_txt.rstrip().endswith("End;")
    assert os.path.exists(ckpt_f + ".npz")
    assert os.path.exists(ckpt_f + ".manifest.json")
    # two Metropolis-coupled chains: 200 states in two swap rounds of 100
    mc3 = run_analysis(_port_spec("strict clock"), mc3_chains=2,
                       verbose=False, device="cpu")
    assert mc3.report.startswith("MC3: 2 chains, temperatures [1.0, 0.5]")
    assert list(mc3.states) == [100, 200]
    assert np.isfinite(mc3.samples["posterior"]).all()


def _state_equal(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for f in ("parent", "children", "heights", "root"):
        assert torch.equal(getattr(a.tree, f), getattr(b.tree, f)), f
    for f in ("log_posterior", "op_adapt", "op_adapt_count", "op_accept",
              "op_reject", "op_sum_accept"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.step == b.step


def test_checkpoint_continues_bit_for_bit(tmp_path):
    """50 steps, saved, loaded into a template of another seed and run 50
    more: the state of 100 straight steps, exactly (the relaxed clock's
    integer categories included)."""
    a = build(_port_spec("relaxed clock + gamma"), device="cpu")
    step = make_mcmc_step(a.log_posterior, a.operators)

    def start(seed):
        return init_mcmc_state(a.params0, a.tree0,
                               torch.Generator().manual_seed(seed),
                               a.operators, a.log_posterior)

    straight, _ = run_chain(step, start(0), 100)
    half, _ = run_chain(step, start(0), 50)
    path = str(tmp_path / "chk")
    save_checkpoint(path, half)
    resumed = load_checkpoint(path, start(9), a.log_posterior, tolerance=0.0)
    assert resumed.step == 50
    resumed, _ = run_chain(step, resumed, 50)
    _state_equal(straight, resumed)
    # a corrupted posterior is refused
    bad = half.replace(log_posterior=half.log_posterior + 1.0)
    save_checkpoint(path, bad)
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(path, start(9), a.log_posterior)


# ---------------------------------------------------------------------------
# the importer
# ---------------------------------------------------------------------------


INLINE = """<?xml version="1.0"?>
<beast>
  <taxa id="taxa">
{taxa}
  </taxa>
  <alignment id="alignment" dataType="nucleotide">
{seqs}
  </alignment>
  <patterns id="patterns" from="1"><alignment idref="alignment"/></patterns>
  <constantSize id="constant" units="years">
    <populationSize><parameter id="constant.popSize" value="0.05"/></populationSize>
  </constantSize>
  <strictClockBranchRates id="branchRates">
    <rate><parameter id="clock.rate" value="1.0"/></rate>
  </strictClockBranchRates>
  <HKYModel id="hky">
    <frequencies><frequencyModel dataType="nucleotide">
      <frequencies><parameter id="hky.frequencies" value="0.25 0.25 0.25 0.25"/></frequencies>
    </frequencyModel></frequencies>
    <kappa><parameter id="kappa" value="2.0" lower="0.0"/></kappa>
  </HKYModel>
  <siteModel id="siteModel">
    <substitutionModel><HKYModel idref="hky"/></substitutionModel>
    <gammaShape gammaCategories="4"><parameter id="alpha" value="0.5" lower="0.0"/></gammaShape>
  </siteModel>
  <treeLikelihood id="treeLikelihood" useAmbiguities="true">
    <patterns idref="patterns"/>
    <siteModel idref="siteModel"/>
  </treeLikelihood>
  <operators id="operators">
    <scaleOperator scaleFactor="0.75" weight="1"><parameter idref="kappa"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="2"><parameter idref="alpha"/></scaleOperator>
    <scaleOperator scaleFactor="0.75" weight="3"><parameter idref="constant.popSize"/></scaleOperator>
  </operators>
  <mcmc id="mcmc" chainLength="60">
    <posterior id="posterior">
      <prior id="prior">
        <logNormalPrior mean="1.0" stdev="1.25"><parameter idref="kappa"/></logNormalPrior>
        <exponentialPrior mean="0.5"><parameter idref="alpha"/></exponentialPrior>
        <oneOnXPrior><parameter idref="constant.popSize"/></oneOnXPrior>
      </prior>
    </posterior>
    <log logEvery="20" fileName="inline.log"/>
  </mcmc>
</beast>
""".format(
    taxa="\n".join(f'    <taxon id="{t}"><date value="{2000 + i}" '
                   'direction="forwards"/></taxon>'
                   for i, t in enumerate(PRIMATE_TAXA)),
    seqs="\n".join(f'    <sequence><taxon idref="{t}"/>{s}</sequence>'
                   for t, s in zip(PRIMATE_TAXA, PRIMATE_SEQS)))


def _plain(obj):
    """A spec as nested plain values: class names, floats, sorted
    patterns with their weights."""
    if hasattr(obj, "weights") and hasattr(obj, "states"):  # SitePatterns
        cols = sorted(zip(map(tuple, np.asarray(obj.states).T.tolist()),
                          np.asarray(obj.weights).tolist()))
        return {"taxa": list(obj.taxa), "n_sites": obj.n_sites,
                "datatype": obj.datatype.name, "columns": cols}
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {f.name: _plain(getattr(obj, f.name))
                                     for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


@pytest.fixture(scope="module")
def spec_doc(tmp_path_factory):
    """chip_smoke.spec_document at 12 taxa x 300 sites, on the CPU."""
    import chip_smoke

    path = str(tmp_path_factory.mktemp("spec") / "spec12.xml")
    info = chip_smoke.spec_document(path, 12, 300, 666, "cpu")
    assert info["taxa"] == 12 and info["sites"] == 300
    return path


def test_importer_matches_jax(spec_doc):
    for text in (INLINE, open(spec_doc).read()):
        got, ref = parse_beast_xml(text), jax_parse(text)
        assert _plain(got) == _plain(ref)
    spec = parse_beast_xml(open(spec_doc).read())
    assert type(spec.clock).__name__ == "RelaxedClockLognormal"
    assert spec.tree_prior.n_cells == 50 and spec.mcmc.log_every == 10
    assert type(spec.partitions[0].substitution).__name__ == "GTR"
    a = build(spec, device="cpu")
    j = jax_build(jax_parse(open(spec_doc).read()))
    assert _ops(a.operators) == _ops(j.operators)
    assert float(a.log_posterior(a.params0, a.tree0)) == pytest.approx(
        float(jax.jit(j.log_posterior)(j.params0, j.tree0)), rel=POST_TOL)


def test_encode_matches_the_loop():
    """DataType.encode's lookup table against the JAX package's
    character loop, on every ASCII character in both cases and a
    non-ASCII string (the port's loop path), for each data type the
    importer and the joint use."""
    text = "".join(map(chr, range(128))) * 2 + "acgtn-?"
    for name in ("NUCLEOTIDES", "AMINO_ACIDS", "BINARY"):
        np.testing.assert_array_equal(getattr(tdt, name).encode(text),
                                      getattr(jdt, name).encode(text))
    for states in (["A", "B", "C", "D"], ["loc00", "loc01", "x"]):
        got = tdt.general_datatype(states)
        ref = jdt.general_datatype(states)
        for t in (text, "ABxé?"):
            np.testing.assert_array_equal(got.encode(t), ref.encode(t))
    np.testing.assert_array_equal(tdt.NUCLEOTIDES.encode("acgtú"),
                                  jdt.NUCLEOTIDES.encode("acgtú"))


def test_importer_refusals():
    with pytest.raises(XmlImportError):
        parse_beast_xml("<notbeast/>")
    with pytest.raises(NotImplementedError, match="logisticGrowth"):
        parse_beast_xml(INLINE.replace(
            "</beast>", '<logisticGrowth id="x"/></beast>'))
    with pytest.raises(NotImplementedError, match="prior element"):
        parse_beast_xml(INLINE.replace(
            "<oneOnXPrior>", "<laplacePrior><parameter idref='kappa'/>"
            "</laplacePrior><oneOnXPrior>"))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_importer_mode(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    doc = tmp_path / "inline.xml"
    doc.write_text(INLINE)
    rc = main(["run", str(doc), "-seed", "3", "-chain_length", "60",
               "-device", "cpu", "-save_state", "state.npz"])
    assert rc == 0
    assert "states/sec" in capsys.readouterr().out
    # the default file names: the document's base name
    assert open("inline.log").read().count("\n") == 1 + 1 + 3
    assert open("inline.trees").read().count("tree STATE_") == 3
    assert os.path.exists("state.npz")
    rc = main(["run", str(doc), "-seed", "3", "-chain_length", "40",
               "-device", "cpu", "-log", "run2.log", "-trees", "run2.trees",
               "-load_state", "state.npz"])
    assert rc == 0
    rows = [ln.split("\t")[0] for ln in open("run2.log") if ln[:1].isdigit()]
    assert rows == ["80", "100"]
    # an existing log is refused without -overwrite
    with pytest.raises(SystemExit):
        main(["run", str(doc), "-device", "cpu", "-log", "run2.log"])
    assert main(["run", str(doc), "-chain_length", "20", "-device", "cpu",
                 "-log", "run2.log", "-overwrite"]) == 0
    # -mc3_chains 2: one swap round of 100 states, the cold chain's log
    assert main(["run", str(doc), "-device", "cpu", "-mc3_chains", "2",
                 "-overwrite"]) == 0
    rows = [ln.split("\t")[0] for ln in open("inline.log")
            if ln[:1].isdigit()]
    assert rows == ["100"]


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    doc = tmp_path / "inline.xml"
    doc.write_text(INLINE)
    assert main(["frobnicate"]) == 2
    assert main(["run", str(doc), "-testxml", "-device", "cpu"]) != 0
    assert main(["run", str(doc), "-particles", "p", "-device", "cpu"]) != 0
    assert main(["treeannotator", "x.trees"]) != 0  # no such file
    bad = tmp_path / "bad.xml"
    bad.write_text(INLINE.replace("</beast>",
                                  '<logisticGrowth id="x"/></beast>'))
    capsys.readouterr()
    # past the importer's vocabulary the document goes to the interpreter,
    # which refuses this one (its <mcmc> names no <operators>)
    assert main(["run", str(bad), "-device", "cpu"]) != 0
    out, err = capsys.readouterr()
    assert "logisticGrowth" in out
    assert "running through the interpreter registry" in out
    assert "<mcmc> without <operators>" in err
    assert not os.path.exists("bad.log")


def test_phase12_rehearsal(spec_doc, tmp_path, monkeypatch):
    """chip_smoke.py's phase 12 on the CPU at 12 taxa: each CLI run's
    likelihood evaluations counted where the card counts peel_stream
    launches, the files read back, the resumed run equal to the straight
    one, the built analysis's checks."""
    import chip_smoke

    calls = [0]
    site = tl._site_logliks

    def counted(*a, **k):
        calls[0] += 1
        return site(*a, **k)

    monkeypatch.setattr(tl, "_site_logliks", counted)

    def reset():
        calls[0] = 0

    def read():
        return {"peel_resident": 0, "peel_stream": calls[0],
                "peel_stream_ring": 0, "peel_mxu": 0}

    def device_ms(fn, label, n=1, top=6):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0) / n, None

    rec, launches = chip_smoke.spec_path(spec_doc, str(tmp_path), reset, read,
                                         device_ms, "cpu", n_steps=40,
                                         n_check=5, n_profile=3)
    assert launches["P12 straight"]["peel_stream"] == 41
    assert launches["P12 resumed"]["peel_stream"] == 22
    assert rec["resumed_equals_straight"]
    assert rec["log_rows"] == rec["trees"] == 4
    assert rec["full_evaluation_deviation"] <= 0.1

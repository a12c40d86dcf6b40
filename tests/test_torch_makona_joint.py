"""The port's Makona joint analysis against the JAX package's XmlAnalysis.

scripts/make_makona.py writes two small documents of the joint model
(GTR+Gamma4 under a discretised lognormal relaxed clock, a skygrid, an
asymmetric CTMC with BSSVS; beast_mcmc_tpu/config/xml_geo.py,
xml_ext.py:194-250, interpreter.py:2499-2514): 24 taxa at 6 locations, and
12 taxa at 56 locations so that the expm runs at S = 56. JAX builds each
(CPU, x64, as tests/conftest.py sets it up) and its patterns, tree and
params cross through convert.py into apps/benchmarks.py::
build_joint_analysis, on the CPU in float64. Each of the eight components
and their sum are held to JAX's leaves (evaluated under jit, as JAX's
chain evaluates them) to 1e-10 relative, the expm ones (geoLikelihood) to
1e-9, at the start and after 20 steps of a JAX chain; the components'
dependency sets to JAX's trace_deps; a 200-step chain of the port to the
full-evaluation check (0.1); apps/makona.py's reader to JAX's taxa; the
sequence simulator's law to JAX's and to the exact pattern probabilities;
the document's five <log> columns at the start state to JAX's (1e-10) and
its annotation tag and labels; the annotation draw's site log-likelihood
to JAX's geoLikelihood (1e-9); a chain that writes the log and the
annotated trees (apps/makona.py::run_joint_logged) ends in the state of
the same chain unlogged, and its tree file reads back.

The same documents through the port's own XML interpreter
(config/interpreter.py with config/xml_geo.py and xml_ext.py;
apps/benchmarks.py::xml_joint_chain, the chain of measure_makona_joint):
its simulated alignment and patterns equal JAX's state for state; every
leaf of the decomposed posterior equals JAX's at the start and after the
20 JAX steps (1e-10, the expm leaf 1e-9); the components' dependency sets
equal JAX's trace_deps; a 200-step component-cached chain passes the 0.1
check; and `python -m beast_mcmc_tpu_torch run` on the document writes
its log and its trees with every node's location annotated.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config.interpreter import XmlAnalysis
from beast_mcmc_tpu.config.xml_assert import initial_eval_state
from beast_mcmc_tpu.inference.component_cache import (
    decompose_likelihood,
    full_lp_fn as jax_full_lp_fn,
    make_components as jax_make_components,
    seed_components as jax_seed_components,
)
from beast_mcmc_tpu.inference.mcmc import (
    init_mcmc_state as jax_init_mcmc_state,
    make_mcmc_step as jax_make_mcmc_step,
)

from beast_mcmc_tpu_torch.apps.benchmarks import (
    build_joint_analysis,
    xml_joint_chain,
    clock_rates,
    gtr_site_model,
)
from beast_mcmc_tpu_torch.apps.makona import (
    location_rows,
    read_makona_xml,
    starting_tree,
    tip_heights,
)
from beast_mcmc_tpu_torch.apps.seqgen import (
    compress_patterns,
    one_hot_tips,
    simulate_states,
)
from beast_mcmc_tpu_torch.convert import (
    JOINT_RENAMES,
    joint_params_from_numpy,
    operator_from,
)
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.models.treelikelihood import (
    branch_transition_matrices,
)
from beast_mcmc_tpu_torch.ops import cuda_mxu, cuda_peeling, cuda_stream
from beast_mcmc_tpu_torch.ops import cuda_stream2, peeling
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

REPO = Path(__file__).resolve().parent.parent
NAMES = ["gammaPrior", "skygrid", "gammaPrior", "poissonPrior",
         "originModel.connectivity", "exponentialPrior", "treeLikelihood",
         "geoLikelihood"]
RTOL, RTOL_EXPM = 1e-10, 1e-9
SHAPES = {"6 locations": (24, 300, 6), "56 locations": (12, 300, 56)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and under six test
    workers torch's threads only contend (the 56-state chain's batched
    products took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_xml(path, taxa, sites, locations):
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_makona.py"),
                    str(path), "--taxa", str(taxa), "--sites", str(sites),
                    "--locations", str(locations)], check=True,
                   capture_output=True, cwd=REPO)
    return path


def _jax_analysis(path):
    ax = XmlAnalysis(str(path), scale=1.0, max_states=10, dtype=jnp.float64)
    mcmc_el = ax.root.find("mcmc")
    post = ax._posterior_of(mcmc_el)
    ops, tids = ax.build(ax.deref(mcmc_el.find("operators")))
    p0, t0 = initial_eval_state(ax)
    leaves = decompose_likelihood(post)
    return ax, ops, tids, p0, t0, leaves


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def joint(request, tmp_path_factory):
    """JAX's analysis of one small document, its state at the start and
    after 20 steps of its component-cached chain."""
    path = _write_xml(tmp_path_factory.mktemp("makona") / "small.xml",
                      *SHAPES[request.param])
    ax, ops, tids, p0, t0, leaves = _jax_analysis(path)
    comps = jax_make_components([(lf.fn, lf.name) for lf in leaves], p0, t0)
    lp = jax_full_lp_fn(comps)
    step = jax.jit(jax_make_mcmc_step(
        lp, ops, components=comps,
        op_tree_flags=[t is not None for t in tids]))
    state = jax_init_mcmc_state(jax_seed_components(p0, t0, comps), t0,
                                jax.random.PRNGKey(5), ops, lp)
    for _ in range(20):
        state = step(state)
    parts = ax._treelik_parts
    port = xml_joint_chain(str(path), "cpu")
    return {"name": request.param, "path": path, "ax": ax, "ops": ops,
            "port": port,
            "tids": tids, "leaves": leaves, "comps": comps,
            "states": [(p0, t0), (state.params, state.tree)],
            "seq": (np.asarray(parts["treeLikelihood"]["tips"]),
                    np.asarray(parts["treeLikelihood"]["w"])),
            "geo": np.asarray(parts["geoLikelihood"]["tips"])[:, :, 0]}


def _port(joint, params, tree):
    """build_joint_analysis on JAX's inputs, at JAX's params and tree, with
    the document's constants as apps/makona.py reads them."""
    tree_np = _np((tree.parent, tree.children, tree.heights, tree.root))
    return build_joint_analysis(
        joint["geo"], *joint["seq"], tree_np,
        read_makona_xml(str(joint["path"]))["model"],
        params=joint_params_from_numpy(_np(params), device="cpu"),
        device="cpu")


def test_components_match_jax(joint):
    """Each component and the sum, at the start and after 20 JAX steps.
    JAX's leaves run under jit: its discrete gamma then takes the smooth
    quantile the port ported (AS91 is its eager-only parity route)."""
    moved = 0
    for params, tree in joint["states"]:
        log_post, _, p0, t0, aux = _port(joint, params, tree)
        assert [c.name for c in aux["components"]] == NAMES
        assert [lf.name for lf in joint["leaves"]] == NAMES
        total_ref = 0.0
        for lf, c in zip(joint["leaves"], aux["components"]):
            ref = float(jax.jit(lf.fn)(params, tree))
            got = c.fn(p0, t0)
            assert got.dtype == torch.float64
            tol = RTOL_EXPM if c.name == "geoLikelihood" else RTOL
            assert float(got) == pytest.approx(ref, rel=tol, abs=1e-300), (
                joint["name"], c.name)
            total_ref += ref
        assert float(log_post(p0, t0)) == pytest.approx(total_ref,
                                                        rel=RTOL)
        moved += int(np.any(np.asarray(tree.heights)
                            != np.asarray(joint["states"][0][1].heights)))
    assert moved == 1  # the chain moved the tree


def test_dependency_sets_match_jax(joint):
    """The port's trace_deps reads the same params as JAX's jaxpr slice,
    and the same components read the tree."""
    params, tree = joint["states"][0]
    _, _, _, _, aux = _port(joint, params, tree)
    for jc, c in zip(joint["comps"], aux["components"]):
        renamed = {JOINT_RENAMES.get(k, k) for k in jc.deps}
        assert c.deps == renamed, c.name
        assert c.uses_tree == jc.uses_tree, c.name


def test_operators_match_the_document(joint):
    """The fourteen operators: JAX's, carried by operator_from, have the
    port's classes, weights and settings, but for geo.rates, whose
    scaleAllIndependently the JAX layer reads as one random dimension."""
    params, tree = joint["states"][0]
    _, ops, _, _, aux = _port(joint, params, tree)
    assert len(ops) == len(joint["ops"]) == 14
    for j_op, op in zip(joint["ops"], ops):
        carried = operator_from(j_op)
        assert type(carried) is type(op)
        if getattr(op, "parameter", None) == "geo.rates":
            assert (j_op.mode, op.mode) == ("random", "independent")
            carried.mode = "independent"
        assert carried == op
    assert aux["op_tree_flags"] == [t is not None for t in joint["tids"]]


def test_port_chain_full_evaluation(joint):
    """200 steps of the port's component-cached chain on the CPU, then the
    full-evaluation check over 50 more (tolerance 0.1)."""
    params, tree = joint["states"][0]
    log_post, ops, p0, t0, aux = _port(joint, params, tree)
    step = make_mcmc_step(log_post, ops, components=aux["components"],
                          op_tree_flags=aux["op_tree_flags"])
    state = init_mcmc_state(p0, t0, torch.Generator().manual_seed(2), ops,
                            log_post)
    state, _ = run_chain(step, state, 200)
    assert np.isfinite(float(state.log_posterior))
    state, dev = full_evaluation_check(step, log_post, state, 50)
    assert float(dev) <= 0.1
    assert int(state.op_accept.sum()) > 0


def test_trait_peels_plain_levels(joint, monkeypatch):
    """geoLikelihood goes to the plain level peel and to no kernel route:
    every kernel entry is made to raise, and the counters stay 0."""
    def refuse(*a, **k):
        raise AssertionError("the trait reached a kernel route")

    import beast_mcmc_tpu_torch.models.treelikelihood as tl

    for name in ("peel_site_loglik_auto", "peel_loglikelihood_auto",
                 "peel_site_loglik_deep"):
        monkeypatch.setattr(tl, name, refuse)
    calls = []
    levels = peeling._peel_forward_levels
    monkeypatch.setattr(peeling, "_peel_forward_levels",
                        lambda *a: calls.append(1) or levels(*a))
    mods = (cuda_peeling, cuda_stream, cuda_stream2, cuda_mxu)
    for mod in mods:
        monkeypatch.setattr(mod, "launches", 0)
    params, tree = joint["states"][1]
    _, _, p0, t0, aux = _port(joint, params, tree)
    geo = aux["components"][NAMES.index("geoLikelihood")]
    calls.clear()
    assert np.isfinite(float(geo.fn(p0, t0)))
    assert calls == [1]
    assert [mod.launches for mod in mods] == [0, 0, 0, 0]


def test_reader_matches_jax(joint):
    """apps/makona.py's reader: the same tip heights (dates), locations,
    location rows and constants as JAX's XML layer, and at the default
    seed the same starting tree."""
    ax = joint["ax"]
    cfg = read_makona_xml(str(joint["path"]))
    jax_taxa = ax.build(ax._ids["taxa"])
    assert cfg["taxa"] == [n for n, _ in jax_taxa]
    np.testing.assert_array_equal(tip_heights(cfg["dates"]),
                                  [h for _, h in jax_taxa])
    assert cfg["locations"] == [" ".join(ax._taxon_attrs[n]["location"])
                                for n in cfg["taxa"]]
    np.testing.assert_array_equal(location_rows(cfg), joint["geo"])
    sky = ax._ids["skygrid"]
    renames = {ax.param_from(sky.find(tag)): name for tag, name in (
        ("numGridPoints", "skygrid.numGridPoints"),
        ("cutOff", "skygrid.cutOff"))}
    assert renames == JOINT_RENAMES
    p0, t0 = _np(joint["states"][0])
    for got, ref in zip(starting_tree(cfg), (t0.parent, t0.children,
                                             t0.heights, t0.root)):
        np.testing.assert_array_equal(got, ref)
    for name, v in cfg["model"]["init"].items():
        jname = {v2: k2 for k2, v2 in renames.items()}.get(name, name)
        np.testing.assert_array_equal(np.ravel(p0[jname]), np.ravel(v))


def test_sequence_simulator_law(tmp_path):
    """apps/seqgen.py against JAX's <beagleSequenceSimulator> on JAX's
    4-taxon starting tree, the clock mean raised so that sites vary: the
    frequencies of the 256 patterns in 40,000 sites of each, held to each
    other and to the exact pattern probabilities (exp of the site
    log-likelihoods) by a chi-square statistic under its 0.999 quantile."""
    from scipy.stats import chi2

    path = _write_xml(tmp_path / "law.xml", 4, 40000, 3)
    text = path.read_text().replace('id="ucld.mean" value="0.0012"',
                                    'id="ucld.mean" value="0.4"')
    path.write_text(text)
    ax, _, _, p0, t0, _ = _jax_analysis(path)
    j_states = np.asarray(ax.build(ax._ids["simulator"]).states)  # [4, L]
    tree_np = _np((t0.parent, t0.children, t0.heights, t0.root))
    tr = make_tree_state(*tree_np, device="cpu")
    params = joint_params_from_numpy(_np(p0), device="cpu")
    eig, freqs, rates, cat_w = gtr_site_model(params, 4)
    pm = branch_transition_matrices(eig, tr.parent, tr.heights,
                                    clock_rates(params), rates)
    states = simulate_states(tr.parent, pm, cat_w, freqs, 40000,
                             torch.Generator().manual_seed(3))[:4]

    def counts(s):
        code = (np.asarray(s) * np.array([64, 16, 4, 1])[:, None]).sum(0)
        return np.bincount(code, minlength=256)

    c_port, c_jax = counts(states), counts(j_states)
    # the exact law: every pattern's probability from the port's peel
    all_pats = torch.tensor(np.array(np.unravel_index(np.arange(256),
                                                      (4,) * 4)))
    tips = one_hot_tips(all_pats, 4)
    probs = torch.exp(peeling.peel_site_loglik(
        tips, tr.children, peeling.peel_order_from_heights(
            tr.heights, 4, tr.parent), tr.root, pm, freqs, cat_w)).numpy()
    assert probs.sum() == pytest.approx(1.0, abs=1e-12)
    keep = probs * 40000 >= 5
    for c in (c_port, c_jax):
        expect = probs[keep] * 40000
        stat = np.sum((c[keep] - expect) ** 2 / expect)
        assert stat < chi2.ppf(0.999, keep.sum() - 1)
    both = keep & ((c_port + c_jax) > 0)
    stat2 = np.sum((c_port[both] - c_jax[both]) ** 2
                   / (c_port[both] + c_jax[both]))
    assert stat2 < chi2.ppf(0.999, both.sum() - 1)
    # compression: unique columns in first-occurrence order, with counts
    pats, w = compress_patterns(states)
    assert int(w.sum()) == 40000
    first = [int(np.flatnonzero((states.numpy() == pats[:, j, None]
                                 .numpy()).all(0))[0])
             for j in range(pats.shape[1])]
    assert first == sorted(first)


def test_log_columns_and_annotation_match_jax(joint):
    """The document's five <log> columns at the start state, and the
    annotation's tag and state labels, against JAX's XmlAnalysis (its
    columns evaluated under jit) to 1e-10."""
    import types

    from beast_mcmc_tpu_torch.apps.makona import (
        JOINT_COLUMNS, LOCATION_TAG, joint_columns)

    ax = joint["ax"]
    params, tree = joint["states"][0]
    mcmc_el = ax.root.find("mcmc")
    cols = ax._log_columns(mcmc_el.find("log"))
    assert [name for name, _ in cols] == list(JOINT_COLUMNS)
    log_post, ops, p0, t0, _ = _port(joint, params, tree)
    state = init_mcmc_state(p0, t0, torch.Generator().manual_seed(1), ops,
                            log_post)
    got = joint_columns(state)
    for name, fn in cols:
        ref = float(jax.jit(lambda p, t, f=fn: f(types.SimpleNamespace(
            params=p, tree=t)))(params, tree))
        assert got[name].dim() == 0
        assert float(got[name]) == pytest.approx(ref, rel=RTOL), name
    rec = ax._ancestral_liks["geoLikelihood"]
    assert rec["tag"] == LOCATION_TAG
    assert rec["labels"] == read_makona_xml(str(joint["path"]))[
        "location_codes"]


def test_location_states_match_jax_geo_likelihood(joint):
    """location_states (the annotation's draw) peels the trait with the
    matrices of JAX's states_fn: JAX's geoLikelihood clock is the unit one
    there, and the draw's site log-likelihood equals JAX's geoLikelihood
    (one pattern of weight 1) to 1e-9, at the start and after 20 JAX
    steps. Tips keep their data."""
    from beast_mcmc_tpu_torch.apps.makona import location_states

    parts = joint["ax"]._treelik_parts["geoLikelihood"]
    geo_leaf = joint["leaves"][NAMES.index("geoLikelihood")]
    data = np.argmax(joint["geo"], axis=1)
    for params, tree in joint["states"]:
        np.testing.assert_array_equal(
            np.asarray(jax.jit(parts["clock"].rates)(params, tree)), 1.0)
        _, _, p0, t0, aux = _port(joint, params, tree)
        states, site_logl = location_states(
            p0, t0, aux["geo_tips"], torch.Generator().manual_seed(3))
        assert site_logl.shape == (1,) and site_logl.dtype == torch.float64
        ref = float(jax.jit(geo_leaf.fn)(params, tree))
        assert float(site_logl[0]) == pytest.approx(ref, rel=RTOL_EXPM)
        np.testing.assert_array_equal(states[:len(data)].numpy(), data)


def test_tree_logger_leaves_the_chain_alone(joint, tmp_path):
    """run_joint_logged (a log row every 10 steps, an annotated tree every
    50) ends in the very state of run_chain over the same steps; the tree
    file reads back with every node annotated and the tips their data
    (chip_smoke.check_joint_trees)."""
    import chip_smoke

    from beast_mcmc_tpu_torch.apps.makona import run_joint_logged

    params, tree = joint["states"][0]
    log_post, ops, p0, t0, aux = _port(joint, params, tree)
    step = make_mcmc_step(log_post, ops, components=aux["components"],
                          op_tree_flags=aux["op_tree_flags"])

    def start():
        return init_mcmc_state(p0, t0, torch.Generator().manual_seed(4), ops,
                               log_post)

    plain, _ = run_chain(step, start(), 100)
    cfg = read_makona_xml(str(joint["path"]))
    files = [str(tmp_path / f"j.{ext}") for ext in ("log", "trees")]
    logged, info = run_joint_logged(step, start(), 100, aux["geo_tips"],
                                    cfg["taxa"], cfg["location_codes"],
                                    *files, 10, 50, 4)
    for k in plain.params:
        assert torch.equal(plain.params[k], logged.params[k]), k
    assert torch.equal(plain.tree.heights, logged.tree.heights)
    assert torch.equal(plain.tree.parent, logged.tree.parent)
    assert torch.equal(plain.log_posterior, logged.log_posterior)
    assert (info["rows"], info["trees"]) == (10, 2)
    assert chip_smoke.check_joint_trees(files[1], cfg) == 2
    rows = [ln.split("\t") for ln in open(files[0]) if ln[:1].isdigit()]
    assert [int(r[0]) for r in rows] == list(range(10, 101, 10))
    assert float(rows[-1][1]) == pytest.approx(float(plain.log_posterior),
                                               rel=1e-9)


def _port_params(params):
    """JAX's params (the component cache left out) as CPU tensors of the
    port's XmlAnalysis, whose names are the document's, as JAX's."""
    return {k: torch.tensor(np.asarray(v)) for k, v in params.items()
            if k != "__comp_cache__"}


def _port_tree(tree):
    return make_tree_state(*_np((tree.parent, tree.children, tree.heights,
                                 tree.root)), dtype=torch.float64,
                           device="cpu")


def test_interpreter_alignment_equals_jax(joint):
    """The port's <beagleSequenceSimulator> draws JAX's alignment state for
    state, so the patterns, their weights and both partitions' tips are
    JAX's."""
    ax, jax_ax = joint["port"]["analysis"], joint["ax"]
    for tag in ("simulator", "patterns"):
        got, want = ax.build(ax._ids[tag]), jax_ax.build(jax_ax._ids[tag])
        assert got.taxa == want.taxa
        np.testing.assert_array_equal(got.states, np.asarray(want.states))
    np.testing.assert_array_equal(
        ax.build(ax._ids["patterns"]).weights,
        jax_ax.build(jax_ax._ids["patterns"]).weights)
    for lik in ("treeLikelihood", "geoLikelihood"):
        got = ax._treelik_parts[lik]
        want = jax_ax._treelik_parts[lik]
        np.testing.assert_array_equal(got["tips"].numpy(),
                                      np.asarray(want["tips"]))
        np.testing.assert_array_equal(got["w"].numpy(),
                                      np.asarray(want["w"]))


def test_interpreter_components_match_jax(joint):
    """Each leaf of the port's decomposed posterior, and their sum, at
    JAX's start state and after 20 JAX steps (JAX's under jit)."""
    comps = joint["port"]["components"]
    assert [c.name for c in comps] == NAMES
    for params, tree in joint["states"]:
        p, t = _port_params(params), _port_tree(tree)
        total = 0.0
        for lf, c in zip(joint["leaves"], comps):
            ref = float(jax.jit(lf.fn)(params, tree))
            tol = RTOL_EXPM if c.name == "geoLikelihood" else RTOL
            assert float(c.fn(p, t)) == pytest.approx(
                ref, rel=tol, abs=1e-300), (joint["name"], c.name)
            total += ref
        assert float(joint["port"]["log_post"](p, t)) == pytest.approx(
            total, rel=RTOL)


def test_interpreter_dependency_sets_match_jax(joint):
    """The port's trace_deps over its interpreter's leaves reads JAX's
    jaxpr slices' params (the same names), and the same leaves read the
    tree; the operators' tree flags are JAX's."""
    for jc, c in zip(joint["comps"], joint["port"]["components"]):
        assert c.deps == set(jc.deps), c.name
        assert c.uses_tree == jc.uses_tree, c.name
    assert len(joint["port"]["operators"]) == len(joint["ops"]) == 14
    for j_op, op in zip(joint["ops"], joint["port"]["operators"]):
        assert type(op).__name__ == type(j_op).__name__
        assert op.weight == j_op.weight


def test_interpreter_chain_full_evaluation(joint):
    """200 steps of the interpreter's component-cached chain, then the
    full-evaluation check over 50 more (tolerance 0.1)."""
    step, log_post = joint["port"]["step"], joint["port"]["log_post"]
    state, _ = run_chain(step, joint["port"]["state"], 200)
    assert np.isfinite(float(state.log_posterior))
    state, dev = full_evaluation_check(step, log_post, state, 50)
    assert float(dev) <= 0.1
    assert int(state.op_accept.sum()) > 0


def test_interpreter_cli_writes_annotated_trees(joint, tmp_path,
                                                monkeypatch, capsys):
    """`python -m beast_mcmc_tpu_torch run small.xml -scale 5e-7`: the
    importer refuses the simulated alignment and the interpreter runs 100
    states, a log row and an annotated tree each; every node of every tree
    carries one of the document's locations, each tip its own
    (chip_smoke.check_joint_trees)."""
    import chip_smoke

    from beast_mcmc_tpu_torch import __main__ as cli

    monkeypatch.chdir(tmp_path)
    rc = cli.main(["run", str(joint["path"]), "-scale", "5e-7", "-device",
                   "cpu", "-seed", "9"])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    assert "running through the interpreter registry]" in out.out
    cfg = read_makona_xml(str(joint["path"]))
    log = (tmp_path / "makona_joint.log").read_text().splitlines()
    assert log[0].split("\t") == ["state", "posterior", "ucld.mean",
                                   "siteModel.alpha", "nonZeroRates",
                                   "treeModel.rootHeight"]
    assert len(log) == 101
    trees = str(tmp_path / "makona_joint.trees")
    assert chip_smoke.check_joint_trees(trees, cfg) == 100


def test_annotation_drawn_only_on_kept_tree_rows(tmp_path, monkeypatch):
    """With the tab log every 2 states and the tree log every 10, the
    interpreter's collector runs every 2 states but draws the ancestral
    states (and gathers the tree) only on the rows the tree log keeps:
    40 states give 20 log rows, 4 trees and 4 draws."""
    import chip_smoke

    from beast_mcmc_tpu_torch.config.interpreter import (
        XmlAnalysis as PortXmlAnalysis,
    )
    from beast_mcmc_tpu_torch.ops import ancestral

    text = _write_xml(tmp_path / "src.xml",
                      *SHAPES["6 locations"]).read_text()
    for old, new in (('chainLength="200000000"', 'chainLength="40"'),
                     ('<log logEvery="1000"', '<log logEvery="2"'),
                     ('<logTree logEvery="10000"', '<logTree logEvery="10"')):
        assert text.count(old) == 1
        text = text.replace(old, new)
    path = tmp_path / "strided.xml"
    path.write_text(text)
    draws = [0]
    sample = ancestral.sample_ancestral_states

    def counted(*a, **k):
        draws[0] += 1
        return sample(*a, **k)

    monkeypatch.setattr(ancestral, "sample_ancestral_states", counted)
    ax = PortXmlAnalysis(str(path), workdir=str(tmp_path), seed=3,
                         device="cpu")
    ax.run(full_eval_steps=0)
    assert ax.runs[-1]["steps"] == 40
    log = (tmp_path / "makona_joint.log").read_text().splitlines()
    assert [int(r.split("\t")[0]) for r in log[1:]] == list(range(2, 41, 2))
    trees = str(tmp_path / "makona_joint.trees")
    assert chip_smoke.check_joint_trees(trees, read_makona_xml(str(path))) \
        == 4
    assert draws[0] == 4
    states = [ln.split()[1] for ln in open(trees)
              if ln.lstrip().startswith("tree ")]
    assert states == ["STATE_10", "STATE_20", "STATE_30", "STATE_40"]


def test_phase16_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's phase 16 on the CPU on the 24-taxon document: the
    CLI's likelihood evaluations counted where the card counts
    peel_stream launches, exactly as north_star_path predicts them, its
    log and annotated trees read back; measure_makona_joint's evaluations
    of the tree likelihood equal to the steps that refresh it; the block
    update's proposals and check; 16d's functions on the CPU twice."""
    import time

    import chip_smoke
    from beast_mcmc_tpu_torch.models import treelikelihood as tl

    path = _write_xml(tmp_path / "small.xml", *SHAPES["6 locations"])
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

    monkeypatch.setattr(tl, "_site_logliks", counted)
    rec, launches = chip_smoke.north_star_path(
        str(tmp_path), reset, read, device_ms, "cpu", doc=str(path),
        scale=3e-7, n_warm=4, n_steps=20, n_profile=3, n_block=6,
        block_check=5)
    a, b, c = rec["16a"], rec["16b"], rec["16c"]
    # the interpreter runs a debug chain of at most 64 states in full
    assert a["steps"] == a["log_rows"] == a["trees"] == 64
    assert launches["P16 16a CLI"] == {"peel_stream": 1 + 200 + 2 * 64}
    assert a["full_evaluation_deviation"] == 0.0
    assert launches["P16 16b timed steps"] == {
        "peel_stream": b["tree_likelihood_steps"]}
    assert sum(b["steps_per_operator"]) == 20 and b["deviation"] < 0.1
    assert rec["taxa"] == 24 and rec["locations"] == 6
    assert c["proposals"] == 6 and c["full_evaluation_deviation"] <= 0.1
    d = chip_smoke.p16_functions_path(str(tmp_path), "cpu", n_taxa=24)
    assert d["functions"] == 20 and d["max_rel_err"] == 0.0

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
sequence simulator's law to JAX's and to the exact pattern probabilities.
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
    return {"name": request.param, "path": path, "ax": ax, "ops": ops,
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

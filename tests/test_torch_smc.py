"""The port's inference/smc.py and the CLI's -particles against the JAX
package.

  - insert_taxon and distance_based_attachment on the JAX package's own
    cases (tests/test_smc_online_treestat.py), and on a tip whose pendant
    branch has no room: the same attachment and the same rewired tree,
    exactly;
  - load_particles stacks a folder's checkpoints into one chain batch (the
    particles' values, statistics and step counts; the first particle's
    generators); run_particles advances it with one chain-axis posterior
    evaluation a step and writes each particle, which reloads within 0.1
    of its carried posterior with its step advanced;
  - `python -m beast_mcmc_tpu_torch run doc.xml -particles DIR` on the
    CPU at 12 taxa: JAX's printed line, four files in DIR.out, each
    reloading within 0.1, one likelihood evaluation a batch step and one
    for the template state; a missing or empty DIR returns 1;
  - chip_smoke.py's phase 17 rehearsed at 24 taxa (its exact evaluation
    counts, 17c on shorter ladders, 17d on the CPU twice).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.inference import smc as jsmc
from beast_mcmc_tpu.tree.topology import (
    make_tree_state as j_tree_state,
    simulate_coalescent_tree,
)

from beast_mcmc_tpu_torch import __main__ as cli
from beast_mcmc_tpu_torch.inference import smc
from beast_mcmc_tpu_torch.inference.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    make_multichain_step,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.operators import (
    RootHeightScaleOperator,
    ScaleOperator,
    UniformNodeHeightOperator,
)
from beast_mcmc_tpu_torch.models.coalescent import constant_coalescent_loglik
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

from test_mcmc import check_tree_valid

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(n, seed=0):
    tr = simulate_coalescent_tree(np.random.default_rng(seed), np.zeros(n),
                                  1.0)
    return j_tree_state(*tr, jnp.float64), make_tree_state(*tr, F64, "cpu")


def _same_tree(got, want):
    for f in ("parent", "children", "heights", "root"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("dists,tip_h", [
    ([5.0, 4.0, 0.1, 3.0, 2.0], 0.0),  # the JAX package's case
    ([0.2, 4.0, 3.0, 3.0, 2.0], 0.0),
    ([5.0, 4.0, 3.0, 0.3, 2.0], 0.35),  # above the tip's parent: walks up
])
def test_attachment_and_insertion_match_jax(dists, tip_h):
    n = 5
    jtree, tree = _trees(n)
    dists = np.array(dists)
    node, h_att = smc.distance_based_attachment(tree, dists, tip_h)
    j_node, j_h = jsmc.distance_based_attachment(jtree, dists, tip_h)
    assert (node, h_att) == (j_node, j_h)
    new = smc.insert_taxon(tree, node, tip_h, h_att)
    _same_tree(new, jsmc.insert_taxon(jtree, j_node, tip_h, j_h))
    check_tree_valid(new.parent.numpy(), new.children.numpy(),
                     new.heights.numpy(), int(new.root), n + 1)
    # the old tips keep their indices and heights
    np.testing.assert_array_equal(new.heights[:n].numpy(),
                                  tree.heights[:n].numpy())


def test_insert_taxon_at_root_branch_matches_jax():
    args = dict(parent=[2, 2, -1], children=[[-1, -1], [-1, -1], [0, 1]],
                heights=[0.0, 0.0, 1.0], root=2)
    tree = make_tree_state(*args.values(), F64, "cpu")
    new = smc.insert_taxon(tree, 2, 0.0, 2.0)
    _same_tree(new, jsmc.insert_taxon(j_tree_state(**args), 2, 0.0, 2.0))
    assert float(new.heights[new.root]) == 2.0
    with pytest.raises(ValueError):
        smc.insert_taxon(tree, 0, 0.0, 1.5)  # above the parent


def _small_analysis(n=6):
    _, tree = _trees(n)

    def lp(params, tree):
        return constant_coalescent_loglik(tree.heights, n, params["pop"])

    def lp_chains(params, tree):
        calls[0] += 1
        return torch.stack([lp({"pop": params["pop"][b]},
                               type(tree)(*(x[b] for x in (
                                   tree.parent, tree.children, tree.heights,
                                   tree.root))))
                            for b in range(tree.parent.shape[0])])

    calls = [0]
    ops = [ScaleOperator(parameter="pop"),
           UniformNodeHeightOperator(weight=3.0), RootHeightScaleOperator()]
    return lp, lp_chains, calls, ops, {"pop": torch.tensor(1.0, dtype=F64)}, \
        tree


def test_particles_load_run_and_write(tmp_path):
    lp, lp_chains, calls, ops, params, tree = _small_analysis()
    step = make_mcmc_step(lp, ops)
    folder = tmp_path / "particles"
    saved = []
    for i in range(4):
        st = init_mcmc_state(params, tree, torch.Generator().manual_seed(i),
                             ops, lp)
        st, _ = run_chain(step, st, 10 + i)  # steps 10 to 13
        save_checkpoint(str(folder / f"p{i:02d}"), st)
        saved.append(st)
    template = init_mcmc_state(params, tree, torch.Generator().manual_seed(9),
                               ops, lp)
    parts = smc.load_particles(str(folder), template)
    assert parts.log_posterior.shape == (4,)
    assert parts.step.tolist() == [10, 11, 12, 13]
    for i, st in enumerate(saved):
        torch.testing.assert_close(parts.params["pop"][i], st.params["pop"])
        torch.testing.assert_close(parts.tree.heights[i], st.tree.heights)
        torch.testing.assert_close(parts.op_accept[i], st.op_accept)
    # the batch's generators are the first particle's
    assert torch.equal(parts.generator.get_state(),
                       saved[0].generator.get_state())

    out = smc.run_particles(make_multichain_step(lp_chains, ops), parts, 30,
                            out_folder=str(tmp_path / "out"))
    assert calls[0] == 30  # one chain-axis posterior a batch step
    assert out.step.tolist() == [40, 41, 42, 43]
    assert len(set(out.log_posterior.tolist())) > 1
    files = sorted(os.listdir(tmp_path / "out"))
    assert [f for f in files if f.endswith(".npz")] == [
        f"particle{i:04d}.npz" for i in range(4)]
    for i in range(4):
        st = load_checkpoint(str(tmp_path / "out" / f"particle{i:04d}"),
                             template, log_posterior=lp)
        assert st.step == 40 + i
        torch.testing.assert_close(st.params["pop"], out.params["pop"][i])
        check_tree_valid(st.tree.parent.numpy(), st.tree.children.numpy(),
                         st.tree.heights.numpy(), int(st.tree.root), 6)


def test_load_particles_needs_checkpoints(tmp_path):
    lp, _, _, ops, params, tree = _small_analysis()
    template = init_mcmc_state(params, tree, torch.Generator(), ops, lp)
    with pytest.raises(ValueError, match="no particle checkpoints"):
        smc.load_particles(str(tmp_path), template)


def test_cli_particles(tmp_path, monkeypatch, capsys):
    """Four particles of a 12-taxon importer document, started from seeds
    1 to 4 and advanced 5 steps each through the builder, then `run
    doc.xml -particles DIR -chain_length 30 -device cpu`."""
    import chip_smoke
    from beast_mcmc_tpu_torch.config.builder import build
    from beast_mcmc_tpu_torch.config.xml_import import parse_beast_xml
    from beast_mcmc_tpu_torch.models import treelikelihood as tl

    doc = str(tmp_path / "doc.xml")
    chip_smoke.spec_document(doc, 12, 300, 666, "cpu")
    analysis = build(parse_beast_xml(open(doc).read()), device="cpu")
    step = make_mcmc_step(analysis.log_posterior, analysis.operators)
    folder = tmp_path / "parts"
    for k in range(4):
        st = init_mcmc_state(analysis.params0, analysis.tree0,
                             torch.Generator().manual_seed(k + 1),
                             analysis.operators, analysis.log_posterior)
        st, _ = run_chain(step, st, 5)
        save_checkpoint(str(folder / f"p{k}"), st)

    calls = [0]
    site = tl._site_logliks

    def counted(*a, **k):
        calls[0] += 1
        return site(*a, **k)

    monkeypatch.setattr(tl, "_site_logliks", counted)
    rc = cli.main(["run", doc, "-particles", str(folder), "-chain_length",
                   "30", "-device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out.strip().endswith(
        f"advanced 4 particles by 30 states -> {folder}.out")
    assert calls[0] == 1 + 30  # the template, then one a batch step
    monkeypatch.setattr(tl, "_site_logliks", site)
    template = init_mcmc_state(analysis.params0, analysis.tree0,
                               torch.Generator(), analysis.operators)
    for k in range(4):
        st = load_checkpoint(f"{folder}.out/particle{k:04d}", template,
                             log_posterior=analysis.log_posterior)
        assert st.step == 35
    # a missing folder, and one without checkpoints, return 1
    (tmp_path / "empty").mkdir()
    for bad, why in (("nowhere", "no folder"),
                     ("empty", "no particle checkpoints")):
        rc = cli.main(["run", doc, "-particles", str(tmp_path / bad),
                       "-device", "cpu"])
        assert rc == 1 and why in capsys.readouterr().err


def test_phase17_rehearsal(tmp_path):
    """chip_smoke.py's phase 17 on the CPU at 24 taxa: each run's
    likelihood evaluations counted where the card counts kernel launches,
    exactly as the phase predicts them (17a's CLI and rung profile, 17b's
    starts, CLI and batch, 17c's XML oracle), 17c's estimates on shorter
    ladders within the JAX tests' tolerances, and 17d's functions on the
    CPU twice."""
    import time

    import chip_smoke
    from beast_mcmc_tpu_torch.models import treelikelihood as tl

    calls, name = [0], ["peel_stream"]
    site = tl._site_logliks

    def counted(*a, **k):
        calls[0] += 1
        return site(*a, **k)

    def reset():
        calls[0] = 0

    def read():
        return {name[0]: calls[0]}

    def device_ms(fn, label, n=1, top=6):
        t0 = time.perf_counter()
        fn()
        device_ms.events = 0.0
        return 1e3 * (time.perf_counter() - t0) / n, None

    out = str(tmp_path)
    tl._site_logliks = counted
    try:
        rec, launches = chip_smoke.mle_path(out, reset, read, device_ms,
                                            "cpu", n_taxa=24, n_sites=300)
        doc = str(tmp_path / "spec.xml")
        chip_smoke.spec_document(doc, 24, 300, 666, "cpu")
        b, more = chip_smoke.particles_path(doc, out, reset, read, "cpu")
        launches.update(more)
        name[0] = "peel_resident"
        c, more = chip_smoke.oracles_path(out, reset, read, "cpu",
                                          ps_chain=600, gss_chain=300,
                                          xml_pilot=200, xml_chain=100)
        launches.update(more)
    finally:
        tl._site_logliks = site
    assert launches == {
        "P17 17a CLI": {"peel_stream": 301 + 8 * (1 + 64 + 8)},
        "P17 17a rung profile": {"peel_stream": 1 + 8},
        "P17 17b starts": {"peel_stream": 4 * (1 + 5)},
        "P17 17b CLI": {"peel_stream": 1 + 50},
        "P17 17b batch": {"peel_stream": 50},
        "P17 17c XML": {"peel_resident": 221 + 8 * (2 + 200 + 50)}}
    a = rec["17a"]
    assert a["rung_deviation"] == 0.0
    assert a["gss_recomputed"] == a["gss_report"] == a["gss_warned"]
    assert max(b["reload_deviations"]) < 1e-9
    assert abs(c["gss"] - c["analytic"]) < 0.15
    d = chip_smoke.p17_functions_path(out, "cpu")
    assert d["functions"] == 12 and d["max_rel_err"] == 0.0

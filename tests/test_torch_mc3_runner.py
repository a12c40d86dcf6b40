"""The builder's posterior over a chain axis and the runner's and the CLI's
MC3 of the port, against the JAX package, on the CPU in float64.

- Analysis.log_posterior_chains on each spec of tests/test_torch_spec_runner
  (strict, relaxed + Gamma, skygrid + GTR, codon partitions, BSSVS, Yule,
  birth-death, exponential growth, TN93 + pInv + mu, Dirichlet GTR) at
  B = 3 parameter draws and trees from numpy seeds: equal to
  jax.vmap(build(spec).log_posterior) to 1e-10 relative, each row equal
  to the single-chain log_posterior; one peel a partition for all B chains
  (the calls of models/treelikelihood.py::_site_logliks, where the card
  counts one launch).
- run_analysis(mc3_chains=3, mc3_delta=0.5, mc3_swap=10): JAX's ladder (and
  the explicit one), the cold chain's log of n_rounds rows, its last logged
  posterior equal to a fresh evaluation of the returned state, the swap
  rate in [0, 1]; the CLI with all four -mc3_* flags writes the same log.
- chip_smoke.py's phase 13 rehearsed at 12 taxa with its launch counts.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beast_mcmc_tpu.config.spec as JS
import beast_mcmc_tpu.data.alignment as jal
import beast_mcmc_tpu.data.datatype as jdt
from beast_mcmc_tpu.config.builder import build as jax_build
from beast_mcmc_tpu.inference.mc3 import mc3_temperatures as jax_temperatures

import beast_mcmc_tpu_torch.models.treelikelihood as tl
from beast_mcmc_tpu_torch import convert
from beast_mcmc_tpu_torch.__main__ import main
from beast_mcmc_tpu_torch.apps.runner import run_analysis
from beast_mcmc_tpu_torch.config.builder import build
from beast_mcmc_tpu_torch.config.xml_import import parse_beast_xml
from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

from test_torch_spec_runner import INLINE, VARIANTS, _port_spec, spec_doc  # noqa: F401

B = 3
POST_TOL = 1e-10  # relative, float64
TREE_FIELDS = ("parent", "children", "heights", "root")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: small tensors, and six test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(params0, rng):
    """B draws of every parameter around params0 (numpy): the relaxed
    clock's categories permuted, BSSVS indicators at random with the
    first kept on, log populations and growth rates shifted, simplices
    renormalised, pInv kept in (0, 1), the rest scaled."""
    out = {}
    for k, v in params0.items():
        v = np.asarray(v)
        shape = (B,) + v.shape
        if k.endswith("categories"):
            out[k] = np.stack([rng.permutation(v) for _ in range(B)])
        elif k.endswith("indicators"):
            x = (rng.random(shape) < 0.7).astype(v.dtype)
            x[:, 0] = 1
            out[k] = x
        elif k.endswith(("growthRate", "logPopSizes")):
            out[k] = v + rng.normal(0.0, 0.3, shape)
        else:
            x = v * np.exp(rng.normal(0.0, 0.1, shape))
            if v.ndim == 1 and abs(v.sum() - 1.0) < 1e-9:
                x /= x.sum(-1, keepdims=True)
            out[k] = np.clip(x, 0.01, 0.9) if k.endswith("pInv") else x
    return out


def _trees(n_taxa, scale, seed):
    """B coalescent trees of n_taxa contemporaneous tips, numpy, stacked."""
    trees = [simulate_coalescent_tree(np.random.default_rng(seed + i),
                                      np.zeros(n_taxa), scale)
             for i in range(B)]
    return [np.stack([t[f] for t in trees]) for f in range(4)]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_build_chains_match_jax_vmap(name, monkeypatch):
    a = build(_port_spec(name), device="cpu")
    j = jax_build(VARIANTS[name](JS, jal, jdt))
    rng = np.random.default_rng(sorted(VARIANTS).index(name))
    draws = _draws({k: np.asarray(v) for k, v in j.params0.items()}, rng)
    trees = _trees(a.n_taxa, float(a.tree0.heights.max()) / 2, 10)
    params = convert.params_from_numpy(draws, torch.float64, "cpu")
    tree = convert.tree_from_numpy(*trees, dtype=torch.float64, device="cpu")

    calls = [0]
    site = tl._site_logliks

    def counted(*args, **kw):
        calls[0] += 1
        return site(*args, **kw)

    monkeypatch.setattr(tl, "_site_logliks", counted)
    got = a.log_posterior_chains(params, tree)
    assert calls[0] == len(a.spec.partitions)  # one peel for the B chains
    assert got.shape == (B,) and got.dtype == torch.float64

    jtree = type(j.tree0)(**{f: jnp.asarray(x)
                             for f, x in zip(TREE_FIELDS, trees)})
    ref = np.asarray(jax.jit(jax.vmap(j.log_posterior))(
        {k: jnp.asarray(v) for k, v in draws.items()}, jtree))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=POST_TOL, atol=0)
    for b in range(B):
        one = a.log_posterior(
            {k: v[b] for k, v in params.items()},
            convert.tree_from_numpy(*(x[b] for x in trees),
                                    dtype=torch.float64, device="cpu"))
        assert float(one) == pytest.approx(float(got[b]), rel=POST_TOL)


def _log_rows(path):
    lines = open(path).read().splitlines()
    header = next(ln for ln in lines if ln.startswith("state"))
    return header.split("\t"), [ln.split("\t") for ln in lines
                                if ln[:1].isdigit()]


def test_mc3_run_analysis(tmp_path):
    spec = _port_spec("relaxed clock + gamma")
    log_f = str(tmp_path / "mc3.log")
    res = run_analysis(spec, log_file=log_f, verbose=False, mc3_chains=3,
                       mc3_delta=0.5, mc3_swap=10, device="cpu")
    n_rounds = spec.mcmc.chain_length // 10
    temps = [float(t) for t in re.search(r"temperatures \[([^\]]*)\]",
                                         res.report).group(1).split(",")]
    np.testing.assert_allclose(
        temps, np.round(np.asarray(jax_temperatures(3, 0.5)), 4), rtol=0)
    header, rows = _log_rows(log_f)
    assert header[:3] == ["state", "posterior", "treeModel.rootHeight"]
    assert len(rows) == n_rounds
    assert [int(r[0]) for r in rows] == list(range(10, 10 * n_rounds + 1, 10))
    assert "mc3 cold chain" in open(log_f).readline()
    # the cold chain's carried posterior: the last row and a fresh one
    a = build(spec, device="cpu")
    fresh = float(a.log_posterior(res.state.params, res.state.tree))
    assert fresh == pytest.approx(float(res.state.log_posterior), abs=1e-8)
    assert float(rows[-1][1]) == pytest.approx(fresh, rel=1e-9)
    assert res.samples["posterior"].shape == (n_rounds,)
    swap = float(re.search(r"swap acceptance ([0-9.]+)", res.report).group(1))
    assert 0.0 <= swap <= 1.0
    assert res.states_per_sec > 0

    explicit = run_analysis(spec, verbose=False, mc3_chains=3,
                            mc3_temperatures=[0.5, 0.25], mc3_swap=10,
                            device="cpu")
    assert "temperatures [1.0, 0.5, 0.25]" in explicit.report


def test_cli_mc3_flags_write_the_same_log(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    doc = tmp_path / "inline.xml"
    doc.write_text(INLINE)
    spec = parse_beast_xml(INLINE)
    spec.mcmc.seed, spec.mcmc.chain_length = 4, 60
    run_analysis(spec, log_file="direct.log", verbose=False, mc3_chains=3,
                 mc3_delta=0.3, mc3_temperatures=[0.6, 0.4], mc3_swap=15,
                 device="cpu")
    rc = main(["run", str(doc), "-seed", "4", "-chain_length", "60",
               "-device", "cpu", "-log", "cli.log", "-mc3_chains", "3",
               "-mc3_delta", "0.3", "-mc3_temperatures", "0.6,0.4",
               "-mc3_swap", "15"])
    assert rc == 0
    assert open("cli.log").read() == open("direct.log").read()
    assert len(_log_rows("cli.log")[1]) == 4
    assert not (tmp_path / "inline.trees").exists()  # no tree file in MC3


def test_phase13_rehearsal(spec_doc, tmp_path, monkeypatch):
    """chip_smoke.py's phase 13 on the CPU at 12 taxa, after phase 12's
    runs wrote their files: the MC3 CLI's and the built batch's likelihood
    evaluations counted where the card counts peel_stream launches (one a
    batch step), the cold chain's log, the deviations; the five sub-tools
    on phase 12's files, each returning 0."""
    import time

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

    out = str(tmp_path)
    chip_smoke.spec_path(spec_doc, out, reset, read, device_ms, "cpu",
                         n_steps=40, n_check=2, n_profile=2)
    rec, launches = chip_smoke.mc3_path(spec_doc, out, reset, read,
                                        device_ms, "cpu", n_steps=40,
                                        swap=10, n_check=5, n_profile=3)
    assert launches["P13 mc3 cli"]["peel_stream"] == 41
    assert launches["P13 mc3 built batch"]["peel_stream"] == 1 + 5 + 1 + 3 + 5
    assert rec["log_rows"] == 4
    assert rec["full_evaluation_deviation"] <= chip_smoke.FULL_EVAL_TOL
    assert rec["draws_max_rel_err"] <= chip_smoke.MC3_REL_TOL
    assert 0.0 <= rec["cli"]["swap_acceptance"] <= 1.0
    tools = chip_smoke.tools_path(out, 12, "cpu", n_sites=300,
                                  burnin_states=20)
    assert all(t["rc"] == 0 for t in tools.values())
    assert tools["logcombiner"]["rows"] == 3  # 20 of first.log, 30 and 40
    assert tools["treeannotator"]["tips"] == 12
    assert tools["treestat"]["rows"] == 4
    assert tools["seqgen"]["shape"] == [12, 300]

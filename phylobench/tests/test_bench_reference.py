"""Each configuration's plain reference against the program, on the CPU at
a tiny size: the harness's whole run (set-up, window, the comparison that
decides `correct`), and the reference's log posterior at the start state
against the program's."""

import math

import numpy as np
import pytest
import torch

from phylobench import harness
from phylobench.tests._tiny import TINY, run_cpu


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_correct_on_the_cpu(cell):
    result, lines = run_cpu(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] == TINY[cell]["chains"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(line.startswith("check ") for line in lines)
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want and "setup_s" in want
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("config", ["makona1610_ucld_skygrid",
                                    "codon_gy94g4_bench1"])
def test_reference_matches_the_program_at_the_start(config):
    import importlib

    from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
    from beast_mcmc_tpu_torch.inference.mcmc import init_mcmc_state

    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    cfg.update({"taxa": 9, "patterns": 40, "sites": 120})
    setup = importlib.import_module(f"phylobench.configs.{config}").build(
        cfg, 77, "cpu")
    gen = torch.Generator().manual_seed(3)
    st = replicate_state(init_mcmc_state(setup["params0"], setup["tree0"],
                                         gen, setup["operators"]), 2, gen)
    prog = setup["log_posterior_chains"](st.params, st.tree)
    ref_mod = importlib.import_module(f"phylobench.reference.{config}")
    params = {k: v for k, v in st.params.items()
              if isinstance(v, torch.Tensor)}
    tree = {f: getattr(st.tree, f) for f in
            ("parent", "children", "heights", "root")}
    ref = ref_mod.log_posterior(cfg, setup["inputs"], params, tree,
                                torch.float64, "cpu")
    np.testing.assert_allclose(prog.numpy(), ref.numpy(), rtol=1e-10)
    g = ref_mod.grad_heights(cfg, setup["inputs"], params, tree,
                             torch.float64, "cpu")
    assert g.shape == tree["heights"].shape
    assert bool(torch.isfinite(g).all()) and math.isfinite(float(ref[0]))

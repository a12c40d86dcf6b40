"""`correct` has to come out false when the timed path is broken: the
harness's whole run on the CPU (its look for a card skipped), with each
fault a cell can have planted underneath, and the control (the reference in
float32 put in the program's place) outside the limits."""

import pytest
import torch

from beast_mcmc_tpu_torch.config import builder
from beast_mcmc_tpu_torch.inference import mcmc
from beast_mcmc_tpu_torch.models import treelikelihood
from phylobench import harness
from phylobench.tests._tiny import TINY, run_cpu


def _broken_step(monkeypatch, fault):
    real = mcmc.make_multichain_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        given = step.given_op

        def broken(states, op_idx, temperatures=1.0):
            if fault == "unchanged":  # the state returned as it came
                return states
            new = given(states, op_idx, temperatures)
            lp = new.log_posterior.clone()
            half = lp.shape[0] // 2  # half the batch left out: their mean
            lp[half:] = lp[:half].mean()
            return new.replace(log_posterior=lp)

        step.given_op = broken
        return step

    monkeypatch.setattr(mcmc, "make_multichain_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("cell", ["makona.mh.b64", "makona.hmc.b8",
                                  "codon.mh.b4"])
def test_broken_step_is_not_correct(monkeypatch, cell, fault):
    _broken_step(monkeypatch, fault)
    result, _ = run_cpu(cell)
    assert result["correct"] is False
    assert result["failed"] > 0


@pytest.mark.parametrize("cell,where", [("makona.mh.b64", builder),
                                        ("codon.mh.b4", treelikelihood)])
def test_altered_answer_is_not_correct(monkeypatch, cell, where):
    real = where.tree_loglikelihood

    def altered(*args, **kwargs):  # the likelihood off where it is made
        return real(*args, **kwargs) * (1.0 + 1e-7)

    monkeypatch.setattr(where, "tree_loglikelihood", altered)
    result, _ = run_cpu(cell)
    assert result["correct"] is False
    assert result["checks"]["lp_rel_gap"]["value"] > 1e-8


def test_altered_gradient_is_not_correct(monkeypatch):
    real = harness._program_gradient

    def altered(*args):
        g = real(*args)
        return g * (1.0 + 1e-2)

    monkeypatch.setattr(harness, "_program_gradient", altered)
    result, _ = run_cpu("makona.hmc.b8")
    assert result["correct"] is False
    assert result["checks"]["grad_rel_gap"]["value"] > 1e-3


@pytest.mark.parametrize("cell", ["makona.hmc.b8", "makona.mh.b64",
                                  "codon.mh.b4"])
def test_control_in_float32_fails_the_limits(cell):
    """The control at a tiny size: the reference in float32 put in the
    program's place comes out not correct under the configuration's
    limits (it fails one of the cell's numbers, at least the log
    posterior's), where the program's run is correct."""
    result, _ = harness.run(cell, 2147483911, 1.0, 0, "cpu", 0.0,
                            overrides=TINY[cell], log=lambda *a: None,
                            control=torch.float32)
    readings = result["readings"]
    assert result["correct"] is True
    assert readings["control_correct"] is False
    limit = result["checks"]["lp_rel_gap"]["limit"]
    assert max(readings["control"]["lp_rel_gap"]) > limit
    assert max(readings["program"]["lp_rel_gap"]) < limit

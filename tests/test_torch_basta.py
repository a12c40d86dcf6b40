"""The port's models/basta.py (the BASTA structured coalescent) against the
JAX package's and against the oracles of tests/test_basta.py: one deme is
the constant coalescent; the numpy recurrences of
GenericBastaLikelihoodDelegate.java at two and three demes; finite
gradients that agree with a finite difference; and the root's deme
distribution. Inputs are drawn with numpy from seeds; float64. Last,
chip_smoke.py's phase 19 rehearsed on the CPU at 24 taxa."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import basta as jbasta

from beast_mcmc_tpu_torch.models import basta
from beast_mcmc_tpu_torch.models.coalescent import constant_coalescent_loglik

from test_basta import numpy_basta, serial_tree

REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _tree(n, seed):
    parent, children, heights, _, rng = serial_tree(n=n, seed=seed)
    return parent, children, heights, rng


@pytest.mark.parametrize("n,k,seed,probs", [(8, 2, 0, False),
                                            (30, 3, 4, False),
                                            (12, 4, 7, True)])
def test_loglikelihood_and_gradients_match_jax(n, k, seed, probs):
    """The log density and its gradient in the heights, the migration
    rates and the population sizes against jax.grad, with int tip demes or
    [N, K] tip probabilities."""
    parent, children, heights, rng = _tree(n, seed)
    if probs:
        tips = rng.uniform(0.1, 1.0, (n, k))
        tips /= tips.sum(1, keepdims=True)
    else:
        tips = rng.integers(0, k, n)
    rates = rng.uniform(0.1, 1.0, k * (k - 1))
    pops = rng.uniform(0.5, 2.0, k)

    def jll(r, h, p):
        return jbasta.basta_loglikelihood(
            jnp.asarray(tips), jnp.asarray(parent), jnp.asarray(children), h,
            jbasta.migration_rate_matrix(r, k), p)

    want = float(jax.jit(jll)(jnp.asarray(rates), jnp.asarray(heights),
                              jnp.asarray(pops)))
    jg = jax.jit(jax.grad(jll, argnums=(0, 1, 2)))(
        jnp.asarray(rates), jnp.asarray(heights), jnp.asarray(pops))
    xs = [_t(v).requires_grad_(True) for v in (rates, heights, pops)]
    tips_t = _t(tips, torch.long if not probs else torch.float64)
    got = basta.basta_loglikelihood(
        tips_t, _t(parent, torch.long), _t(children, torch.long), xs[1],
        basta.migration_rate_matrix(xs[0], k), xs[2])
    np.testing.assert_allclose(float(got.detach()), want, rtol=REL)
    for g, w in zip(torch.autograd.grad(got, xs), jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())
    root = basta.basta_root_deme_distribution(
        tips_t, _t(parent, torch.long), _t(children, torch.long),
        _t(heights), basta.migration_rate_matrix(_t(rates), k), _t(pops))
    jroot = jbasta.basta_root_deme_distribution(
        jnp.asarray(tips), jnp.asarray(parent), jnp.asarray(children),
        jnp.asarray(heights),
        jbasta.migration_rate_matrix(jnp.asarray(rates), k),
        jnp.asarray(pops))
    np.testing.assert_allclose(root.numpy(), np.asarray(jroot), rtol=REL)
    np.testing.assert_allclose(float(root.sum()), 1.0, rtol=1e-12)


def test_one_deme_reduces_to_constant_coalescent():
    parent, children, heights, _ = _tree(8, 0)
    got = basta.basta_loglikelihood(
        torch.zeros(8, dtype=torch.long), _t(parent, torch.long),
        _t(children, torch.long), _t(heights),
        basta.migration_rate_matrix(torch.zeros(2, dtype=torch.float64), 2),
        _t([0.7, 123.0]))
    want = constant_coalescent_loglik(_t(heights), 8, _t(0.7))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-9)


@pytest.mark.parametrize("n,k,seed", [(10, 2, 3), (7, 3, 11)])
def test_matches_numpy_oracle(n, k, seed):
    parent, children, heights, rng = _tree(n, seed)
    demes = rng.integers(0, k, n)
    if k == 2:
        q = np.array([[-0.8, 0.8], [0.3, -0.3]])
        pops = np.array([0.5, 2.0])
    else:
        q = basta.migration_rate_matrix(_t(rng.uniform(0.1, 1.0, 6)),
                                        3).numpy()
        pops = np.array([0.5, 2.0, 1.3])
    got = basta.basta_loglikelihood(
        _t(demes, torch.long), _t(parent, torch.long),
        _t(children, torch.long), _t(heights), _t(q), _t(pops))
    want = numpy_basta(demes, parent, children, heights, q, pops)
    np.testing.assert_allclose(float(got), want, rtol=1e-8)


def test_gradients_finite():
    parent, children, heights, rng = _tree(6, 5)
    demes = _t(rng.integers(0, 2, 6), torch.long)

    def ll(rates, pops):
        return basta.basta_loglikelihood(
            demes, _t(parent, torch.long), _t(children, torch.long),
            _t(heights), basta.migration_rate_matrix(rates, 2), pops)

    r = _t([0.5, 0.2]).requires_grad_(True)
    p = _t([1.0, 2.0]).requires_grad_(True)
    g1, g2 = torch.autograd.grad(ll(r, p), (r, p))
    assert torch.isfinite(g1).all() and torch.isfinite(g2).all()
    eps = 1e-6
    with torch.no_grad():
        f0 = float(ll(_t([0.5, 0.2]), _t([1.0, 2.0])))
        f1 = float(ll(_t([0.5, 0.2]), _t([1.0 + eps, 2.0])))
    np.testing.assert_allclose(float(g2[0]), (f1 - f0) / eps, rtol=1e-3)


def test_phase19_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's phase 19 on the CPU: 19a at 24 taxa x 300 sites
    (`run -testxml`, 20 states: the CLI's likelihood evaluations counted
    where the card counts peel_stream launches, exactly as predicted with
    the gradient report's and the bound proposals' own; the report held
    to the CPU's by the document's <assertEqual>), 19b on the 24-taxon
    north-star document with its GLM (64 states, annotated trees), 19c's
    functions on the CPU twice."""
    import time

    import chip_smoke
    from beast_mcmc_tpu_torch.models import treelikelihood as tl

    from test_torch_makona_joint import _write_xml

    src = _write_xml(tmp_path / "small.xml", 24, 300, 6)
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
    out = str(tmp_path / "out")
    rec, launches = chip_smoke.hmc_path(
        out, reset, read, device_ms, "cpu", n_taxa=24, n_sites=300,
        n_steps=20, log_every=10, n_profile=2)
    a = rec["19a"]
    assert a["steps"] == 20 and a["log_rows"] == 2 and a["rc"] == 0
    assert a["full_evaluation_deviation"] == 0.0
    # the report: its gradient and 23 heights' central differences, and
    # as many for its diagonal Hessian (at most 64 values)
    assert a["report_launches"] == 2 * (1 + 2 * 23)
    assert launches["P19 19a CLI"] == {
        "peel_stream": 1 + 200 + 20 + 2 + 94 + a["bound_launches"]}
    assert set(a["bound_proposals"]) <= {"NodeHeightHmcOperator",
                                         "NutsOperator"}
    assert a["gradient_entries"] == 23
    assert len(a["hmc_proposal_ms"]) == a["bound_proposals"].get(
        "NodeHeightHmcOperator", 0)
    more, more_launches = chip_smoke.glm_path(
        out, reset, read, "cpu", scale=3e-7, src=str(src))
    b = more["19b"]
    assert b["steps"] == b["log_rows"] == b["trees"] == 64
    assert more_launches["P19 19b CLI"] == {
        "peel_stream": 1 + 200 + 2 * 64 + b["bound_launches"]}
    assert b["bound_launches"] == 2 * 5 * len(b["hmc_proposal_ms"])
    assert more["locations"] == 6
    c = chip_smoke.p19_functions_path(
        out, "cpu", os.path.join(out, "p19", "makona_glm.xml"))
    assert c["functions"] == 13 and c["max_rel_err"] == 0.0
    assert c["basta_taxa"] == 24
    assert len(c["surrogate_gradient"]) == len(c["exact_gradient"]) == 4


def test_phase19a_fails_on_a_planted_wrong_gradient(tmp_path, monkeypatch):
    """19a's -testxml check can fail: with one expected entry of its
    <assertEqual> moved by 1e-8 of the largest (100 times the tolerance),
    the assertion warns "(skipped)" on the simulated start tree, and
    hmc_path raises on that warning."""
    import chip_smoke

    write = chip_smoke.hmc_document

    def planted(path, data, n_steps, log_every, expected=None):
        if expected is not None:
            expected = expected.copy()
            expected[0] += 1e-8 * np.abs(expected).max()
        return write(path, data, n_steps, log_every, expected)

    monkeypatch.setattr(chip_smoke, "hmc_document", planted)
    with pytest.raises(AssertionError,
                       match=r"19a CLI -testxml: \[.*\(skipped\)"):
        chip_smoke.hmc_path(
            str(tmp_path), lambda: None, lambda: {"peel_stream": 0},
            lambda fn, label, n=1: (0.0, None), "cpu", n_taxa=12,
            n_sites=200, n_steps=10, log_every=10)

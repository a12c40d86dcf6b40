"""The port's peels against the JAX package's.

The plain PyTorch peel (the CPU path and the reference for both CUDA
kernels) is held against the JAX scan peel in float64 (rtol 1e-12: the
same operations in another summation order), and in float32 against the
two Pallas kernels it replaces, run in interpret mode (atol 5e-5 per site,
as tests/test_pallas_stream.py holds the streaming kernel). The kernels
themselves run only on the card: chip_smoke.py holds them against these
plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.ops.pallas_peeling import peel_site_loglik_pallas
from beast_mcmc_tpu.ops.pallas_stream2 import peel_site_loglik_deep
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models.sitemodel import (
    discrete_gamma_rates,
    single_rate,
)
from beast_mcmc_tpu_torch.models.substitution import (
    gtr_eigen,
    hky_eigen,
    jc_eigen,
)
from beast_mcmc_tpu_torch.models.treelikelihood import tree_loglikelihood
from beast_mcmc_tpu_torch.ops import cuda_peeling, cuda_stream
from beast_mcmc_tpu_torch.ops import peeling as tpeel

from fixtures import primate_patterns, primate_tree


def _problem(n_taxa, c, s, p, seed=0):
    """Random tree, tips and row-stochastic matrices (numpy)."""
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    m = 2 * n_taxa - 1
    tips = (rng.random((n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    pm = rng.random((m, c, s, s)) * 0.2 + 0.01
    pm = pm / pm.sum(-1, keepdims=True)
    freqs = np.full(s, 1.0 / s)
    cw = np.full(c, 1.0 / c)
    order = np.asarray(jpeel.peel_order_from_heights(jnp.asarray(heights),
                                                      n_taxa))
    return tips, children, order, root, pm, freqs, cw


def _jax(args, dt):
    tips, children, order, root, pm, freqs, cw = args
    return (jnp.asarray(tips, dt), jnp.asarray(children), jnp.asarray(order),
            jnp.asarray(root), jnp.asarray(pm, dt), jnp.asarray(freqs, dt),
            jnp.asarray(cw, dt))


def _torch(args, dt):
    tips, children, order, root, pm, freqs, cw = args
    f = lambda x: torch.tensor(np.array(x), dtype=dt)  # noqa: E731
    i = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    return (f(tips), i(children), i(order), i(root), f(pm), f(freqs), f(cw))


SHAPES = [(6, 4, 4, 40), (33, 1, 4, 200), (64, 2, 4, 130), (1025, 2, 4, 128)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_peel_matches_jax_scan_f64(shape):
    args = _problem(*shape, seed=3)
    ref = np.asarray(jpeel.peel_site_loglik(*_jax(args, jnp.float64)))
    targs = _torch(args, torch.float64)
    got = tpeel.peel_site_loglik(*targs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    # the streaming kernel's plain version reads the peel-ordered schedule
    got = cuda_stream.peel_site_loglik_stream(*targs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("shape", [(6, 4, 4, 40), (33, 1, 4, 200),
                                   (12, 2, 4, 64)])
def test_plain_peel_matches_pallas_kernels_f32(shape):
    """Both TPU kernels of the main path, interpret mode, float32."""
    args = _problem(*shape, seed=5)
    jargs = _jax(args, jnp.float32)
    targs = _torch(args, torch.float32)
    resident = np.asarray(peel_site_loglik_pallas(*jargs, True))
    deep = np.asarray(peel_site_loglik_deep(*jargs, True))
    got = cuda_peeling.peel_site_loglik_cuda(*targs).numpy()
    np.testing.assert_allclose(got, resident, atol=5e-5)
    np.testing.assert_allclose(got, deep, atol=5e-5)
    got = cuda_stream.peel_site_loglik_stream(*targs).numpy()
    np.testing.assert_allclose(got, deep, atol=5e-5)


@pytest.fixture(scope="module")
def primates():
    pats = primate_patterns()
    parent, children, heights, root, taxa = primate_tree()
    f = lambda x: torch.tensor(np.array(x), dtype=torch.float64)  # noqa: E731
    i = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    return {
        "tips": f(np.swapaxes(pats.tip_partials(), 1, 2)),
        "weights": f(pats.weights),
        "parent": i(parent), "children": i(children),
        "heights": f(heights), "root": i(root),
        "freqs_emp": f(pats.empirical_frequencies()),
    }


def _loglik(st, eig, freqs, rates, weights):
    return float(tree_loglikelihood(
        st["tips"], st["weights"], st["parent"], st["children"],
        st["heights"], st["root"], eig, freqs, rates, weights,
        branch_rates=1.0))


def _golden(name, st):
    """(logL, expected) for the oracles of tests/test_peeling.py
    (LikelihoodTest.java)."""
    quarter = torch.full((4,), 0.25, dtype=torch.float64)
    emp = st["freqs_emp"]
    one = single_rate(device="cpu")
    if name == "jc69":
        return _loglik(st, jc_eigen(device="cpu"), quarter, *one), -1992.20564
    if name == "k80":
        return (_loglik(st, hky_eigen(27.402591, quarter), quarter, *one),
                -1856.30305)
    if name == "hky85":
        return _loglik(st, hky_eigen(29.739445, emp), emp, *one), -1825.21317
    if name == "hky85_gamma":
        rates = discrete_gamma_rates(torch.tensor(0.137064, dtype=torch.float64), 4)
        return _loglik(st, hky_eigen(38.829740, emp), emp, *rates), -1789.75936
    eig = gtr_eigen(torch.ones(6, dtype=torch.float64), emp)
    return _loglik(st, eig, emp, *one), -1969.14584


@pytest.mark.parametrize("name", ["jc69", "k80", "hky85", "hky85_gamma", "gtr"])
def test_golden_oracles(primates, name):
    got, expected = _golden(name, primates)
    np.testing.assert_allclose(got, expected, atol=2e-5)


def test_non_divisible_patterns(primates):
    """P = 61: the wrappers take a ragged pattern count as it is, and
    pad_patterns' all-ones, zero-weight columns leave the total unchanged."""
    st = primates
    tips = st["tips"][:, :, :61].contiguous()
    w = st["weights"][:61]
    freqs = st["freqs_emp"]
    rates, cw = discrete_gamma_rates(torch.tensor(0.5, dtype=torch.float64), 4)
    eig = gtr_eigen(torch.tensor([1.0, 2.0, 0.7, 1.1, 3.0, 1.0],
                                 dtype=torch.float64), freqs)
    from beast_mcmc_tpu_torch.models.treelikelihood import (
        branch_transition_matrices,
    )

    pm = branch_transition_matrices(eig, st["parent"], st["heights"], 1.0,
                                    rates)
    order = tpeel.peel_order_from_heights(st["heights"], 6, st["parent"])
    args = (st["children"], order, st["root"], pm, freqs, cw)
    site = cuda_peeling.peel_site_loglik_cuda(tips, *args)
    assert site.shape == (61,)
    ref = peel_site_loglik_pallas(
        jnp.asarray(tips.numpy(), jnp.float32), jnp.asarray(st["children"]),
        jnp.asarray(order.numpy()), jnp.asarray(st["root"]),
        jnp.asarray(pm.numpy(), jnp.float32), jnp.asarray(freqs, jnp.float32),
        jnp.asarray(cw, jnp.float32), True)
    np.testing.assert_allclose(site.numpy(), np.asarray(ref), atol=5e-5)
    np.testing.assert_allclose(
        cuda_stream.peel_site_loglik_stream(tips, *args).numpy(),
        site.numpy(), rtol=1e-12)
    tips_p, w_p = tpeel.pad_patterns(tips, w, 128)
    assert tips_p.shape[2] == 128 and float(w_p[61:].abs().sum()) == 0.0
    site_p = cuda_peeling.peel_site_loglik_cuda(tips_p, *args)
    assert bool(torch.isfinite(site_p).all())
    np.testing.assert_allclose(
        float(tpeel.peel_loglikelihood(tips_p, *args, w_p)),
        float(tpeel.peel_loglikelihood(tips, *args, w)), rtol=1e-12)


@pytest.mark.parametrize("dtype,itemsize", [(torch.float64, 8),
                                            (torch.float32, 4)])
def test_resident_plan_cut_over(dtype, itemsize):
    """Re-derived for Hopper shared memory: the benchmark2 tree's matrices
    fit (resident), the Makona tree's do not (streaming)."""
    b2_m, mak_m = 2 * 62 - 1, 2 * 1610 - 1
    assert cuda_peeling.resident_plan_fits(b2_m, 4, 4, itemsize)
    assert not cuda_peeling.resident_plan_fits(mak_m, 4, 4, itemsize)
    # the cut-over sits where [M,C,S,S] + the reduction buffer meet 200 KB
    m_max = max(m for m in range(1, 4000)
                if cuda_peeling.resident_plan_fits(m, 4, 4, itemsize))
    assert (m_max * 64 + 256) * itemsize <= 200 * 1024 < (
        (m_max + 1) * 64 + 256) * itemsize

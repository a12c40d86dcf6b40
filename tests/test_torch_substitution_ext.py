"""The covarion, GLM and HKY generators and eigen_from_q_reversible
(queue item 4h-1), and the plain peel under autograd_peel on every route
(fault C7), against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - hky_q, glm_rates, covarion_q and expand_tip_partials_hidden against
    JAX's at 1e-12 relative (the generators' entries, the product
    frequencies, the tiled partials);
  - eigen_from_q_reversible: its reconstruction U diag(values) U_inv of
    the covarion generator and P(t) against JAX's at 1e-12 of the largest
    entry (an eigenvector's sign is free, so the factors are not
    compared); and the S = 8 covarion likelihood through it (the
    tree_loglikelihood route phase 21a takes) against JAX's and, with two
    identical classes, against the base HKY likelihood;
  - C7: under ops/peeling.py::autograd_peel, models/treelikelihood.py's
    `_site_logliks` (one tree, the deep route, a chain batch) and
    `multipartition_loglikelihood` (one tree, a chain batch) take the
    node-by-node plain peel for tips that report themselves as CUDA
    tensors: the kernel entries are replaced by recorders that fail the
    test, the value equals the CPU's to 1e-12 and a second derivative is
    taken through it; outside autograd_peel the same call reaches the
    kernel entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.models.sitemodel import single_rate as jsingle_rate
from beast_mcmc_tpu.models.treelikelihood import (
    tree_loglikelihood as j_tree_loglik,
)
from beast_mcmc_tpu.ops import eigen as jeig
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.models import treelikelihood as ttl
from beast_mcmc_tpu_torch.ops import cuda_peeling, eigen as teig, peeling

from test_substitution_ext import primate_setup

F64 = torch.float64
REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()) / scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hky_q_and_glm_rates_match_jax(seed):
    rng = np.random.default_rng(seed)
    kappa = rng.uniform(0.5, 8.0)
    freqs = rng.dirichlet(np.full(4, 4.0))
    _close(tsub.hky_q(kappa, torch.tensor(freqs)),
           jsub.hky_q(kappa, jnp.asarray(freqs)))
    design = rng.normal(size=(12, 3))
    beta = rng.normal(size=3)
    ind = (rng.random(3) > 0.5).astype(float)
    _close(tsub.glm_rates(torch.tensor(design), torch.tensor(beta)),
           jsub.glm_rates(jnp.asarray(design), jnp.asarray(beta)))
    _close(tsub.glm_rates(torch.tensor(design), torch.tensor(beta),
                          torch.tensor(ind)),
           jsub.glm_rates(jnp.asarray(design), jnp.asarray(beta),
                          jnp.asarray(ind)))


def _covarion_inputs(seed, h):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 4.0, (4, 4))
    r = (r + r.T) * (1.0 - np.eye(4))
    freqs = rng.dirichlet(np.full(4, 5.0))
    class_rates = rng.uniform(0.1, 2.0, h)
    class_freqs = rng.dirichlet(np.full(h, 3.0))
    return r, freqs, class_rates, class_freqs, rng.uniform(0.2, 3.0)


@pytest.mark.parametrize("h", [2, 3])
def test_covarion_q_and_eigen_match_jax(h):
    """covarion_q's generator and product frequencies, the tiled tip
    partials and eigen_from_q_reversible's reconstruction and P(t) against
    JAX's."""
    args = _covarion_inputs(10 + h, h)
    tq, tpf = tsub.covarion_q(*(torch.tensor(a) for a in args[:4]), args[4])
    jq, jpf = jsub.covarion_q(*(jnp.asarray(a) for a in args[:4]), args[4])
    _close(tq, jq)
    _close(tpf, jpf)
    te = teig.eigen_from_q_reversible(tq, tpf)
    je = jeig.eigen_from_q_reversible(jq, jpf)
    recon = (te.U * te.values[None, :]) @ te.U_inv
    _close(recon, (je.U * je.values[None, :]) @ je.U_inv)
    _close(recon, jq)
    t = np.array([1e-6, 0.01, 0.3, 2.0])
    _close(teig.transition_probs(te, torch.tensor(t)),
           jeig.transition_probs(je, jnp.asarray(t)))
    tips = np.random.default_rng(h).random((5, 4, 7))
    _close(tsub.expand_tip_partials_hidden(torch.tensor(tips), h),
           jsub.expand_tip_partials_hidden(jnp.asarray(tips), h))


def _primate_torch():
    tips, weights, parent, children, heights, root, freqs = primate_setup()
    tl = lambda x: torch.tensor(np.asarray(x), dtype=torch.long)  # noqa
    return (torch.tensor(np.asarray(tips)), torch.tensor(np.asarray(weights)),
            tl(parent), tl(children), torch.tensor(np.asarray(heights)),
            tl(root), torch.tensor(np.asarray(freqs)))


@pytest.mark.parametrize("classes", ["identical", "varied"])
def test_covarion_likelihood_through_its_eigensystem(classes):
    """The S = 8 covarion likelihood by tree_loglikelihood over
    eigen_from_q_reversible (phase 21a's route) against JAX's over its own
    eigen_from_q_reversible at 1e-12; with identical classes, the base HKY
    likelihood too (the switching is unidentifiable)."""
    tips, weights, parent, children, heights, root, freqs = primate_setup()
    kappa = 3.0
    r = np.ones((4, 4))
    for i, j in ((0, 2), (2, 0), (1, 3), (3, 1)):
        r[i, j] = kappa
    r *= 1.0 - np.eye(4)
    cr, cf, sw = (([1.0, 1.0], [0.4, 0.6], 1.7) if classes == "identical"
                  else ([0.1, 1.9], [0.5, 0.5], 0.5))
    jq, jpf = jsub.covarion_q(jnp.asarray(r), freqs, jnp.asarray(cr),
                              jnp.asarray(cf), sw)
    cat_r, cat_w = jsingle_rate()
    want = float(j_tree_loglik(
        jsub.expand_tip_partials_hidden(tips, 2), weights,
        jnp.asarray(parent), jnp.asarray(children), jnp.asarray(heights),
        root, jeig.eigen_from_q_reversible(jq, jpf), jpf, cat_r, cat_w,
        1.0))
    t_tips, t_w, t_par, t_ch, t_h, t_root, t_freqs = _primate_torch()
    tq, tpf = tsub.covarion_q(torch.tensor(r), t_freqs,
                              torch.tensor(cr, dtype=F64),
                              torch.tensor(cf, dtype=F64), sw)
    got = float(ttl.tree_loglikelihood(
        tsub.expand_tip_partials_hidden(t_tips, 2), t_w, t_par, t_ch, t_h,
        t_root, teig.eigen_from_q_reversible(tq, tpf), tpf,
        torch.ones(1, dtype=F64), torch.ones(1, dtype=F64), 1.0))
    np.testing.assert_allclose(got, want, rtol=REL)
    if classes == "identical":
        base = float(ttl.tree_loglikelihood(
            t_tips, t_w, t_par, t_ch, t_h, t_root,
            tsub.hky_eigen(kappa, t_freqs), t_freqs,
            torch.ones(1, dtype=F64), torch.ones(1, dtype=F64), 1.0))
        np.testing.assert_allclose(got, base, rtol=1e-10)


# ---------------------------------------------------------------------------
# C7: the plain peel under autograd_peel on every route and device
# ---------------------------------------------------------------------------


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so that the
    likelihood takes its CUDA branches."""

    @property
    def is_cuda(self):
        return True


def _kernel_recorders(monkeypatch):
    """The kernel entries models/treelikelihood.py reaches, replaced by
    recorders that return NaN."""
    calls = []

    def rec(name):
        def fn(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} reached")
        return fn

    for name in ("peel_site_loglik_auto", "peel_loglikelihood_auto",
                 "peel_site_loglik_deep"):
        monkeypatch.setattr(ttl, name, rec(name))
    return calls


def _c7_case(n_taxa, c, seed, k_parts=None, chains=None):
    rng = np.random.default_rng(seed)
    trees = [simulate_coalescent_tree(rng, np.zeros(n_taxa), 1.0)
             for _ in range(chains or 1)]
    tl = lambda x: torch.tensor(np.array(x), dtype=torch.long)  # noqa: E731
    parent = tl([t[0] for t in trees])
    children = tl([t[1] for t in trees])
    heights = torch.tensor(np.array([t[2] for t in trees]))
    root = tl([t[3] for t in trees])
    if chains is None:
        parent, children, heights, root = parent[0], children[0], \
            heights[0], root[0]
    lead = () if k_parts is None else (k_parts,)
    tips = torch.tensor((rng.random((*lead, n_taxa, 4, 9)) > 0.5) * 0.9
                        + 0.1)
    w = torch.tensor(rng.integers(1, 5, (*lead, 9)), dtype=F64)
    freqs = torch.tensor(rng.dirichlet(np.full(4, 5.0), size=k_parts)
                         if k_parts else rng.dirichlet(np.full(4, 5.0)))
    rates = torch.tensor(rng.uniform(0.3, 2.0, (*lead, c)))
    cat_w = torch.tensor(rng.dirichlet(np.full(c, 3.0), size=k_parts)
                         if k_parts else rng.dirichlet(np.full(c, 3.0)))
    kappa = torch.tensor(rng.uniform(1.5, 5.0, lead) if lead else 2.5)
    return tips, w, parent, children, heights, root, kappa, freqs, rates, \
        cat_w


def _second_derivative(fn, kappa):
    """d2 fn / d kappa2 summed over kappa's entries, by two autograd
    passes."""
    k = kappa.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(k), k, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), k)
    return h


@pytest.mark.parametrize("case", ["one tree", "deep", "chains"])
def test_c7_site_logliks_take_the_plain_peel_under_autograd_peel(
        monkeypatch, case):
    """tree_loglikelihood (`_site_logliks`) of CUDA-looking tips under
    autograd_peel: no kernel entry, the CPU's value, a second derivative
    in kappa; outside it the kernel entry is reached."""
    n_taxa, c = {"one tree": (10, 2), "deep": (220, 4),
                 "chains": (10, 2)}[case]
    tips, w, parent, children, heights, root, kappa, freqs, rates, cat_w = \
        _c7_case(n_taxa, c, 71, chains=3 if case == "chains" else None)
    assert (cuda_peeling.peel_route(2 * n_taxa - 1, c, 4, 8) == "deep") \
        == (case == "deep")
    chain_kappa = kappa.expand(3) if case == "chains" else kappa

    def total(tp, k):
        ll = ttl.tree_loglikelihood(tp, w, parent, children, heights, root,
                                    tsub.hky_eigen(k, freqs), freqs, rates,
                                    cat_w, 0.8)
        return ll.sum()

    ref = total(tips, chain_kappa)
    calls = _kernel_recorders(monkeypatch)
    cuda_tips = tips.as_subclass(_CudaLooking)
    with peeling.sequential_peel_only(), peeling.autograd_peel():
        got = total(cuda_tips, chain_kappa)
        h = _second_derivative(lambda k: total(cuda_tips, k), chain_kappa)
    assert calls == []
    np.testing.assert_allclose(float(got), float(ref), rtol=REL)
    with peeling.sequential_peel_only(), peeling.autograd_peel():
        want_h = _second_derivative(lambda k: total(tips, k), chain_kappa)
    assert torch.isfinite(h).all()
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), rtol=1e-10)
    with pytest.raises(AssertionError, match="reached"):
        total(cuda_tips, chain_kappa)
    assert calls


@pytest.mark.parametrize("chains", [None, 2])
def test_c7_multipartition_takes_the_plain_peel_under_autograd_peel(
        monkeypatch, chains):
    """multipartition_loglikelihood of CUDA-looking tips under
    autograd_peel: every partition by the plain peel, the CPU's total and
    a second derivative; outside it a kernel entry is reached."""
    k_parts = 3
    tips, w, parent, children, heights, root, kappa, freqs, rates, cat_w = \
        _c7_case(12, 2, 72, k_parts=k_parts, chains=chains)
    if chains:  # the chains' [B, K] parameters
        kappa = kappa.expand(chains, k_parts)
        rates, cat_w = (x.expand(chains, *x.shape) for x in (rates, cat_w))

    def total(tp, k):
        return ttl.multipartition_loglikelihood(
            tp, w, parent, children, heights, root, tsub.hky_eigen(k, freqs),
            freqs, rates, cat_w, 0.9).sum()

    ref = total(tips, kappa)
    calls = _kernel_recorders(monkeypatch)
    cuda_tips = tips.as_subclass(_CudaLooking)
    with peeling.sequential_peel_only(), peeling.autograd_peel():
        got = total(cuda_tips, kappa)
        h = _second_derivative(lambda k: total(cuda_tips, k), kappa)
    assert calls == []
    np.testing.assert_allclose(float(got), float(ref), rtol=REL)
    assert torch.isfinite(h).all()
    with pytest.raises(AssertionError, match="reached"):
        total(cuda_tips, kappa)

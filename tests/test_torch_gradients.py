"""Gradients of the port's likelihood against jax.grad of the JAX package.

The JAX peel is a custom VJP (beast_mcmc_tpu/ops/peeling.py): a pre-order
adjoint over the rescaled partials, reused by every Pallas wrapper. The
port's counterpart is ops/peeling.py: `peel_site_loglik`, an autograd
Function over the node-by-node adjoint (the CPU oracle), and
`peel_with_adjoint`, the level adjoint behind every kernel route, whose
forward is the kernel with its partials or, for a CPU tensor, the kernel's
plain version. Here, in float64 on the CPU, each route's entry point is
held against jax.grad of the JAX scan peel with respect to the branch
matrices, the frequencies and the category weights (1e-10 relative to the
largest entry, or 1e-12 absolute), the Pallas kernel's VJP in interpret
mode at the tolerance of tests/test_pallas_peeling.py (float32), and the
whole log posterior of `build_analysis` against the JAX one with respect
to the node heights and every parameter. The kernels themselves run only
on the card, where chip_smoke.py holds each route's gradient against the
plain one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jbuild
from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.ops import eigen as jeigen
from beast_mcmc_tpu.ops import peeling as jpeel
from beast_mcmc_tpu.ops.pallas_peeling import (
    _peel_forward_pallas,
    peel_site_loglik_pallas,
)
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.ops import (
    cuda_mxu,
    cuda_peeling,
    cuda_stream,
    cuda_stream2,
)
from beast_mcmc_tpu_torch.ops import eigen as teigen
from beast_mcmc_tpu_torch.ops import peeling as tpeel

from fixtures import primate_patterns, primate_tree

REL, ABS = 1e-10, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_taxa, c, s, p, seed, k=None):
    """A coalescent tree, tips, row-stochastic matrices, random freqs and
    category weights (numpy); with `k`, k partitions on the tree."""
    rng = np.random.default_rng(seed)
    parent, children, heights, root = simulate_coalescent_tree(
        rng, np.zeros(n_taxa), 1.0)
    lead = () if k is None else (k,)
    tips = (rng.random((*lead, n_taxa, s, p)) > 0.6) * 0.9 + 0.1
    pm = rng.random((*lead, 2 * n_taxa - 1, c, s, s)) * 0.2 + 0.01
    pm = pm / pm.sum(-1, keepdims=True)
    freqs = rng.random((*lead, s)) + 0.2
    freqs = freqs / freqs.sum(-1, keepdims=True)
    cw = rng.random((*lead, c)) + 0.2
    cw = cw / cw.sum(-1, keepdims=True)
    order = np.argsort(heights[n_taxa:], kind="stable") + n_taxa
    g = rng.random((*lead, p)) + 0.5  # the cotangent: pattern weights
    return tips, children, order, root, pm, freqs, cw, g


def _jax_grads(tips, children, order, root, pm, freqs, cw, g, peel=None):
    """jax.grad of sum(g * site_logl) of one tree, float64."""
    peel = peel or jpeel.peel_site_loglik

    def total(pm_, fr_, cw_):
        return jnp.dot(jnp.asarray(g), peel(
            jnp.asarray(tips), jnp.asarray(children), jnp.asarray(order),
            jnp.asarray(root), pm_, fr_, cw_))

    return [np.asarray(a) for a in jax.grad(total, argnums=(0, 1, 2))(
        jnp.asarray(pm), jnp.asarray(freqs), jnp.asarray(cw))]


def _torch_grads(fn, tips, children, order, root, pm, freqs, cw, g,
                 dt=torch.float64):
    leaf = lambda x: torch.tensor(x, dtype=dt, requires_grad=True)  # noqa
    i64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.long)  # noqa
    xs = [leaf(pm), leaf(freqs), leaf(cw)]
    site = fn(torch.tensor(tips, dtype=dt), i64(children), i64(order),
              i64(root), *xs)
    total = torch.sum(torch.tensor(g, dtype=dt) * site)
    return [t.numpy() for t in torch.autograd.grad(total, xs)]


def _close(got, ref, rel=REL, abs_=ABS):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert np.all(np.isfinite(a))
        err = np.abs(a - b).max()
        assert err <= max(rel * np.abs(b).max(), abs_), (err,
                                                         np.abs(b).max())


def _levels_entry(fn):
    """An entry point that reads level_schedule, called as the plain one."""
    def call(tips, children, order, root, pm, freqs, cw):
        sched = cuda_stream.level_schedule(children, tips.shape[0])
        return fn(tips, children, order, root, pm, freqs, cw, sched)
    return call


ROUTES = {
    "node": tpeel.peel_site_loglik,
    "resident": cuda_peeling.peel_site_loglik_cuda,
    "resident, schedule given": _levels_entry(
        cuda_peeling.peel_site_loglik_cuda),
    "deep": cuda_stream2.peel_site_loglik_deep,
    "mxu": cuda_mxu.peel_site_loglik_mxu,
    "stream": cuda_stream.peel_site_loglik_stream,
}
CASES = [(r, (14, 4, 4, 37)) for r in ROUTES] + [
    (r, shape) for r in ("node", "mxu", "stream")
    for shape in ((11, 2, 20, 19), (9, 1, 61, 13))]


@pytest.mark.parametrize("route,shape", CASES)
def test_route_gradient_matches_jax(route, shape):
    """Each route's entry point on CPU tensors (the plain version with the
    residual, and the level adjoint; the node-by-node adjoint for
    `peel_site_loglik`) against jax.grad of the JAX scan peel."""
    args = _problem(*shape, seed=len(route) + shape[2])
    _close(_torch_grads(ROUTES[route], *args), _jax_grads(*args))


def test_deep_route_three_partitions_matches_jax():
    """K = 3 partitions on one tree in one deep peel: each partition's
    gradient against jax.grad of its own JAX peel."""
    tips, ch, order, root, pm, fr, cw, g = _problem(16, 2, 4, 21, seed=4,
                                                    k=3)
    got = _torch_grads(cuda_stream2.peel_site_loglik_deep, tips, ch, order,
                       root, pm, fr, cw, g)
    for k in range(3):
        _close([t[k] for t in got], _jax_grads(tips[k], ch, order, root,
                                               pm[k], fr[k], cw[k], g[k]))


def test_gradient_matches_pallas_vjp_interpret():
    """The resident route (the port's kernel for this TPU kernel) against
    the Pallas kernel's VJP in interpret mode, and its residual against
    `_peel_forward_pallas(want_post=True)`, in float32 on the primate data
    at the tolerances of tests/test_pallas_peeling.py."""
    pats = primate_patterns()
    parent, children, heights, root, taxa = primate_tree()
    rng = np.random.default_rng(8)
    tips = np.swapaxes(pats.tip_partials(), 1, 2).astype(np.float32)
    n, s, p = tips.shape
    pm = (rng.random((2 * n - 1, 4, s, s)) * 0.2 + 0.01).astype(np.float32)
    pm = pm / pm.sum(-1, keepdims=True)
    freqs = np.asarray(pats.empirical_frequencies(), np.float32)
    cw = np.full(4, 0.25, np.float32)
    order = np.argsort(np.asarray(heights)[n:], kind="stable") + n
    g = np.asarray(pats.weights, np.float32)
    args = (tips, np.asarray(children), order, np.asarray(root), pm, freqs,
            cw, g)
    ref = _jax_grads(*args, peel=lambda *a: peel_site_loglik_pallas(*a,
                                                                    True))
    got = _torch_grads(cuda_peeling.peel_site_loglik_cuda, *args,
                       dt=torch.float32)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    _, ref_post = _peel_forward_pallas(
        jnp.asarray(tips), jnp.asarray(children), jnp.asarray(order),
        jnp.asarray(pm), jnp.asarray(freqs), jnp.asarray(cw), True,
        want_post=True)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    sched = cuda_stream.level_schedule(t(children).long(), n)
    _, pos = cuda_peeling._resident_plain(
        t(tips), sched[1], sched[2], sched[3], t(pm),
        t(cw)[:, None] * t(freqs)[None], want_post=True)
    post = tpeel.post_by_node(pos[None], t(tips)[None], sched[0])[0]
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post),
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(10, 2, 4, 3), (12, 1, 4, 8),
                                   (9, 4, 20, 2)])
def test_small_pattern_level_branch(monkeypatch, shape):
    """C * P <= 8 takes the level forms (`_peel_forward_levels`,
    `_peel_bwd_levels`), as the JAX peel does; `sequential_peel_only`
    forces the node forms. Both agree with jax.grad of the JAX peel (which
    takes its own level form here)."""
    args = _problem(*shape, seed=9)
    taken = []
    for name in ("_peel_forward_levels", "_peel_bwd_levels"):
        real = getattr(tpeel, name)
        monkeypatch.setattr(tpeel, name, lambda *a, _r=real, _n=name: (
            taken.append(_n), _r(*a))[1])
    ref = _jax_grads(*args)
    _close(_torch_grads(tpeel.peel_site_loglik, *args), ref)
    assert taken == ["_peel_forward_levels", "_peel_bwd_levels"]
    with tpeel.sequential_peel_only():
        with tpeel.sequential_peel_only():  # re-entrant
            pass
        _close(_torch_grads(tpeel.peel_site_loglik, *args), ref)
    assert len(taken) == 2
    assert tpeel._LEVEL_PEEL_ENABLED


@pytest.mark.parametrize("p,pw,tiles", [(37, 8, 2), (64, 4, 4), (5, 8, 1)])
def test_scratch_to_post_round_trip(p, pw, tiles):
    """The kernels' scratch layouts, filled from partials by position (the
    padded patterns of the last tile set to NaN, which the gather must cut
    away), gathered back: resident [tiles, n_int, S, C, pw], deep [K,
    tiles, n_int, C, S, pw]; then `post_by_node` puts position i at node
    order[i] and the tips in their rows."""
    n_tips, c, s, k = 9, 3, 4, 2
    n_int = n_tips - 1
    rng = np.random.default_rng(p)
    pos = torch.tensor(rng.random((k, n_int, c, s, p)))
    t_all = -(-p // (pw * tiles)) * tiles
    padded = torch.full((k, n_int, c, s, t_all * pw), float("nan"),
                        dtype=torch.float64)
    padded[..., :p] = pos
    blocks = padded.reshape(k, n_int, c, s, t_all, pw)
    resident = blocks[0].permute(3, 0, 2, 1, 4).contiguous()
    assert resident.shape == (t_all, n_int, s, c, pw)
    torch.testing.assert_close(cuda_peeling.resident_positions(resident, p),
                               pos[0], rtol=0, atol=0)
    deep = blocks.permute(0, 4, 1, 2, 3, 5).contiguous()
    assert deep.shape == (k, t_all, n_int, c, s, pw)
    torch.testing.assert_close(cuda_stream2.deep_positions(deep, p), pos,
                               rtol=0, atol=0)
    tips = torch.tensor(rng.random((k, n_tips, s, p)))
    order = torch.tensor(rng.permutation(n_int) + n_tips)
    post = tpeel.post_by_node(pos, tips, order)
    assert post.shape == (k, n_tips + n_int, c, s, p)
    torch.testing.assert_close(post[:, order], pos, rtol=0, atol=0)
    torch.testing.assert_close(post[:, :n_tips],
                               tips[:, :, None].expand(k, n_tips, c, s, p),
                               rtol=0, atol=0)


NAMES = ("clock.rate", "alpha", "pop.size", "gtr.rates")


def _posterior_grads(rates=None):
    """(port, JAX) gradients of build_analysis(16, 40)'s log posterior
    with respect to the node heights and NAMES, at its start point (GTR
    rates `rates` where given)."""
    lp, _, p0, t0, _ = build_analysis(16, 40, "gtr_gamma", device="cpu",
                                      dtype=torch.float64)
    params = {k: v.clone().requires_grad_(True) if k in NAMES else v
              for k, v in p0.items()}
    if rates is not None:
        params["gtr.rates"] = torch.tensor(rates, requires_grad=True)
    heights = t0.heights.clone().requires_grad_(True)
    got = torch.autograd.grad(lp(params, t0.replace(heights=heights)),
                              [heights] + [params[n] for n in NAMES])
    jlp, _, jp0, jt0, _ = jbuild(16, 40, "gtr_gamma")
    if rates is not None:
        jp0 = {**jp0, "gtr.rates": jnp.asarray(rates)}

    def f(h, *xs):
        return jlp({**jp0, **dict(zip(NAMES, xs))}, jt0.replace(heights=h))

    ref = jax.grad(f, argnums=tuple(range(5)))(
        jt0.heights, *[jp0[n] for n in NAMES])
    return [t.numpy() for t in got], [np.asarray(r) for r in ref]


def test_posterior_gradient_matches_jax():
    """Fault C1's case: the gradient of build_analysis(16, 40, "gtr_gamma")'s
    log posterior, which raised on the CPU, now equals JAX's with respect to
    the heights, clock.rate, alpha and pop.size; and at distinct GTR rates
    (1..6, where the eigenvalues are simple) with respect to the rates."""
    got, ref = _posterior_grads(np.arange(1.0, 7.0))
    _close(got, ref)
    got, ref = _posterior_grads()
    _close(got[:4], ref[:4])


def test_eigen_gradient_is_nan_at_equal_rates_in_both_packages():
    """At rates ones(6) and freqs [0.3, 0.2, 0.2, 0.3] the spectrum is
    F81's, with a triple eigenvalue: the eigensolver's backward divides by
    eigenvalue gaps, and JAX's gradient of P(t) with respect to the rates
    is NaN. The port's no longer is (it was before P(t) took the
    Daleckii-Krein backward of ops/eigen.py): it is finite and agrees with
    central differences (1e-6 relative). At rates 1..6 the two packages
    are finite and equal."""
    freqs = [0.3, 0.2, 0.2, 0.3]

    def jax_grad(rates):
        def f(r):
            eig = jsub.gtr_eigen(r, jnp.asarray(freqs))
            return jnp.sum(jeigen.transition_probs(eig, jnp.asarray(0.3))
                           * jnp.arange(16.0).reshape(4, 4))
        return np.asarray(jax.grad(f)(jnp.asarray(rates)))

    def torch_grad(rates):
        r = torch.tensor(rates, requires_grad=True)
        eig = tsub.gtr_eigen(r, torch.tensor(freqs, dtype=torch.float64))
        p = teigen.transition_probs(eig, torch.tensor(0.3,
                                                      dtype=torch.float64))
        total = torch.sum(p * torch.arange(16.0, dtype=torch.float64)
                          .reshape(4, 4))
        return torch.autograd.grad(total, r)[0].numpy()

    ones = np.ones(6)
    assert np.isnan(jax_grad(ones)).any()

    def total(rates):
        eig = tsub.gtr_eigen(torch.tensor(rates),
                             torch.tensor(freqs, dtype=torch.float64))
        return float(torch.sum(teigen.transition_probs(
            eig, torch.tensor(0.3, dtype=torch.float64))
            * torch.arange(16.0, dtype=torch.float64).reshape(4, 4)))

    h = 1e-6
    diffs = [(total(ones + h * e) - total(ones - h * e)) / (2 * h)
             for e in np.eye(6)]
    np.testing.assert_allclose(torch_grad(ones), diffs, rtol=1e-6,
                               atol=1e-8)
    distinct = np.arange(1.0, 7.0)
    ref = jax_grad(distinct)
    assert np.all(np.isfinite(ref))
    np.testing.assert_allclose(torch_grad(distinct), ref, rtol=1e-10,
                               atol=1e-12)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so that a route
    takes its kernel branch into the recorders below."""

    @property
    def is_cuda(self):
        return True


def test_kernel_entries_raise_on_inputs_that_require_grad(monkeypatch):
    """The CUDA half of fault C1: a kernel's ctypes launch is invisible to
    autograd, so every kernel entry called outside the autograd wrapper with
    inputs that require grad raises before it launches. Through the
    differentiable entry point the kernel entry (here a recorder that
    returns the plain version, as tests/test_torch_deep_levels.py replaces
    entries) is called with autograd off, and the gradient is the CPU's."""
    tips, ch, order, root, pm, fr, cw, g = _problem(12, 4, 4, 16, seed=2)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    tips_t, ch_t, order_t, pm_t = t(tips), t(ch).long(), t(order), t(pm)
    fr_t, cw_t = t(fr), t(cw)
    sched = cuda_stream.level_schedule(ch_t, 12)
    _, ids, pos, ls = sched
    pm_req = pm_t.clone().requires_grad_(True)
    for call in (
            lambda: cuda_peeling.prepare_resident(tips_t, ch_t, order_t,
                                                  pm_req, fr_t, cw_t, sched),
            lambda: cuda_stream2.prepare_deep(
                tips_t[None], ids, pos, ls, pm_req[ids.long()][None],
                fr_t[None], cw_t[None]),
            lambda: cuda_stream.prepare_stream(tips_t, sched, pm_req, fr_t,
                                               cw_t),
            lambda: cuda_mxu.prepare_mxu(tips_t, ch_t, order_t, pm_req,
                                         fr_t, cw_t, sched)):
        with pytest.raises(RuntimeError, match="require grad"):
            call()
    with torch.no_grad():  # no gradient asked: the guard passes, and the
        with pytest.raises(ValueError, match="CUDA"):  # device check raises
            cuda_peeling.prepare_resident(tips_t, ch_t, order_t, pm_req,
                                          fr_t, cw_t, sched)

    seen = []

    def resident(tips_, children, order_, pm_, freqs_, cw_, schedule,
                 want_post=False):
        seen.append((torch.is_grad_enabled(), want_post))
        assert not tpeel.wants_grad(pm_, freqs_, cw_)  # the guard passes
        _, lr_ids, lr_pos, level_start = schedule
        return cuda_peeling._resident_plain(
            tips_.as_subclass(torch.Tensor), lr_ids, lr_pos, level_start,
            pm_, cw_[..., None] * freqs_[..., None, :], want_post=want_post)

    monkeypatch.setattr(cuda_peeling, "_peel_resident_kernel", resident)
    got = _torch_grads(
        lambda tp, *a: cuda_peeling.peel_site_loglik_cuda(
            tp.as_subclass(_CudaLooking), *a),
        tips, ch, order, root, pm, fr, cw, g)
    assert seen == [(False, True)]
    _close(got, _jax_grads(tips, ch, order, root, pm, fr, cw, g))


def test_multipartition_posterior_gradient_matches_jax():
    """build_analysis(9, 40, "hky_codon3"): three partitions on one tree
    through multipartition_loglikelihood, the gradient with respect to the
    heights, mu [3] and clock.rate against JAX's. With respect to kappa [3]
    against central differences of the log posterior (1e-6 relative): the
    freqs give purines and pyrimidines 0.5 each, so HKY's spectrum has a
    double eigenvalue, and there jax.grad through XLA's eigh differs from
    the differences (-339.9 against -69.8 for kappa[0]) where the port's
    agrees with them."""
    names = ("kappa", "mu", "clock.rate")
    lp, _, p0, t0, _ = build_analysis(9, 40, "hky_codon3", device="cpu",
                                      dtype=torch.float64)
    params = {k: v.clone().requires_grad_(True) if k in names else v
              for k, v in p0.items()}
    heights = t0.heights.clone().requires_grad_(True)
    got = torch.autograd.grad(lp(params, t0.replace(heights=heights)),
                              [heights] + [params[n] for n in names])
    jlp, _, jp0, jt0, _ = jbuild(9, 40, "hky_codon3")

    def f(h, *xs):
        return jlp({**jp0, **dict(zip(names, xs))}, jt0.replace(heights=h))

    ref = jax.grad(f, argnums=tuple(range(4)))(jt0.heights,
                                               *[jp0[n] for n in names])
    got = [t.numpy() for t in got]
    ref = [np.asarray(r) for r in ref]
    _close([got[0], *got[2:]], [ref[0], *ref[2:]])

    def lp_at(kappa):
        return float(lp({**p0, "kappa": torch.tensor(kappa)}, t0))

    h, k0 = 1e-6, p0["kappa"].numpy()
    diffs = np.array([(lp_at(k0 + h * e) - lp_at(k0 - h * e)) / (2 * h)
                      for e in np.eye(3)])
    np.testing.assert_allclose(got[1], diffs, rtol=1e-6)


@pytest.mark.parametrize("kappa", [[1.9996839432925457, 1.8441266117500663,
                                    2.0056277909770017],
                                   [1.0, 1.000001, 0.5]])
def test_kappa_gradient_at_degenerate_spectra(kappa):
    """build_analysis(9, 40, "hky_codon3")'s log posterior with respect to
    kappa [3] against central differences. HKY's spectrum has a double
    eigenvalue at every kappa here (purine and pyrimidine frequencies 0.5
    each) and a triple one at kappa 1; the first kappa is
    one a reflective HMC trajectory reached, where the eigensolver's own
    backward gives NaN. Then build_analysis(9, 40)'s log posterior with
    respect to the GTR rates at ones(6) (a triple eigenvalue) and at an
    HKY-like (1, 2, 1, 1, 2, 1), whose double eigenvalue the GTR
    directions split: finite, and equal to fourth-order central
    differences (h = 1e-4) to 1e-6 of the largest entry."""
    lp, _, p0, t0, _ = build_analysis(9, 40, "hky_codon3", device="cpu",
                                      dtype=torch.float64)
    glp, _, g0, gt0, _ = build_analysis(9, 40, device="cpu",
                                        dtype=torch.float64)
    h = 1e-4

    def check(f, x0):
        x = x0.clone().requires_grad_(True)
        got = torch.autograd.grad(f(x), x)[0].numpy()
        eye = torch.eye(x0.shape[0], dtype=torch.float64)
        diffs = np.array([(8 * (float(f(x0 + h * e)) - float(f(x0 - h * e)))
                           - float(f(x0 + 2 * h * e))
                           + float(f(x0 - 2 * h * e))) / (12 * h)
                          for e in eye])
        assert np.all(np.isfinite(got))
        assert np.abs(got - diffs).max() <= 1e-6 * np.abs(diffs).max(), (
            got, diffs)

    check(lambda k: lp({**p0, "kappa": k}, t0),
          torch.tensor(kappa, dtype=torch.float64))
    for rates in ([1.0] * 6, [1.0, 2.0, 1.0, 1.0, 2.0, 1.0]):
        check(lambda r: glp({**g0, "gtr.rates": r}, gt0),
              torch.tensor(rates, dtype=torch.float64))

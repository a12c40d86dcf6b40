"""The port's NUTS and PDMP operators against the JAX package.

Deterministic parts in float64: `_ckpt_idxs` for n = 0..255 exactly; a
NUTS trajectory on build_analysis(12, 64)'s posterior, its leapfrog taking
one value and gradient a point (cached at the ends), against JAX's
algorithm with two jax.grad calls a leapfrog, every doubling run and
masked, written here in numpy from beast_mcmc_tpu/inference/nuts.py with
the same injected uniforms (1e-10 relative); the port's early stop against
that full masked run on Gaussians (the proposal to 1e-12, the acceptance
statistic and the leapfrog count exactly). Counts: n_lf + 1 posterior
evaluations a NUTS proposal, events + 1 a PDMP chain step. Statistical:
tests/test_samplers.py's NUTS tests with their targets, settings and
tolerances, and tests/test_mds_hawkes_pdmp.py's Zig-Zag and BPS tests with
their targets, operator settings and tolerances over 1,000 steps where
JAX takes 4,000 (each event is a host-driven gradient on the CPU here).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jbuild
from beast_mcmc_tpu.inference import nuts as jnuts

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.inference.hmc import batch_of_one, value_and_grad
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.nuts import (
    NutsOperator,
    _ckpt_idxs,
    nuts_trajectory,
)
from beast_mcmc_tpu_torch.inference.pdmp import (
    BouncyParticleOperator,
    ZigZagOperator,
)
from beast_mcmc_tpu_torch.tree.topology import make_tree_state
from beast_mcmc_tpu_torch.utils.transforms import LogTransform

F64 = torch.float64
CKPT = np.stack([np.asarray(a) for a in jax.jit(jax.vmap(jnuts._ckpt_idxs))(
    jnp.arange(256, dtype=jnp.int32))], 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many thousands of tiny torch ops; with the default
    thread pool its idle threads spin between them on every core, five
    times the CPU time for no gain. One thread while they run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ckpt_idxs_matches_jax():
    assert [_ckpt_idxs(n) for n in range(256)] == [tuple(r) for r in
                                                   CKPT.tolist()]


def nuts_masked_np(u_fn, g_fn, y0, r0, eps, inv_mass, md, draws):
    """JAX's NutsOperator.propose after its momentum draw, line for line in
    numpy: every doubling runs, masked once done; two gradients a
    leapfrog. draws[depth] = (u_direction, u_leaves, u_select).
    Returns (y_proposed, mean acceptance statistic, n_lf)."""
    dim = y0.shape[0]

    def energy(y, r):
        return u_fn(y) + 0.5 * np.sum(r * r) * inv_mass

    def leapfrog(y, r):
        r = r - 0.5 * eps * g_fn(y)
        y = y + eps * r * inv_mass
        r = r - 0.5 * eps * g_fn(y)
        return y, r

    h0 = energy(y0, r0)

    def build_subtree(y_edge, r_edge_int, depth, u_leaf):
        ck_y = np.zeros((md + 1, dim))
        ck_r = np.zeros((md + 1, dim))
        y, r, y_prop, logw = y_edge, r_edge_int, y_edge, -np.inf
        sum_acc, turning, diverged = 0.0, False, False
        for i in range(2 ** depth):
            y, r = leapfrog(y, r)
            delta = h0 - energy(y, r)
            diverged = diverged or delta < -1000.0 or np.isnan(delta)
            logw_leaf = -np.inf if diverged else delta
            logw_new = np.logaddexp(logw, logw_leaf)
            if np.log(u_leaf[i]) < logw_leaf - logw_new:
                y_prop = y
            logw = logw_new
            sum_acc = sum_acc + np.minimum(1.0, np.exp(delta))
            idx_min, idx_max = CKPT[i]
            if i % 2 == 0:
                ck_y[idx_max], ck_r[idx_max] = y, r
            else:
                idxs = np.arange(md + 1)
                active = (idxs >= idx_min) & (idxs <= idx_max)
                d_y = y[None, :] - ck_y
                t_left = np.einsum("kd,kd->k", d_y, ck_r) < 0.0
                t_right = (d_y @ r) < 0.0
                turning = turning or bool(np.any(active & (t_left | t_right)))
        return y, r, y_prop, logw, sum_acc, turning, diverged

    y_minus, r_minus, y_plus, r_plus, y_prop = y0, r0, y0, r0, y0
    logw, sum_acc, n_lf, done = 0.0, 0.0, 0, False
    for depth in range(md):
        u_dir, u_leaf, u_sel = draws[depth]
        direction = -1.0 if u_dir < 0.5 else 1.0
        y_edge = y_plus if direction > 0 else y_minus
        r_edge = r_plus if direction > 0 else r_minus
        (y_far, r_far_int, y_sub, logw_sub, acc_sub, turning_sub,
         diverged_sub) = build_subtree(y_edge, r_edge * direction, depth,
                                       u_leaf)
        r_far = r_far_int * direction
        ok = not done and not turning_sub and not diverged_sub
        take = ok and np.log(u_sel) < logw_sub - logw
        y_prop = y_sub if take else y_prop
        logw = np.logaddexp(logw, logw_sub) if ok else logw
        sum_acc = sum_acc + (acc_sub if not done else 0.0)
        n_lf = n_lf + (2 ** depth if not done else 0)
        if ok and direction < 0:
            y_minus, r_minus = y_far, r_far
        if ok and direction > 0:
            y_plus, r_plus = y_far, r_far
        dz = y_plus - y_minus
        whole_turn = np.dot(dz, r_minus) < 0.0 or np.dot(dz, r_plus) < 0.0
        done = done or turning_sub or diverged_sub or whole_turn
    return y_prop, sum_acc / max(n_lf, 1), n_lf


def _draws(md, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random(), rng.random(2 ** d), rng.random())
            for d in range(md)]


def _run_port(u, y0, r0, eps, md, draws):
    calls = []

    def u_and_grad(y):
        calls.append(1)
        return value_and_grad(u, y)

    def draw(depth):
        a, leaves, b = draws[depth]
        return torch.tensor(a), torch.tensor(leaves), torch.tensor(b)

    y, acc, n_lf = nuts_trajectory(u_and_grad, torch.tensor(y0),
                                   torch.tensor(r0), eps, 1.0, md, draw)
    assert len(calls) == n_lf + 1  # a value and gradient a new point
    return y.numpy(), float(acc), n_lf


def test_nuts_trajectory_on_the_tree_posterior_matches_jax():
    """NutsOperator(("clock.rate", "pop.size")) on build_analysis(12, 64):
    the trajectory from a given momentum and uniforms, with the port's
    cached end gradients, against JAX's masked algorithm on jax.grad of the
    JAX posterior, for two sets of uniforms and step sizes (one that stops
    early)."""
    lp, _, p0, t0, aux = build_analysis(12, 64, device="cpu", dtype=F64)
    _, _, jp0, jt0, jaux = jbuild(12, 64)
    op = NutsOperator(parameters=("clock.rate", "pop.size"))
    op.bind_log_posterior(aux["log_post_cached"])
    u1 = op.neg_log_density(op.one_chain_posterior(), batch_of_one(p0),
                            batch_of_one(t0))
    u = lambda y: u1(y[None])[0]  # noqa: E731  (the batch of one's chain)
    y0 = op._pack(batch_of_one(p0))[0].numpy()

    def ju(y):
        x = jnp.exp(y)
        return -(jaux["log_post_cached"]({**jp0, "clock.rate": x[0],
                                          "pop.size": x[1]}, jt0)
                 + jnp.sum(y))

    ju_jit, jg = jax.jit(ju), jax.jit(jax.grad(ju))
    u_fn = lambda y: float(ju_jit(jnp.asarray(y)))  # noqa: E731
    g_fn = lambda y: np.asarray(jg(jnp.asarray(y)))  # noqa: E731
    r0 = np.array([0.8, -0.6])
    n_lfs = []
    for eps, seed in ((2e-4, 0), (5e-4, 1)):
        draws = _draws(4, seed)
        y, acc, n_lf = _run_port(u, y0, r0, eps, 4, draws)
        ry, racc, rn = nuts_masked_np(u_fn, g_fn, y0, r0, eps, 1.0, 4, draws)
        np.testing.assert_allclose(y, ry, rtol=1e-10)
        assert acc == pytest.approx(racc, rel=1e-10)
        assert n_lf == rn
        n_lfs.append(n_lf)
    assert min(n_lfs) < 15


@pytest.mark.parametrize("eps,md", [(0.05, 6), (0.3, 6), (1.0, 5), (2.5, 4),
                                    (30.0, 4)])
def test_nuts_early_stop_matches_full_masked_run(eps, md):
    """Correlated Gaussian targets: the port's trajectory, which stops
    between doublings once done, against the full masked run in numpy
    with the same injected uniforms (four seeds each): the proposal to
    1e-12, the acceptance statistic and n_lf exactly. The step sizes run
    from no early stop to divergence at the first leaf."""
    cov = np.array([[1.0, 0.9, 0.0], [0.9, 1.0, 0.3], [0.0, 0.3, 2.0]])
    prec = np.linalg.inv(cov)
    mean = np.array([1.0, -2.0, 0.5])
    tprec, tmean = torch.tensor(prec), torch.tensor(mean)

    def u(y):
        d = y - tmean
        return 0.5 * d @ tprec @ d

    u_fn = lambda y: 0.5 * (y - mean) @ prec @ (y - mean)  # noqa: E731
    g_fn = lambda y: prec @ (y - mean)  # noqa: E731
    rng = np.random.default_rng(int(eps * 100) + md)
    for seed in range(4):
        y0, r0 = rng.normal(size=3), rng.normal(size=3)
        draws = _draws(md, 10 * seed + md)
        y, acc, n_lf = _run_port(u, y0, r0, eps, md, draws)
        with np.errstate(all="ignore"):
            ry, racc, rn = nuts_masked_np(u_fn, g_fn, y0, r0, eps, 1.0, md,
                                          draws)
        np.testing.assert_allclose(y, ry, rtol=0, atol=1e-12)
        assert n_lf == rn
        assert acc == pytest.approx(racc, rel=1e-12, abs=1e-15)
        assert n_lf < 2 ** md - 1  # the trajectory stopped early


def _dummy_tree():
    return make_tree_state(np.array([2, 2, -1]),
                           np.array([[-1, -1], [-1, -1], [0, 1]]),
                           np.array([0.0, 0.0, 1.0]), 2, F64, "cpu")


def _counted(log_post):
    calls = []

    def f(params, tree):
        calls.append(1)
        return log_post(params, tree)

    return f, calls


def test_evaluations_per_proposal_and_refused_settings():
    """A NUTS proposal evaluates the posterior n_lf + 1 times (its value and
    gradient at each new point and at the start); a chain step with a PDMP
    proposal last_n_events + 1 times (a gradient an event inside the
    horizon and the chain's evaluation). NUTS, Zig-Zag and BPS refuse the
    precondition and transform settings that JAX ignores."""
    def log_post(params, tree):
        return -0.5 * torch.sum((params["x"] - 1.0) ** 2 / torch.tensor(
            [1.0, 4.0], dtype=F64))

    lp, calls = _counted(log_post)
    ops = [NutsOperator(parameters=("x",), log_transform=False, max_depth=6),
           ZigZagOperator(parameters=("x",), log_transform=False,
                          grad_bound=[3.0, 2.0], travel_time=1.0),
           BouncyParticleOperator(parameters=("x",), log_transform=False,
                                  grad_bound=4.0, travel_time=1.0,
                                  max_events=5)]
    for op in ops:
        step = make_mcmc_step(lp, [op])
        st = init_mcmc_state({"x": torch.zeros(2, dtype=F64)},
                             _dummy_tree(), torch.Generator().manual_seed(3),
                             [op], lp)
        seen = set()
        for _ in range(20):
            calls.clear()
            if isinstance(op, NutsOperator):
                op.propose(st.params, st.tree, st.generator, 0.4)
                assert len(calls) == op.last_n_leapfrog + 1
                seen.add(op.last_n_leapfrog)
            st = step(st)
            if not isinstance(op, NutsOperator):
                assert len(calls) == op.last_n_events + 1
                seen.add(op.last_n_events)
        assert len(seen) > 1
        assert op.last_n_events <= 5 if hasattr(op, "refresh_rate") else True
    for cls in (NutsOperator, ZigZagOperator, BouncyParticleOperator):
        for kw in ({"precondition": "diag"}, {"transform": LogTransform()}):
            with pytest.raises(ValueError, match="neither"):
                cls(parameters=("x",), **kw)


def _chain(ops, params, log_post, n_steps, seed, every):
    step = make_mcmc_step(log_post, ops)
    st = init_mcmc_state(params, _dummy_tree(),
                         torch.Generator().manual_seed(seed), ops, log_post)
    return run_chain(step, st, n_steps, every,
                     lambda s: {k: v.clone() for k, v in s.params.items()})


def _gamma_logpdf(x, shape, scale):
    return ((shape - 1.0) * torch.log(x) - x / scale - math.lgamma(shape)
            - shape * math.log(scale))


def test_nuts_gamma_target():
    """x ~ Gamma(3, scale 2), NUTS in log space, step size 0.5, max depth 5,
    4,000 steps (tests/test_samplers.py): mean and variance in JAX's
    bands."""
    ops = [NutsOperator(parameters=["x"], step_size=0.5, max_depth=5)]
    _, trace = _chain(ops, {"x": torch.tensor(4.0, dtype=F64)},
                      lambda p, t: torch.sum(_gamma_logpdf(p["x"], 3.0, 2.0)),
                      4000, 0, 10)
    xs = trace["x"].numpy()[20:]
    se = xs.std() / np.sqrt(len(xs) / 10.0)
    assert abs(xs.mean() - 6.0) < max(4 * se, 0.5), xs.mean()
    assert abs(xs.var() - 12.0) < 4.0, xs.var()


def test_nuts_correlated_normal():
    """A 2-d normal with correlation 0.9, NUTS step size 0.3, max depth 5,
    4,000 steps (tests/test_samplers.py): means within 0.3, correlation
    within 0.1."""
    prec = torch.tensor(np.linalg.inv([[1.0, 0.9], [0.9, 1.0]]))
    mean = torch.tensor([1.0, -2.0], dtype=F64)

    def log_post(params, tree):
        d = params["x"] - mean
        return -0.5 * d @ prec @ d

    ops = [NutsOperator(parameters=["x"], step_size=0.3, max_depth=5,
                        log_transform=False)]
    _, trace = _chain(ops, {"x": torch.zeros(2, dtype=F64)}, log_post, 4000,
                      0, 10)
    xs = trace["x"].numpy()[20:]
    assert np.allclose(xs.mean(axis=0), [1.0, -2.0], atol=0.3), xs.mean(0)
    assert abs(np.corrcoef(xs.T)[0, 1] - 0.9) < 0.1


def _pdmp_gaussian(op):
    """tests/test_mds_hawkes_pdmp.py's target: mean (1, -1), unit variances,
    correlation 0.6; draws every 5 steps, the first 40 dropped."""
    prec = torch.tensor(np.linalg.inv([[1.0, 0.6], [0.6, 1.0]]))
    mean = torch.tensor([1.0, -1.0], dtype=F64)

    def log_post(params, tree):
        d = params["x"] - mean
        return -0.5 * d @ prec @ d

    _, trace = _chain([op], {"x": torch.zeros(2, dtype=F64)}, log_post, 1000,
                      0, 5)
    return trace["x"].numpy()[40:]


def test_zigzag_gaussian_moments():
    xs = _pdmp_gaussian(ZigZagOperator(
        parameters=["x"], log_transform=False, travel_time=2.0,
        grad_bound=25.0))
    assert np.allclose(xs.mean(axis=0), [1.0, -1.0], atol=0.25), xs.mean(0)
    assert abs(np.corrcoef(xs.T)[0, 1] - 0.6) < 0.2


def test_bps_gaussian_moments():
    xs = _pdmp_gaussian(BouncyParticleOperator(
        parameters=["x"], log_transform=False, travel_time=2.0,
        grad_bound=30.0, refresh_rate=1.0))
    assert np.allclose(xs.mean(axis=0), [1.0, -1.0], atol=0.25), xs.mean(0)
    assert abs(np.corrcoef(xs.T)[0, 1] - 0.6) < 0.2

"""The port's reflective, sphere, simplex and Stiefel HMC operators against
the JAX package.

Deterministic parts in float64: ReflectiveHmcOperator._reflect on a grid
(1e-12), the Stiefel position update and momentum projection against the
port's and JAX's numpy oracles (1e-10), the block structures exactly, and
one integrator trajectory per operator from a given start and momentum
against one rebuilt here from jax.grad of the JAX posterior (1e-10
relative). Statistical: the vMF test of tests/test_hmc_ext2.py with its
settings and tolerances, and Dirichlet moments for the simplex and the
reflective operators (four standard errors of the sample mean, an
autocorrelation discount of ten as tests/test_samplers.py takes).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jbuild
from beast_mcmc_tpu.inference import geodesic as jgeo
from beast_mcmc_tpu.inference.hmc import ReflectiveHmcOperator as JReflective

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.inference import geodesic as tgeo
from beast_mcmc_tpu_torch.inference.hmc import (
    GeodesicHmcOperator,
    ReflectiveHmcOperator,
    SimplexHmcOperator,
    batch_of_one,
)
from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

F64 = torch.float64
REL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many thousands of tiny torch ops; with the default
    thread pool its idle threads spin between them on every core, five
    times the CPU time for no gain. One thread while they run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dummy_tree():
    return make_tree_state(np.array([2, 2, -1]),
                           np.array([[-1, -1], [-1, -1], [0, 1]]),
                           np.array([0.0, 0.0, 1.0]), 2, F64, "cpu")


def _one_chain_trajectory(op, params, tree, y0, p0, eps):
    """op.trajectory of one chain under its bound posterior: the batch of
    one's."""
    y, p = op.trajectory(op.one_chain_posterior(), batch_of_one(params),
                         batch_of_one(tree), y0[None], p0[None], eps)
    return y[0], p[0]


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.all(np.isfinite(got))
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1.0), (
        got, ref)


@pytest.mark.parametrize("lower,upper", [(0.0, math.inf), (-math.inf, 2.0),
                                         (-1.0, 3.0), (0.0, 1.0),
                                         (-math.inf, math.inf)])
def test_reflect_matches_jax(lower, upper):
    """One-sided and two-sided bounds: the fold and the momentum flips on y
    from several spans below the lower bound to several above the upper,
    against the JAX operator's _reflect (remainder, not fmod), 1e-12."""
    y = np.concatenate([np.linspace(-13.7, 14.2, 301), [lower, upper]])
    y = y[np.isfinite(y)]
    p = np.random.default_rng(0).normal(size=y.shape)
    jy, jp = JReflective(lower=lower, upper=upper)._reflect(jnp.asarray(y),
                                                            jnp.asarray(p))
    ty, tp = ReflectiveHmcOperator(lower=lower, upper=upper)._reflect(
        torch.tensor(y), torch.tensor(p))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if math.isfinite(lower):
        assert ty.min() >= lower - 1e-12
    if math.isfinite(upper):
        assert ty.max() <= upper + 1e-12


def _stiefel_point(p, k, seed):
    rng = np.random.default_rng(seed)
    X = np.linalg.qr(rng.normal(size=(p, k)))[0]
    return X, rng.normal(size=(p, k))


@pytest.mark.parametrize("mask,groups", [
    (None, []),
    (np.r_[np.ones(5), np.ones(5), np.r_[0, 1, 1, 1, 1]], []),
    (None, [[1, 2]]),
])
def test_stiefel_numpy_and_tensor_flow_match_jax(mask, groups):
    """The block structure exactly; the numpy position update, momentum
    projection and whole leapfrog against JAX's numpy oracle; the tensor
    update_position and project_momentum of the chain operator against the
    same oracle on one block (1e-10)."""
    p, k, eps = 5, 3, 0.07
    jb = jgeo.apply_orthogonality_structure(jgeo.blocks_from_mask(p, k, mask),
                                            groups)
    tb = tgeo.apply_orthogonality_structure(tgeo.blocks_from_mask(p, k, mask),
                                            groups)
    assert tb == jb
    X, M = _stiefel_point(p, k, 3)
    Xj, Mj, Xt, Mt = X.copy(), M.copy(), X.copy(), M.copy()
    jgeo._project_momentum_np(Xj, Mj, jb)
    tgeo._project_momentum_np(Xt, Mt, tb)
    _close(Mt, Mj)
    jgeo._update_position_np(Xj, Mj, jb, eps)
    tgeo._update_position_np(Xt, Mt, tb, eps)
    _close(Xt, Xj)
    _close(Mt, Mj)
    C = np.random.default_rng(4).normal(size=(p, k))
    args = (X, tgeo.deterministic_momentum(p, k) * 0.01, lambda x: C, 4,
            eps, tb)
    xj, hj = jgeo.geodesic_leapfrog_np(*args[:5], jb)
    xt, ht = tgeo.geodesic_leapfrog_np(*args)
    _close(xt, xj)
    assert ht == pytest.approx(hj, rel=REL)
    np.testing.assert_array_equal(tgeo.deterministic_momentum(p, k),
                                  jgeo.deterministic_momentum(p, k))
    if mask is None and not groups:  # one whole-matrix block
        X0, M0 = _stiefel_point(p, k, 5)
        Mj = M0.copy()
        jgeo._project_momentum_np(X0, Mj, jb)
        Mt = tgeo.project_momentum(torch.tensor(X0), torch.tensor(M0))
        _close(Mt.numpy(), Mj)
        Xj = X0.copy()
        jgeo._update_position_np(Xj, Mj, jb, eps)
        Xt, Mt = tgeo.update_position(torch.tensor(X0), Mt, eps)
        _close(Xt.numpy(), Xj)
        _close(Mt.numpy(), Mj)
        _close((Xt.T @ Xt).numpy(), np.eye(k))


def _analyses():
    port = build_analysis(12, 64, device="cpu", dtype=F64)
    return port, jbuild(12, 64)


def test_reflective_trajectory_matches_jax():
    """ReflectiveHmcOperator(("clock.rate", "pop.size")) on
    build_analysis(12, 64)'s posterior, lower 0: six steps from a given
    momentum against the JAX leapfrog from jax.grad of the JAX posterior
    and the JAX operator's reflection; the step size and momentum send
    pop.size across its bound, so the fold is on the path."""
    (_, _, p0, t0, aux), (_, _, jp0, jt0, jaux) = _analyses()
    names = ("clock.rate", "pop.size")
    op = ReflectiveHmcOperator(parameters=names, n_leapfrog=6, lower=0.0)
    op.bind_log_posterior(aux["log_post_cached"])
    y0 = torch.stack([p0[n] for n in names])
    pm0 = torch.tensor([0.3, -150.0], dtype=F64)
    eps = 0.002
    y1, pm1 = _one_chain_trajectory(op, p0, t0, y0, pm0, eps)

    def ju(y):
        return -jaux["log_post_cached"]({**jp0, names[0]: y[0],
                                         names[1]: y[1]}, jt0)

    jg, jref = jax.jit(jax.grad(ju)), JReflective(lower=0.0)
    y, p = jnp.asarray(y0.numpy()), jnp.asarray(pm0.numpy())
    crossed = False
    for _ in range(6):
        p = p - 0.5 * eps * jg(y)
        crossed |= bool(jnp.any(y + eps * p < 0.0))
        y, p = jref._reflect(y + eps * p, p)
        p = p - 0.5 * eps * jg(y)
    assert crossed
    _close(y1.numpy(), y)
    _close(pm1.numpy(), p)


MU = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.6, 0.0, 0.8]])


def test_sphere_trajectory_matches_jax():
    """GeodesicHmcOperator on three unit spheres in R^3 under a vMF-type
    target with a quadratic term: eight steps against the JAX operator's
    tangent kicks and great-circle moves rebuilt from jax.grad."""
    A = np.random.default_rng(6).normal(size=(9, 9)) * 0.3

    def tlp(params, tree):
        x = params["x"]
        return 4.0 * torch.sum(x.reshape(3, 3) * torch.tensor(MU)) + x @ (
            torch.tensor(A) @ x)

    def jlp(x):
        return 4.0 * jnp.sum(x.reshape(3, 3) * MU) + x @ (A @ x)

    op = GeodesicHmcOperator(parameter="x", block_dim=3, n_leapfrog=8)
    op.bind_log_posterior(tlp)
    rng = np.random.default_rng(7)
    y0 = rng.normal(size=(3, 3))
    y0 /= np.linalg.norm(y0, axis=1, keepdims=True)
    v = rng.normal(size=(3, 3))
    p0 = v - np.sum(v * y0, 1, keepdims=True) * y0
    eps = 0.2
    params = {"x": torch.tensor(y0.reshape(-1))}
    y1, p1 = _one_chain_trajectory(op, params, _dummy_tree(),
                                   torch.tensor(y0), torch.tensor(p0), eps)

    g = jax.jit(jax.grad(lambda y: -jlp(y.reshape(-1))))
    tan = lambda y, v: v - jnp.sum(v * y, 1, keepdims=True) * y  # noqa: E731

    def geo(y, p, t):
        speed = jnp.linalg.norm(p, axis=1, keepdims=True)
        u, a = p / jnp.maximum(speed, 1e-30), speed * t
        return (y * jnp.cos(a) + u * jnp.sin(a),
                (-y * jnp.sin(a) + u * jnp.cos(a)) * speed)

    y, p = jnp.asarray(y0), jnp.asarray(p0)
    for _ in range(8):
        p = tan(y, p - 0.5 * eps * g(y))
        y, p = geo(y, p, eps)
        p = tan(y, p - 0.5 * eps * g(y))
    _close(y1.numpy(), y)
    _close(p1.numpy(), p)
    np.testing.assert_allclose(np.linalg.norm(y1.numpy(), axis=1), 1.0,
                               atol=1e-12)


ALPHA = np.array([2.0, 3.0, 4.0, 5.0])


def _dirichlet_t(params, tree):
    return torch.sum((torch.tensor(ALPHA) - 1.0) * torch.log(params["x"]))


def test_simplex_trajectory_matches_jax():
    """SimplexHmcOperator on a Dirichlet(2, 3, 4, 5) with a correlation
    term: five steps in ALR coordinates against the JAX leapfrog on the
    JAX operator's target (softmax([y, 0]), log|J| = sum log x)."""
    def tlp(params, tree):
        x = params["x"]
        return _dirichlet_t(params, tree) + 3.0 * x[0] * x[2]

    def jneg(y):
        x = jax.nn.softmax(jnp.concatenate([y, jnp.zeros(1)]))
        return -(jnp.sum((ALPHA - 1.0) * jnp.log(x)) + 3.0 * x[0] * x[2]
                 + jnp.sum(jnp.log(x)))

    op = SimplexHmcOperator(parameter="x", n_leapfrog=5)
    op.bind_log_posterior(tlp)
    x0 = np.array([0.1, 0.2, 0.3, 0.4])
    y0 = np.log(x0[:-1]) - np.log(x0[-1])
    p0 = np.array([0.5, -1.1, 0.7])
    eps = 0.15
    y1, p1 = _one_chain_trajectory(op, {"x": torch.tensor(x0)},
                                   _dummy_tree(), torch.tensor(y0),
                                   torch.tensor(p0), eps)
    g = jax.jit(jax.grad(jneg))
    y, p = jnp.asarray(y0), jnp.asarray(p0)
    for _ in range(5):
        p = p - 0.5 * eps * g(y)
        y = y + eps * p
        p = p - 0.5 * eps * g(y)
    _close(y1.numpy(), y)
    _close(p1.numpy(), p)


def test_stiefel_trajectory_matches_jax():
    """StiefelGeodesicHmcOperator on a 5 x 2 matrix (two column parameters)
    under tr(C^T X) + tr(X^T B X): five steps against the JAX operator's
    integrator (jax.scipy.linalg.expm, cholesky, solve_triangular) rebuilt
    from jax.grad; the columns stay orthonormal."""
    rng = np.random.default_rng(8)
    C, B = rng.normal(size=(5, 2)), rng.normal(size=(5, 5))
    B = B + B.T

    def tlp(params, tree):
        X = torch.stack([params["a"], params["b"]], 1)
        return torch.sum(torch.tensor(C) * X) + torch.trace(
            X.T @ torch.tensor(B) @ X)

    def jlp(X):
        return jnp.sum(C * X) + jnp.trace(X.T @ B @ X)

    op = tgeo.StiefelGeodesicHmcOperator(parameters=("a", "b"), n_leapfrog=5)
    op.bind_log_posterior(tlp)
    X0, M = _stiefel_point(5, 2, 9)
    M0 = M.copy()
    jgeo._project_momentum_np(X0, M0, jgeo.blocks_from_mask(5, 2, None))
    eps = 0.05
    params = {"a": torch.tensor(X0[:, 0]), "b": torch.tensor(X0[:, 1])}
    X1, M1 = _one_chain_trajectory(op, params, _dummy_tree(),
                                   torch.tensor(X0), torch.tensor(M0), eps)

    grad = jax.jit(jax.grad(jlp))

    def project(X, M):
        A = X.T @ M
        return M - X @ ((A + A.T) / 2.0)

    def update(X, M):
        A = X.T @ M
        vtv = jnp.block([[A, -M.T @ M], [jnp.eye(2), A]])
        e1 = jax.scipy.linalg.expm(-eps * A)
        z = jax.scipy.linalg.expm(eps * vtv) @ jnp.block(
            [[e1, jnp.zeros((2, 2))], [jnp.zeros((2, 2)), e1]])
        w = jnp.concatenate([X, M], axis=1) @ z
        L = jnp.linalg.cholesky(w[:, :2].T @ w[:, :2])
        return (jax.scipy.linalg.solve_triangular(L, w[:, :2].T,
                                                  lower=True).T, w[:, 2:])

    X, Mj = jnp.asarray(X0), jnp.asarray(M0)
    for _ in range(5):
        Mj = project(X, Mj + 0.5 * eps * grad(X))
        X, Mj = update(X, Mj)
        Mj = project(X, Mj + 0.5 * eps * grad(X))
    _close(X1.numpy(), X)
    _close(M1.numpy(), Mj)
    np.testing.assert_allclose((X1.T @ X1).numpy(), np.eye(2), atol=1e-10)


def _chain(ops, params, log_post, n_steps, seed, every):
    step = make_mcmc_step(log_post, ops)
    st = init_mcmc_state(params, _dummy_tree(),
                         torch.Generator().manual_seed(seed), ops, log_post)
    return run_chain(step, st, n_steps, every,
                     lambda s: {k: v.clone() for k, v in s.params.items()})


def test_geodesic_hmc_keeps_sphere_and_targets_vmf():
    """tests/test_hmc_ext2.py's test with its settings and tolerances: x on
    S^2 with p(x) ~ exp(4 mu.x), 8,000 steps of 8 leapfrogs, 40 draws: on
    the sphere to 1e-8, mean direction's z above 0.45, more than 100
    acceptances."""
    mu = torch.tensor([0.0, 0.0, 1.0], dtype=F64)

    def log_post(params, tree):
        return 4.0 * torch.sum(params["x"].reshape(1, 3) @ mu)

    op = GeodesicHmcOperator(parameter="x", block_dim=3, n_leapfrog=8,
                             step_size=0.3)
    st, out = _chain([op], {"x": torch.tensor([1.0, 0.0, 0.0], dtype=F64)},
                     log_post, 8000, 0, 200)
    xs = out["x"].numpy()
    assert xs.shape == (40, 3)
    assert np.max(np.abs(np.linalg.norm(xs, axis=1) - 1.0)) < 1e-8
    assert xs.mean(0)[2] > 0.45, xs.mean(0)
    assert int(st.op_accept.sum()) > 100


def _moments_ok(xs, alpha):
    """Dirichlet(alpha) means within four standard errors (an
    autocorrelation discount of ten) and variances within 25%."""
    a0 = alpha.sum()
    mean = alpha / a0
    var = alpha * (a0 - alpha) / (a0 ** 2 * (a0 + 1.0))
    se = np.sqrt(var / (len(xs) / 10.0))
    assert np.all(np.abs(xs.mean(0) - mean) < 4 * se), (xs.mean(0), mean)
    np.testing.assert_allclose(xs.var(0), var, rtol=0.25)


def test_simplex_hmc_dirichlet_moments():
    """SimplexHmcOperator on Dirichlet(2, 3, 4, 5): 3,000 steps of 5
    leapfrogs from the step size 0.3; the draws stay on the simplex to
    1e-12 and their moments are Dirichlet's."""
    op = SimplexHmcOperator(parameter="x", n_leapfrog=5, step_size=0.3)
    st, out = _chain([op], {"x": torch.full((4,), 0.25, dtype=F64)},
                     _dirichlet_t, 3000, 1, 2)
    xs = out["x"].numpy()[100:]
    assert np.abs(xs.sum(1) - 1.0).max() < 1e-12 and xs.min() > 0
    _moments_ok(xs, ALPHA)
    assert int(st.op_accept[0]) > 1500


def test_reflective_hmc_dirichlet_moments():
    """ReflectiveHmcOperator with a one-sided bound (lower 0) on three
    independent Gamma(alpha_i, 1) coordinates, whose normalised vector is
    Dirichlet(2, 3, 4); and with a two-sided bound [0, 1] on Beta(2, 3),
    the Dirichlet(2, 3) marginal. 3,000 steps of 5 leapfrogs each; the
    draws stay inside their bounds."""
    alpha = np.array([2.0, 3.0, 4.0])

    def gammas(params, tree):
        g = params["g"]
        return torch.sum((torch.tensor(alpha) - 1.0) * torch.log(g) - g)

    op = ReflectiveHmcOperator(parameters=("g",), n_leapfrog=5,
                               step_size=0.5, lower=0.0)
    st, out = _chain([op], {"g": torch.ones(3, dtype=F64)}, gammas, 3000, 2,
                     2)
    g = out["g"].numpy()[100:]
    assert g.min() > 0
    _moments_ok(g / g.sum(1, keepdims=True), alpha)

    def beta(params, tree):
        b = params["b"]
        return torch.sum(torch.log(b) + 2.0 * torch.log1p(-b))

    op = ReflectiveHmcOperator(parameters=("b",), n_leapfrog=5,
                               step_size=0.2, lower=0.0, upper=1.0)
    st, out = _chain([op], {"b": torch.full((1,), 0.5, dtype=F64)}, beta,
                     3000, 3, 2)
    b = out["b"].numpy()[100:, 0]
    assert 0.0 < b.min() and b.max() < 1.0
    _moments_ok(np.stack([b, 1.0 - b], 1), np.array([2.0, 3.0]))

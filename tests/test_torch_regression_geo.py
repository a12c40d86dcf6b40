"""Regression likelihoods and the geospatial models (queue item 4h-4's
models/regression.py and geo.py) against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - xbeta, the linear (with and without the log transform and per-row
    precisions), logistic and log-linear likelihoods, glm_loglik's three
    families and the SCCS conditional likelihood (padded intervals) against
    JAX's at 1e-12 relative, and each gradient in beta against jax.grad;
  - point_in_polygon on tests/test_geo_mg94.py's square and non-convex
    ring and on a 50-vertex star with 2,000 random points,
    geo_spatial_logpdf (both sides), multi_region_logpdf (union and
    intersection), parse_kml_coordinates, great_circle_distance and
    lattice_rate_matrix (a 9 x 7 raster with blocked cells, per-cell
    rates) against JAX's;
  - brownian_bridge at JAX's normals (each level's draw injected) against
    JAX's path at 1e-12, and by law from the port's generator: the
    midpoint's mean and variance of tests/test_geo_mg94.py, the endpoints
    pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import geo as jgeo
from beast_mcmc_tpu.models import regression as jreg

from beast_mcmc_tpu_torch.models import geo as tgeo
from beast_mcmc_tpu_torch.models import regression as treg

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
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, err


def _regression_data(seed, n=60, p=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    beta = rng.normal(0, 0.4, p)
    return rng, x, beta


@pytest.mark.parametrize("case", ["linear", "linear log", "linear per-row",
                                  "logistic", "poisson", "glm normal",
                                  "glm logistic", "glm poisson"])
def test_regression_likelihoods_and_gradients_match_jax(case):
    rng, x, beta = _regression_data(len(case))
    offset = rng.normal(0, 0.1, x.shape[0])
    if case.startswith("linear"):
        y = np.exp(x @ beta + rng.normal(0, 0.3, x.shape[0]))
        prec = rng.uniform(0.5, 3.0, x.shape[0]) if "per-row" in case else 2.0
        log_t = case == "linear log"

        def fn(mod, b, X, Y, P, o):
            return mod.linear_regression_loglik(Y, X, b, P, o, log_t)
    elif case in ("logistic", "poisson"):
        y = ((rng.random(x.shape[0]) < 0.5).astype(float) if case ==
             "logistic" else rng.poisson(2.0, x.shape[0]).astype(float))
        prec = None

        def fn(mod, b, X, Y, P, o):
            return (mod.logistic_regression_loglik(Y, X, b, o)
                    if case == "logistic" else
                    mod.log_linear_loglik(Y, X, b, o))
    else:
        kind = case.split()[1]
        y = {"normal": rng.normal(size=x.shape[0]),
             "logistic": (rng.random(x.shape[0]) < 0.5).astype(float),
             "poisson": rng.poisson(1.5, x.shape[0]).astype(float)}[kind]
        prec = 1.7 if kind == "normal" else None

        def fn(mod, b, X, Y, P, o):
            return mod.glm_loglik(kind, Y, X, b, P, o)

    tb = torch.tensor(beta, requires_grad=True)
    tp = None if prec is None else torch.as_tensor(prec, dtype=F64)
    got = fn(treg, tb, torch.tensor(x), torch.tensor(y), tp,
             torch.tensor(offset))
    (g,) = torch.autograd.grad(got, tb)
    jf = lambda b: fn(jreg, b, jnp.asarray(x), jnp.asarray(y),  # noqa
                      None if prec is None else jnp.asarray(prec),
                      jnp.asarray(offset))
    np.testing.assert_allclose(float(got.detach()), float(jf(
        jnp.asarray(beta))), rtol=REL)
    _close(g, jax.grad(jf)(jnp.asarray(beta)), rel=1e-11)
    _close(treg.xbeta(torch.tensor(x), torch.tensor(beta), 0.3),
           jreg.xbeta(jnp.asarray(x), jnp.asarray(beta), 0.3))


def test_sccs_matches_jax():
    rng = np.random.default_rng(5)
    i_n, j_n, p = 15, 6, 3
    counts = rng.poisson(1.0, (i_n, j_n)).astype(float)
    x = rng.normal(size=(i_n, j_n, p))
    logexp = np.log(rng.uniform(0.1, 1.0, (i_n, j_n)))
    logexp[:, -2:] = -np.inf
    counts[:, -2:] = 0.0
    beta = rng.normal(0, 0.5, p)
    tb = torch.tensor(beta, requires_grad=True)
    got = treg.sccs_conditional_loglik(torch.tensor(counts), torch.tensor(x),
                                       tb, torch.tensor(logexp))
    (g,) = torch.autograd.grad(got, tb)
    jf = lambda b: jreg.sccs_conditional_loglik(  # noqa: E731
        jnp.asarray(counts), jnp.asarray(x), b, jnp.asarray(logexp))
    np.testing.assert_allclose(float(got.detach()),
                               float(jf(jnp.asarray(beta))), rtol=REL)
    _close(g, jax.grad(jf)(jnp.asarray(beta)), rel=1e-11)


def _star(n=50, inner=0.45):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([np.cos(ang), np.sin(ang)], 1) * np.where(
        np.arange(n) % 2, inner, 1.0)[:, None]


def test_polygons_and_distances_match_jax():
    square = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    ell = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2.0]])
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1.2, 2.2, (2000, 2))
    for ring in (square, ell, _star()):
        np.testing.assert_array_equal(
            tgeo.point_in_polygon(torch.tensor(pts), torch.tensor(ring))
            .numpy(), np.asarray(jgeo.point_in_polygon(jnp.asarray(pts),
                                                       jnp.asarray(ring))))
        for p in (pts[0], pts[7], np.array([0.5, 0.5])):
            for outside in (False, True):
                assert float(tgeo.geo_spatial_logpdf(
                    torch.tensor(p), torch.tensor(ring), outside)) == float(
                    jgeo.geo_spatial_logpdf(jnp.asarray(p), jnp.asarray(ring),
                                            outside))
    for p in (np.array([0.5, 0.5]), np.array([1.5, 1.5]), pts[3]):
        for union in (True, False):
            assert float(tgeo.multi_region_logpdf(
                torch.tensor(p), [torch.tensor(square), torch.tensor(ell)],
                union)) == float(jgeo.multi_region_logpdf(
                    jnp.asarray(p), [jnp.asarray(square), jnp.asarray(ell)],
                    union))
    kml = ("<kml><coordinates>1,2,0 3,4,0 5,6,0 1,2,0</coordinates>"
           "<coordinates>\n 7,8 9,10 11,12\n</coordinates></kml>")
    for a, b in zip(tgeo.parse_kml_coordinates(kml),
                    jgeo.parse_kml_coordinates(kml)):
        np.testing.assert_array_equal(a, b)
    ll1 = rng.uniform(-80, 80, (50, 2))
    ll2 = rng.uniform(-80, 80, (50, 2))
    _close(tgeo.great_circle_distance(torch.tensor(ll1), torch.tensor(ll2)),
           jgeo.great_circle_distance(jnp.asarray(ll1), jnp.asarray(ll2)))


def test_lattice_rate_matrix_matches_jax():
    rng = np.random.default_rng(7)
    valid = rng.random((9, 7)) < 0.75
    for rates in (1.0, rng.uniform(0.5, 2.0, (9, 7))):
        _close(tgeo.lattice_rate_matrix(torch.tensor(valid),
                                        torch.as_tensor(rates, dtype=F64)),
               jgeo.lattice_rate_matrix(jnp.asarray(valid),
                                        jnp.asarray(rates)))


def test_brownian_bridge_at_jax_normals_and_by_law():
    start, end = np.array([0.0, 1.0]), np.array([2.0, -1.0])
    key = jax.random.PRNGKey(3)
    want = jgeo.brownian_bridge(key, jnp.asarray(start), jnp.asarray(end),
                                0.2, 1.4, 2.5, depth=5)
    noises, k = [], key
    for level in range(5):
        k, sub = jax.random.split(k)
        noises.append(torch.tensor(np.asarray(jax.random.normal(
            sub, (1 << level, 2), jnp.float64))))
    got = tgeo.brownian_bridge(None, torch.tensor(start), torch.tensor(end),
                               0.2, 1.4, 2.5, depth=5, noises=noises)
    _close(got, want)
    gen = torch.Generator().manual_seed(0)
    paths = torch.stack([tgeo.brownian_bridge(
        gen, torch.tensor(start), torch.tensor(end), 0.0, 1.0, 1.0, depth=4)
        for _ in range(2000)])
    mid = paths[:, 8, :].numpy()
    np.testing.assert_allclose(mid.mean(axis=0), [1.0, 0.0], atol=0.03)
    np.testing.assert_allclose(mid.var(axis=0), 0.25, atol=0.03)
    assert bool((paths[:, 0] == torch.tensor(start)).all())
    assert bool((paths[:, -1] == torch.tensor(end)).all())

"""The prior library, the fixed-iteration gamma functions and the AS91
route against the JAX package.

Each of the 36 distributions that beast_mcmc_tpu/models/priors.py adds to
the nine of the main path is held against JAX's at inputs drawn with
numpy from a seed, inside its support and, where it has one, outside
(-inf in both), at 1e-12 relative (JAX under x64 on the CPU, as
tests/conftest.py sets it; the port on the CPU in float64).
gammainc_fixed and gamma_quantile (ops/special.py) are held to JAX's at
1e-12 relative, discrete_gamma_rates(exact_quantiles=True) and the port's
own copy of utils/as91.py to JAX's bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import priors as jpriors
from beast_mcmc_tpu.models import sitemodel as jsite
from beast_mcmc_tpu.ops import special as jspecial
from beast_mcmc_tpu.utils import as91 as jas91

from beast_mcmc_tpu_torch.models import priors
from beast_mcmc_tpu_torch.models import sitemodel
from beast_mcmc_tpu_torch.ops import special
from beast_mcmc_tpu_torch.utils import as91

REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T + d * np.eye(d)


def _corr(rng, d):
    c = _spd(rng, d)
    s = 1.0 / np.sqrt(np.diag(c))
    return c * s[:, None] * s[None, :]


def _pos(rng, n=6, lo=0.1, hi=4.0):
    return rng.uniform(lo, hi, n)


def _unit(rng, n=6):
    return rng.uniform(0.02, 0.98, n)


def _ints(rng, n=6, hi=12):
    return rng.integers(0, hi, n).astype(np.float64)


# name: (inside(rng) -> args, outside(rng) -> args or None); the first
# argument is x, the rest the distribution's parameters. The geometric
# checks no support, as JAX's does (k = -1 gives a finite value in both)
CASES = {
    "inverse_gamma_logpdf": (lambda r: (_pos(r), 2.5, 1.3),
                             lambda r: (np.r_[_pos(r, 3), -0.4], 2.5, 1.3)),
    "laplace_logpdf": (lambda r: (r.normal(0, 2, 6), 0.3, 1.7), None),
    "beta_logpdf": (lambda r: (_unit(r), 2.0, 3.5),
                    lambda r: (np.r_[_unit(r, 3), 1.2], 2.0, 3.5)),
    "normal_gamma_precision_logpdf": (lambda r: (r.normal(0, 1, 6), 0.2, 3.0),
                                      None),
    "multivariate_normal_logpdf": (
        lambda r: (r.normal(0, 1, 4), r.normal(0, 1, 4), _spd(r, 4)), None),
    "bayesian_bridge_logpdf": (lambda r: (r.normal(0, 1, 6), 0.7, 0.25),
                               None),
    "lkj_logpdf": (lambda r: (_corr(r, 4), 2.5), None),
    "wishart_logpdf": (lambda r: (_spd(r, 3), 6.0, _spd(r, 3)), None),
    "inverse_wishart_logpdf": (lambda r: (_spd(r, 3), 6.0, _spd(r, 3)), None),
    "half_t_logpdf": (lambda r: (_pos(r), 1.5, 3.0),
                      lambda r: (np.r_[_pos(r, 3), -1.0], 1.5, 3.0)),
    "chi_square_logpdf": (lambda r: (_pos(r), 3.0),
                          lambda r: (np.r_[_pos(r, 3), -2.0], 3.0)),
    "t_logpdf": (lambda r: (r.normal(0, 3, 6), 4.0, 0.5, 1.3), None),
    "cauchy_logpdf": (lambda r: (r.normal(0, 3, 6), 0.2, 0.8), None),
    "logistic_logpdf": (lambda r: (r.normal(0, 30, 6), 0.5, 1.2), None),
    "weibull_logpdf": (lambda r: (_pos(r), 1.7, 2.2),
                       lambda r: (np.r_[_pos(r, 3), -0.5], 1.7, 2.2)),
    "gumbel2_logpdf": (lambda r: (_pos(r), 2.0, 1.5),
                       lambda r: (np.r_[_pos(r, 3), -0.5], 2.0, 1.5)),
    "half_normal_logpdf": (lambda r: (_pos(r), 1.4),
                           lambda r: (np.r_[_pos(r, 3), -0.1], 1.4)),
    "pareto_logpdf": (lambda r: (_pos(r, lo=1.0), 0.9, 2.5),
                      lambda r: (np.r_[_pos(r, 3, lo=1.0), 0.5], 0.9, 2.5)),
    "inverse_gaussian_logpdf": (lambda r: (_pos(r), 1.2, 2.0),
                                lambda r: (np.r_[_pos(r, 3), -0.3], 1.2, 2.0)),
    "truncated_normal_logpdf": (
        lambda r: (r.uniform(-0.5, 2.5, 6), 0.4, 1.1, -0.5, 2.5),
        lambda r: (np.r_[r.uniform(-0.5, 2.5, 3), 2.6], 0.4, 1.1, -0.5, 2.5)),
    "reflected_normal_logpdf": (
        lambda r: (r.uniform(0.0, 3.0, 6), 1.0, 0.9, 0.0, 3.0),
        lambda r: (np.r_[r.uniform(0.0, 3.0, 3), -0.2], 1.0, 0.9, 0.0, 3.0)),
    "negative_binomial_logpmf": (lambda r: (_ints(r), 4.5, 0.6),
                                 lambda r: (np.r_[_ints(r, 3), -1.0], 4.5,
                                            0.6)),
    "geometric_logpmf": (lambda r: (_ints(r), 0.3), None),
    "binomial_logpmf": (lambda r: (_ints(r, hi=10), 10.0, 0.35),
                        lambda r: (np.r_[_ints(r, 3, 10), 11.0], 10.0, 0.35)),
    "discrete_uniform_logpmf": (lambda r: (_ints(r, hi=8), 0.0, 9.0),
                                lambda r: (np.r_[_ints(r, 3, 8), 11.0], 0.0,
                                           9.0)),
    "multivariate_gamma_logpdf": (
        lambda r: (_pos(r, 4), np.array([0.5, 1.5, 2.0, 4.0]),
                   np.array([2.0, 0.5, 1.0, 3.0])),
        lambda r: (np.r_[_pos(r, 3), -1.0], np.array([0.5, 1.5, 2.0, 4.0]),
                   np.array([2.0, 0.5, 1.0, 3.0]))),
    "ar1_normal_logpdf": (lambda r: (r.normal(0, 1, 7), 1.3, 0.6), None),
    "normal_kde_logpdf": (lambda r: (r.normal(0, 1, 5), r.normal(0, 1, 40)),
                          None),
    "log_transformed_normal_kde_logpdf": (
        lambda r: (_pos(r, 5), _pos(r, 40)), None),
    "logit_transformed_normal_kde_logpdf": (
        lambda r: (_unit(r, 5), _unit(r, 40)), None),
    "marginalized_alpha_stable_logpdf": (
        lambda r: (r.normal(0, 2, 6), 1.3, 0.7), None),
    "multivariate_t_logpdf": (
        lambda r: (r.normal(0, 1, 3), r.normal(0, 1, 3), _spd(r, 3), 5.0),
        None),
    "multivariate_lognormal_logpdf": (
        lambda r: (_pos(r, 3), r.normal(0, 1, 3), _spd(r, 3)), None),
    "kumaraswamy_logpdf": (lambda r: (_unit(r), 2.0, 3.0),
                           lambda r: (np.r_[_unit(r, 3), 1.5], 2.0, 3.0)),
    "point_mass_mixture_logpmf": (
        lambda r: (np.array([1.0, 2.0]), np.array([0.2, 0.5, 0.3]),
                   np.array([[0.0, 1.0], [1.0, 2.0], [1.0, 2.0]])),
        lambda r: (np.array([3.0, 3.0]), np.array([0.2, 0.5, 0.3]),
                   np.array([[0.0, 1.0], [1.0, 2.0], [1.0, 2.0]]))),
    "frechet_logpdf": (lambda r: (_pos(r), 2.5, 1.5),
                       lambda r: (np.r_[_pos(r, 3), -0.5], 2.5, 1.5)),
}


def _call(mod, name, args, as_tensor):
    args = [as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    return float(getattr(mod, name)(*args))


@pytest.mark.parametrize("name", sorted(CASES))
def test_distribution_matches_jax(name):
    """Three seeded draws inside the support at 1e-12 relative; where the
    distribution has a bounded support, one draw with a value outside,
    -inf in both packages (the point-mass mixture's floor, log 1e-300, off
    its points)."""
    inside, outside = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    for _ in range(3):
        args = inside(rng)
        ref = _call(jpriors, name, args, jnp.asarray)
        got = _call(priors, name, args, torch.tensor)
        assert math.isfinite(ref), (name, ref)
        assert got == pytest.approx(ref, rel=REL, abs=0.0), (name, got, ref)
    if outside is not None:
        args = outside(rng)
        ref = _call(jpriors, name, args, jnp.asarray)
        got = _call(priors, name, args, torch.tensor)
        # the point-mass mixture floors its mass at 1e-300, as JAX's does
        want = -math.inf if name != "point_mass_mixture_logpmf" else ref
        assert ref == want and got == pytest.approx(want, rel=REL), (got, ref)


def test_all_jax_distributions_are_ported():
    """Every function of JAX's priors.py has its port of the same name."""
    import ast
    import beast_mcmc_tpu.models.priors as jmod
    import beast_mcmc_tpu_torch.models.priors as tmod

    def names(mod):
        tree = ast.parse(open(mod.__file__).read())
        return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}

    assert names(jmod) <= names(tmod)
    assert len(CASES) == 36
    assert set(CASES) == names(jmod) - names(jmod).intersection(
        {"_sum", "_multivariate_gammaln", "_normal_logcdf", "uniform_logpdf",
         "normal_logpdf", "lognormal_logpdf", "gamma_logpdf",
         "exponential_logpdf", "dirichlet_logpdf", "one_on_x_logpdf",
         "poisson_logpmf", "ctmc_scale_logpdf"})


def test_gamma_functions_match_jax():
    """gammainc_fixed on both of its branches (x below and above a + 1)
    and gamma_quantile from the small-shape and the Wilson-Hilferty starts,
    against JAX's at 1e-12 relative."""
    rng = np.random.default_rng(5)
    a = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), 40))
    x = a * np.exp(rng.normal(0.0, 1.0, 40))
    got = special.gammainc_fixed(torch.tensor(a), torch.tensor(x)).numpy()
    ref = np.asarray(jspecial.gammainc_fixed(jnp.asarray(a), jnp.asarray(x)))
    assert (x < a + 1).any() and (x >= a + 1).any()
    np.testing.assert_allclose(got, ref, rtol=REL, atol=1e-300)
    p = rng.uniform(0.01, 0.99, 40)
    shape = np.exp(rng.uniform(np.log(0.05), np.log(50.0), 40))
    got = special.gamma_quantile(torch.tensor(p), torch.tensor(shape),
                                 2.0).numpy()
    ref = np.asarray(jspecial.gamma_quantile(jnp.asarray(p),
                                             jnp.asarray(shape), 2.0))
    assert (shape < 0.6).any() and (shape >= 0.6).any()
    np.testing.assert_allclose(got, ref, rtol=REL)
    lx = rng.normal(0.0, 1.0, 5)
    got = special._log_gamma_pdf(torch.tensor(shape[:5]), torch.tensor(lx),
                                 torch.tensor(np.exp(lx))).numpy()
    ref = np.asarray(jspecial._log_gamma_pdf(jnp.asarray(shape[:5]),
                                             jnp.asarray(lx),
                                             jnp.asarray(np.exp(lx))))
    np.testing.assert_allclose(got, ref, rtol=REL)


@pytest.mark.parametrize("alpha", [0.05, 0.37, 1.0, 2.5, 48.0])
def test_as91_rates_match_jax_bit_for_bit(alpha):
    """The port's own AS91 copy gives JAX's category rates exactly, and
    discrete_gamma_rates(exact_quantiles=True) takes it for a concrete
    alpha (and mu), as JAX's does; with p_invariant, or an alpha that
    requires grad, the smooth route (1e-12 relative to JAX's smooth
    route)."""
    for k in (4, 6):
        assert as91.gamma_category_rates(alpha, k) == \
            jas91.gamma_category_rates(alpha, k)
        got = sitemodel.discrete_gamma_rates(
            torch.tensor(alpha, dtype=torch.float64), k, mu=0.8,
            exact_quantiles=True)
        ref = jsite.discrete_gamma_rates(jnp.asarray(alpha), k, mu=0.8,
                                         exact_quantiles=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    smooth = sitemodel.discrete_gamma_rates(
        torch.tensor(alpha, dtype=torch.float64), 4)
    for kw in ({"p_invariant": torch.tensor(0.2, dtype=torch.float64)},
               {"alpha": torch.tensor(alpha, dtype=torch.float64,
                                      requires_grad=True)}):
        a = kw.pop("alpha", torch.tensor(alpha, dtype=torch.float64))
        got = sitemodel.discrete_gamma_rates(a, 4, exact_quantiles=True,
                                             **kw)
        ref = jsite.discrete_gamma_rates(
            jnp.asarray(alpha), 4, exact_quantiles=False,
            **{k: jnp.asarray(float(v)) for k, v in kw.items()})
        np.testing.assert_allclose(got[0].detach().numpy(),
                                   np.asarray(ref[0]), rtol=REL)
    assert not torch.equal(smooth[0], sitemodel.discrete_gamma_rates(
        torch.tensor(alpha, dtype=torch.float64), 4,
        exact_quantiles=True)[0])

"""The clock, epoch, coalescent and speciation functions of the port
against the JAX package's.

Every function that beast_mcmc_tpu_torch/models/{clock,epoch,coalescent,
speciation}.py gained with the XML interpreter route is evaluated at the
same inputs, made with numpy from a seed (a serially sampled coalescent
tree of 12 taxa), by its JAX function under x64 and by the port in
float64 on the CPU, to 1e-10 relative (1e-8 for the SIR ODE, whose
Runge-Kutta loop accumulates). torch.autograd gradients of
gmrf_skyride_loglik, bayesian_skyline_loglik and random_local_clock_rates
are held to jax.grad at 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import clock as jclock
from beast_mcmc_tpu.models import coalescent as jcoal
from beast_mcmc_tpu.models import epoch as jepoch
from beast_mcmc_tpu.models import speciation as jspec
from beast_mcmc_tpu.models import substitution as jsubst

from beast_mcmc_tpu_torch.models import clock
from beast_mcmc_tpu_torch.models import coalescent as coal
from beast_mcmc_tpu_torch.models import epoch
from beast_mcmc_tpu_torch.models import speciation as spec
from beast_mcmc_tpu_torch.models import substitution as subst
from beast_mcmc_tpu_torch.tree.topology import simulate_coalescent_tree

REL = 1e-10
N = 12
M = 2 * N - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=3, n=N, serial=True):
    rng = np.random.default_rng(seed)
    tips = rng.uniform(0.0, 0.4, n) if serial else np.zeros(n)
    tips = tips - tips.min()
    parent, children, heights, root = simulate_coalescent_tree(rng, tips, 0.5)
    return parent.astype(np.int64), children, heights, root


PARENT, CHILDREN, HEIGHTS, ROOT = _tree()
PARENT2, _, HEIGHTS2, _ = _tree(seed=5, n=7)
RNG = np.random.default_rng(11)
RATES = RNG.uniform(0.5, 2.0, M)
IND = (RNG.uniform(size=M) < 0.3).astype(np.float64)
LOG_RATES = RNG.normal(0.0, 0.3, M)
Q = RNG.uniform(0.05, 0.95, M)
LOG_POPS = RNG.normal(0.0, 0.4, N - 1)
GROUPS = np.array([3, 4, 4])
TIPSET = np.zeros(M, bool)
TIPSET[[1, 4, 7]] = True


def _hky(mod, kappa):
    freqs = np.array([0.3, 0.2, 0.25, 0.25])
    if mod is jsubst:
        return mod.hky_eigen(jnp.asarray(kappa), jnp.asarray(freqs))
    return mod.hky_eigen(torch.tensor(kappa, dtype=torch.float64),
                         torch.tensor(freqs))


def _q(seed):
    r = np.random.default_rng(seed).uniform(0.1, 1.0, (4, 4))
    np.fill_diagonal(r, 0.0)
    np.fill_diagonal(r, -r.sum(1))
    return r


# (jax call, torch call): each takes (module set, array maker)
def _j(x):
    return jnp.asarray(x)


def _p(x):
    x = np.asarray(x)
    return torch.as_tensor(x)


JM = dict(clock=jclock, coal=jcoal, epoch=jepoch, spec=jspec, subst=jsubst)
PM = dict(clock=clock, coal=coal, epoch=epoch, spec=spec, subst=subst)


def _h(a):
    return a(HEIGHTS)


CASES = {
    # -- clock.py
    "strict_clock_rates": lambda m, a: m["clock"].strict_clock_rates(
        a(1.7), M),
    "continuous_quantile_rates": lambda m, a: m["clock"]
    .continuous_quantile_rates(a(Q), a(1.2), a(0.4)),
    "arbitrary_rates": lambda m, a: m["clock"].arbitrary_rates(a(RATES)),
    "rate_epoch_rates": lambda m, a: m["clock"].rate_epoch_rates(
        _h(a), a(PARENT), a(np.array([0.3, 0.8])),
        a(np.array([1.0, 2.0, 0.5]))),
    "_doubling_steps": lambda m, a: a(np.asarray(
        [m["clock"]._doubling_steps(k) for k in (2, 3, 23, 3219)])),
    "ancestor_or_self_mask": lambda m, a: m["clock"].ancestor_or_self_mask(
        a(PARENT), 15).astype(np.float64) if a is _j else
    m["clock"].ancestor_or_self_mask(a(PARENT), 15).double(),
    "local_clock_rates": lambda m, a: m["clock"].local_clock_rates(
        a(np.arange(M) % 3), a(np.array([0.5, 1.0, 2.0]))),
    "random_local_clock_rates": lambda m, a: m["clock"]
    .random_local_clock_rates(a(PARENT), _h(a), a(IND), a(RATES)),
    "random_local_clock_rates_multipliers": lambda m, a: m["clock"]
    .random_local_clock_rates(a(PARENT), _h(a), a(IND), a(RATES),
                              mean_rate=a(0.7), rates_are_multipliers=True),
    "branch_rate_increments": lambda m, a: m["clock"].branch_rate_increments(
        a(PARENT), _h(a), a(LOG_RATES))[0],
    "branch_rate_increments_by_time": lambda m, a: m["clock"]
    .branch_rate_increments(a(PARENT), _h(a), a(LOG_RATES), True)[0],
    "autocorrelated_rates_log_density": lambda m, a: m["clock"]
    .autocorrelated_rates_log_density(a(PARENT), _h(a), a(LOG_RATES),
                                      a(3.0)),
    "shrinkage_local_clock_log_density": lambda m, a: m["clock"]
    .shrinkage_local_clock_log_density(a(PARENT), _h(a), a(LOG_RATES),
                                       a(0.4), a(0.5)),
    "lognormal_mixture_cdf": lambda m, a: m["clock"].lognormal_mixture_cdf(
        a(RATES), a(np.array([0.3, 0.7])), a(np.array([0.8, 1.5])),
        a(np.array([0.3, 0.6]))),
    "mixture_model_rates": lambda m, a: m["clock"].mixture_model_rates(
        a(Q), a(np.array([0.3, 0.7])), a(np.array([0.8, 1.5])),
        a(np.array([0.3, 0.6]))),
    "latent_state_branch_rates": lambda m, a: m["clock"]
    .latent_state_branch_rates(a(RATES), a(Q * 0.5)),
    "two_state_occupancy_log_density": lambda m, a: m["clock"]
    .two_state_occupancy_log_density(a(RATES), a(np.where(Q < 0.2, 0.0,
                                                          Q * 0.5)),
                                     a(0.8), a(1.3)),
    "two_state_occupancy_unconditioned": lambda m, a: m["clock"]
    .two_state_occupancy_log_density(a(RATES), a(Q * 0.5), a(0.8), a(1.3),
                                     condition_on_active_end=False),
    # -- epoch.py
    "epoch_overlaps": lambda m, a: m["epoch"].epoch_overlaps(
        a(PARENT), _h(a), a(np.array([0.2, 0.6]))),
    "epoch_branch_matrices": lambda m, a: m["epoch"].epoch_branch_matrices(
        [_hky(m["subst"], 2.0), a(_q(1)), _hky(m["subst"], 6.0)],
        a(np.array([0.2, 0.6])), a(PARENT), _h(a), a(RATES),
        a(np.array([0.3, 0.8, 1.9]))),
    "ancestor_closure": lambda m, a: m["epoch"].ancestor_closure(
        a(PARENT), jnp.float64 if a is _j else torch.float64),
    "clade_branch_matrices": lambda m, a: m["epoch"].clade_branch_matrices(
        _hky(m["subst"], 2.0),
        [(a(TIPSET[:N]), _hky(m["subst"], 8.0), a(0.4)),
         (a(np.arange(N) >= 9), a(_q(2)), a(0.0))],
        a(PARENT), _h(a), a(ROOT), a(RATES), a(np.array([0.5, 1.5]))),
    # -- coalescent.py
    "logistic_growth_loglik": lambda m, a: m["coal"].logistic_growth_loglik(
        _h(a), N, a(0.6), a(2.0), a(0.3)),
    "expansion_loglik": lambda m, a: m["coal"].expansion_loglik(
        _h(a), N, a(0.6), a(0.2), a(3.0)),
    "piecewise_exponential_loglik": lambda m, a: m["coal"]
    .piecewise_exponential_loglik(_h(a), N, a(np.array([0.6, 0.3, 0.9])),
                                  a(np.array([1.5])), a(np.array([0.2, 0.3]))),
    "piecewise_exponential_chained": lambda m, a: m["coal"]
    .piecewise_exponential_loglik(_h(a), N, a(np.array([0.6])),
                                  a(np.array([1.5, 0.0, -0.5])),
                                  a(np.array([0.2, 0.3]))),
    "cataclysm_loglik": lambda m, a: m["coal"].cataclysm_loglik(
        _h(a), N, a(0.5), a(1.2), a(4.0), a(0.3)),
    "bayesian_skyline_loglik": lambda m, a: m["coal"].bayesian_skyline_loglik(
        _h(a), N, a(np.array([0.4, 0.9, 0.6])), a(GROUPS)),
    "bayesian_skyline_linear_loglik": lambda m, a: m["coal"]
    .bayesian_skyline_linear_loglik(_h(a), N,
                                    a(np.array([0.4, 0.9, 0.6, 0.5])),
                                    a(GROUPS)),
    "gmrf_skyride_loglik": lambda m, a: m["coal"].gmrf_skyride_loglik(
        _h(a), N, a(LOG_POPS)),
    "skyride_coalescent_midpoints": lambda m, a: m["coal"]
    .skyride_coalescent_midpoints(_h(a), N),
    "gmrf_skyride_time_aware_prior": lambda m, a: m["coal"]
    .gmrf_skyride_time_aware_prior(_h(a), N, a(LOG_POPS), a(2.5)),
    "gmrf_skyride_uniform_prior": lambda m, a: m["coal"]
    .gmrf_skyride_uniform_prior(a(LOG_POPS), a(2.5)),
    "grouped_skyride_loglik": lambda m, a: m["coal"].grouped_skyride_loglik(
        _h(a), N, a(np.array([-0.5, 0.2, 0.1])), a(GROUPS)),
    "grouped_skyride_gmrf_prior": lambda m, a: m["coal"]
    .grouped_skyride_gmrf_prior(
        _h(a), N, a(np.array([-0.5, 0.2, 0.1])), a(GROUPS), a(1.5),
        covariates=a(np.array([[1.0, 0.2], [0.5, -0.3], [0.1, 0.9]])),
        beta=a(np.array([0.3, -0.2])), lam=a(0.6)),
    "sir_trajectories": lambda m, a: m["coal"].sir_trajectories(
        a(2.5), a(4.0), a(0.01), a(np.linspace(0.0, 2.0, 64)))[1],
    "sir_coalescent_loglik": lambda m, a: m["coal"].sir_coalescent_loglik(
        _h(a), N, a(2.5), a(4.0), a(0.01), a(5000.0), 2.0, 64),
    "multilocus_skygrid_loglik": lambda m, a: m["coal"]
    .multilocus_skygrid_loglik([_h(a), a(HEIGHTS2)], [N, 7],
                               a(np.array([-0.4, 0.1, 0.3, -0.2])),
                               a(np.array([0.1, 0.25, 0.5])), [1.0, 0.5]),
    "_ebsp_pop_at": lambda m, a: m["coal"]._ebsp_pop_at(
        a(np.linspace(0.0, 1.5, 40)), a(np.array([0.0, 0.2, 0.5, 0.9, 1.2])),
        a(np.array([0.5, 0.8, 0.3, 1.1, 0.7])),
        a(np.array([True, False, True, False, False]))),
    "ebsp_knots": lambda m, a: m["coal"].ebsp_knots(a(HEIGHTS[N:]), True),
    "ebsp_knots_events": lambda m, a: m["coal"].ebsp_knots(
        a(HEIGHTS[N:]), False),
    "ebsp_coalescent_loglik": lambda m, a: m["coal"].ebsp_coalescent_loglik(
        [_h(a), a(HEIGHTS2)], [N, 7], [1.0, 2.0],
        a(RNG_EBSP_POPS), a(RNG_EBSP_IND), True),
    "smooth_skygrid_loglik": lambda m, a: m["coal"].smooth_skygrid_loglik(
        _h(a), N, a(np.array([-0.4, 0.1, 0.3, -0.2])),
        a(np.array([0.1, 0.25, 0.5])), a(20.0)),
    "coalescent_loglik_integral": lambda m, a: m["coal"]
    .coalescent_loglik_integral(
        _h(a), N, lambda t: 0.2 * t - 0.5,
        m["coal"].quad_interval_integral(lambda t: 0.2 * t - 0.5, 12)),
    "quad_interval_integral": lambda m, a: m["coal"].quad_interval_integral(
        lambda t: 0.3 * t + 0.1 * t * t, 16)(a(HEIGHTS[:-1]),
                                             a(HEIGHTS[1:])),
    "const_exponential_loglik": lambda m, a: m["coal"]
    .const_exponential_loglik(_h(a), N, a(0.6), a(0.1), a(4.0)),
    "exp_constant_loglik": lambda m, a: m["coal"].exp_constant_loglik(
        _h(a), N, a(0.6), a(2.0), a(0.2)),
    "const_logistic_loglik": lambda m, a: m["coal"].const_logistic_loglik(
        _h(a), N, a(0.6), a(0.1), a(3.0), a(0.4)),
    "linear_growth_loglik": lambda m, a: m["coal"].linear_growth_loglik(
        _h(a), N, a(2.0)),
    "power_law_growth_loglik": lambda m, a: m["coal"]
    .power_law_growth_loglik(_h(a), N, a(0.5), a(1.5)),
    "flexible_growth_loglik": lambda m, a: m["coal"].flexible_growth_loglik(
        _h(a), N, a(0.5), a(2.0), a(1.5)),
    "multi_epoch_exponential_loglik": lambda m, a: m["coal"]
    .multi_epoch_exponential_loglik(_h(a), N, a(0.6),
                                    a(np.array([2.0, 0.0, 1.0])),
                                    a(np.array([0.1, 0.3]))),
    "exponential_sawtooth_loglik": lambda m, a: m["coal"]
    .exponential_sawtooth_loglik(_h(a), N, a(0.6), a(2.0), a(0.15), a(0.2)),
    "exponential_logistic_loglik": lambda m, a: m["coal"]
    .exponential_logistic_loglik(_h(a), N, a(0.6), a(3.0), a(0.1), a(0.5),
                                 a(0.25)),
    # -- speciation.py
    "_bdss_c1": lambda m, a: m["spec"]._bdss_c1(a(2.0), a(0.5), a(0.3)),
    "_bdss_c2": lambda m, a: m["spec"]._bdss_c2(a(2.0), a(0.5), a(0.1),
                                                a(0.3)),
    "bdss_log_q": lambda m, a: m["spec"].bdss_log_q(a(2.0), a(0.5), a(0.1),
                                                    a(0.3), _h(a)),
    "bdss_p0": lambda m, a: m["spec"].bdss_p0(a(2.0), a(0.5), a(0.1),
                                              a(0.3), _h(a)),
    "serial_birth_death_loglik": lambda m, a: m["spec"]
    .serial_birth_death_loglik(_h(a), N, a(2.0), a(0.5), a(0.3),
                               a(HEIGHTS.max() + 0.2)),
    "serial_birth_death_final_sample": lambda m, a: m["spec"]
    .serial_birth_death_loglik(_h(a), N, a(2.0), a(0.5), a(0.3),
                               a(HEIGHTS.max() + 0.2), a(0.4), True),
    "serial_birth_death_origin_below_root": lambda m, a: m["spec"]
    .serial_birth_death_loglik(_h(a), N, a(2.0), a(0.5), a(0.3),
                               a(HEIGHTS.max() - 0.1)),
    "episodic_serial_birth_death_loglik": lambda m, a: m["spec"]
    .episodic_serial_birth_death_loglik(
        _h(a), N, a(HEIGHTS.max() + 0.2), a(np.array([2.0, 1.5, 3.0])),
        a(np.array([0.5, 0.7, 0.2])), a(np.array([0.3, 0.4, 0.2])),
        treatment_probs=a(np.array([0.9, 1.0, 0.5])), rho_present=a(0.3),
        grid_end=a(1.0), num_intervals=3),
    "episodic_serial_one_interval": lambda m, a: m["spec"]
    .episodic_serial_birth_death_loglik(
        _h(a), N, a(HEIGHTS.max() + 0.2), a(2.0), a(0.5), a(0.3),
        grid_end=a(HEIGHTS.max() + 0.2), num_intervals=1),
    "mrca_node": lambda m, a: m["spec"].mrca_node(
        a(PARENT), _h(a), a(TIPSET)),
    "calibrated_speciation_loglik": lambda m, a: m["spec"]
    .calibrated_speciation_loglik(
        a(-3.5), a(PARENT), _h(a),
        [(a(TIPSET), lambda h: -0.5 * (h - 0.4) ** 2),
         (a(np.arange(M) < 2), lambda h: -h)]),
}

RNG_EBSP_POPS = np.random.default_rng(4).uniform(0.3, 1.2, N - 1 + 6)
RNG_EBSP_IND = (np.random.default_rng(6).uniform(size=N - 1 + 5)
                < 0.4).astype(np.float64)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(name):
    want = _np(CASES[name](JM, _j))
    got = _np(CASES[name](PM, _p))
    assert got.shape == want.shape
    tol = 1e-8 if name.startswith("sir") else REL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 1e-3)


def test_every_new_function_is_covered():
    """Each new public function of the four modules has a case here."""
    names = {k.split("_multipliers")[0] for k in CASES}
    want = {
        "strict_clock_rates", "continuous_quantile_rates", "arbitrary_rates",
        "rate_epoch_rates", "_doubling_steps", "ancestor_or_self_mask",
        "local_clock_rates", "random_local_clock_rates",
        "branch_rate_increments", "autocorrelated_rates_log_density",
        "shrinkage_local_clock_log_density", "lognormal_mixture_cdf",
        "mixture_model_rates", "latent_state_branch_rates",
        "two_state_occupancy_log_density", "epoch_overlaps",
        "epoch_branch_matrices", "ancestor_closure", "clade_branch_matrices",
        "logistic_growth_loglik", "expansion_loglik",
        "piecewise_exponential_loglik", "cataclysm_loglik",
        "bayesian_skyline_loglik", "sir_trajectories",
        "sir_coalescent_loglik", "multilocus_skygrid_loglik",
        "gmrf_skyride_loglik", "skyride_coalescent_midpoints",
        "gmrf_skyride_time_aware_prior", "gmrf_skyride_uniform_prior",
        "bayesian_skyline_linear_loglik", "_ebsp_pop_at", "ebsp_knots",
        "ebsp_coalescent_loglik", "grouped_skyride_loglik",
        "grouped_skyride_gmrf_prior", "smooth_skygrid_loglik",
        "coalescent_loglik_integral", "quad_interval_integral",
        "const_exponential_loglik", "exp_constant_loglik",
        "const_logistic_loglik", "linear_growth_loglik",
        "power_law_growth_loglik", "flexible_growth_loglik",
        "multi_epoch_exponential_loglik", "exponential_sawtooth_loglik",
        "exponential_logistic_loglik", "_bdss_c1", "_bdss_c2", "bdss_log_q",
        "bdss_p0", "serial_birth_death_loglik",
        "episodic_serial_birth_death_loglik", "mrca_node",
        "calibrated_speciation_loglik"}
    assert want <= names
    for mod in (clock, coal, epoch, spec):
        jmod = {clock: jclock, coal: jcoal, epoch: jepoch, spec: jspec}[mod]
        for fn in dir(jmod):
            if callable(getattr(jmod, fn)) and getattr(
                    getattr(jmod, fn), "__module__", "") == jmod.__name__:
                assert hasattr(mod, fn), f"{mod.__name__} lacks {fn}"


def _grad_case(name):
    """(jax scalar fn of x, torch scalar fn of x, x0)."""
    w = np.random.default_rng(9).uniform(0.5, 1.5, M)
    if name == "gmrf_skyride_loglik":
        return (lambda x: jcoal.gmrf_skyride_loglik(jnp.asarray(HEIGHTS), N,
                                                    x),
                lambda x: coal.gmrf_skyride_loglik(torch.tensor(HEIGHTS), N,
                                                   x), LOG_POPS)
    if name == "bayesian_skyline_loglik":
        return (lambda x: jcoal.bayesian_skyline_loglik(
            jnp.asarray(HEIGHTS), N, x, jnp.asarray(GROUPS)),
            lambda x: coal.bayesian_skyline_loglik(
                torch.tensor(HEIGHTS), N, x, torch.tensor(GROUPS)),
            np.array([0.4, 0.9, 0.6]))
    return (lambda x: jnp.sum(jnp.asarray(w) * jclock.random_local_clock_rates(
        jnp.asarray(PARENT), jnp.asarray(HEIGHTS), jnp.asarray(IND), x)),
        lambda x: torch.sum(torch.tensor(w) * clock.random_local_clock_rates(
            torch.tensor(PARENT), torch.tensor(HEIGHTS), torch.tensor(IND),
            x)), RATES)


@pytest.mark.parametrize("name", ["gmrf_skyride_loglik",
                                  "bayesian_skyline_loglik",
                                  "random_local_clock_rates"])
def test_gradient_matches_jax(name):
    jf, tf, x0 = _grad_case(name)
    want = np.asarray(jax.grad(jf)(jnp.asarray(x0)))
    x = torch.tensor(x0, requires_grad=True)
    (got,) = torch.autograd.grad(tf(x), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)

"""The port's slice, elliptical-slice, MVN and AVMVN operators, the chain
step's acceptance statistic and post-update hook, and the new operators'
settings carried across from the JAX package.

Statistical tests take tests/test_samplers.py's and tests/test_avmvn_gss.py's
targets, settings and tolerances. make_mcmc_step is held to JAX's formula
exactly (an operator's own acceptance statistic in the Robbins-Monro
update, NaN falling back to the Metropolis probability; the hook applied
after accept/reject); the derived-cache guard is checked for every
operator that binds the posterior; a build_analysis(12, 64) chain with
NUTS, slice and AVMVN added keeps the 0.1 full-evaluation deviation.
"""

import math

import numpy as np
import pytest
import torch

from beast_mcmc_tpu.inference import geodesic as jgeo
from beast_mcmc_tpu.inference import hmc as jhmc
from beast_mcmc_tpu.inference import nuts as jnuts
from beast_mcmc_tpu.inference import pdmp as jpdmp
from beast_mcmc_tpu.inference import samplers as jsamp

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.convert import operator_from, params_from_numpy
from beast_mcmc_tpu_torch.inference import geodesic, hmc, nuts, pdmp
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.operators import Operator
from beast_mcmc_tpu_torch.inference.samplers import (
    AvmvnOperator,
    EllipticalSliceOperator,
    MvnOperator,
    SliceOperator,
    empirical_covariance,
    make_post_update,
)
from beast_mcmc_tpu_torch.tree.topology import make_tree_state

F64 = torch.float64


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


def _run(ops, params, log_post, n_steps, seed=0, every=10):
    step = make_mcmc_step(log_post, ops, post_update=make_post_update(ops))
    st = init_mcmc_state(params, _dummy_tree(),
                         torch.Generator().manual_seed(seed), ops, log_post)
    st, trace = run_chain(step, st, n_steps, every, lambda s: {
        k: v.clone() for k, v in s.params.items() if not k.startswith("_")})
    return st, {k: v.numpy() for k, v in trace.items()}


def _gamma_logpdf(x, shape, scale):
    return ((shape - 1.0) * torch.log(x) - x / scale - math.lgamma(shape)
            - shape * math.log(scale))


def _normal_logpdf(x, mu, sd):
    return -0.5 * ((x - mu) / sd) ** 2 - math.log(sd) - 0.5 * math.log(
        2 * math.pi)


def test_slice_gamma_target():
    """Gamma(3, scale 2) by the slice sampler in log space, width 2, 6,000
    steps: mean within 0.6 of 6, variance within 5 of 12."""
    _, trace = _run([SliceOperator(parameter="x", width=2.0,
                                   log_transform=True)],
                    {"x": torch.tensor(4.0, dtype=F64)},
                    lambda p, t: torch.sum(_gamma_logpdf(p["x"], 3.0, 2.0)),
                    6000)
    xs = trace["x"][50:]
    assert abs(xs.mean() - 6.0) < 0.6, xs.mean()
    assert abs(xs.var() - 12.0) < 5.0, xs.var()


def test_elliptical_slice_normal_product():
    """Prior N(0, 1) times likelihood N(2, 0.5^2) on three coordinates:
    the posterior N(1.6, 0.2); means within 0.15, variance within 0.08."""
    def log_post(params, tree):
        x = params["x"]
        return (torch.sum(_normal_logpdf(x, 0.0, 1.0))
                + torch.sum(_normal_logpdf(x, 2.0, 0.5)))

    _, trace = _run([EllipticalSliceOperator(parameter="x")],
                    {"x": torch.zeros(3, dtype=F64)}, log_post, 6000)
    xs = trace["x"][50:]
    assert np.allclose(xs.mean(axis=0), 1.6, atol=0.15), xs.mean(axis=0)
    assert abs(xs.var() - 0.2) < 0.08, xs.var()


def test_mvn_operator_with_empirical_cov():
    """log x ~ N((1, 2), cov): a first MVN run gives the empirical Cholesky
    factor, a second with it recovers the means within 0.2."""
    cov = np.array([[0.3, 0.2], [0.2, 0.5]])
    prec = torch.tensor(np.linalg.inv(cov))
    mean = torch.tensor([1.0, 2.0], dtype=F64)

    def log_post(params, tree):
        d = torch.log(params["x"]) - mean
        return -0.5 * d @ prec @ d - torch.sum(torch.log(params["x"]))

    _, trace = _run([MvnOperator(parameters=["x"], scale=0.5)],
                    {"x": torch.exp(mean)}, log_post, 4000)
    chol = empirical_covariance(trace["x"][40:], log_space=True)
    assert chol.shape == (2, 2)
    _, trace2 = _run([MvnOperator(parameters=["x"], scale=1.0, chol=chol)],
                     {"x": torch.exp(mean)}, log_post, 6000, seed=1)
    logx = np.log(trace2["x"][50:])
    assert np.allclose(logx.mean(axis=0), [1.0, 2.0], atol=0.2), logx.mean(0)


def test_avmvn_learns_correlation():
    """tests/test_avmvn_gss.py: a Gaussian with sds (1, 5) and correlation
    0.95, 30,000 steps: the chain's and the learned covariance's
    correlation within 0.05, the variances within 35%; the statistics
    counted every step."""
    cov = np.array([[1.0, 0.95 * 5.0], [0.95 * 5.0, 25.0]])
    prec = torch.tensor(np.linalg.inv(cov))
    op = AvmvnOperator(parameters=["x"], scale=1.0, log_transform=False,
                       warmup=200)
    st, trace = _run([op], {"x": torch.zeros(2, dtype=F64)},
                     lambda p, t: -0.5 * p["x"] @ prec @ p["x"], 30000,
                     every=5)
    emp = np.cov(trace["x"][1000:], rowvar=False)
    assert abs(emp[0, 1] / np.sqrt(emp[0, 0] * emp[1, 1]) - 0.95) < 0.05, emp
    np.testing.assert_allclose(np.diag(emp), np.diag(cov), rtol=0.35)
    stats = st.params[op.stats_key]
    assert float(stats["n"]) == 30000
    learned = stats["scatter"].numpy() / (float(stats["n"]) - 1)
    assert abs(learned[0, 1] / np.sqrt(learned[0, 0] * learned[1, 1])
               - 0.95) < 0.05


def test_avmvn_log_space_positive_params():
    """tests/test_avmvn_gss.py: log x ~ N(1, 0.5^2) by AVMVN in log space,
    20,000 steps: mean within 0.1, sd within 0.1."""
    def log_post(params, tree):
        y = torch.log(params["x"])
        return torch.sum(_normal_logpdf(y, 1.0, 0.5)) - torch.sum(y)

    _, trace = _run([AvmvnOperator(parameters=["x"], scale=0.5)],
                    {"x": torch.full((2,), 2.0, dtype=F64)}, log_post, 20000,
                    every=5)
    ys = np.log(trace["x"][500:])
    assert abs(ys.mean() - 1.0) < 0.1, ys.mean()
    assert abs(ys.std() - 0.5) < 0.1, ys.std()


class _Fixed(Operator):
    """A proposal of fixed x with a fixed Hastings term and, where given, a
    fixed acceptance statistic."""

    adaptable = True
    target_acceptance = 0.6

    def __init__(self, x, logh, acc=None):
        self.x, self.logh, self.acc = x, logh, acc
        self.weight = 1.0

    def modified_params(self):
        return ("x",)

    def propose(self, params, tree, gen, tuning):
        out = ({**params, "x": torch.tensor(self.x, dtype=F64)}, tree,
               torch.tensor(self.logh, dtype=F64))
        return out if self.acc is None else (*out, torch.tensor(self.acc,
                                                                dtype=F64))


def test_acc_stat_drives_adaptation_and_post_update_sees_the_chosen_state():
    """A 4-tuple's statistic (0.3) enters the Robbins-Monro update as JAX
    writes it, p += (acc - target) / log(count + 2), and the operator's
    acceptance sum; a NaN statistic, or a 3-tuple, falls back to the
    Metropolis probability. post_update runs on the params after
    accept/reject: a rejected proposal leaves it the old x."""
    def log_post(params, tree):
        return -0.5 * params["x"] ** 2

    for acc, logh, x_new in ((0.3, 0.0, 0.5), (math.nan, 0.0, 0.5),
                             (None, math.log(0.25), 0.0),
                             (None, -math.inf, 0.0)):
        op = _Fixed(x_new, logh, acc)
        seen = []

        def post(params):
            seen.append(float(params["x"]))
            return {**params, "n": params["n"] + 1}

        step = make_mcmc_step(log_post, [op], post_update=post)
        st = init_mcmc_state({"x": torch.tensor(0.0, dtype=F64),
                              "n": torch.tensor(0.0, dtype=F64)},
                             _dummy_tree(), torch.Generator().manual_seed(0),
                             [op], log_post)
        adapt, total = 0.0, 0.0
        for k in range(6):
            x_old = float(st.params["x"])
            metropolis = min(1.0, math.exp(0.5 * (x_old ** 2 - x_new ** 2)
                                           + logh))
            prob = metropolis if acc is None or math.isnan(acc) else acc
            st = step(st)
            adapt += (prob - 0.6) / math.log(k + 2.0)
            total += prob
            assert seen[-1] == float(st.params["x"])  # after accept/reject
        assert float(st.params["n"]) == 6
        assert float(st.op_adapt[0]) == pytest.approx(adapt, rel=1e-12,
                                                      abs=1e-15)
        assert float(st.op_sum_accept[0]) == pytest.approx(total, rel=1e-12)
        if logh == -math.inf:
            assert int(st.op_accept[0]) == 0 and seen == [0.0] * 6


def _tree_ops_on(name):
    """Every operator of the port that binds the posterior, targeting
    `name`."""
    return [hmc.HmcOperator(parameters=(name,)),
            hmc.ReflectiveHmcOperator(parameters=(name,)),
            hmc.GeodesicHmcOperator(parameter=name),
            hmc.SimplexHmcOperator(parameter=name),
            nuts.NutsOperator(parameters=(name,)),
            pdmp.ZigZagOperator(parameters=(name,)),
            pdmp.BouncyParticleOperator(parameters=(name,)),
            geodesic.StiefelGeodesicHmcOperator(parameters=(name,)),
            SliceOperator(parameter=name),
            EllipticalSliceOperator(parameter=name)]


def test_derived_cache_guard_and_small_chain():
    """make_mcmc_step refuses each operator that binds the posterior and
    moves gtr.rates, on which the eigensystem cache depends; the MVN
    operators do not bind it and may. build_analysis(12, 64)'s chain with
    NUTS on (clock.rate, pop.size), the slice sampler on pop.size and
    AVMVN on (gtr.rates, alpha) added: each accepts, its AVMVN statistics
    count every step, and the full-evaluation deviation stays under 0.1."""
    log_post, ops, p0, t0, aux = build_analysis(12, 64, device="cpu",
                                                dtype=F64)
    lpc, derived = aux["log_post_cached"], aux["derived"]
    for op in _tree_ops_on("gtr.rates"):
        with pytest.raises(ValueError, match="derived"):
            make_mcmc_step(lpc, [op], derived=derived)
    make_mcmc_step(lpc, [MvnOperator(parameters=("gtr.rates",)),
                         AvmvnOperator(parameters=("gtr.rates",))],
                   derived=derived)
    avmvn = AvmvnOperator(parameters=("gtr.rates", "alpha"), weight=3.0,
                          warmup=50)
    added = [nuts.NutsOperator(parameters=("clock.rate", "pop.size"),
                               weight=5.0, max_depth=4, step_size=0.01),
             SliceOperator(parameter="pop.size", log_transform=True,
                           weight=3.0), avmvn]
    ops = ops + added
    step = make_mcmc_step(lpc, ops, derived=derived,
                          post_update=make_post_update(ops))
    st = init_mcmc_state(p0, t0, torch.Generator().manual_seed(0), ops, lpc)
    st, _ = run_chain(step, st, 250)
    st, dev = full_evaluation_check(step, log_post, st, 50, derived=derived)
    assert float(dev) < 0.1
    assert math.isfinite(float(st.log_posterior))
    assert all(int(a) > 0 for a in st.op_accept[-3:])
    assert float(st.params[avmvn.stats_key]["n"]) == 300


def test_avmvn_statistics_carry_across():
    """convert.params_from_numpy carries a JAX chain's "_avmvn:..." entry
    (a dict of arrays); the build_analysis posteriors ignore it."""
    log_post, _, p0, t0, aux = build_analysis(12, 64, device="cpu",
                                              dtype=F64)
    op = jsamp.AvmvnOperator(parameters=("gtr.rates", "alpha"))
    jstats = {"mean": np.arange(7.0), "scatter": np.eye(7), "n": np.array(3.0)}
    got = params_from_numpy({"alpha": 0.5, op.stats_key: jstats},
                            device="cpu")
    assert set(got[op.stats_key]) == {"mean", "scatter", "n"}
    np.testing.assert_array_equal(got[op.stats_key]["scatter"].numpy(),
                                  np.eye(7))
    with_stats = {**p0, op.stats_key: got[op.stats_key]}
    assert float(log_post(with_stats, t0)) == float(log_post(p0, t0))
    assert float(aux["log_post_cached"](with_stats, t0)) == float(
        aux["log_post_cached"](p0, t0))


NEW_OPERATORS = [
    jhmc.ReflectiveHmcOperator(parameters=("kappa",), n_leapfrog=7,
                               step_size=0.02, mass=2.0, lower=-1.0,
                               upper=3.0, weight=2.0, target_acceptance=0.7),
    jhmc.GeodesicHmcOperator(parameter="x", block_dim=3, n_leapfrog=4,
                             step_size=0.2, weight=0.5),
    jhmc.SimplexHmcOperator(parameter="pi", n_leapfrog=3, step_size=0.03,
                            mass=1.5, adaptable=False),
    jnuts.NutsOperator(parameters=("clock.rate", "pop.size"), max_depth=4,
                       step_size=0.01, mass=2.0, log_transform=False),
    jpdmp.ZigZagOperator(parameters=("x",), travel_time=0.3,
                         grad_bound=(4.0, 5.0), max_events=40),
    jpdmp.BouncyParticleOperator(parameters=("x",), travel_time=0.2,
                                 grad_bound=7.0, refresh_rate=0.5,
                                 max_events=30),
    jgeo.StiefelGeodesicHmcOperator(parameters=("a", "b"), n_leapfrog=3,
                                    step_size=0.04, draw_variance=2.0),
    jsamp.SliceOperator(parameter="pop.size", width=0.5,
                        log_transform=True, weight=3.0),
    jsamp.EllipticalSliceOperator(parameter="x", prior_mean=1.0,
                                  prior_stdev=2.0),
    jsamp.MvnOperator(parameters=("a", "b"), scale=0.3,
                      chol=np.array([[1.0, 0.0], [0.5, 2.0]]),
                      log_transform=False),
    jsamp.AvmvnOperator(parameters=("gtr.rates", "alpha"), scale=0.4,
                        beta=0.1, warmup=20),
]


@pytest.mark.parametrize("jop", NEW_OPERATORS,
                         ids=lambda o: type(o).__name__)
def test_operator_settings_carry_across(jop):
    """convert.operator_from builds the port's class of the same name with
    every setting of the JAX operator's, and the same targets."""
    op = operator_from(jop)
    assert type(op).__name__ == type(jop).__name__
    for f in (f for f in op.__dataclass_fields__ if not f.startswith("_")):
        got, ref = getattr(op, f), getattr(jop, f)
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(got, ref)
        else:
            assert got == ref, f
    assert op.modified_params() == jop.modified_params()
    if hasattr(jop, "stats_key"):
        assert op.stats_key == jop.stats_key

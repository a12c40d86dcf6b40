"""The port's inference/marginal_likelihood.py and config/xml_mle.py
against the JAX package's.

  - the beta-quantile schedule, exactly, and the five estimators (path
    sampling, stepping stones, generalized stepping stones, the harmonic
    mean, and the <generalizedSteppingStoneSamplingAnalysis> of a written
    MLE log) on identical arrays, to 1e-12;
  - the reference priors (<normalReferencePrior>,
    <logTransformedNormalReferencePrior>) fitted to one log file written
    here, past a burn-in, their densities at several values to 1e-12;
  - a rung's power-posterior and generalized-path values at identical
    states, the closures of make_power_posterior and make_gss_path and a
    <marginalLikelihoodEstimator>'s source and destination (tree
    likelihood, coalescent and working priors) at each theta, to 1e-10
    relative;
  - the ladder is sequential: one start, then per rung one re-evaluation
    of the state the last rung ended in, its steps and its samples;
  - the conjugate normal model (tests/test_marginal_likelihood.py's and
    tests/test_avmvn_gss.py's analytic log m) through
    sample_power_posteriors (path sampling, stepping stones, the harmonic
    mean) and sample_gss_ratios, each within JAX's own test's tolerance;
  - a short XML marginal-likelihood document (pilot <mcmc>, the
    estimator, a GSS <assertEqual>) end to end on both packages: the MLE
    log's layout, both GSS estimates within 0.15 of the analytic log m,
    and the assertion's warn-and-skip after the <mcmc> in both;
  - ROADMAP reference caveat 8: <pathSamplingAnalysis> and
    <steppingStoneSamplingAnalysis> read `pathLikelihood.delta` by
    default, which the log never holds: both packages raise the same
    Unsupported, and give the same estimate for a named column.
"""

import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.config import interpreter as jinterp
from beast_mcmc_tpu.config.xml_assert import (
    initial_eval_state as j_initial_eval_state,
)
from beast_mcmc_tpu.config.xml_assert import report_of as j_report_of
from beast_mcmc_tpu.inference import marginal_likelihood as jml

from beast_mcmc_tpu_torch.config import interpreter as interp
from beast_mcmc_tpu_torch.config.xml_assert import (
    initial_eval_state,
    report_of,
)
from beast_mcmc_tpu_torch.inference import marginal_likelihood as ml
from beast_mcmc_tpu_torch.inference.operators import RandomWalkOperator
from beast_mcmc_tpu_torch.models.priors import normal_logpdf
from beast_mcmc_tpu_torch.tree.topology import (
    make_tree_state,
    simulate_coalescent_tree,
)

from test_distribution_likelihood_xml import XML as CONJUGATE_XML

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,alpha", [(2, 0.3), (11, 0.3), (24, 0.3),
                                     (8, 0.5), (5, 1.0)])
def test_schedule_equals_jax(n, alpha):
    np.testing.assert_array_equal(ml.beta_quantile_schedule(n, alpha),
                                  jml.beta_quantile_schedule(n, alpha))


GSS_COLUMNS = ('<thetaColumn name="pathLikelihood.theta"/>'
               '<sourceColumn name="pathLikelihood.source"/>'
               '<destinationColumn name="pathLikelihood.destination"/>')


def _mle_log(path, betas, samples, rng):
    """An MLE log of the estimator's layout: per theta, source and
    destination rows."""
    with open(path, "w") as fh:
        fh.write("state\tpathLikelihood.theta\tpathLikelihood.source\t"
                 "pathLikelihood.destination\n")
        i = 0
        for b in betas:
            for _ in range(samples):
                fh.write(f"{i}\t{float(b)!r}\t{rng.normal(-20.0, 3.0)!r}\t"
                         f"{rng.normal(-2.0, 1.0)!r}\n")
                i += 1


def _bare_analyses(tmp_path, body):
    path = tmp_path / "bare.xml"
    path.write_text(f"<beast>{body}</beast>")
    return (jinterp.XmlAnalysis(str(path), workdir=str(tmp_path)),
            interp.XmlAnalysis(str(path), workdir=str(tmp_path),
                               device="cpu"))


@pytest.mark.parametrize("name", ["path_sampling_logml",
                                  "stepping_stone_logml",
                                  "generalized_stepping_stone_logml",
                                  "harmonic_mean_logml", "gss_of_a_log"])
def test_estimators_equal_jax(name, tmp_path):
    """On identical arrays (betas shuffled: the estimators sort them) and
    on one MLE log file, to 1e-12."""
    rng = np.random.default_rng(4)
    betas = rng.permutation(ml.beta_quantile_schedule(9))
    x = rng.normal(-30.0, 4.0, (9, 60)) * (1.0 + betas[:, None])
    if name == "harmonic_mean_logml":
        got, want = ml.harmonic_mean_logml(x[0]), jml.harmonic_mean_logml(
            x[0])
    elif name == "gss_of_a_log":
        _mle_log(tmp_path / "mle.log", ml.beta_quantile_schedule(7), 40, rng)
        jax_ax, ax = _bare_analyses(tmp_path, (
            '<generalizedSteppingStoneSamplingAnalysis id="gss" '
            f'fileName="mle.log">{GSS_COLUMNS}'
            '</generalizedSteppingStoneSamplingAnalysis>'))
        got = ax.build(ax._ids["gss"]).estimate(ax)
        want = jax_ax.build(jax_ax._ids["gss"]).estimate(jax_ax)
        assert report_of(ax, ax._ids["gss"]) == j_report_of(
            jax_ax, jax_ax._ids["gss"])
    else:
        got, want = getattr(ml, name)(x, betas), getattr(jml, name)(x, betas)
    assert math.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _pilot_log(path, rng, n=60):
    with open(path, "w") as fh:
        fh.write("state\tkappa\tconstant.popSize\tm\tx1\tx2\n")
        for i in range(n):
            fh.write(f"{i * 10}\t{rng.lognormal(0.7, 0.2)!r}\t"
                     f"{rng.lognormal(-2.5, 0.3)!r}\t{rng.normal(1.9, 0.5)!r}"
                     f"\t{rng.lognormal(0.0, 0.4)!r}\t"
                     f"{rng.lognormal(1.0, 0.1)!r}\n")


@pytest.mark.parametrize("tag", ["normalReferencePrior",
                                 "logTransformedNormalReferencePrior"])
@pytest.mark.parametrize("column,burnin", [("kappa", "0"), ("x", "150")])
def test_reference_priors_equal_jax(tag, column, burnin, tmp_path):
    """Fitted to one log file written here (a scalar column, and a vector
    parameter's numbered columns past a burn-in), the densities at five
    values each to 1e-12."""
    rng = np.random.default_rng(11)
    _pilot_log(tmp_path / "pilot.log", rng)
    value = "2.0" if column == "kappa" else "1.0 2.5"
    jax_ax, ax = _bare_analyses(tmp_path, (
        f'<parameter id="{column}" value="{value}"/>'
        f'<{tag} id="ref" fileName="pilot.log" parameterColumn="{column}" '
        f'burnin="{burnin}"><parameter idref="{column}"/></{tag}>'))
    lik, jlik = ax.build(ax._ids["ref"]), jax_ax.build(jax_ax._ids["ref"])
    assert lik.data_params == jlik.data_params == (column,)
    dim = len(value.split())
    for v in rng.lognormal(0.3, 0.5, (5, dim)):
        v = v.reshape(()) if dim == 1 else v
        got = float(lik.fn({column: torch.tensor(v, dtype=F64)}, None))
        want = float(jlik.fn({column: jnp.asarray(v)}, None))
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_power_posterior_and_gss_path_closures_equal_jax():
    """make_power_posterior and make_gss_path over the same densities, at
    every rung of a ladder and three states, to 1e-10 relative."""
    def dens(lib, c):
        return lambda p, t: lib.sum(-0.5 * (p["x"] - c) ** 2) - p["x"][0]

    for beta in ml.beta_quantile_schedule(6):
        pp = ml.make_power_posterior(dens(torch, 1.0), dens(torch, -0.5))
        jpp = jml.make_power_posterior(dens(jnp, 1.0), dens(jnp, -0.5))
        gss = ml.make_gss_path(dens(torch, 1.0), dens(torch, -0.5),
                               dens(torch, 0.2))
        jgss = jml.make_gss_path(dens(jnp, 1.0), dens(jnp, -0.5),
                                 dens(jnp, 0.2))
        for x in np.random.default_rng(2).normal(size=(3, 4)):
            for f, jf in ((pp, jpp), (gss, jgss)):
                got = float(f(float(beta))({"x": torch.tensor(x)}, None))
                want = float(jf(float(beta))({"x": jnp.asarray(x)}, None))
                np.testing.assert_allclose(got, want, rtol=1e-10)


def _with_estimator(xml, chain_length=64, path_steps=4, log_every=8,
                    extra=""):
    """CONJUGATE_XML with a pilot log of kappa, popSize and m, then a
    <marginalLikelihoodEstimator> from the posterior to working priors on
    the three (fitted to the pilot log) and the coalescent."""
    mle = f"""
  <marginalLikelihoodEstimator chainLength="{chain_length}" pathSteps="{path_steps}">
    <samplers><mcmc idref="mcmc"/></samplers>
    <pathLikelihood id="pathLikelihood">
      <source><posterior idref="posterior"/></source>
      <destination>
        <workingPrior>
          <logTransformedNormalReferencePrior fileName="pilot.log" parameterColumn="kappa" burnin="0">
            <parameter idref="kappa"/></logTransformedNormalReferencePrior>
          <logTransformedNormalReferencePrior fileName="pilot.log" parameterColumn="constant.popSize" burnin="0">
            <parameter idref="constant.popSize"/></logTransformedNormalReferencePrior>
          <normalReferencePrior fileName="pilot.log" parameterColumn="m" burnin="0">
            <parameter idref="m"/></normalReferencePrior>
        </workingPrior>
        <coalescentLikelihood idref="coalescent"/>
      </destination>
    </pathLikelihood>
    <log logEvery="{log_every}" fileName="mle.log"/>
  </marginalLikelihoodEstimator>{extra}
</beast>"""
    return (xml.replace('<parameter idref="m"/>\n    </log>',
                        '<parameter idref="m"/>\n      <parameter idref="kappa"/>'
                        '\n      <parameter idref="constant.popSize"/>\n    </log>')
            .replace('fileName="distlik.log"', 'fileName="pilot.log"')
            .replace("</beast>", mle))


def test_rung_values_equal_jax(tmp_path):
    """A <marginalLikelihoodEstimator>'s source (the posterior: tree
    likelihood, coalescent, priors, the normal data) and destination (three
    working priors fitted to a pilot log written here, and the
    coalescent), and the rung target theta src + (1 - theta) dst, at the
    start state and two perturbed ones, at every theta, to 1e-10
    relative."""
    from beast_mcmc_tpu_torch.config.xml_mle import estimator_parts

    _pilot_log(tmp_path / "pilot.log", np.random.default_rng(3))
    path = tmp_path / "doc.xml"
    path.write_text(_with_estimator(CONJUGATE_XML))
    ax = interp.XmlAnalysis(str(path), workdir=str(tmp_path), device="cpu")
    jax_ax = jinterp.XmlAnalysis(str(path), workdir=str(tmp_path))
    for a in (ax, jax_ax):
        a.build(a._ids["treeModel"])
    parts = estimator_parts(ax, ax.root.find("marginalLikelihoodEstimator"))
    pl = jax_ax.root.find("marginalLikelihoodEstimator/pathLikelihood")
    j_src = jax_ax.build(jax_ax.deref(pl.find("source")[0]))
    j_dst = [jax_ax.build(jax_ax.deref(d))
             for d in pl.find("destination/workingPrior")]
    j_dst.append(jax_ax.build(jax_ax.deref(pl.find("destination")[1])))
    np.testing.assert_array_equal(parts["betas"],
                                  jml.beta_quantile_schedule(4))
    assert (parts["chain_length"], parts["log_every"]) == (64, 8)

    p0, t0 = initial_eval_state(ax)
    jp0, jt0 = j_initial_eval_state(jax_ax)
    rng = np.random.default_rng(8)
    for k in range(3):
        scale = {n: (rng.uniform(0.8, 1.25) if k else 1.0)
                 for n in ("kappa", "constant.popSize", "m")}
        p = {**p0, **{n: p0[n] * s for n, s in scale.items()}}
        jp = {**jp0, **{n: jp0[n] * s for n, s in scale.items()}}
        src = float(parts["source"](p, t0))
        dst = float(parts["destination"](p, t0))
        j_src_v = float(jax.jit(j_src.fn)(jp, jt0))
        j_dst_v = float(sum(jax.jit(d.fn)(jp, jt0) for d in j_dst))
        np.testing.assert_allclose([src, dst], [j_src_v, j_dst_v],
                                   rtol=1e-10)
        for b in parts["betas"]:
            np.testing.assert_allclose(b * src + (1 - b) * dst,
                                       b * j_src_v + (1 - b) * j_dst_v,
                                       rtol=1e-10)


def _normal_model(n_data=12, seed=0):
    rng = np.random.default_rng(seed)
    data_np = rng.normal(1.5, 1.0, size=n_data)
    data = torch.tensor(data_np)
    s, t = 1.0, 2.0

    def log_lik(p, tree):
        return torch.sum(normal_logpdf(data, p["mu"], s))

    def log_prior(p, tree):
        return normal_logpdf(p["mu"], 0.0, t)

    cov = s ** 2 * np.eye(n_data) + t ** 2 * np.ones((n_data, n_data))
    _, logdet = np.linalg.slogdet(cov)
    analytic = float(-0.5 * (n_data * np.log(2 * np.pi) + logdet
                             + data_np @ np.linalg.solve(cov, data_np)))
    prec_post = n_data / s ** 2 + 1 / t ** 2
    mu_post = float(np.sum(data_np) / s ** 2 / prec_post)
    tree = make_tree_state(*simulate_coalescent_tree(
        np.random.default_rng(0), np.zeros(3), 1.0), F64, "cpu")
    return log_lik, log_prior, analytic, mu_post, prec_post, tree


def test_ladder_is_sequential():
    """Three rungs of 20 states, a sample every 5: one evaluation at the
    start, then a rung's re-evaluation at the state the last rung ended in
    (its last sample's), its 20 steps and its 4 samples."""
    log_lik, log_prior, _, _, _, tree = _normal_model()
    seen = []

    def counted(p, t):
        seen.append(float(p["mu"]))
        return log_lik(p, t)

    ops = [RandomWalkOperator(parameter="mu", window=1.0)]
    out = ml.sample_power_posteriors(
        counted, log_prior, ops, {"mu": torch.tensor(0.5, dtype=F64)}, tree,
        [1.0, 0.5, 0.0], 22, 5, torch.Generator().manual_seed(1),
        burnin_fraction=0.0)
    assert out.shape == (3, 4)
    # per rung: the start (or re-evaluation), 20 steps, 4 samples
    assert len(seen) == 3 * (1 + 20 + 4)
    for r in (1, 2):
        last_sample = seen[r * 25 - 1]
        assert seen[r * 25] == last_sample  # the inherited state


def test_conjugate_ladders_recover_the_analytic_log_m():
    """tests/test_marginal_likelihood.py's and tests/test_avmvn_gss.py's
    models, on shorter chains: path sampling within 0.25, stepping stones
    within 0.15, the harmonic mean within 2.0 (24 rungs of 600 states), the
    generalized stepping stones within 0.15 (12 rungs of 600)."""
    log_lik, log_prior, analytic, mu_post, prec_post, tree = _normal_model()
    ops = [RandomWalkOperator(parameter="mu", window=1.0)]
    mu0 = {"mu": torch.tensor(0.5, dtype=F64)}
    betas = ml.beta_quantile_schedule(24)
    lls = ml.sample_power_posteriors(log_lik, log_prior, ops, mu0, tree,
                                     betas, 600, 4,
                                     torch.Generator().manual_seed(0))
    assert abs(ml.path_sampling_logml(lls, betas) - analytic) < 0.25
    assert abs(ml.stepping_stone_logml(lls, betas) - analytic) < 0.15
    assert abs(ml.harmonic_mean_logml(lls[0]) - analytic) < 2.0

    sd_ref = 1.6 / math.sqrt(prec_post)

    def log_ref(p, tree):
        return normal_logpdf(p["mu"], mu_post, sd_ref)

    betas = ml.beta_quantile_schedule(12)
    ratios = ml.sample_gss_ratios(log_lik, log_prior, log_ref, ops, mu0,
                                  tree, betas, 600, 4,
                                  torch.Generator().manual_seed(1))
    est = ml.generalized_stepping_stone_logml(ratios, betas)
    assert abs(est - analytic) < 0.15, (est, analytic)


DATA = np.array([1.1, 2.3, 0.7, 1.9, 1.4, 2.2, 0.9, 1.6, 1.2, 2.0])

NORMAL_MLE_XML = f"""<beast>
  <parameter id="mu" value="0.5"/>
  <distributionLikelihood id="lik">
    <distribution><normalDistributionModel>
      <mean><parameter idref="mu"/></mean>
      <stdev><parameter id="sd" value="1.0"/></stdev>
    </normalDistributionModel></distribution>
    <data><parameter id="x" value="{' '.join(map(str, DATA))}"/></data>
  </distributionLikelihood>
  <operators id="ops">
    <randomWalkOperator windowSize="1.0" weight="1"><parameter idref="mu"/></randomWalkOperator>
  </operators>
  <mcmc id="mcmc" chainLength="1000">
    <posterior id="posterior">
      <prior id="prior"><normalPrior mean="0.0" stdev="2.0"><parameter idref="mu"/></normalPrior></prior>
      <likelihood id="likelihood"><distributionLikelihood idref="lik"/></likelihood>
    </posterior>
    <operators idref="ops"/>
    <log logEvery="10" fileName="pilot.log"><parameter idref="mu"/></log>
  </mcmc>
  <marginalLikelihoodEstimator chainLength="500" pathSteps="8">
    <samplers><mcmc idref="mcmc"/></samplers>
    <pathLikelihood id="pathLikelihood">
      <source><posterior idref="posterior"/></source>
      <destination><workingPrior>
        <normalReferencePrior fileName="pilot.log" parameterColumn="mu" burnin="200">
          <parameter idref="mu"/></normalReferencePrior>
      </workingPrior></destination>
    </pathLikelihood>
    <log logEvery="4" fileName="mle.log"/>
  </marginalLikelihoodEstimator>
  <assertEqual tolerance="0.001">
    <message>GSS of the conjugate normal model</message>
    <actual regex="= (\\S+)"><generalizedSteppingStoneSamplingAnalysis id="gss" fileName="mle.log">{GSS_COLUMNS}</generalizedSteppingStoneSamplingAnalysis></actual>
    <expected>-14.0</expected>
  </assertEqual>
</beast>
"""


def _analytic(x, s=1.0, t=2.0):
    n = len(x)
    cov = s ** 2 * np.eye(n) + t ** 2 * np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    return float(-0.5 * (n * np.log(2 * np.pi) + logdet
                         + x @ np.linalg.solve(cov, x)))


def _read(path):
    with open(path) as fh:
        rows = [ln.split("\t") for ln in fh.read().splitlines()]
    return rows[0], np.array(rows[1:], float)


def test_xml_mle_document_on_both_packages(tmp_path):
    analytic = _analytic(DATA)
    estimates = {}
    for name, mod, kw in (("port", interp, {"device": "cpu"}),
                          ("jax", jinterp, {})):
        d = tmp_path / name
        d.mkdir()
        (d / "doc.xml").write_text(NORMAL_MLE_XML)
        ax = mod.XmlAnalysis(str(d / "doc.xml"), workdir=str(d), seed=5,
                             **kw)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ax.run(full_eval_steps=5)
        # the failing GSS assertion (expected -14.0) after the <mcmc> warns
        # and is skipped, in both packages
        assert any("skipped" in str(x.message) for x in w), name
        names, rows = _read(d / "mle.log")
        assert names == ["state", "pathLikelihood.theta",
                         "pathLikelihood.source",
                         "pathLikelihood.destination"]
        assert rows.shape == (8 * 125, 4)
        np.testing.assert_array_equal(np.unique(rows[:, 1])[::-1],
                                      ml.beta_quantile_schedule(8))
        assert len(ax._mle_rows["mle.log"]) == 8 * 125
        rep = (report_of if name == "port" else j_report_of)(
            ax, ax._ids["gss"])
        estimates[name] = float(rep.split("= ")[1])
        assert abs(estimates[name] - analytic) < 0.15, (name, estimates)


def test_xml_gss_assertion_fails_without_a_chain(tmp_path):
    """Without a stochastic <mcmc> before it, a failing assertEqual over
    an estimator's report raises, in both packages."""
    rng = np.random.default_rng(0)
    _mle_log(tmp_path / "mle.log", ml.beta_quantile_schedule(5), 30, rng)
    body = (f'<assertEqual tolerance="1e-9"><actual regex="= (\\S+)">'
            f'<generalizedSteppingStoneSamplingAnalysis fileName="mle.log">'
            f'{GSS_COLUMNS}</generalizedSteppingStoneSamplingAnalysis>'
            f'</actual><expected>0.0</expected></assertEqual>')
    for ax in _bare_analyses(tmp_path, body):
        with pytest.raises(AssertionError, match="!= '0.0'"):
            ax.run()


@pytest.mark.parametrize("tag", ["pathSamplingAnalysis",
                                 "steppingStoneSamplingAnalysis"])
def test_ps_ss_default_column_caveat(tag, tmp_path):
    """ROADMAP reference caveat 8: the default likelihood column
    `pathLikelihood.delta` is not in the estimator's log; both packages
    raise the same Unsupported. With a named column both estimate the
    same number."""
    rng = np.random.default_rng(2)
    _mle_log(tmp_path / "mle.log", ml.beta_quantile_schedule(6), 25, rng)
    jax_ax, ax = _bare_analyses(tmp_path, (
        f'<{tag} id="bare" fileName="mle.log"/>'
        f'<{tag} id="named" fileName="mle.log">'
        f'<likelihoodColumn name="pathLikelihood.source"/></{tag}>'))
    with pytest.raises(interp.Unsupported) as e:
        ax.build(ax._ids["bare"]).estimate(ax)
    with pytest.raises(jinterp.Unsupported) as je:
        jax_ax.build(jax_ax._ids["bare"]).estimate(jax_ax)
    assert str(e.value) == str(je.value) == \
        "column 'pathLikelihood.delta' not in mle.log"
    got = ax.build(ax._ids["named"]).estimate(ax)
    want = jax_ax.build(jax_ax._ids["named"]).estimate(jax_ax)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert report_of(ax, ax._ids["named"]) == j_report_of(
        jax_ax, jax_ax._ids["named"])

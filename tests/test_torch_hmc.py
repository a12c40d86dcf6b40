"""The port's transforms and HMC operators against the JAX package.

utils/transforms.py (round trips and log-Jacobians, the cases of
tests/test_transforms.py), tree/transforms.py (node heights <-> ratios,
level by level here, node by node in JAX) and inference/hmc.py
(NodeHeightHmcOperator's potential energy and its gradient, a leapfrog
trajectory from a given start) are held against the JAX functions in
float64, at 1e-10 relative. The chains are held statistically: the
lognormal moments of tests/test_hmc.py, the low-rank preconditioned
Gaussian of tests/test_hmc_ext2.py (both with fewer steps, the second with
a proportionally lower acceptance count), and a build_analysis(12, 64) chain
with both HMC operators and the reference's 0.1 full-evaluation check.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jbuild
from beast_mcmc_tpu.inference.trace import analyze
from beast_mcmc_tpu.tree import transforms as jtt
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree
from beast_mcmc_tpu.utils import transforms as jt

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.inference.hmc import (
    HmcOperator,
    NodeHeightHmcOperator,
    batch_of_one,
    leapfrog,
    value_grad,
)
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.models.priors import lognormal_logpdf
from beast_mcmc_tpu_torch.tree import transforms as ttt
from beast_mcmc_tpu_torch.tree.topology import make_tree_state
from beast_mcmc_tpu_torch.utils import transforms as tt

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


def _pair(name, **kw):
    return getattr(jt, name)(**kw), getattr(tt, name)(**kw)


CASES = {
    "none": (("NoTransform", {}), [0.3, -1.2, 4.0]),
    "log": (("LogTransform", {}), [0.3, 1.7, 4.0]),
    "logit": (("LogitTransform", {}), [0.2, 0.5, 0.9]),
    "scaled_logit": (("ScaledLogitTransform", {"lower": -2.0, "upper": 5.0}),
                     [-1.0, 0.0, 4.5]),
    "fisher_z": (("FisherZTransform", {}), [-0.8, 0.1, 0.6]),
    "affine": (("AffineTransform", {"a": -2.5, "b": 1.0}), [0.3, -1.2, 4.0]),
    "negate": (("NegateTransform", {}), [0.3, -1.2, 4.0]),
    "power": (("PowerTransform", {"power": 3.0}), [0.3, 1.7, 4.0]),
    "reciprocal": (("ReciprocalTransform", {}), [0.3, 1.7, 4.0]),
    "positive_ordered": (("PositiveOrderedTransform", {}), [0.3, 1.7, 4.0]),
    "simplex": (("SimplexTransform", {"k": 4}), [0.1, 0.4, 0.2, 0.3]),
    "lkj": (("LKJCorrelationTransform", {"d": 3}), [0.3, -0.2, 0.1]),
}


def _build(name):
    if name == "compose":
        return (jt.ComposeTransform(outer=jt.AffineTransform(a=2.0, b=-1.0),
                                    inner=jt.LogTransform()),
                tt.ComposeTransform(outer=tt.AffineTransform(a=2.0, b=-1.0),
                                    inner=tt.LogTransform()),
                [0.3, 1.7, 4.0])
    if name == "array":
        return (jt.ArrayTransform(blocks=[(jt.LogTransform(), 2),
                                          (jt.SimplexTransform(k=3), 3)]),
                tt.ArrayTransform(blocks=[(tt.LogTransform(), 2),
                                          (tt.SimplexTransform(k=3), 3)]),
                [0.5, 3.0, 0.25, 0.35, 0.4])
    (cls, kw), x = CASES[name]
    return (*_pair(cls, **kw), x)


@pytest.mark.parametrize("name", sorted(CASES) + ["compose", "array"])
def test_transform_matches_jax(name):
    """forward, inverse, the log-Jacobian (closed form, or the autograd
    log-determinant where the transform has none) and the reference's
    log_jacobian, against the JAX transform; the round trip; and the
    closed form against the autograd log-determinant."""
    jtr, ttr, x = _build(name)
    xj, xt = jnp.asarray(x), torch.tensor(x, dtype=F64)
    yj, yt = jtr.forward(xj), ttr.forward(xt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(ttr.inverse(yt).numpy(), x, rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(float(ttr.log_det_jacobian_inverse(yt)),
                               float(jtr.log_det_jacobian_inverse(yj)),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(ttr.log_jacobian(xt)),
                               float(jtr.log_jacobian(xj)), rtol=1e-10,
                               atol=1e-12)
    if name not in ("simplex", "array"):  # k -> k - 1 coordinates
        np.testing.assert_allclose(
            float(tt.Transform.log_det_jacobian_inverse(ttr, yt)),
            float(ttr.log_det_jacobian_inverse(yt)), rtol=1e-10, atol=1e-12)


def test_parse_transform_and_simplex():
    assert isinstance(tt.parse_transform("log"), tt.LogTransform)
    assert isinstance(tt.parse_transform("simplex", k=3), tt.SimplexTransform)
    with pytest.raises(ValueError):
        tt.parse_transform("nope")
    x = tt.SimplexTransform(k=5).inverse(torch.tensor([0.3, -1.0, 2.0, -0.4],
                                                      dtype=F64))
    assert float(x.sum()) == pytest.approx(1.0, abs=1e-12)
    assert bool(torch.all(x > 0))


def _tree(n_taxa, seed, serial):
    rng = np.random.default_rng(seed)
    tips = rng.random(n_taxa) * 0.3 if serial else np.zeros(n_taxa)
    return simulate_coalescent_tree(rng, tips, 1.0)


@pytest.mark.parametrize("n_taxa,serial", [(8, False), (200, False),
                                           (200, True)])
def test_tree_transforms_match_jax(n_taxa, serial):
    """Depths, orders, anchors, heights -> ratios and back (heights and
    log|J|), level by level against JAX's node-by-node scans; the round
    trip recovers the heights."""
    parent, children, heights, root = _tree(n_taxa, n_taxa + serial, serial)
    tr = make_tree_state(parent, children, heights, root, F64, "cpu")
    ja = [jnp.asarray(a) for a in (parent, children, heights)]
    np.testing.assert_array_equal(ttt.node_depths(tr.parent).numpy(),
                                  np.asarray(jtt.node_depths(ja[0])))
    for got, ref in zip(ttt._internal_orders(tr.parent, n_taxa),
                        jtt._internal_orders(ja[0], n_taxa)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(
        ttt.subtree_anchors(tr.parent, tr.children, tr.heights[:n_taxa],
                            n_taxa).numpy(),
        np.asarray(jtt.subtree_anchors(ja[0], ja[1], ja[2][:n_taxa],
                                       n_taxa)), rtol=0, atol=0)
    r, rh = ttt.heights_to_ratios(tr.parent, tr.children, tr.heights,
                                  tr.root, n_taxa)
    jr, jrh = jtt.heights_to_ratios(*ja, root, n_taxa)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12)
    assert float(rh) == float(jrh)
    rng = np.random.default_rng(1)
    ratios = rng.random(n_taxa - 1) * 0.9 + 0.05
    h, logj = ttt.ratios_to_heights(tr.parent, tr.children,
                                    tr.heights[:n_taxa],
                                    torch.tensor(ratios), rh + 0.5, tr.root,
                                    n_taxa)
    jh, jlogj = jtt.ratios_to_heights(ja[0], ja[1], ja[2][:n_taxa],
                                      jnp.asarray(ratios), jrh + 0.5, root,
                                      n_taxa)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-12)
    np.testing.assert_allclose(float(logj), float(jlogj), rtol=1e-10)
    back, _ = ttt.ratios_to_heights(tr.parent, tr.children,
                                    tr.heights[:n_taxa], r, rh, tr.root,
                                    n_taxa)
    np.testing.assert_allclose(back.numpy(), heights, rtol=1e-12,
                               atol=1e-14)


def _analyses(n_taxa=12, n_patterns=64):
    """The port's and the JAX package's build_analysis: the same tips,
    weights and start tree from the same seed."""
    port = build_analysis(n_taxa, n_patterns, device="cpu", dtype=F64)
    return port, jbuild(n_taxa, n_patterns)


def _jax_node_height_potential(jlp, jp0, jtree):
    """JAX NodeHeightHmcOperator's z0 and -log pi(z), built from the JAX
    functions as its propose builds them."""
    n_taxa = jtree.n_taxa
    parent, children, root = jtree.parent, jtree.children, jtree.root
    tip_h = jtree.heights[:n_taxa]
    max_tip = jnp.max(tip_h)
    is_root = jnp.arange(n_taxa, parent.shape[0]) == root
    ratios, rh = jtt.heights_to_ratios(parent, children, jtree.heights, root,
                                       n_taxa)
    z0 = jnp.where(is_root, jnp.log(rh - max_tip), jax.scipy.special.logit(
        jnp.clip(ratios, 1e-12, 1.0 - 1e-12)))

    def u(z):
        r = jax.nn.sigmoid(z)
        root_h = max_tip + jnp.exp(jnp.sum(jnp.where(is_root, z, 0.0)))
        h, logj = jtt.ratios_to_heights(parent, children, tip_h, r, root_h,
                                        root, n_taxa)
        logdet = logj + jnp.sum(jnp.where(is_root, z, jnp.log(r)
                                          + jnp.log1p(-r)))
        return -(jlp(jp0, jtree.replace(heights=h)) + logdet)

    return z0, u


def test_node_height_potential_and_gradient_match_jax():
    """NodeHeightHmcOperator's coordinates, -log pi(z) and its gradient
    (through the ratios map, the peel's adjoint and the coalescent) against
    the JAX operator's, on build_analysis(12, 64)'s start."""
    (lp, _, p0, t0, aux), (jlp, _, jp0, jt0, jaux) = _analyses()
    op = NodeHeightHmcOperator()
    op.bind_log_posterior(aux["log_post_cached"])
    z0, _, u1 = op.coordinates(op.one_chain_posterior(), batch_of_one(p0),
                               batch_of_one(t0))
    z0, u = z0[0], (lambda z: u1(z[None])[0])  # the batch of one's chain
    jz0, ju = _jax_node_height_potential(jaux["log_post_cached"], jp0, jt0)
    np.testing.assert_allclose(z0.numpy(), np.asarray(jz0), rtol=1e-12)
    z = z0 + torch.tensor(np.random.default_rng(2).normal(0, 0.1,
                                                          z0.shape[0]))
    zj = jnp.asarray(z.numpy())
    np.testing.assert_allclose(float(u(z)), float(jax.jit(ju)(zj)),
                               rtol=1e-12)
    got = value_grad(u, z).numpy()
    ref = np.asarray(jax.jit(jax.grad(ju))(zj))
    assert np.all(np.isfinite(got))
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


def test_leapfrog_trajectory_matches_jax():
    """HmcOperator(("clock.rate", "pop.size")) in log space: a leapfrog
    trajectory of 6 steps from a given (y0, p0) against one built from
    jax.grad of the JAX operator's potential, at a step size that keeps
    it near the start."""
    (lp, _, p0, t0, aux), (jlp, _, jp0, jt0, jaux) = _analyses()
    names = ("clock.rate", "pop.size")
    op = HmcOperator(parameters=names)
    op.bind_log_posterior(aux["log_post_cached"])
    y0 = op._pack(batch_of_one(p0))[0]
    pm0 = torch.tensor([0.7, -1.3], dtype=F64)
    eps, n = 0.002, 6  # the start's gradient in log clock rate is ~ -1,800
    u = op.neg_log_density(op.one_chain_posterior(), batch_of_one(p0),
                           batch_of_one(t0))
    y1, pm1 = leapfrog(lambda y: value_grad(lambda v: u(v[None])[0], y),
                       y0, pm0, eps, n, lambda p: p)

    def ju(y):
        x = jnp.exp(y)
        prm = {**jp0, names[0]: x[0], names[1]: x[1]}
        return -(jaux["log_post_cached"](prm, jt0) + jnp.sum(y))

    jg = jax.jit(jax.grad(ju))
    y, p = jnp.asarray(y0.numpy()), jnp.asarray(pm0.numpy())
    for _ in range(n):
        p = p - 0.5 * eps * jg(y)
        y = y + eps * p
        p = p - 0.5 * eps * jg(y)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y), rtol=1e-10)
    np.testing.assert_allclose(pm1.numpy(), np.asarray(p), rtol=1e-10)


def _dummy_tree():
    return make_tree_state(np.array([2, 2, -1]),
                           np.array([[-1, -1], [-1, -1], [0, 1]]),
                           np.array([0.0, 0.0, 1.0]), 2, F64, "cpu")


def test_hmc_lognormal_target_moments():
    """x with log x ~ N(mu, sigma^2), by HMC in log space (the target of
    tests/test_hmc.py, 2,000 steps): E[log x] within four standard errors,
    sd within 0.05, acceptance above one half."""
    mu, sigma = 0.7, 0.45

    def log_post(params, tree):
        return lognormal_logpdf(params["x"], mu, sigma)

    ops = [HmcOperator(parameters=("x",), n_leapfrog=8, step_size=0.3)]
    step = make_mcmc_step(log_post, ops)
    state = init_mcmc_state({"x": torch.tensor(1.0, dtype=F64)},
                            _dummy_tree(), torch.Generator().manual_seed(2),
                            ops, log_post)
    state, out = run_chain(step, state, 2000, collect_every=1,
                           collector=lambda s: {"x": s.params["x"]})
    lx = np.log(out["x"].numpy())[100:]
    st = analyze(lx)
    assert st.ess > 200
    assert abs(st.mean - mu) < 4 * st.std_error_of_mean
    assert abs(lx.std() - sigma) < 0.05
    acc = int(state.op_accept[0]) / (int(state.op_accept[0])
                                     + int(state.op_reject[0]))
    assert acc > 0.5


def test_low_rank_preconditioning_anisotropic_gaussian():
    """HMC with the low-rank Hessian mass on the badly conditioned Gaussian
    of tests/test_hmc_ext2.py (1,500 steps, 60 draws): each marginal sd
    within the same bands; more than 250 acceptances (1,000 of 6,000
    there)."""
    scales = torch.tensor([100.0, 1.0, 1.0, 0.01], dtype=F64)

    def log_post(params, tree):
        return -0.5 * torch.sum((params["x"] / scales) ** 2)

    op = HmcOperator(parameters=("x",), n_leapfrog=15, step_size=0.5,
                     precondition="low_rank", low_rank=2,
                     log_transform=False)
    step = make_mcmc_step(log_post, [op])
    st = init_mcmc_state({"x": torch.zeros(4, dtype=F64)}, _dummy_tree(),
                         torch.Generator().manual_seed(1), [op], log_post)
    st, out = run_chain(step, st, 1500, collect_every=25,
                        collector=lambda s: {"x": s.params["x"]})
    sd = out["x"].numpy().std(0)
    assert 30.0 < sd[0] < 300.0, sd
    assert 0.003 < sd[3] < 0.03, sd
    assert int(st.op_accept.sum()) > 250


def test_diag_preconditioning_mass_is_hessian_diagonal():
    """precondition="diag": the mass is |diag(Hessian)| of the potential
    at the start point, against the JAX Hessian of the same Gaussian."""
    scales = np.array([10.0, 1.0, 0.1])
    op = HmcOperator(parameters=("x",), precondition="diag",
                     log_transform=False)
    op.bind_log_posterior(lambda p, t: -0.5 * torch.sum(
        (p["x"] / torch.tensor(scales)) ** 2 + p["x"][0] * p["x"][1]))
    params = batch_of_one({"x": torch.tensor([0.3, -0.2, 0.5], dtype=F64)})
    u = op.neg_log_density(op.one_chain_posterior(), params,
                           batch_of_one(_dummy_tree()))
    velocity, _, _ = op._mass(u, op._pack(params))
    ref = np.diag(np.asarray(jax.hessian(lambda x: 0.5 * jnp.sum(
        (x / scales) ** 2 + x[0] * x[1]))(jnp.asarray([0.3, -0.2, 0.5]))))
    np.testing.assert_allclose(
        velocity(torch.ones(1, 3, dtype=F64))[0].numpy(), 1.0 / np.abs(ref),
        rtol=1e-12)


def test_gtr_chain_with_both_hmc_operators():
    """build_analysis(12, 64)'s chain with NodeHeightHmcOperator and
    HmcOperator(("clock.rate", "pop.size")) added to its operators: both
    bound by make_mcmc_step, both accept, the full-evaluation deviation
    stays under the reference's 0.1; an HMC operator on a parameter a
    derived cache depends on is refused."""
    log_post, ops, p0, t0, aux = build_analysis(12, 64, device="cpu",
                                                dtype=F64)
    hmc = [NodeHeightHmcOperator(weight=8.0, n_leapfrog=5),
           HmcOperator(parameters=("clock.rate", "pop.size"), weight=4.0,
                       n_leapfrog=5)]
    ops = ops + hmc
    lpc = aux["log_post_cached"]
    step = make_mcmc_step(lpc, ops, derived=aux["derived"])
    assert all(op._log_posterior is lpc for op in hmc)
    st = init_mcmc_state(p0, t0, torch.Generator().manual_seed(0), ops, lpc)
    st, _ = run_chain(step, st, 300)
    st, dev = full_evaluation_check(step, log_post, st, 60,
                                    derived=aux["derived"])
    assert float(dev) < 0.1
    assert math.isfinite(float(st.log_posterior))
    assert int(st.op_accept[-2]) > 0 and int(st.op_accept[-1]) > 0
    with pytest.raises(ValueError, match="derived"):
        make_mcmc_step(lpc, [HmcOperator(parameters=("alpha",))],
                       derived=aux["derived"])


def test_operator_settings_carry_across():
    """convert.operator_from: the JAX HMC operators' settings, transforms
    included, become the port's operators of the same class, as do the
    other operators' (the uniform real move); an
    operator with no counterpart yet raises."""
    from beast_mcmc_tpu.inference import hmc as jhmc
    from beast_mcmc_tpu.inference import operators as jops

    from beast_mcmc_tpu_torch.convert import operator_from

    op = operator_from(jhmc.HmcOperator(
        parameters=("kappa", "pi"), n_leapfrog=7, step_size=0.05,
        precondition="diag", weight=3.0, log_transform=False,
        transform=jt.ArrayTransform(blocks=[(jt.LogTransform(), 1),
                                            (jt.SimplexTransform(k=3), 3)])))
    assert isinstance(op, HmcOperator)
    assert (op.parameters, op.n_leapfrog, op.step_size, op.precondition,
            op.weight, op.log_transform) == (("kappa", "pi"), 7, 0.05,
                                             "diag", 3.0, False)
    assert op.transform == tt.ArrayTransform(
        blocks=[(tt.LogTransform(), 1), (tt.SimplexTransform(k=3), 3)])
    node = operator_from(jhmc.NodeHeightHmcOperator(step_size=0.01,
                                                    n_leapfrog=4))
    assert isinstance(node, NodeHeightHmcOperator)
    assert (node.step_size, node.n_leapfrog) == (0.01, 4)
    assert node.modified_params() == ()
    scale = operator_from(jops.ScaleOperator(parameter="alpha", weight=2.0))
    assert (type(scale).__name__, scale.parameter, scale.weight) == (
        "ScaleOperator", "alpha", 2.0)
    uniform = operator_from(jops.UniformRealOperator(parameter="x",
                                                     lower=0.5, upper=2.0))
    assert (type(uniform).__name__, uniform.lower, uniform.upper) == (
        "UniformRealOperator", 0.5, 2.0)
    # every class of inference/gibbs.py maps to the port's gibbs.py
    from beast_mcmc_tpu.inference import gibbs as jgibbs
    from beast_mcmc_tpu_torch.inference import gibbs
    block = operator_from(jgibbs.GmrfBlockUpdateOperator(
        field="g", precision="tau", n_taxa=5, cut_points=(0.5, 1.0)))
    assert isinstance(block, gibbs.GmrfBlockUpdateOperator)
    assert (block.field, block.n_taxa, block.cut_points) == ("g", 5,
                                                            (0.5, 1.0))
    assert isinstance(operator_from(jgibbs.EllipticalSliceOperator()),
                      gibbs.EllipticalSliceOperator)
    assert isinstance(operator_from(jgibbs.InternalTraitGibbsOperator()),
                      gibbs.InternalTraitGibbsOperator)

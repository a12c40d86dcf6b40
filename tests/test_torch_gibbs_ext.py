"""The port's inference/gibbs.py (its conjugate draws and trait moves) and
inference/bridge_gibbs.py against the JAX package's.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - NormalNormalMeanGibbs, NormalGammaPrecisionGibbs,
    InternalTraitGibbsOperator, PrecisionWishartGibbsOperator and
    LatentLiabilityGibbsOperator: the proposal given the same normals,
    gammas and integers in both packages (JAX's jax.random draws and the
    port's gibbs._normal, _gamma and _randint replaced), to 1e-12; the
    latent liability where the first draw is inside its box, where a later
    one is and where none is (rejected);
  - each over a chain batch (make_multichain_step's vmapped proposal,
    each chain with its own tree and values) against single chains at the
    same draws, and a short multichain run of all five on real draws;
  - a singular precision rejects the proposal (-inf), where JAX's NaNs do;
  - the Bayesian bridge: `tilted_stable` and `draw_local_scales` from one
    numpy seed equal JAX's exactly; the operator's global and local scales
    given the same gamma variate and seed; its chain-axis proposal against
    single chains;
  - convert.operator_from carries each JAX operator across to the port's
    class of its name.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.inference import bridge_gibbs as jbridge
from beast_mcmc_tpu.inference import gibbs as jgibbs
from beast_mcmc_tpu.tree.topology import (
    make_tree_state as j_tree_state,
    simulate_coalescent_tree,
)

from beast_mcmc_tpu_torch.convert import operator_from
from beast_mcmc_tpu_torch.inference import bridge_gibbs, gibbs
from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
from beast_mcmc_tpu_torch.inference.mcmc import (
    TREE_FIELDS,
    _propose_chains,
    init_mcmc_state,
    make_multichain_step,
    run_chain,
)
from beast_mcmc_tpu_torch.tree.topology import TreeState, make_tree_state

F64 = torch.float64
N_TIPS, D = 6, 2
M = 2 * N_TIPS - 1
LAM = np.array([[1.5, 0.4], [0.4, 0.8]])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(seed):
    tr = simulate_coalescent_tree(np.random.default_rng(seed),
                                  np.zeros(N_TIPS), 1.0)
    return j_tree_state(*tr, jnp.float64), make_tree_state(*tr, F64, "cpu")


def _inject(monkeypatch, normals=(), gammas=(), ints=(), port_normals=None):
    """Both packages' draws replaced by the given values, in order: JAX's
    jax.random.normal, gamma and randint (its lax.while_loop run eagerly,
    a draw an attempt), the port's gibbs._normal, _gamma and _randint
    (`port_normals`, where the port draws another shape: all of the
    liability's attempts at once)."""
    qs = {k: (list(v), list(v)) for k, v in
          (("n", normals), ("g", gammas), ("i", ints))}
    if port_normals is not None:
        qs["n"] = (list(normals), [port_normals])

    def j_normal(key, shape=(), dtype=jnp.float64, *a, **k):
        return jnp.asarray(qs["n"][0].pop(0), dtype).reshape(shape)

    def j_gamma(key, a, shape=None, dtype=jnp.float64, *x, **k):
        return jnp.asarray(qs["g"][0].pop(0), dtype).reshape(jnp.shape(a))

    def j_randint(key, shape, minval, maxval, dtype=jnp.int32, *a, **k):
        return jnp.asarray(qs["i"][0].pop(0), dtype).reshape(shape)

    def py_while(cond, body, val):  # eager, so that each attempt draws
        while bool(cond(val)):
            val = body(val)
        return val

    monkeypatch.setattr(jax.random, "normal", j_normal)
    monkeypatch.setattr(jax.random, "gamma", j_gamma)
    monkeypatch.setattr(jax.random, "randint", j_randint)
    monkeypatch.setattr(jax.lax, "while_loop", py_while)
    monkeypatch.setattr(gibbs, "_normal", lambda gen, like, shape=():
                        torch.as_tensor(qs["n"][1].pop(0), dtype=like.dtype)
                        .reshape(shape))
    monkeypatch.setattr(gibbs, "_gamma", lambda gen, a, like, size=():
                        torch.as_tensor(qs["g"][1].pop(0), dtype=like.dtype)
                        .reshape(size))
    monkeypatch.setattr(gibbs, "_randint", lambda gen, lo, hi, like:
                        torch.tensor([qs["i"][1].pop(0)]))


def _j_prec(p):
    return jnp.asarray(LAM) * p["s"]


def _t_prec(p):
    return torch.as_tensor(LAM, dtype=p["s"].dtype) * p["s"]


def _cases(rng):
    """{name: (JAX operator, port operator, params as numpy, draws)}; the
    draws: (normals, gammas, ints, the port's normals or None)."""
    w = rng.uniform(-0.3, 0.3, (N_TIPS, N_TIPS))
    np.fill_diagonal(w, 0.0)
    liab = dict(trait_param="z", dim=D, n_tips=N_TIPS, cond_weights=w,
                cond_scale=rng.uniform(0.5, 1.5, N_TIPS),
                mu0=np.array([0.2, -0.1]),
                lo=np.full((N_TIPS, D), -3.0), hi=np.full((N_TIPS, D), 3.0),
                max_attempts=4)
    zs = rng.normal(size=(4, D))
    inside = np.array([0.05, 0.02])  # a draw the box keeps; z + 9 it drops
    mean_op = dict(mean_param="mu", data_params=("x", "y"), prior_mean=0.3,
                   prior_stdev=1.7)
    prec_op = dict(precision_param="tau", data_params=("x", "y"),
                   prior_shape=2.0, prior_scale=0.5)
    return {
        "normal mean": (
            jgibbs.NormalNormalMeanGibbs(precision_of=lambda p: p["tau"],
                                         **mean_op),
            gibbs.NormalNormalMeanGibbs(precision_of=lambda p: p["tau"],
                                        **mean_op),
            ([0.37], [], [], None)),
        "gamma precision": (
            jgibbs.NormalGammaPrecisionGibbs(mean_of=lambda p: p["mu"],
                                             **prec_op),
            gibbs.NormalGammaPrecisionGibbs(mean_of=lambda p: p["mu"],
                                            **prec_op),
            ([], [3.1], [], None)),
        "internal trait": (
            jgibbs.InternalTraitGibbsOperator(trait_param="t", dim=D,
                                              n_tips=N_TIPS,
                                              prec_of=_j_prec),
            gibbs.InternalTraitGibbsOperator(trait_param="t", dim=D,
                                             n_tips=N_TIPS, prec_of=_t_prec),
            ([rng.normal(size=D)], [], [2], None)),
        "wishart": (
            jgibbs.PrecisionWishartGibbsOperator(
                trait_param="t", dim=D, col_params=("c1", "c2"),
                prior_df=3.0, prior_scale=np.array([[1.0, 0.2],
                                                    [0.2, 2.0]])),
            gibbs.PrecisionWishartGibbsOperator(
                trait_param="t", dim=D, col_params=("c1", "c2"),
                prior_df=3.0, prior_scale=np.array([[1.0, 0.2],
                                                    [0.2, 2.0]])),
            ([rng.normal(size=(D, D))], [rng.uniform(2.0, 6.0, D)], [],
             None)),
        "liability first": (
            jgibbs.LatentLiabilityGibbsOperator(prec_of=_j_prec, **liab),
            gibbs.LatentLiabilityGibbsOperator(prec_of=_t_prec, **liab),
            ([inside], [], [3], np.vstack([inside, zs[1:]]))),
        "liability third": (
            jgibbs.LatentLiabilityGibbsOperator(prec_of=_j_prec, **liab),
            gibbs.LatentLiabilityGibbsOperator(prec_of=_t_prec, **liab),
            ([zs[0] + 9.0, zs[1] - 9.0, inside], [], [1],
             np.vstack([zs[0] + 9.0, zs[1] - 9.0, inside, zs[3]]))),
        "liability none": (
            jgibbs.LatentLiabilityGibbsOperator(prec_of=_j_prec, **liab),
            gibbs.LatentLiabilityGibbsOperator(prec_of=_t_prec, **liab),
            ([zs[k] + 9.0 for k in range(4)], [], [0], zs + 9.0)),
    }


def _params(rng):
    return {"mu": np.array(0.4), "tau": np.array(1.3),
            "x": rng.normal(0.5, 1.0, 5), "y": rng.normal(0.5, 1.0, (2, 2)),
            "t": rng.normal(size=M * D), "c1": np.array([1.0, 0.1]),
            "c2": np.array([0.1, 1.0]), "s": np.array(0.9),
            "z": rng.uniform(-0.3, 0.5, (N_TIPS, D))}


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _t(params):
    return {k: torch.as_tensor(v, dtype=F64) for k, v in params.items()}


CASES = sorted(_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("name", CASES)
def test_proposal_matches_jax(name, monkeypatch):
    rng = np.random.default_rng(5)
    jop, op, (normals, gammas, ints, port_n) = _cases(rng)[name]
    params = _params(rng)
    jtree, tree = _trees(3)
    _inject(monkeypatch, normals, gammas, ints, port_n)
    jp, _, jh = jop.propose(_j(params), jtree, jax.random.PRNGKey(0), None)
    tp, tt, th = op.propose(_t(params), tree, None, None)
    assert tt is tree
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-12, atol=1e-14, err_msg=k)
    np.testing.assert_allclose(float(th), float(jh), rtol=1e-12, atol=1e-12)
    if name == "liability none":
        assert float(th) == -math.inf
    if name.startswith("liability") and name != "liability none":
        assert math.isfinite(float(th))


@pytest.mark.parametrize("name", ["internal trait", "wishart",
                                  "liability first"])
def test_singular_precision_rejects(name, monkeypatch):
    """A singular diffusion precision (s = 0): the port rejects the move
    (log Hastings -inf) where torch.linalg would raise; the values it
    proposes are not finite, as JAX's are."""
    rng = np.random.default_rng(5)
    jop, op, (normals, gammas, ints, port_n) = _cases(rng)[name]
    params = _params(rng)
    params["s"] = np.array(0.0)
    if name == "wishart":  # a singular prior scale
        op = gibbs.PrecisionWishartGibbsOperator(
            trait_param="t", dim=D, col_params=("c1", "c2"), prior_df=3.0,
            prior_scale=np.zeros((D, D)))
    _, tree = _trees(3)
    _inject(monkeypatch, normals, gammas, ints, port_n)
    tp, _, th = op.propose(_t(params), tree, None, None)
    assert float(th) == -math.inf


def _batch(trees):
    return TreeState(*(torch.stack([getattr(t, f) for t in trees])
                       for f in TREE_FIELDS))


@pytest.mark.parametrize("name", CASES)
def test_chain_batch_equals_single_chains(name, monkeypatch):
    """Three chains, each with its own tree and values, through
    make_multichain_step's vmapped proposal, against three single
    proposals at the same draws."""
    b_n = 3
    rng = np.random.default_rng(8)
    _, op, draws = _cases(rng)[name]
    chains = [_t(_params(rng)) for _ in range(b_n)]
    trees = [_trees(10 + b)[1] for b in range(b_n)]
    params = {k: torch.stack([c[k] for c in chains]) for k in chains[0]}
    _inject(monkeypatch, *draws)
    p_b, t_b, logh_b, _ = _propose_chains(op, params, _batch(trees), None,
                                          None)
    assert t_b is None
    for b in range(b_n):
        _inject(monkeypatch, *draws)
        p1, _, logh1 = op.propose(chains[b], trees[b], None, None)
        for k in p_b:
            torch.testing.assert_close(p_b[k][b], p1[k], rtol=1e-12,
                                       atol=1e-14)
        torch.testing.assert_close(logh_b[b], logh1.to(logh_b.dtype),
                                   rtol=1e-12, atol=1e-12)


def test_multichain_run_on_real_draws():
    """All five operators in one multichain step over three chains, 40
    steps on their own draws from the generator (a vmapped proposal each,
    no host read): every proposal finite or rejected, the carried
    posterior equal to a fresh one."""
    rng = np.random.default_rng(2)
    cases = _cases(rng)
    ops = [cases[k][1] for k in ("normal mean", "gamma precision",
                                 "internal trait", "wishart",
                                 "liability first")]
    _, tree = _trees(3)

    def lp(params, tree):
        return (-0.5 * torch.sum(params["t"] ** 2, -1)
                - 0.5 * torch.sum(params["z"].flatten(-2) ** 2, -1)
                - 0.5 * params["mu"] ** 2 - params["tau"]
                + torch.sum(params["c1"] + params["c2"], -1) * 0.0)

    st = init_mcmc_state(_t(_params(rng)), tree,
                         torch.Generator().manual_seed(1), ops, lp)
    states = replicate_state(st, 3, torch.Generator().manual_seed(4))
    mstep = make_multichain_step(lp, ops)
    states, _ = run_chain(mstep, states, 40)
    fresh = lp(states.params, states.tree)
    torch.testing.assert_close(states.log_posterior, fresh.to(
        states.log_posterior.dtype), rtol=1e-12, atol=1e-12)
    assert int(states.op_accept.sum()) > 0


# ---------------------------------------------------------------------------
# the Bayesian bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma,tilt", [(0.125, 0.01), (0.125, 30.0),
                                        (0.4, 2.0), (0.4, 500.0)])
def test_tilted_stable_equals_jax(gamma, tilt):
    for seed in range(3):
        assert (bridge_gibbs.tilted_stable(np.random.default_rng(seed),
                                           gamma, tilt)
                == jbridge.tilted_stable(np.random.default_rng(seed), gamma,
                                         tilt))
    draws = bridge_gibbs._one_sided_stable(np.random.default_rng(7), gamma,
                                           (50,))
    np.testing.assert_array_equal(
        draws, jbridge._one_sided_stable(np.random.default_rng(7), gamma,
                                         (50,)))


def test_draw_local_scales_equals_jax():
    r2 = np.random.default_rng(1).gamma(0.5, 4.0, 12)
    for seed in (0, 123, 2 ** 31 - 2):
        np.testing.assert_array_equal(
            bridge_gibbs.draw_local_scales(seed, 0.125, r2),
            jbridge.draw_local_scales(seed, 0.125, r2))


BRIDGE = dict(coefficient="beta", global_scale="g", local_scale="l",
              exponent=0.25, prior_shape=1.0, prior_scale=2.0)


@pytest.mark.parametrize("local", ["l", ""])
def test_bridge_proposal_matches_jax(local, monkeypatch):
    """The global scale given JAX's gamma variate and the local scales
    given its seed (JAX's pure_callback on its randint): equal to 1e-12;
    a declared local scale longer than the coefficients keeps its tail."""
    rng = np.random.default_rng(3)
    beta = rng.normal(0.0, 0.5, 5)
    params = {"beta": beta, "g": np.array(0.7),
              "l": rng.uniform(0.5, 2.0, 7)}
    kw = {**BRIDGE, "local_scale": local}
    _, tree = _trees(1)
    jtree, _ = _trees(1)
    monkeypatch.setattr(jax.random, "gamma",
                        lambda key, a, shape=None, dtype=jnp.float64:
                        jnp.asarray(2.7, dtype))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, dtype=jnp.int32:
                        jnp.asarray(424242, dtype))
    monkeypatch.setattr(bridge_gibbs, "_gamma", lambda gen, a, like, size=():
                        torch.full(size, 2.7, dtype=like.dtype))
    monkeypatch.setattr(bridge_gibbs, "_seeds", lambda gen, n, like:
                        torch.full((n,), 424242))
    jp, _, jh = jbridge.BayesianBridgeGibbsOperator(**kw).propose(
        _j(params), jtree, jax.random.PRNGKey(0), None)
    tp, _, th = bridge_gibbs.BayesianBridgeGibbsOperator(**kw).propose(
        _t(params), tree, torch.Generator(), None)
    assert float(th) == float(jh) == math.inf
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-12, err_msg=k)
    if local:
        np.testing.assert_array_equal(tp["l"][5:].numpy(), params["l"][5:])
        assert not np.allclose(tp["l"][:5].numpy(), params["l"][:5])


def test_bridge_chain_batch_equals_single_chains(monkeypatch):
    """make_multichain_step takes the bridge's own chain-axis proposal
    (its host draw cannot be vmapped): three chains' global scales from
    one gamma draw of [3] and local scales from one seed a chain, against
    single chains given their part; and a short batch run on real draws."""
    b_n = 3
    rng = np.random.default_rng(6)
    chains = [_t({"beta": rng.normal(0.0, 0.5, 5), "g": np.array(0.7),
                  "l": rng.uniform(0.5, 2.0, 5)}) for _ in range(b_n)]
    params = {k: torch.stack([c[k] for c in chains]) for k in chains[0]}
    trees = [_trees(20 + b)[1] for b in range(b_n)]
    op = bridge_gibbs.BayesianBridgeGibbsOperator(**BRIDGE)
    gam = torch.tensor([1.5, 2.5, 4.0], dtype=F64)
    seeds = torch.tensor([11, 22, 33])
    pick = [None]

    def g(gen, a, like, size=()):
        return gam if pick[0] is None else gam[pick[0]:pick[0] + 1]

    def s(gen, n, like):
        return seeds if pick[0] is None else seeds[pick[0]:pick[0] + 1]

    monkeypatch.setattr(bridge_gibbs, "_gamma", g)
    monkeypatch.setattr(bridge_gibbs, "_seeds", s)
    mstep = make_multichain_step(lambda p, t: torch.zeros(
        p["g"].shape[0], dtype=F64), [op])
    st = init_mcmc_state(chains[0], trees[0], torch.Generator(), [op])
    batch = replicate_state(st, b_n, torch.Generator()).replace(
        params=params, tree=_batch(trees))
    out = mstep(batch)
    for b in range(b_n):
        pick[0] = b
        p1, _, _ = op.propose(chains[b], trees[b], None, None)
        for k in ("g", "l"):
            torch.testing.assert_close(out.params[k][b], p1[k], rtol=1e-12,
                                       atol=0.0)
    monkeypatch.undo()
    out, _ = run_chain(mstep, batch, 5)
    assert torch.isfinite(out.params["l"]).all()
    assert (out.params["g"] > 0).all()


@pytest.mark.parametrize("jop", [
    jgibbs.NormalNormalMeanGibbs(mean_param="mu", data_params=("x",),
                                 prior_mean=1.0, prior_stdev=2.0,
                                 weight=3.0),
    jgibbs.NormalGammaPrecisionGibbs(precision_param="tau",
                                     data_params=("x",), prior_shape=2.0,
                                     prior_scale=0.5),
    jgibbs.InternalTraitGibbsOperator(trait_param="t", dim=2, n_tips=6),
    jgibbs.PrecisionWishartGibbsOperator(trait_param="t", dim=2,
                                         col_params=("a", "b"),
                                         prior_df=4.0),
    jgibbs.LatentLiabilityGibbsOperator(trait_param="z", dim=2, n_tips=6,
                                        max_attempts=9),
    jbridge.BayesianBridgeGibbsOperator(coefficient="b", global_scale="g",
                                        local_scale="l", exponent=0.5),
], ids=lambda o: type(o).__name__)
def test_operator_settings_carry_across(jop):
    op = operator_from(jop)
    assert type(op).__name__ == type(jop).__name__
    assert type(op).__module__.rsplit(".", 1)[1] == \
        type(jop).__module__.rsplit(".", 1)[1]
    for f in (f for f in op.__dataclass_fields__ if not f.startswith("_")):
        got, ref = getattr(op, f), getattr(jop, f)
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(got, ref)
        else:
            assert got == ref, f
    assert op.modified_params() == jop.modified_params()

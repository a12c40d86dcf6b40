"""The parameter and composite operators of beast_mcmc_tpu/inference/
operators.py that the earlier slices left, against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - move by move: for 250 JAX keys each, JAX's own draws injected into the
    port's proposal (its draw helpers replaced by a queue) give JAX's
    parameters to 1e-15 relative and its log Hastings to 1e-12 (the
    normal-gamma draw injected as JAX's gamma variate);
  - the gamma sampler's law (`gamma_draw`, Marsaglia-Tsang on the
    operator's generator) against scipy.stats.gamma by Kolmogorov-Smirnov,
    below shape 1 and above;
  - the two conjugate Gibbs operators' draws against the closed-form
    posterior mean and variance, and their acceptance statistic 1 on a
    chain batch as on one chain;
  - a chain batch (make_multichain_step's vmapped proposal) gives each
    chain what one chain gives at the same draws, for every operator here
    and every tree operator of the slice (`Replay`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from beast_mcmc_tpu.inference import operators as jops
from beast_mcmc_tpu.tree.topology import make_tree_state as jax_tree_state
from beast_mcmc_tpu.utils import transforms as jtr

from beast_mcmc_tpu_torch.inference import operators as ops
from beast_mcmc_tpu_torch.inference import tree_operators as tops
from beast_mcmc_tpu_torch.inference.mc3 import replicate_state
from beast_mcmc_tpu_torch.inference.mcmc import (
    _propose_chains,
    init_mcmc_state,
    make_mcmc_step,
    make_multichain_step,
    map_tensors,
)
from beast_mcmc_tpu_torch.tree.topology import TreeState, make_tree_state
from beast_mcmc_tpu_torch.utils import transforms as tr

F64 = torch.float64
N_KEYS = 250
FIELDS = ("parent", "children", "heights", "root")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _star(n=5, h=1.0):
    """A tree on n tips at 0 whose internal nodes all sit at heights near
    h (a caterpillar; numpy)."""
    m = 2 * n - 1
    parent, children = np.full(m, -1), np.full((m, 2), -1)
    for i in range(1, n):
        children[n + i - 1] = (n + i - 2 if i > 1 else 0, i)
        parent[children[n + i - 1]] = n + i - 1
    heights = np.r_[np.zeros(n), h + 0.01 * np.arange(n - 1)]
    return parent, children, heights, m - 1


class Queue:
    """The port's draw helpers replaced by a queue of given draws, popped
    in the order the proposal calls them."""

    def __init__(self, monkeypatch):
        self.items = []
        for mod in (ops, tops):
            monkeypatch.setattr(mod, "_randint", self._randint)
            monkeypatch.setattr(mod, "_uniform", self._uniform)
            monkeypatch.setattr(mod, "_normal", self._normal)
        monkeypatch.setattr(ops, "_uniforms", self._uniforms)
        monkeypatch.setattr(ops, "gamma_draw", lambda gen, shape, like:
                            torch.tensor(float(self.items.pop(0)),
                                         dtype=like.dtype))

    def _randint(self, gen, low, high, device):
        v = int(self.items.pop(0))
        assert low <= v < high
        return torch.tensor([v], device=device)

    def _uniform(self, gen, like):
        return torch.tensor(float(self.items.pop(0)), dtype=like.dtype)

    def _normal(self, gen, like, shape=()):
        return torch.tensor(np.reshape(self.items.pop(0), shape),
                            dtype=like.dtype)

    def _uniforms(self, gen, like, shape):
        return torch.tensor(np.reshape(self.items.pop(0), shape),
                            dtype=like.dtype)


def _u(key):
    return jax.random.uniform(key, dtype=jnp.float64)


def _ri(key, n):
    return jax.random.randint(key, (), 0, n)


def _split(key, n=2):
    return jax.random.split(key, n)


# name: (JAX operator, port operator, params, tuning, draws(key)): draws
# in the port's order, JAX's keys split as JAX's proposal splits them
SPLITS = {
    "transformed_random_walk": lambda k: (lambda a, b: [_ri(a, 3), _u(b)])(
        *_split(k)),
    "star_root_height_scale": lambda k: [_u(k)],
    "uniform_real": lambda k: (lambda a, b: [_ri(a, 3), _u(b)])(*_split(k)),
    "compound_weighted_delta": lambda k: (lambda a, b, c: [
        _ri(a, 3), _ri(b, 2), _u(c)])(*_split(k, 3)),
    "mvn_random_walk": lambda k: [jax.random.normal(k, (3,), jnp.float64)],
    "subset_random_walk": lambda k: (lambda a, b: [_ri(a, 2), _u(b)])(
        *_split(k)),
    "rate_bit_exchange": lambda k: [_ri(k, 3)],
    "normal_normal_mean": lambda k: [jax.random.normal(k, dtype=jnp.float64)],
    "normal_gamma_precision": lambda k: [jax.random.gamma(
        k, 0.001 + 0.5 * 3, dtype=jnp.float64)],
}


def _joint_draws(key):
    k, s1 = _split(key)
    _, s2 = _split(k)
    return [*(lambda a, b: [_ri(a, 3), _u(b)])(*_split(s1)),
            *(lambda a, b: [_ri(a, 3), _u(b)])(*_split(s2))]


def _team_draws(key, n_subs=3, n_pick=2):
    k_perm, key = _split(key)
    perm = jax.random.permutation(k_perm, n_subs)
    # the uniforms whose order is JAX's permutation
    u = jnp.zeros(n_subs).at[perm].set((jnp.arange(n_subs) + 0.5) / n_subs)
    out = [u]
    for _ in range(n_pick):
        key, k_op = _split(key)
        out += [*SPLITS["uniform_real"](k_op),
                *SPLITS["subset_random_walk"](k_op),
                *SPLITS["rate_bit_exchange"](k_op)]
    return out


CHOL = np.array([[0.5, 0.0, 0.0], [0.2, 0.3, 0.0], [-0.1, 0.05, 0.4]])


def _param_cases():
    x = np.array([0.7, 1.3, 2.1])
    bits, rates = np.array([1.0, 0.0, 0.0, 1.0, 1.0, 0.0]), np.arange(1.0, 7)
    p = {"x": x, "y": np.array(0.4), "z": np.array(1.9), "bits": bits,
         "rates": rates, "data": np.array([0.3, -1.2, 0.8]),
         "mu": np.array(0.1), "tau": np.array(2.0)}
    jx_tr = jtr.LogTransform()
    return {
        "transformed_random_walk": (
            jops.TransformedRandomWalkOperator(parameter="x",
                                               transform=jx_tr),
            ops.TransformedRandomWalkOperator(parameter="x",
                                              transform=tr.LogTransform()),
            p, 0.8),
        "star_root_height_scale": (
            jops.StarRootHeightScaleOperator(n_taxa=5),
            ops.StarRootHeightScaleOperator(n_taxa=5), p, 0.6),
        "uniform_real": (
            jops.UniformRealOperator(parameter="x", lower=0.5, upper=3.0),
            ops.UniformRealOperator(parameter="x", lower=0.5, upper=3.0), p,
            None),
        "compound_weighted_delta": (
            jops.CompoundWeightedDeltaOperator(
                parameters=("y", "z", "mu"),
                parameter_weights=(1.0, 2.0, 0.5)),
            ops.CompoundWeightedDeltaOperator(
                parameters=("y", "z", "mu"),
                parameter_weights=(1.0, 2.0, 0.5)),
            p, 0.9),
        "mvn_random_walk": (
            jops.MvnRandomWalkOperator(parameter="x", chol=CHOL),
            ops.MvnRandomWalkOperator(parameter="x", chol=CHOL), p, 0.7),
        "subset_random_walk": (
            jops.SubsetRandomWalkOperator(parameter="rates", indices=(1, 4)),
            ops.SubsetRandomWalkOperator(parameter="rates", indices=(1, 4)),
            p, 0.5),
        "rate_bit_exchange": (
            jops.RateBitExchangeOperator(bit_parameter="bits",
                                         rate_parameter="rates"),
            ops.RateBitExchangeOperator(bit_parameter="bits",
                                        rate_parameter="rates"), p, None),
        "normal_normal_mean": (
            jops.NormalNormalMeanGibbsOperator(
                data_parameter="data", mean_parameter="mu",
                precision_parameter="tau", prior_mean=0.5,
                prior_precision=0.1),
            ops.NormalNormalMeanGibbsOperator(
                data_parameter="data", mean_parameter="mu",
                precision_parameter="tau", prior_mean=0.5,
                prior_precision=0.1), p, None),
        "normal_gamma_precision": (
            jops.NormalGammaPrecisionGibbsOperator(
                data_parameter="data", mean_parameter="mu",
                precision_parameter="tau"),
            ops.NormalGammaPrecisionGibbsOperator(
                data_parameter="data", mean_parameter="mu",
                precision_parameter="tau"), p, None),
        "joint": (
            jops.JointOperator(sub_operators=[
                jops.TransformedRandomWalkOperator(parameter="x",
                                                   transform=jx_tr),
                jops.UniformRealOperator(parameter="x", lower=0.5,
                                         upper=3.0)]),
            ops.JointOperator(sub_operators=[
                ops.TransformedRandomWalkOperator(
                    parameter="x", transform=tr.LogTransform()),
                ops.UniformRealOperator(parameter="x", lower=0.5,
                                        upper=3.0)]), p, None),
        "team": (
            jops.TeamOperator(n_pick=2, sub_operators=[
                jops.UniformRealOperator(parameter="x", lower=0.5, upper=3.0),
                jops.SubsetRandomWalkOperator(parameter="rates",
                                              indices=(1, 4)),
                jops.RateBitExchangeOperator(bit_parameter="bits",
                                             rate_parameter="rates")]),
            ops.TeamOperator(n_pick=2, sub_operators=[
                ops.UniformRealOperator(parameter="x", lower=0.5, upper=3.0),
                ops.SubsetRandomWalkOperator(parameter="rates",
                                             indices=(1, 4)),
                ops.RateBitExchangeOperator(bit_parameter="bits",
                                            rate_parameter="rates")]),
            p, None),
    }


CASES = _param_cases()
DRAWS = {**SPLITS, "joint": _joint_draws, "team": _team_draws}


@pytest.mark.parametrize("name", sorted(CASES))
def test_injected_draws_match_jax(monkeypatch, name):
    """For 250 JAX keys: JAX's proposal against the port's at JAX's draws,
    every parameter to 1e-15 relative (1e-16 absolute near 0), the log
    Hastings to 1e-12 (or the same infinity), the tree's heights as JAX's;
    each operator that rejects here does so for some keys and not for
    others."""
    j_op, t_op, params, tuning = CASES[name]
    tree_np = _star()
    j_tree = jax_tree_state(*tree_np, dtype=jnp.float64)
    t_tree = make_tree_state(*tree_np, F64, "cpu")
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    tun_j = 1.0 if tuning is None else tuning

    def jax_side(key):
        out = j_op.propose(j_params, j_tree, key, tun_j)
        return out[0], out[1].heights, out[2], DRAWS[name](key)

    keys = jax.random.split(jax.random.PRNGKey(11), N_KEYS)
    j_p, j_h, j_logq, j_draws = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(jax_side))(keys))
    queue = Queue(monkeypatch)
    t_params = {k: torch.tensor(v) for k, v in params.items()}
    tun = None if tuning is None else torch.tensor(tuning, dtype=F64)
    finite = 0
    for n in range(N_KEYS):
        queue.items = [d[n] for d in j_draws]
        p2, t2, logq, *acc = t_op.propose(t_params, t_tree, None, tun)
        assert not queue.items
        ref, got = float(j_logq[n]), float(logq)
        finite += ref > -math.inf
        if math.isfinite(ref):
            assert got == pytest.approx(ref, rel=1e-12, abs=1e-12), n
        else:
            assert got == ref, n
        for k in params:
            # XLA may fuse a product and a sum: an ulp of the larger term
            np.testing.assert_allclose(p2[k].numpy(), j_p[k][n], rtol=1e-15,
                                       atol=1e-16)
        np.testing.assert_allclose(t2.heights.numpy(), j_h[n], rtol=1e-15)
        if acc:
            assert float(acc[0]) == 1.0
    assert finite > 0
    if name in ("compound_weighted_delta", "rate_bit_exchange"):
        assert finite < N_KEYS


@pytest.mark.parametrize("shape", [0.3, 1.0, 4.5, 1503.0])
def test_gamma_draw_law(shape):
    """8,000 draws at each shape from one generator, Kolmogorov-Smirnov
    against scipy.stats.gamma(shape) with p > 0.001; all positive."""
    g = ops.gamma_draw(torch.Generator().manual_seed(int(shape * 10)),
                       shape, torch.zeros((), dtype=F64), (8000,))
    assert (g > 0).all()
    assert scipy.stats.kstest(g.numpy(), scipy.stats.gamma(shape).cdf
                              ).pvalue > 1e-3


def _conjugate_ops():
    kw = {"data_parameter": "data", "mean_parameter": "mu",
          "precision_parameter": "tau"}
    return (ops.NormalGammaPrecisionGibbsOperator(prior_shape=2.0,
                                                  prior_rate=1.5, **kw),
            ops.NormalNormalMeanGibbsOperator(prior_mean=0.5,
                                              prior_precision=0.2, **kw))


def test_conjugate_gibbs_closed_form():
    """Each conjugate draw, 4,000 times over a batch of 4,000 chains at
    fixed data, mean and precision: the sample mean and variance within 5
    standard errors of the closed forms (tau: Gamma(a + n/2, b + S/2), mean
    shape / rate, variance shape / rate^2; mu: N((p0 m0 + tau sum x) / P,
    1 / P), P = p0 + n tau); log Hastings +inf, statistic 1."""
    data = np.array([0.3, -1.2, 0.8, 2.2, 1.1])
    b_n = 4000
    params = {"data": torch.tensor(np.tile(data, (b_n, 1))),
              "mu": torch.full((b_n,), 0.4, dtype=F64),
              "tau": torch.full((b_n,), 1.7, dtype=F64)}
    tree = make_tree_state(*_star(), F64, "cpu")
    trees = TreeState(*(getattr(tree, f).expand(b_n, *getattr(tree, f).shape)
                        for f in FIELDS))
    gamma_op, normal_op = _conjugate_ops()
    gen = torch.Generator().manual_seed(2)
    n = len(data)
    shape = 2.0 + 0.5 * n
    rate = 1.5 + 0.5 * np.sum((data - 0.4) ** 2)
    pp = 0.2 + n * 1.7
    want = {"tau": (shape / rate, shape / rate ** 2),
            "mu": ((0.2 * 0.5 + 1.7 * data.sum()) / pp, 1.0 / pp)}
    for op, key in ((gamma_op, "tau"), (normal_op, "mu")):
        p2, _, logh, acc = _propose_chains(op, params, trees, gen, None)
        x = p2[key].numpy()
        mean, var = want[key]
        assert abs(x.mean() - mean) < 5 * math.sqrt(var / b_n)
        assert abs(x.var() - var) < 5 * var * math.sqrt(2.0 / b_n)
        assert torch.isinf(logh).all() and (logh > 0).all()
        assert torch.equal(acc, torch.ones(b_n, dtype=F64))


def test_conjugate_gibbs_accepted_on_a_batch_as_on_one_chain():
    """The conjugate pair in make_mcmc_step and in make_multichain_step of
    3 chains, 40 steps each on the normal model: every proposal accepted,
    and each operator's summed acceptance statistic equal to its count of
    proposals, on one chain and on the batch alike."""
    data = torch.tensor([0.3, -1.2, 0.8, 2.2, 1.1], dtype=F64)

    def log_post(params, tree):
        x = params["data"]
        mu, tau = params["mu"], params["tau"]
        return (0.5 * x.shape[-1] * torch.log(tau)
                - 0.5 * tau * torch.sum((x - mu[..., None]) ** 2, -1)
                + torch.log(tau) - 1.5 * tau - 0.1 * (mu - 0.5) ** 2)

    operators = list(_conjugate_ops())
    tree = make_tree_state(*_star(), F64, "cpu")
    st = init_mcmc_state({"data": data, "mu": torch.tensor(0.4, dtype=F64),
                          "tau": torch.tensor(1.7, dtype=F64)}, tree,
                         torch.Generator().manual_seed(3), operators,
                         log_post)
    states = replicate_state(st, 3, torch.Generator().manual_seed(4))
    step = make_mcmc_step(log_post, operators)
    mstep = make_multichain_step(log_post, operators)
    for _ in range(40):
        st = step(st)
        states = mstep(states)
    for s in (st, states):
        total = s.op_accept.reshape(-1, 2).sum(0)
        assert int(s.op_reject.sum()) == 0 and int(total.sum()) == 40 * (
            s.op_accept.numel() // 2)
        torch.testing.assert_close(
            s.op_sum_accept.reshape(-1, 2).sum(0), total.to(F64))


class Replay:
    """A chain batch's draws handed to single chains: after `chain(b)`
    every draw helper draws the batch's shape ([B, ...], as a vmapped or
    chain-axis proposal draws it from the generator) and returns chain b's
    part."""

    def __init__(self, monkeypatch, b_n):
        self.b = None
        for mod in (ops, tops):
            for name in ("_randint", "_uniform", "_normal"):
                monkeypatch.setattr(mod, name, self._wrap(name))
        monkeypatch.setattr(ops, "_uniforms", self._wrap("_uniforms"))
        monkeypatch.setattr(tops, "_chain_randint",
                            self._wrap("_chain_randint"))
        monkeypatch.setattr(tops, "_chain_uniforms",
                            self._wrap("_chain_uniforms"))
        self.b_n = b_n

    def _wrap(self, name):
        def draw(gen, *a):
            if self.b is None:
                return REAL[name](gen, *a)
            return REAL_BATCH[name](self, gen, *a)
        return draw

    def chain(self, b):
        self.b = b


REAL = {"_randint": ops._randint, "_uniform": ops._uniform,
        "_normal": ops._normal, "_uniforms": ops._uniforms,
        "_chain_randint": tops._chain_randint,
        "_chain_uniforms": tops._chain_uniforms}
REAL_BATCH = {
    "_randint": lambda r, gen, low, high, dev: torch.randint(
        low, high, (r.b_n, 1), generator=gen, device=dev)[r.b],
    "_uniform": lambda r, gen, like: torch.rand(
        (r.b_n,), generator=gen, dtype=like.dtype)[r.b],
    "_normal": lambda r, gen, like, shape=(): torch.randn(
        (r.b_n, *shape), generator=gen, dtype=like.dtype)[r.b],
    "_uniforms": lambda r, gen, like, shape: torch.rand(
        (r.b_n, *shape), generator=gen, dtype=like.dtype)[r.b],
    "_chain_randint": lambda r, gen, high, b_n, dev: torch.randint(
        0, high, (r.b_n,), generator=gen, device=dev)[r.b:r.b + 1],
    "_chain_uniforms": lambda r, gen, like, b_n: torch.rand(
        r.b_n, generator=gen, dtype=like.dtype)[r.b:r.b + 1],
}


def chains_against_singles(monkeypatch, op, params, trees, tuning, seed=5,
                           rtol=1e-12):
    """op's chain-batch proposal (vmapped, or its own chain-axis one for a
    bound operator) against each chain's single proposal at the batch's
    draws."""
    b_n = len(trees)
    replay = Replay(monkeypatch, b_n)
    batch_tree = TreeState(*(torch.stack([getattr(t, f) for t in trees])
                             for f in FIELDS))
    if hasattr(op, "propose_chains"):
        out = op.propose_chains(params, batch_tree,
                                torch.Generator().manual_seed(seed), tuning)
        p_b, t_b, logh_b = out[0], out[1], out[2]
    else:
        p_b, t_b, logh_b, _ = _propose_chains(
            op, params, batch_tree, torch.Generator().manual_seed(seed),
            tuning)
        p_b = {**params, **p_b}
        t_b = batch_tree if t_b is None else t_b
    for b in range(b_n):
        replay.chain(b)
        p1, t1, logh1 = op.propose(
            map_tensors(lambda v: v[b], params), trees[b],
            torch.Generator().manual_seed(seed),
            None if tuning is None else tuning[b])[:3]
        replay.chain(None)
        for k, v in p1.items():
            torch.testing.assert_close(p_b[k][b], v, rtol=rtol, atol=1e-300)
        for f in FIELDS:
            torch.testing.assert_close(getattr(t_b, f)[b], getattr(t1, f),
                                       rtol=rtol, atol=0)
        torch.testing.assert_close(logh_b[b], logh1, rtol=rtol, atol=1e-14)
    return logh_b


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_batch_equals_single_chains(monkeypatch, name):
    """Four chains, each from its own parameters: the vmapped proposal
    against four single proposals at the batch's draws."""
    _, t_op, params, tuning = CASES[name]
    rng = np.random.default_rng(len(name))
    tree = make_tree_state(*_star(), F64, "cpu")
    batch = {k: torch.tensor(np.stack([v * rng.uniform(0.8, 1.2)
                                       if k not in ("bits",) else v
                                       for _ in range(4)]))
             for k, v in params.items()}
    tun = (None if tuning is None
           else torch.tensor(tuning * rng.uniform(0.8, 1.2, 4)))
    chains_against_singles(monkeypatch, t_op, batch, [tree] * 4, tun)

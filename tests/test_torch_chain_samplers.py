"""The samplers that bind the posterior, over a chain batch, against
single chains of the port and the JAX package.

Every operator that evaluates the posterior inside its proposal proposes
over a chain batch at once (`propose_chains`, bound to the chain-axis
posterior): HMC and its preconditioned and transformed forms, node-height
HMC, reflective, sphere, simplex and Stiefel HMC, NUTS, Zig-Zag, BPS,
slice and elliptical slice. Held here, in float64 on the CPU: with the
batch's draws recorded and each chain's part handed to a single-chain
proposal, the batch's proposal equals B single-chain proposals of the port
(rtol 1e-12: the same arithmetic, batched); leapfrog trajectories chain by
chain against jax.grad of the JAX posterior (rtol 1e-10, as
tests/test_torch_hmc.py); NUTS with injected uniforms against JAX's masked
algorithm for each chain, the chains stopping at different depths (as
tests/test_torch_nuts_pdmp.py); a lognormal target's moments from
make_multichain_step with HMC over four chains (four standard errors);
MC3 with HMC and slice at a small benchmark1 shape, its full-evaluation
deviation under the reference's 0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.apps.benchmarks import build_analysis as jbuild
from beast_mcmc_tpu.inference.trace import analyze
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.apps.benchmarks import build_analysis
from beast_mcmc_tpu_torch.inference import (
    geodesic, gibbs, hmc, nuts, pdmp, samplers)
from beast_mcmc_tpu_torch.inference.geodesic import StiefelGeodesicHmcOperator
from beast_mcmc_tpu_torch.inference.hmc import (
    GeodesicHmcOperator,
    HmcOperator,
    NodeHeightHmcOperator,
    ReflectiveHmcOperator,
    SimplexHmcOperator,
    leapfrog,
    value_and_grad,
    value_grad,
)
from beast_mcmc_tpu_torch.inference.mc3 import make_mc3_runner, replicate_state
from beast_mcmc_tpu_torch.inference.mcmc import (
    full_evaluation_check,
    init_mcmc_state,
    make_multichain_step,
    map_tensors,
    run_chain,
)
from beast_mcmc_tpu_torch.inference.nuts import NutsOperator, nuts_trajectory
from beast_mcmc_tpu_torch.inference.pdmp import (
    BouncyParticleOperator,
    ZigZagOperator,
)
from beast_mcmc_tpu_torch.inference.samplers import (
    EllipticalSliceOperator,
    SliceOperator,
)
from beast_mcmc_tpu_torch.models.priors import lognormal_logpdf
from beast_mcmc_tpu_torch.tree.topology import TreeState, make_tree_state
from beast_mcmc_tpu_torch.utils.transforms import LogTransform

from test_torch_nuts_pdmp import _draws, nuts_masked_np

F64 = torch.float64
B_N = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny torch ops: one thread while they run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# every draw of the bound operators goes through one of these helpers
HELPERS = [(hmc, "_normal"), (geodesic, "_normal"), (nuts, "_normal"),
           (nuts, "_uniforms"), (pdmp, "_normal"), (pdmp, "_uniforms"),
           (pdmp, "_exponentials"), (pdmp, "_coordinates"),
           (samplers, "_normal"), (samplers, "_exponential"),
           (samplers, "_uniform"), (samplers, "_coordinate"),
           # samplers.py's elliptical slice runs gibbs.elliptical_slice
           (gibbs, "_normal"), (gibbs, "_uniforms")]


class Draws:
    """Records a chain batch's draws, helper by helper; after `replay(b)`
    each helper hands chain b's part of the batch's draws, in order, to a
    single-chain proposal, the batch of one (cut to the single draw's
    shape: a chain that stops early, or has fewer events, takes a
    prefix)."""

    def __init__(self, monkeypatch):
        self.log, self.chain = {}, None
        for mod, name in HELPERS:
            monkeypatch.setattr(mod, name, self._wrap(
                f"{mod.__name__}.{name}", getattr(mod, name)))

    def _wrap(self, key, real):
        def draw(*a, **kw):
            out = real(*a, **kw)
            if self.chain is None:
                self.log.setdefault(key, []).append(out)
                return out
            rec = self.queue[key].pop(0)[self.chain:self.chain + 1]
            return rec[tuple(slice(0, n) for n in out.shape)].to(out.dtype)
        return draw

    def replay(self, b):
        self.chain = b
        self.queue = {k: list(v) for k, v in self.log.items()}


def _tree_batch(trees):
    return TreeState(*(torch.stack([getattr(t, f) for t in trees])
                       for f in ("parent", "children", "heights", "root")))


def _dummy_trees():
    one = make_tree_state(np.array([2, 2, -1]),
                          np.array([[-1, -1], [-1, -1], [0, 1]]),
                          np.array([0.0, 0.0, 1.0]), 2, F64, "cpu")
    return [one] * B_N


def _gaussian(params, tree):
    prec = torch.tensor([[2.0, 0.6, 0.0], [0.6, 1.0, 0.2], [0.0, 0.2, 0.5]],
                        dtype=F64)
    x = params["x"] - 0.5
    return -0.5 * torch.einsum("...i,ij,...j->...", x, prec, x)


def _gamma(params, tree):
    x = params["x"]
    return torch.sum(1.5 * torch.log(x) - x / 1.3, dim=-1)


MU = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.6, 0.0, 0.8]],
                  dtype=F64)
C_MAT = torch.tensor(np.random.default_rng(20).normal(size=(5, 2)))
ALPHA = torch.tensor([2.0, 3.0, 4.0, 5.0], dtype=F64)


def _toy(op, make_x, lp, names=("x",)):
    """(op, chain b's params as a function of its rng, posterior)."""
    return op, make_x, lp, names


def _positive(rng):
    return {"x": torch.tensor(rng.uniform(0.5, 2.0, 3))}


def _real(rng):
    return {"x": torch.tensor(rng.normal(0.5, 0.8, 3))}


def _sphere(rng):
    x = rng.normal(size=(3, 3))
    return {"x": torch.tensor((x / np.linalg.norm(x, axis=1,
                                                  keepdims=True)).ravel())}


def _stiefel(rng):
    q = np.linalg.qr(rng.normal(size=(5, 2)))[0]
    return {"a": torch.tensor(q[:, 0]), "b": torch.tensor(q[:, 1])}


TOYS = {
    "hmc log": _toy(HmcOperator(parameters=("x",), n_leapfrog=4), _positive,
                    _gamma),
    "hmc transform": _toy(HmcOperator(parameters=("x",), n_leapfrog=4,
                                      transform=LogTransform()),
                          _positive, _gamma),
    "hmc diag": _toy(HmcOperator(parameters=("x",), n_leapfrog=4,
                                 log_transform=False, precondition="diag"),
                     _real, _gaussian),
    "hmc low rank": _toy(HmcOperator(parameters=("x",), n_leapfrog=4,
                                     log_transform=False,
                                     precondition="low_rank", low_rank=2),
                         _real, _gaussian),
    "reflective": _toy(ReflectiveHmcOperator(parameters=("x",), lower=0.0,
                                             upper=3.0, n_leapfrog=4),
                       _positive, _gamma),
    "sphere": _toy(GeodesicHmcOperator(parameter="x", block_dim=3,
                                       n_leapfrog=4), _sphere,
                   lambda p, t: 4.0 * torch.sum(p["x"].reshape(
                       *p["x"].shape[:-1], 3, 3) * MU, dim=(-2, -1))),
    "simplex": _toy(SimplexHmcOperator(parameter="x", n_leapfrog=4),
                    lambda rng: {"x": torch.tensor(rng.dirichlet(
                        np.ones(4) * 3))},
                    lambda p, t: torch.sum((ALPHA - 1.0) * torch.log(p["x"]),
                                           dim=-1)),
    "stiefel": _toy(StiefelGeodesicHmcOperator(parameters=("a", "b"),
                                               n_leapfrog=3), _stiefel,
                    lambda p, t: torch.sum(C_MAT * torch.stack(
                        [p["a"], p["b"]], -1), dim=(-2, -1)), ("a", "b")),
    "nuts": _toy(NutsOperator(parameters=("x",), log_transform=False,
                              max_depth=5), _real, _gaussian),
    "zigzag": _toy(ZigZagOperator(parameters=("x",), log_transform=False,
                                  grad_bound=4.0, travel_time=1.5), _real,
                   _gaussian),
    "bps": _toy(BouncyParticleOperator(parameters=("x",),
                                       log_transform=False, grad_bound=6.0,
                                       travel_time=1.5), _real, _gaussian),
    "slice": _toy(SliceOperator(parameter="x", log_transform=True,
                                width=0.5), _positive, _gamma),
    "elliptical slice": _toy(EllipticalSliceOperator(parameter="x"), _real,
                             lambda p, t: torch.sum(
                                 -0.5 * p["x"] ** 2
                                 - 2.0 * (p["x"] - 2.0) ** 2, dim=-1)),
}


def _same(batch_out, singles, rtol=1e-12):
    """The batch's proposal against the single chains', entry by entry
    (the derived caches, which no bound operator moves, left out)."""
    params, tree, logh, *acc = batch_out
    for b, (p1, t1, logh1, *acc1) in enumerate(singles):
        for k, v in p1.items():
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(params[k][b], v, rtol=rtol,
                                           atol=1e-14)
        torch.testing.assert_close(tree.heights[b], t1.heights, rtol=rtol,
                                   atol=1e-14)
        torch.testing.assert_close(logh[b], logh1, rtol=rtol, atol=1e-12)
        for a, a1 in zip(acc, acc1):
            torch.testing.assert_close(a[b], a1, rtol=rtol, atol=1e-14,
                                       equal_nan=True)


def _chains_vs_singles(monkeypatch, op, params, trees, lp_chains, lp, tuning,
                       rtol=1e-12):
    draws = Draws(monkeypatch)
    op.bind_log_posterior(lp)
    op.bind_log_posterior_chains(lp_chains)
    gen = torch.Generator().manual_seed(3)
    out = op.propose_chains(params, _tree_batch(trees), gen, tuning)
    singles = []
    for b in range(B_N):
        draws.replay(b)
        singles.append(op.propose(map_tensors(lambda x: x[b], params),
                                  trees[b], gen,
                                  None if tuning is None else tuning[b]))
    _same(out, singles, rtol)
    return out


@pytest.mark.parametrize("name", list(TOYS))
def test_chain_proposal_equals_single_chain_proposals(monkeypatch, name):
    """Each bound operator's chain-axis proposal on a toy target, three
    chains from their own starts and step sizes, against three single-chain
    proposals handed the same draws. Stiefel HMC to 1e-8 relative:
    torch.linalg.matrix_exp takes one Taylor degree for a batch, from its
    largest norm, and a lower one for a single small matrix (5e-13 off
    scipy's expm at norm 0.015, against 1e-16 in the batch), which the
    trajectory carries to ~1e-10."""
    op, make_x, lp, _ = TOYS[name]
    rng = np.random.default_rng(len(name))
    starts = [make_x(rng) for _ in range(B_N)]
    params = {k: torch.stack([s[k] for s in starts]) for k in starts[0]}
    tuning = (torch.tensor([0.05, 0.12, 0.3], dtype=F64)
              if op.adaptable else None)
    _chains_vs_singles(monkeypatch, op, params, _dummy_trees(), lp, lp,
                       tuning, 1e-8 if name == "stiefel" else 1e-12)


def _tree_chains(n_taxa, seed):
    return [make_tree_state(*simulate_coalescent_tree(
        np.random.default_rng(seed + b), np.zeros(n_taxa), 0.5), F64, "cpu")
        for b in range(B_N)]


@pytest.mark.parametrize("op", [
    NodeHeightHmcOperator(n_leapfrog=3),
    HmcOperator(parameters=("clock.rate", "pop.size"), n_leapfrog=3),
    NutsOperator(parameters=("clock.rate", "pop.size"), max_depth=3),
    SliceOperator(parameter="pop.size", log_transform=True)],
    ids=lambda op: type(op).__name__)
def test_tree_posterior_chain_proposal_equals_single_chains(monkeypatch, op):
    """The operators of the chips' paths on build_analysis(10, 32)'s
    posterior, three chains with their own trees and rates: the chain-axis
    proposal (one peel a gradient for the three) against three single
    chains with the same draws."""
    _, _, p0, _, aux = build_analysis(10, 32, device="cpu")
    trees = _tree_chains(10, 70)
    st = init_mcmc_state(p0, trees[0], torch.Generator().manual_seed(0), [])
    params = replicate_state(st, B_N, torch.Generator()).params
    params["clock.rate"] = torch.tensor([0.8, 1.0, 1.3], dtype=F64)
    params["pop.size"] = torch.tensor([0.4, 0.6, 0.9], dtype=F64)
    tuning = (torch.tensor([2e-3, 5e-3, 1e-2], dtype=F64)
              if op.adaptable else None)
    _chains_vs_singles(monkeypatch, op, params, trees,
                       aux["log_post_cached_chains"], aux["log_post_cached"],
                       tuning)


def test_leapfrog_trajectories_match_jax_chain_by_chain():
    """HmcOperator(("clock.rate", "pop.size")) in log space over three
    chains of build_analysis(12, 64), each with its own tree, rates,
    momentum and step size: the batch's leapfrog end points (one gradient
    of the three chains a half step) and Hastings terms against each
    chain's trajectory built from jax.grad of the JAX posterior."""
    _, _, p0, _, aux = build_analysis(12, 64, device="cpu")
    _, _, jp0, jt0, jaux = jbuild(12, 64)
    names = ("clock.rate", "pop.size")
    trees = _tree_chains(12, 80)
    st = init_mcmc_state(p0, trees[0], torch.Generator().manual_seed(0), [])
    params = replicate_state(st, B_N, torch.Generator()).params
    params["clock.rate"] = torch.tensor([0.9, 1.0, 1.2], dtype=F64)
    params["pop.size"] = torch.tensor([0.5, 0.6, 0.8], dtype=F64)
    op = HmcOperator(parameters=names)
    tree = _tree_batch(trees)
    y0 = op._pack(params)
    p_0 = torch.tensor([[0.7, -1.3], [-0.2, 0.4], [1.1, 0.9]], dtype=F64)
    eps = torch.tensor([[0.002], [0.0015], [0.001]], dtype=F64)
    u = op.neg_log_density(aux["log_post_cached_chains"], params, tree)
    y1, p1 = leapfrog(lambda y: value_grad(u, y), y0, p_0, eps, 6,
                      lambda p: p)
    logh = (0.5 * (p_0 ** 2 - p1 ** 2).sum(-1) + op._ldj(y1)
            - op._ldj(y0))
    for b in range(B_N):
        jtree = jt0.replace(**{f: jnp.asarray(getattr(trees[b], f).numpy())
                               for f in ("parent", "children", "heights",
                                         "root")})

        def ju(y):
            x = jnp.exp(y)
            prm = {**jp0, names[0]: x[0], names[1]: x[1]}
            return -(jaux["log_post_cached"](prm, jtree) + jnp.sum(y))

        jg = jax.jit(jax.grad(ju))
        y, p = jnp.asarray(y0[b].numpy()), jnp.asarray(p_0[b].numpy())
        e = float(eps[b, 0])
        for _ in range(6):
            p = p - 0.5 * e * jg(y)
            y = y + e * p
            p = p - 0.5 * e * jg(y)
        np.testing.assert_allclose(y1[b].numpy(), np.asarray(y), rtol=1e-10)
        np.testing.assert_allclose(p1[b].numpy(), np.asarray(p), rtol=1e-10)
        jlogh = (0.5 * float(jnp.sum(jnp.asarray(p_0[b].numpy()) ** 2
                                     - p ** 2))
                 + float(jnp.sum(y)) - float(y0[b].sum()))
        assert float(logh[b]) == pytest.approx(jlogh, rel=1e-10, abs=1e-12)


def test_nuts_chains_match_masked_algorithm():
    """nuts_trajectory over three chains of a correlated Gaussian, each
    with its own start, momentum, step size and uniforms (one runs all its
    doublings, one diverges at once, one stops after two), against
    JAX's masked algorithm in numpy chain by chain: the proposal to 1e-12,
    the acceptance statistic and the leapfrogs exactly; the batch makes the
    largest chain's evaluations."""
    cov = np.array([[1.0, 0.9, 0.0], [0.9, 1.0, 0.3], [0.0, 0.3, 2.0]])
    prec, mean = np.linalg.inv(cov), np.array([1.0, -2.0, 0.5])
    tprec, tmean = torch.tensor(prec), torch.tensor(mean)

    def u(y):
        d = y - tmean
        return 0.5 * torch.einsum("...i,ij,...j->...", d, tprec, d)

    u_fn = lambda y: 0.5 * (y - mean) @ prec @ (y - mean)  # noqa: E731
    g_fn = lambda y: prec @ (y - mean)  # noqa: E731
    md = 5
    rng = np.random.default_rng(11)
    y0, r0 = rng.normal(size=(3, 3)), rng.normal(size=(3, 3))
    eps = np.array([0.05, 30.0, 0.2])
    draws = [_draws(md, 40 + b) for b in range(3)]
    calls = []

    def u_and_grad(y):
        calls.append(1)
        return value_and_grad(u, y)

    def draw(depth):
        return tuple(torch.tensor(np.stack([d[depth][i] for d in draws]))
                     for i in range(3))

    y, acc, n_lf = nuts_trajectory(u_and_grad, torch.tensor(y0),
                                   torch.tensor(r0),
                                   torch.tensor(eps)[:, None], 1.0, md, draw)
    assert len(calls) == max(n_lf) + 1
    for b in range(3):
        with np.errstate(all="ignore"):
            ry, racc, rn = nuts_masked_np(u_fn, g_fn, y0[b], r0[b], eps[b],
                                          1.0, md, draws[b])
        np.testing.assert_allclose(y[b].numpy(), ry, rtol=0, atol=1e-12)
        assert n_lf[b] == rn
        assert float(acc[b]) == pytest.approx(racc, rel=1e-12, abs=1e-15)
    assert len(set(n_lf)) == 3


def test_multichain_hmc_lognormal_moments():
    """log x ~ N(0.7, 0.45^2) by HMC in log space through
    make_multichain_step over four chains, 700 steps each after 100: the
    pooled mean of log x within four standard errors (each chain's from
    its own autocorrelation), the sd within 0.05, every chain accepting
    more than half its proposals."""
    mu, sigma = 0.7, 0.45

    def lp_chains(params, tree):
        return lognormal_logpdf(params["x"], mu, sigma, chains=True)

    op = HmcOperator(parameters=("x",), n_leapfrog=8, step_size=0.3)
    mstep = make_multichain_step(lp_chains, [op])
    st = init_mcmc_state({"x": torch.tensor([1.0], dtype=F64)},
                         _dummy_trees()[0], torch.Generator().manual_seed(2),
                         [op])
    states = replicate_state(st, 4, torch.Generator().manual_seed(3))
    states = states.replace(log_posterior=lp_chains(states.params,
                                                    states.tree))
    states, out = run_chain(mstep, states, 800, collect_every=1,
                            collector=lambda s: {"x": s.params["x"][:, 0]})
    lx = np.log(out["x"].numpy())[100:]  # [steps, chains]
    stats = [analyze(lx[:, b]) for b in range(4)]
    se = np.sqrt(sum(s.std_error_of_mean ** 2 for s in stats)) / 4
    assert all(s.ess > 60 for s in stats)
    assert abs(lx.mean() - mu) < 4 * se
    assert abs(lx.std() - sigma) < 0.05
    acc = states.op_accept[:, 0] / (states.op_accept[:, 0]
                                    + states.op_reject[:, 0])
    assert bool((acc > 0.5).all())


def test_mc3_with_hmc_and_slice_full_evaluation():
    """MC3 on four chains of build_analysis(9, 40, "hky_codon3") with HMC on
    (clock.rate, pop.size) and slice on pop.size beside its plain
    operators, each chain its own operator draw: every bound operator ran
    and accepted, the carried posteriors equal fresh ones, and a
    full-evaluation check at the ladder's temperatures stays under 0.1."""
    log_post, ops, p0, t0, aux = build_analysis(9, 40, model="hky_codon3",
                                                device="cpu")
    added = [HmcOperator(parameters=("clock.rate", "pop.size"), weight=8.0,
                         n_leapfrog=3, step_size=0.01),
             SliceOperator(parameter="pop.size", log_transform=True,
                           weight=8.0)]
    ops = [*ops, *added]
    lp_chains = aux["log_post_chains"]
    st = init_mcmc_state(p0, t0, torch.Generator().manual_seed(4), ops,
                         log_post)
    states = replicate_state(st, 4, torch.Generator().manual_seed(5))
    run, temps = make_mc3_runner(lp_chains, ops, 4, swap_every=5,
                                 delta=0.02)
    states, out = run(states, torch.Generator().manual_seed(6), 8)
    drawn = (states.op_accept + states.op_reject).sum(0)
    assert bool((drawn[-2:] > 0).all()) and bool(
        (states.op_accept.sum(0)[-2:] > 0).all())
    torch.testing.assert_close(lp_chains(states.params, states.tree),
                               states.log_posterior, rtol=0, atol=1e-9)
    step = make_multichain_step(lp_chains, ops)
    _, dev = full_evaluation_check(step, lp_chains, states, 10,
                                   temperature=temps)
    assert float(dev) < 0.1
    assert out["swap_accepted"].shape == (8,)

"""Stochastic mapping (queue item 4h-2): ops/markov_jumps.py and
ops/uniformization.py against the JAX package.

Held here, in float64 on the CPU (JAX under x64, tests/conftest.py):
  - the spectral integral, joint_jump_matrix, expected_jumps and
    expected_reward against JAX's at 1e-12 relative, on HKY (distinct
    eigenvalues), JC (a triple eigenvalue: the t e^{lt} limit on both
    sides) and a 2-state chain; the spectral integral against a long
    double reference too, also at t = 1e-4, where JAX's difference
    quotient is 1.7e-12 off; where two eigenvalues are close but not
    equal (HKY with purine and pyrimidine frequencies 1e-9 apart) the
    port's sinh form keeps the sum rule sum_ab pi_a J_ab = t to 1e-12;
  - branch_expected_jumps over a 9-taxon tree against JAX's (marginal and
    one-hot node states);
  - uniformized_powers against JAX's; the port's histories by law, as
    tests/test_uniformization.py holds JAX's: the endpoints, the dwell
    times summing to t, the jump counts and dwell times against the
    spectral expectations within 4 standard errors; labeled_jump_count and
    state_dwell_times against JAX's on the port's histories; a history
    given its uniforms is deterministic (sample_branch_histories with the
    uniforms history_uniforms draws).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beast_mcmc_tpu.models import substitution as jsub
from beast_mcmc_tpu.ops import eigen as jeig
from beast_mcmc_tpu.ops import markov_jumps as jmj
from beast_mcmc_tpu.ops import uniformization as juni
from beast_mcmc_tpu.tree.topology import simulate_coalescent_tree

from beast_mcmc_tpu_torch.models import substitution as tsub
from beast_mcmc_tpu_torch.ops import eigen as teig
from beast_mcmc_tpu_torch.ops import markov_jumps as tmj
from beast_mcmc_tpu_torch.ops import uniformization as tuni

from test_uniformization import _hky_q

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


def _systems(model):
    """(port eigen, JAX eigen, Q numpy, freqs numpy) of a model."""
    if model == "hky":
        freqs = np.array([0.3, 0.2, 0.25, 0.25])
        te = tsub.hky_eigen(3.0, torch.tensor(freqs))
        je = jsub.hky_eigen(3.0, jnp.asarray(freqs))
    elif model == "jc":
        freqs = np.full(4, 0.25)
        te, je = tsub.jc_eigen(dtype=F64, device="cpu"), jsub.jc_eigen()
    else:  # two states
        freqs = np.array([0.5, 0.5])
        te = teig.reversible_eigen(torch.ones((2, 2), dtype=F64),
                                   torch.tensor(freqs))
        je = jeig.reversible_eigen(jnp.ones((2, 2)), jnp.asarray(freqs))
    q = (te.U * te.values[None, :]) @ te.U_inv
    return te, je, q.numpy(), freqs


def _integral_longdouble(values, t):
    """The spectral integral from the difference quotient in numpy's long
    double (t e^{lt} where the eigenvalues are within 1e-10, as JAX
    takes it), rounded to float64."""
    lk = values.astype(np.longdouble)[:, None]
    ll = values.astype(np.longdouble)[None, :]
    t = np.longdouble(t)
    same = np.abs(lk - ll) < 1e-10
    off = (np.exp(lk * t) - np.exp(ll * t)) / np.where(same, 1.0, lk - ll)
    return np.where(same, t * np.exp(lk * t) + 0 * ll, off).astype(
        np.float64)


@pytest.mark.parametrize("model", ["hky", "jc", "two"])
def test_jump_expectations_match_jax(model):
    """_spectral_integral against a long-double reference at four branch
    lengths and JAX's where its difference quotient keeps 1e-12 (t >=
    0.05); joint_jump_matrix, expected_jumps (every transition, and the
    A<->G ones where S = 4) and expected_reward (the time in state 0)
    against JAX's there too."""
    te, je, q, freqs = _systems(model)
    s = len(freqs)
    labels = [1.0 - np.eye(s)]
    if s == 4:
        ag = np.zeros((4, 4))
        ag[0, 2] = ag[2, 0] = 1.0
        labels.append(ag)
    reward = np.eye(s)[0]
    for t in (1e-4, 0.05, 0.7, 3.0):
        got = tmj._spectral_integral(te.values, t)
        _close(got, _integral_longdouble(te.values.numpy(), t))
        if t < 0.01:  # JAX's difference quotient loses eps / (gap t) there
            continue
        _close(got, jmj._spectral_integral(je.values, t))
        p = teig.transition_probs(te, torch.tensor(t, dtype=F64))
        pj = jeig.transition_probs(je, jnp.asarray(t))
        for lab in labels:
            args_t = (te, torch.tensor(q), torch.tensor(lab), t)
            args_j = (je, jnp.asarray(q), jnp.asarray(lab), t)
            _close(tmj.joint_jump_matrix(*args_t),
                   jmj.joint_jump_matrix(*args_j))
            _close(tmj.expected_jumps(*args_t, p),
                   jmj.expected_jumps(*args_j, pj))
        _close(tmj.expected_reward(te, torch.tensor(reward), t, p),
               jmj.expected_reward(je, jnp.asarray(reward), t, pj))


@pytest.mark.parametrize("gap", [0.0, 1e-9])
def test_near_equal_eigenvalues_keep_the_sum_rule(gap):
    """HKY with pi_A + pi_G = pi_C + pi_T has a double eigenvalue; 1e-9
    from it, two eigenvalues are close but not equal. The unconditional
    expected count of every transition, sum_ab pi_a J_ab, is t (Q has
    mean rate 1), to 1e-12 at both."""
    freqs = np.array([0.3 + gap, 0.2, 0.2, 0.3 - gap])
    te = tsub.hky_eigen(5.0, torch.tensor(freqs))
    q = (te.U * te.values[None, :]) @ te.U_inv
    label = torch.tensor(1.0 - np.eye(4))
    for t in (0.05, 0.5, 2.0):
        j = tmj.joint_jump_matrix(te, q, label, t)
        total = float(torch.einsum("a,ab->", torch.tensor(freqs), j))
        np.testing.assert_allclose(total, t, rtol=REL)


def test_branch_expected_jumps_match_jax():
    """Per-branch expected A<->G counts over a 9-taxon tree, node states
    marginal (random simplex rows) and one-hot, against JAX's."""
    rng = np.random.default_rng(4)
    parent, _, heights, _ = simulate_coalescent_tree(rng, np.zeros(9), 1.0)
    te, je, q, _ = _systems("hky")
    label = np.zeros((4, 4))
    label[0, 2] = label[2, 0] = 1.0
    bl = np.where(parent >= 0, heights[np.maximum(parent, 0)] - heights,
                  0.0) * 0.8
    pm_t = teig.transition_probs(te, torch.tensor(bl))
    pm_j = jeig.transition_probs(je, jnp.asarray(bl))
    for probs in (rng.dirichlet(np.ones(4), size=17),
                  np.eye(4)[rng.integers(0, 4, 17)]):
        _close(tmj.branch_expected_jumps(
            te, torch.tensor(q), torch.tensor(label), torch.tensor(bl),
            torch.tensor(probs), torch.tensor(parent, dtype=torch.long),
            pm_t),
            jmj.branch_expected_jumps(
                je, jnp.asarray(q), jnp.asarray(label), jnp.asarray(bl),
                jnp.asarray(probs), jnp.asarray(parent), pm_j))


def _histories(q, t, a, b, n, nmax=48, seed=7):
    """n histories of one branch from (a at 0, b at t), one batch."""
    m = torch.full((n,), t, dtype=F64)
    return tuni.sample_branch_histories(
        torch.Generator().manual_seed(seed), torch.tensor(q), m,
        torch.full((n,), a), torch.full((n,), b), nmax=nmax)


def test_uniformized_powers_match_jax():
    q, _ = _hky_q()
    mu_t, r_t, pows_t = tuni.uniformized_powers(torch.tensor(q), 12)
    mu_j, r_j, pows_j = juni.uniformized_powers(jnp.asarray(q), 12)
    np.testing.assert_allclose(float(mu_t), float(mu_j), rtol=REL)
    _close(r_t, r_j)
    _close(pows_t, pows_j)


def test_dwell_partitions_branch_length_and_endpoints_hold():
    """tests/test_uniformization.py's first test on the port: every path
    starts at a and ends at b, and its dwell times sum to t."""
    q, _ = _hky_q()
    t, a, b = 0.9, 0, 3
    h = _histories(q, t, a, b, 256)
    dwell = tuni.state_dwell_times(h, 4)
    np.testing.assert_allclose(dwell.sum(1).numpy(), t, rtol=1e-12)
    assert bool((h.states[:, 0] == a).all())
    last = torch.gather(h.states, 1, h.n_jumps[:, None])[:, 0]
    assert bool((last == b).all())


def test_jump_counts_and_dwell_match_spectral_expectations():
    """tests/test_uniformization.py's Monte Carlo checks on the port's
    histories (6,000 a case, 4 standard errors + 1e-3): all real jumps at
    (0, 0), (0, 2), (1, 3) against expected_jumps, the time in A at
    (2, 1) against expected_reward."""
    q, pi = _hky_q()
    te = teig.eigen_from_q_reversible(torch.tensor(q), torch.tensor(pi))
    label = torch.tensor(1.0 - np.eye(4))
    t = 0.8
    want = tmj.expected_jumps(te, torch.tensor(q), label, t,
                              teig.transition_probs(te, torch.tensor(t)))
    for (a, b) in [(0, 0), (0, 2), (1, 3)]:
        counts = tuni.labeled_jump_count(_histories(q, t, a, b, 6000),
                                         label).numpy()
        se = counts.std() / np.sqrt(len(counts))
        assert abs(counts.mean() - float(want[a, b])) < 4 * se + 1e-3, (
            a, b, counts.mean(), float(want[a, b]))
    t, a, b = 1.2, 2, 1
    reward = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64)
    w = float(tmj.expected_reward(te, reward, t, teig.transition_probs(
        te, torch.tensor(t)))[a, b])
    dwell = tuni.state_dwell_times(_histories(q, t, a, b, 6000), 4)[:, 0]
    se = float(dwell.std()) / np.sqrt(len(dwell))
    assert abs(float(dwell.mean()) - w) < 4 * se + 1e-3, (
        float(dwell.mean()), w)


def test_history_statistics_match_jax_on_the_same_paths():
    """labeled_jump_count and state_dwell_times of the port's histories
    (a whole tree's branches at once) against JAX's on the same paths;
    sample_state_history's one path; the same uniforms give the same
    histories."""
    q, _ = _hky_q()
    rng = np.random.default_rng(9)
    m, nmax = 40, 32
    bl = torch.tensor(rng.uniform(0.01, 1.5, m))
    start = torch.tensor(rng.integers(0, 4, m))
    end = torch.tensor(rng.integers(0, 4, m))
    gen = torch.Generator().manual_seed(3)
    u = tuni.history_uniforms(gen, m, nmax)
    h = tuni.sample_branch_histories(None, torch.tensor(q), bl, start, end,
                                     nmax, uniforms=u)
    again = tuni.histories_from_uniforms(torch.tensor(q), bl, start, end, u)
    for x, y in zip(h, again):
        assert torch.equal(x, y)
    np.testing.assert_allclose(tuni.state_dwell_times(h, 4).sum(1).numpy(),
                               bl.numpy(), rtol=1e-12)
    label = rng.random((4, 4)) * (1.0 - np.eye(4))
    for i in range(m):
        jh = juni.StateHistory(n_jumps=jnp.asarray(int(h.n_jumps[i])),
                               states=jnp.asarray(h.states[i].numpy()),
                               dwell=jnp.asarray(h.dwell[i].numpy()))
        np.testing.assert_allclose(
            float(tuni.labeled_jump_count(
                tuni.StateHistory(*(x[i] for x in h)), torch.tensor(label))),
            float(juni.labeled_jump_count(jh, jnp.asarray(label))),
            rtol=REL, atol=0)
        _close(tuni.state_dwell_times(tuni.StateHistory(*(x[i] for x in h)),
                                      4),
               juni.state_dwell_times(jh, 4))
    one = tuni.sample_state_history(torch.Generator().manual_seed(1),
                                    torch.tensor(q), 0.6, 1, 2, nmax=16)
    assert one.states.shape == (17,) and int(one.states[0]) == 1
    assert int(one.states[int(one.n_jumps)]) == 2
    np.testing.assert_allclose(float(one.dwell.sum()), 0.6, rtol=1e-12)

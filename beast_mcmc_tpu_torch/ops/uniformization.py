"""Endpoint-conditioned CTMC path sampling by uniformization.

Counterpart of beast_mcmc_tpu/ops/uniformization.py
(UniformizedStateHistory.java; Fearnhead & Sherlock 2006): a whole history
on a branch of length t, given both endpoint states, from a chain
subordinated to a Poisson(mu t) number of candidate jumps with kernel
R = I + Q / mu, mu >= max_i(-q_ii). The number of candidate jumps is
bounded by nmax; its law is P(N = n | a, b) ~ Poisson(n; mu t) [R^n]_ab,
the intermediate states are drawn forward given the end state, and the
jump times are sorted uniforms by exponential spacings.

Every branch of a tree is drawn at once ([M] branches, the nmax state
steps in sequence). The draws come from uniforms: 2 nmax + 2 a branch
(`history_uniforms`, from a torch.Generator), and each pick inverts the
CDF of one uniform where the JAX package draws from its key; the law is
the same, the stream is not. Given the uniforms, a history is a
deterministic function of them, so a caller may pass its own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from beast_mcmc_tpu_torch.inference.tree_operators import _pick_rows


class StateHistory(NamedTuple):
    """Sampled paths, [..., nmax + 1] each: entries past n_jumps are
    padding (state = end, dwell 0)."""

    n_jumps: torch.Tensor  # [...] int64: candidate jumps, virtual included
    states: torch.Tensor  # [..., nmax + 1] int64: start, ..., end, padding
    dwell: torch.Tensor  # [..., nmax + 1]: time spent in states[..., i]


def uniformized_powers(q: torch.Tensor, nmax: int):
    """(mu, R, R^0..R^nmax [nmax + 1, S, S]) of the subordinated chain."""
    s = q.shape[-1]
    mu = torch.max(-torch.diagonal(q)) * (1.0 + 1e-12) + 1e-30
    eye = torch.eye(s, dtype=q.dtype, device=q.device)
    r = eye + q / mu
    pows = [eye]
    for _ in range(nmax):
        pows.append(pows[-1] @ r)
    return mu, r, torch.stack(pows)


def history_uniforms(generator: torch.Generator, m: int, nmax: int,
                     dtype=torch.float64) -> torch.Tensor:
    """The [m, 2 nmax + 2] uniforms of m branches' histories, on the
    generator's device: the jump count's, nmax states' and nmax + 1
    spacings'."""
    return torch.rand((m, 2 * nmax + 2), generator=generator, dtype=dtype,
                      device=generator.device)


def histories_from_uniforms(q: torch.Tensor, branch_lengths: torch.Tensor,
                            start_states: torch.Tensor,
                            end_states: torch.Tensor,
                            uniforms: torch.Tensor) -> StateHistory:
    """The histories of M branches [M] from their uniforms [M, 2 nmax +
    2] (`history_uniforms`)."""
    dt, dev = q.dtype, q.device
    m = branch_lengths.shape[0]
    nmax = (uniforms.shape[-1] - 2) // 2
    t = branch_lengths.to(dt)
    start = start_states.long()
    end = end_states.long()
    mu, r, pows = uniformized_powers(q, nmax)

    # the number of candidate jumps: Poisson(n; mu t) [R^n]_ab
    ns = torch.arange(nmax + 1, dtype=dt, device=dev)
    mt = (mu * t)[:, None]
    log_pois = torch.xlogy(ns, mt) - mt - torch.lgamma(ns + 1.0)
    rn_ab = pows[:, start, end].T  # [M, nmax + 1]
    logw = torch.where(rn_ab > 0,
                       log_pois + torch.log(torch.clamp_min(rn_ab, 1e-300)),
                       torch.full_like(log_pois, -torch.inf))
    n = _pick_rows(logw, uniforms[:, 0])

    # the states between: P(s_i = c) ~ R[s_{i-1}, c] [R^{n-i}]_{c, end}
    rows = torch.arange(q.shape[-1], device=dev)[None, :]
    s_prev = start
    states = [start]
    for i in range(1, nmax + 1):
        rem = (n - i).clamp_min(0)
        probs = r[s_prev] * pows[rem[:, None], rows, end[:, None]]
        c = _pick_rows(torch.log(torch.clamp_min(probs, 0.0)),
                       uniforms[:, i])
        s_prev = torch.where(i < n, c, end)
        states.append(s_prev)
    states = torch.stack(states, dim=-1)

    # the jump times: n sorted uniforms on [0, t] by exponential spacings
    e = -torch.log1p(-uniforms[:, nmax + 1:])  # [M, nmax + 1]
    cs = torch.cumsum(e, dim=-1)
    denom = cs.gather(1, n[:, None])
    idx = torch.arange(1, nmax + 1, device=dev)
    jump_t = torch.where(idx <= n[:, None], t[:, None] * cs[:, :nmax] / denom,
                         t[:, None])
    bounds = torch.cat([torch.zeros((m, 1), dtype=dt, device=dev), jump_t,
                        t[:, None]], dim=-1)
    dwell = torch.diff(bounds, dim=-1)
    dwell = torch.where(torch.arange(nmax + 1, device=dev) <= n[:, None],
                        dwell, torch.zeros_like(dwell))
    return StateHistory(n_jumps=n, states=states, dwell=dwell)


def sample_branch_histories(generator: torch.Generator, q: torch.Tensor,
                            branch_lengths: torch.Tensor,
                            start_states: torch.Tensor,
                            end_states: torch.Tensor, nmax: int = 64,
                            uniforms: Optional[torch.Tensor] = None
                            ) -> StateHistory:
    """Whole-tree stochastic mapping: every branch's history given its
    endpoint states (ops/ancestral.py's joint draw), arrays [M, ...]. The
    uniforms come from the generator unless given."""
    if uniforms is None:
        uniforms = history_uniforms(generator, branch_lengths.shape[0], nmax,
                                    q.dtype)
    return histories_from_uniforms(q, branch_lengths, start_states,
                                   end_states, uniforms)


def sample_state_history(generator: torch.Generator, q: torch.Tensor, t,
                         start, end, nmax: int = 64) -> StateHistory:
    """One path of X on [0, t] given X_0 = start and X_t = end."""
    dev = q.device

    def one(v, d):
        return torch.as_tensor(v, dtype=d, device=dev).reshape(1)

    h = sample_branch_histories(generator, q, one(t, q.dtype),
                                one(start, torch.long), one(end, torch.long),
                                nmax)
    return StateHistory(*(x[0] for x in h))


def labeled_jump_count(hist: StateHistory,
                       label: torch.Tensor) -> torch.Tensor:
    """Real labelled jumps of each path (a virtual self-jump counts
    nothing where label's diagonal is 0)."""
    nmax = hist.states.shape[-1] - 1
    valid = (torch.arange(1, nmax + 1, device=label.device)
             <= hist.n_jumps[..., None])
    counted = label[hist.states[..., :-1], hist.states[..., 1:]]
    return torch.sum(torch.where(valid, counted, torch.zeros_like(counted)),
                     dim=-1)


def state_dwell_times(hist: StateHistory, n_states: int) -> torch.Tensor:
    """[..., S] time each path spends in each state (summing to t)."""
    onehot = torch.nn.functional.one_hot(hist.states, n_states).to(
        hist.dwell.dtype)
    return torch.einsum("...ks,...k->...s", onehot, hist.dwell)

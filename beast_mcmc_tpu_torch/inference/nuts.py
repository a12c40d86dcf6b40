"""No-U-Turn Sampler (NUTS).

Counterpart of beast_mcmc_tpu/inference/nuts.py (the reference's
NoUTurnOperator.java:41,157): iterative multinomial NUTS, each doubling a
run of 2^depth leapfrog steps with the binary-counter checkpoints for the
sub-trajectory U-turn checks.

JAX unrolls every doubling statically and masks the ones after the
trajectory stopped, so a proposal always costs 2^max_depth - 1 leapfrogs.
Here a host loop stops between doublings once the trajectory is done (one
host copy of the stop flag a doubling); over a chain batch, once every
chain's is, the chains that stopped earlier masked as JAX masks them. The
draw is unchanged: after the stop nothing further is used. Inside a
doubling all 2^depth leaves run, as in JAX, since the acceptance
statistic counts every leaf of the last subtree. Each new point takes its
value and gradient together, cached at both ends of the trajectory, so a
proposal of n_lf leapfrogs makes n_lf + 1 posterior evaluations (one
kernel launch each on a CUDA device); the chain's acceptance evaluation
is one more.

A Gibbs-style move: it returns log-Hastings +inf and the trajectory's mean
acceptance statistic for the Robbins-Monro step-size adaptation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from beast_mcmc_tpu_torch.inference.hmc import (
    HmcOperator,
    _normal,
    per_chain,
    value_and_grad,
)

_DIVERGENCE = 1000.0  # energy-error threshold (Stan / reference convention)


def _ckpt_idxs(n: int) -> Tuple[int, int]:
    """Checkpoint slots of leaf n (0-based within a subtree): idx_max =
    popcount(n >> 1), the slot an even leaf writes; an odd leaf with t
    trailing set bits closes t balanced subtrees, whose left ends are in
    slots [idx_max - t + 1, idx_max]."""
    idx_max = bin(n >> 1).count("1")
    trailing = (~n & (n + 1)).bit_length() - 1
    return idx_max - trailing + 1, idx_max


def _no_ignored_settings(op):
    """NUTS and the PDMP operators inherit `precondition` and `transform`
    from HmcOperator and do not use them: refuse them rather than ignore
    them."""
    if op.precondition != "none" or op.transform is not None:
        raise ValueError(f"{type(op).__name__} takes neither precondition "
                         "nor transform")


def nuts_trajectory(u_and_grad: Callable, y0: torch.Tensor,
                    r0: torch.Tensor, eps, inv_mass, max_depth: int,
                    draw: Callable):
    """One multinomial NUTS trajectory from (y0, r0).

    u_and_grad(y) -> (U(y), dU/dy), U the potential energy. draw(depth) ->
    (u_direction, u_leaves [2^depth], u_select), uniforms on [0, 1).
    Returns (y_proposed, mean acceptance statistic, leapfrogs run).

    A chain batch: y0 and r0 [B, dim], eps [B, 1], U [B], and draw's
    uniforms with the leading B. Each chain's trajectory is its own; the
    doublings go on while any chain's runs, a chain that has stopped is
    masked as JAX's algorithm masks it (its draw, statistic and leapfrogs
    are what it had), and the leapfrogs are a list, one a chain."""
    if y0.dim() == 1:  # one chain: the batch of one
        def draw1(depth):
            return tuple(torch.as_tensor(u)[None] for u in draw(depth))

        y, acc, n_lf = nuts_trajectory(
            lambda y: tuple(t[None] for t in u_and_grad(y[0])), y0[None],
            r0[None], eps, inv_mass, max_depth, draw1)
        return y[0], acc[0], n_lf[0]
    dt = y0.dtype
    md = max_depth
    b_n, dim = y0.shape
    dev = y0.device

    def kinetic(r):
        return 0.5 * torch.sum(r * r * inv_mass, dim=-1)

    def col(x):  # [B] against [B, dim]
        return x[:, None]

    u0, g0 = u_and_grad(y0)
    h0 = u0 + kinetic(r0)
    neg_inf = torch.full((b_n,), -math.inf, dtype=dt, device=dev)
    false = torch.zeros(b_n, dtype=torch.bool, device=dev)

    def subtree(y, r, g, depth, u_leaf):
        """2^depth leapfrogs from the edge (y, r, g), momenta in the
        integration frame: the far end with its gradient, the multinomial
        proposal, its log weight, the acceptance sum and the stop flags."""
        ck_y = torch.zeros((b_n, md + 1, dim), dtype=dt, device=dev)
        ck_r = torch.zeros_like(ck_y)
        y_prop, logw = y, neg_inf
        sum_acc = torch.zeros(b_n, dtype=dt, device=dev)
        turning = diverged = false
        for i in range(2 ** depth):
            r = r - 0.5 * eps * g
            y = y + eps * r * inv_mass
            u_new, g = u_and_grad(y)
            r = r - 0.5 * eps * g
            delta = h0 - (u_new + kinetic(r))
            diverged = diverged | (delta < -_DIVERGENCE) | torch.isnan(delta)
            logw_leaf = torch.where(diverged, neg_inf, delta)
            # progressive multinomial sampling within the subtree
            logw_new = torch.logaddexp(logw, logw_leaf)
            take = torch.log(u_leaf[:, i]) < logw_leaf - logw_new
            y_prop = torch.where(col(take), y, y_prop)
            logw = logw_new
            sum_acc = sum_acc + torch.minimum(torch.ones_like(delta),
                                              torch.exp(delta))
            lo, hi = _ckpt_idxs(i)
            if i % 2 == 0:
                ck_y[:, hi], ck_r[:, hi] = y, r
            else:
                d_y = y[:, None, :] - ck_y[:, lo:hi + 1]
                turn = (torch.sum(d_y * ck_r[:, lo:hi + 1], dim=-1) < 0.0) | (
                    torch.einsum("bkd,bd->bk", d_y, r) < 0.0)
                turning = turning | torch.any(turn, dim=-1)
        return y, r, g, y_prop, logw, sum_acc, turning, diverged

    # trajectory ends in the global frame, with their gradients
    y_minus = y_plus = y_prop = y0
    r_minus = r_plus = r0
    g_minus = g_plus = g0
    logw = torch.zeros(b_n, dtype=dt, device=dev)  # the root leaf
    sum_acc = torch.zeros(b_n, dtype=dt, device=dev)
    n_lf = [0] * b_n
    done = false
    for depth in range(md):
        u_dir, u_leaf, u_sel = draw(depth)
        direction = torch.where(u_dir < 0.5, -1.0, 1.0).to(dt)
        fwd = col(direction > 0)
        (y_far, r_far, g_far, y_sub, logw_sub, acc_sub, turning_sub,
         diverged_sub) = subtree(
            torch.where(fwd, y_plus, y_minus),
            torch.where(fwd, r_plus, r_minus) * col(direction),
            torch.where(fwd, g_plus, g_minus), depth, u_leaf)
        r_far = r_far * col(direction)  # back to the global frame
        ok = ~done & ~turning_sub & ~diverged_sub
        # biased progressive sampling across doublings
        take = ok & (torch.log(u_sel) < logw_sub - logw)
        y_prop = torch.where(col(take), y_sub, y_prop)
        logw = torch.where(ok, torch.logaddexp(logw, logw_sub), logw)
        sum_acc = sum_acc + torch.where(done, 0.0, acc_sub)
        # extend the end only if the subtree joined the trajectory
        ext_m, ext_p = col(ok) & ~fwd, col(ok) & fwd
        y_minus = torch.where(ext_m, y_far, y_minus)
        r_minus = torch.where(ext_m, r_far, r_minus)
        g_minus = torch.where(ext_m, g_far, g_minus)
        y_plus = torch.where(ext_p, y_far, y_plus)
        r_plus = torch.where(ext_p, r_far, r_plus)
        g_plus = torch.where(ext_p, g_far, g_plus)
        dz = y_plus - y_minus
        whole_turn = ((torch.sum(dz * r_minus, dim=-1) < 0.0)
                      | (torch.sum(dz * r_plus, dim=-1) < 0.0))
        now = done | turning_sub | diverged_sub | whole_turn
        was, stop = torch.stack([done, now]).tolist()  # one host copy
        n_lf = [n + (0 if d else 2 ** depth) for n, d in zip(n_lf, was)]
        done = now
        if all(stop):
            break
    return (y_prop, sum_acc / torch.tensor([max(n, 1) for n in n_lf],
                                           dtype=dt, device=dev), n_lf)


def _uniforms(gen, shape, like):
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


@dataclasses.dataclass
class NutsOperator(HmcOperator):
    """Multinomial NUTS over named continuous parameters (log space with
    log_transform, as HmcOperator). max_depth: at most 2^max_depth - 1
    leapfrogs. The step size adapts toward target_acceptance.
    `last_n_leapfrog` holds the leapfrogs of the last proposal (a list,
    one a chain, after a chain batch's: the batch makes the largest count's
    posterior evaluations)."""

    max_depth: int = 6
    target_acceptance: float = 0.8
    last_n_leapfrog = 0
    _reports = ("last_n_leapfrog",)

    def __post_init__(self):
        _no_ignored_settings(self)

    def _propose(self, lp, params, tree, gen, tuning):
        dt = tree.heights.dtype
        y0 = self._pack(params).to(dt).detach()
        lead = y0.shape[:-1]
        mass = torch.as_tensor(self.mass, dtype=dt, device=y0.device)
        u = self.neg_log_density(lp, params, tree)

        def draw(depth):
            v = _uniforms(gen, (*lead, 2 ** depth + 2), y0)
            return v[..., 0], v[..., 1:-1], v[..., -1]

        r0 = _normal(gen, y0) * torch.sqrt(mass)
        y_prop, mean_acc, self.last_n_leapfrog = nuts_trajectory(
            lambda y: value_and_grad(u, y), y0, r0, per_chain(tuning, y0),
            1.0 / mass, self.max_depth, draw)
        return (self._unpack(params, y_prop), tree,
                torch.full(lead, math.inf, dtype=dt, device=y0.device),
                mean_acc)

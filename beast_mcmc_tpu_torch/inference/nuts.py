"""No-U-Turn Sampler (NUTS).

Counterpart of beast_mcmc_tpu/inference/nuts.py (the reference's
NoUTurnOperator.java:41,157): iterative multinomial NUTS, each doubling a
run of 2^depth leapfrog steps with the binary-counter checkpoints for the
sub-trajectory U-turn checks.

JAX unrolls every doubling statically and masks the ones after the
trajectory stopped, so a proposal always costs 2^max_depth - 1 leapfrogs.
Here a host loop stops between doublings once the trajectory is done (one
host copy of the stop flag a doubling). The draw is unchanged: after the
stop nothing further is used. Inside a doubling all 2^depth leaves run, as
in JAX, since the acceptance statistic counts every leaf of the last
subtree. Each new point takes its value and gradient together, cached at
both ends of the trajectory, so a proposal of n_lf leapfrogs makes n_lf + 1
posterior evaluations (one kernel launch each on a CUDA device); the
chain's acceptance evaluation is one more.

A Gibbs-style move: it returns log-Hastings +inf and the trajectory's mean
acceptance statistic for the Robbins-Monro step-size adaptation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from beast_mcmc_tpu_torch.inference.hmc import HmcOperator, value_and_grad

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
    Returns (y_proposed, mean acceptance statistic, leapfrogs run)."""
    dt = y0.dtype
    md = max_depth
    dim = y0.shape[0]

    def kinetic(r):
        return 0.5 * torch.sum(r * r * inv_mass)

    u0, g0 = u_and_grad(y0)
    h0 = u0 + kinetic(r0)
    neg_inf = torch.full((), -math.inf, dtype=dt, device=y0.device)
    false = torch.zeros((), dtype=torch.bool, device=y0.device)

    def subtree(y, r, g, depth, u_leaf):
        """2^depth leapfrogs from the edge (y, r, g), momenta in the
        integration frame: the far end with its gradient, the multinomial
        proposal, its log weight, the acceptance sum and the stop flags."""
        ck_y = torch.zeros((md + 1, dim), dtype=dt, device=y.device)
        ck_r = torch.zeros_like(ck_y)
        y_prop, logw, sum_acc = y, neg_inf, torch.zeros((), dtype=dt,
                                                        device=y.device)
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
            take = torch.log(u_leaf[i]) < logw_leaf - logw_new
            y_prop = torch.where(take, y, y_prop)
            logw = logw_new
            sum_acc = sum_acc + torch.minimum(torch.ones_like(delta),
                                              torch.exp(delta))
            lo, hi = _ckpt_idxs(i)
            if i % 2 == 0:
                ck_y[hi], ck_r[hi] = y, r
            else:
                d_y = y[None, :] - ck_y[lo:hi + 1]
                turn = (torch.sum(d_y * ck_r[lo:hi + 1], dim=1) < 0.0) | (
                    d_y @ r < 0.0)
                turning = turning | torch.any(turn)
        return y, r, g, y_prop, logw, sum_acc, turning, diverged

    # trajectory ends in the global frame, with their gradients
    y_minus = y_plus = y_prop = y0
    r_minus = r_plus = r0
    g_minus = g_plus = g0
    logw = torch.zeros((), dtype=dt, device=y0.device)  # the root leaf
    sum_acc = torch.zeros((), dtype=dt, device=y0.device)
    n_lf = 0
    for depth in range(md):
        u_dir, u_leaf, u_sel = draw(depth)
        direction = torch.where(u_dir < 0.5, -1.0, 1.0).to(dt)
        fwd = direction > 0
        (y_far, r_far, g_far, y_sub, logw_sub, acc_sub, turning_sub,
         diverged_sub) = subtree(
            torch.where(fwd, y_plus, y_minus),
            torch.where(fwd, r_plus, r_minus) * direction,
            torch.where(fwd, g_plus, g_minus), depth, u_leaf)
        r_far = r_far * direction  # back to the global frame
        ok = ~turning_sub & ~diverged_sub
        # biased progressive sampling across doublings
        take = ok & (torch.log(u_sel) < logw_sub - logw)
        y_prop = torch.where(take, y_sub, y_prop)
        logw = torch.where(ok, torch.logaddexp(logw, logw_sub), logw)
        sum_acc = sum_acc + acc_sub
        n_lf += 2 ** depth
        # extend the end only if the subtree joined the trajectory
        ext_m, ext_p = ok & ~fwd, ok & fwd
        y_minus = torch.where(ext_m, y_far, y_minus)
        r_minus = torch.where(ext_m, r_far, r_minus)
        g_minus = torch.where(ext_m, g_far, g_minus)
        y_plus = torch.where(ext_p, y_far, y_plus)
        r_plus = torch.where(ext_p, r_far, r_plus)
        g_plus = torch.where(ext_p, g_far, g_plus)
        dz = y_plus - y_minus
        whole_turn = (dz @ r_minus < 0.0) | (dz @ r_plus < 0.0)
        if bool(turning_sub | diverged_sub | whole_turn):  # one host copy
            break
    return y_prop, sum_acc / max(n_lf, 1), n_lf


@dataclasses.dataclass
class NutsOperator(HmcOperator):
    """Multinomial NUTS over named continuous parameters (log space with
    log_transform, as HmcOperator). max_depth: at most 2^max_depth - 1
    leapfrogs. The step size adapts toward target_acceptance.
    `last_n_leapfrog` holds the leapfrogs of the last proposal."""

    max_depth: int = 6
    target_acceptance: float = 0.8
    last_n_leapfrog = 0

    def __post_init__(self):
        _no_ignored_settings(self)

    def propose(self, params, tree, gen, tuning):
        assert self._log_posterior is not None, "NutsOperator not bound"
        dt = tree.heights.dtype
        y0 = self._pack(params).to(dt).detach()
        mass = torch.as_tensor(self.mass, dtype=dt, device=y0.device)
        u = self.neg_log_density(params, tree)

        def draw(depth):
            v = torch.rand(2 ** depth + 2, generator=gen, dtype=dt,
                           device=y0.device)
            return v[0], v[1:-1], v[-1]

        r0 = torch.randn(y0.shape, generator=gen, dtype=dt,
                         device=y0.device) * torch.sqrt(mass)
        y_prop, mean_acc, self.last_n_leapfrog = nuts_trajectory(
            lambda y: value_and_grad(u, y), y0, r0, tuning, 1.0 / mass,
            self.max_depth, draw)
        return (self._unpack(params, y_prop), tree,
                torch.full((), math.inf, dtype=dt, device=y0.device),
                mean_acc)

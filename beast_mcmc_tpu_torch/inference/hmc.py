"""Hamiltonian Monte Carlo operators.

Counterpart of beast_mcmc_tpu/inference/hmc.py (the reference's
HamiltonianMonteCarloOperator leapfrog and MassPreconditioner). Gradients
come from torch.autograd.grad of the bound log posterior, which reaches the
peel through its adjoint on every route (ops/peeling.py): one gradient is
one forward with its residual (one kernel launch on a CUDA device) and the
level adjoint, so a proposal of n_leapfrog steps makes 2 * n_leapfrog
launches, and the chain's acceptance evaluation one more.

Positive parameters move in log space: the operator targets
pi_y(y) = pi_x(e^y) e^y and returns the Hastings term
  logh = (ldj(y') - ldj(y)) + (K_old - K_new)
so the chain's Metropolis-Hastings step, which compares pi_x, stays exact.
Momenta come from the state's device generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from beast_mcmc_tpu_torch.inference.operators import NEG_INF, Operator


def value_grad(fn: Callable, y: torch.Tensor) -> torch.Tensor:
    """d fn(y) / dy at y, whatever the caller's grad mode."""
    y = y.detach().requires_grad_(True)
    with torch.enable_grad():
        out = fn(y)
    return torch.autograd.grad(out, y)[0]


def leapfrog(grad_fn: Callable, y: torch.Tensor, p: torch.Tensor, eps,
             n_steps: int, velocity: Callable):
    """n_steps of the leapfrog integrator for H = U(y) + K(p), with
    grad_fn = dU/dy and velocity = dK/dp: (y, p) at the end. Two gradients
    a step, as the reference takes them."""
    for _ in range(n_steps):
        p = p - 0.5 * eps * grad_fn(y)
        y = y + eps * velocity(p)
        p = p - 0.5 * eps * grad_fn(y)
    return y, p


def _normal(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _finish(y0, y1, logh):
    """Reject (logh = -inf, y back to y0) a trajectory that left the finite
    reals."""
    ok = torch.all(torch.isfinite(y1)) & torch.isfinite(logh)
    return (torch.where(ok, y1, y0),
            torch.where(ok, logh, torch.full_like(logh, NEG_INF)))


@dataclasses.dataclass
class HmcOperator(Operator):
    """Leapfrog HMC over named continuous parameters (scalars or vectors).

    log_transform moves all of them in log space (positivity); `transform`
    (a utils.transforms.Transform of the packed vector) overrides it.
    mass is a scalar or a [dim] diagonal. precondition: "none"; "diag",
    the Hessian diagonal's magnitudes at the start point; "low_rank", the
    `low_rank` curvature directions of largest magnitude with their Hessian
    eigenvalues and the median magnitude on the complement
    (MassPreconditioner.java:51). The Hessians come from
    torch.autograd.functional.hessian and so need a twice-differentiable
    target: the peel's adjoint is once differentiable, as the JAX one is.
    The step size adapts by Robbins-Monro toward target_acceptance."""

    parameters: Sequence[str] = ()
    n_leapfrog: int = 10
    step_size: float = 0.1
    mass: float = 1.0
    precondition: str = "none"  # "none" | "diag" | "low_rank"
    low_rank: int = 4
    log_transform: bool = True
    transform: Optional[object] = None
    adaptable: bool = True
    target_acceptance: float = 0.8
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def bind_log_posterior(self, log_posterior):
        self._log_posterior = log_posterior

    def initial_adapt(self) -> float:
        return math.log(self.step_size)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def _pack(self, params):
        flat = torch.cat([torch.atleast_1d(params[n])
                          for n in self.parameters])
        if self.transform is not None:
            return self.transform.forward(flat)
        return torch.log(flat) if self.log_transform else flat

    def _ldj(self, y):
        """log |d constrained / d unconstrained| at y."""
        if self.transform is not None:
            return self.transform.log_det_jacobian_inverse(y)
        if self.log_transform:
            return torch.sum(y)
        return torch.zeros((), dtype=y.dtype, device=y.device)

    def _unpack(self, params, y):
        if self.transform is not None:
            x = self.transform.inverse(y)
        else:
            x = torch.exp(y) if self.log_transform else y
        out, i = dict(params), 0
        for n in self.parameters:
            v = params[n]
            k = max(1, v.numel())
            out[n] = x[i:i + k].reshape(v.shape)
            i += k
        return out

    def neg_log_density(self, params, tree):
        """y -> -(log pi_x(x(y)) + ldj(y)): the potential energy."""
        def u(y):
            return -(self._log_posterior(self._unpack(params, y), tree)
                     + self._ldj(y))
        return u

    def _mass(self, u, y0):
        """(velocity, kinetic, momentum draw) of the mass matrix."""
        dt = y0.dtype
        if self.precondition in ("diag", "low_rank"):
            h = torch.autograd.functional.hessian(u, y0.detach())
        if self.precondition == "low_rank":
            h = 0.5 * (h + h.T)
            evals, evecs = torch.linalg.eigh(h)
            mag = torch.clamp(torch.abs(evals), 1e-8, 1e8)
            top = torch.argsort(-mag)[:min(self.low_rank, y0.shape[0])]
            u_k, l_k = evecs[:, top], mag[top]
            l_fill = torch.quantile(mag, 0.5)  # the median, as jnp.median

            def m_solve(v):
                proj = u_k.T @ v
                return u_k @ (proj / l_k) + (v - u_k @ proj) / l_fill

            def draw(gen):
                z = _normal(gen, y0)
                proj = u_k.T @ z
                return (u_k @ (torch.sqrt(l_k) * proj)
                        + torch.sqrt(l_fill) * (z - u_k @ proj))

            return m_solve, lambda p: 0.5 * torch.sum(p * m_solve(p)), draw
        if self.precondition == "diag":
            mass = torch.clamp(torch.abs(torch.diagonal(h)), 1e-8, 1e8)
        else:
            mass = torch.as_tensor(self.mass, dtype=dt, device=y0.device)
        return (lambda p: p / mass,
                lambda p: 0.5 * torch.sum(p * p / mass),
                lambda gen: _normal(gen, y0) * torch.sqrt(mass))

    def propose(self, params, tree, gen, tuning):
        assert self._log_posterior is not None, "HmcOperator not bound"
        y0 = self._pack(params).to(tree.heights.dtype).detach()
        u = self.neg_log_density(params, tree)
        velocity, kinetic, draw = self._mass(u, y0)
        p0 = draw(gen)
        y1, p1 = leapfrog(lambda y: value_grad(u, y), y0, p0, tuning,
                          self.n_leapfrog, velocity)
        logh = (kinetic(p0) - kinetic(p1)) + self._ldj(y1) - self._ldj(y0)
        y1, logh = _finish(y0, y1, logh)
        return self._unpack(params, y1), tree, logh


@dataclasses.dataclass
class NodeHeightHmcOperator(Operator):
    """HMC over all internal node heights of the current topology.

    Unconstrained coordinates (tree/transforms.py): z_i = logit(ratio_i)
    for the internal non-root nodes, z_root = log(root height - max tip
    height). HMC targets pi_z(z) = pi_h(h(z)) |dh/dz|; the chain compares
    pi_h, so the Hastings term is K_old - K_new + log|dh/dz|(z1) -
    log|dh/dz|(z0). The topology is fixed through a proposal, so its
    levels and anchors are computed once (one host copy)."""

    n_leapfrog: int = 10
    step_size: float = 0.02
    mass: float = 1.0
    adaptable: bool = True
    target_acceptance: float = 0.8
    modifies_params = ()  # a tree-only proposal
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def bind_log_posterior(self, log_posterior):
        self._log_posterior = log_posterior

    def initial_adapt(self) -> float:
        return math.log(self.step_size)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)

    def coordinates(self, params, tree):
        """(z0, h_of_z, u): the start point, z -> (heights, log|dh/dz|), and
        the potential energy z -> -(log pi_h(h(z)) + log|dh/dz|)."""
        from beast_mcmc_tpu_torch.tree.transforms import (
            heights_to_ratios,
            internal_levels,
            ratios_to_heights,
            subtree_anchors,
        )

        parent, children, root = tree.parent, tree.children, tree.root
        m = parent.shape[0]
        n_taxa = (m + 1) // 2
        dt = tree.heights.dtype
        tip_h = tree.heights[:n_taxa]
        max_tip = torch.max(tip_h)
        levels = internal_levels(parent, n_taxa)
        anchors = subtree_anchors(parent, children, tip_h, n_taxa, levels)
        is_root = torch.arange(n_taxa, m, device=parent.device) == root
        ratios, rh = heights_to_ratios(parent, children, tree.heights, root,
                                       n_taxa, levels)
        z0 = torch.where(is_root, torch.log(rh - max_tip),
                         torch.logit(torch.clamp(ratios, 1e-12, 1.0 - 1e-12))
                         ).to(dt)
        zero = torch.zeros((), dtype=dt, device=z0.device)

        def h_of_z(z):
            r = torch.sigmoid(z)
            root_h = max_tip + torch.exp(torch.sum(torch.where(is_root, z,
                                                               zero)))
            heights, logj = ratios_to_heights(parent, children, tip_h, r,
                                              root_h, root, n_taxa, levels,
                                              anchors)
            # |dh/dz| = J(ratios -> heights) prod r(1-r) (root - max tip)
            logdet = logj + torch.sum(torch.where(
                is_root, z, torch.log(r) + torch.log1p(-r)))
            return heights, logdet

        def u(z):
            heights, logdet = h_of_z(z)
            return -(self._log_posterior(params, tree.replace(
                heights=heights)) + logdet)

        return z0.detach(), h_of_z, u

    def propose(self, params, tree, gen, tuning):
        assert self._log_posterior is not None, "operator not bound"
        z0, h_of_z, u = self.coordinates(params, tree)
        p0 = _normal(gen, z0) * math.sqrt(self.mass)
        z1, p1 = leapfrog(lambda z: value_grad(u, z), z0, p0, tuning,
                          self.n_leapfrog, lambda p: p / self.mass)
        k_old = 0.5 * torch.sum(p0 * p0) / self.mass
        k_new = 0.5 * torch.sum(p1 * p1) / self.mass
        h1, logdet1 = h_of_z(z1)
        _, logdet0 = h_of_z(z0)
        logh = (k_old - k_new) + logdet1 - logdet0
        ok = torch.all(torch.isfinite(h1)) & torch.isfinite(logh)
        logh = torch.where(ok, logh, torch.full_like(logh, NEG_INF))
        heights = torch.where(ok, h1, tree.heights)
        return params, tree.replace(heights=heights), logh

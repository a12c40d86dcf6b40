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

The constrained operators keep their constraint in the integrator instead:
ReflectiveHmcOperator folds a step back at the bounds, GeodesicHmcOperator
moves rows along great circles of their unit spheres, SimplexHmcOperator
runs in additive log-ratio coordinates. Each exposes `trajectory(lp,
params, tree, y0, p0, eps)`, the integrator from a given start and
momentum.

Chain batches: every operator here is written once, over a chain batch:
`_propose(lp, params, tree, gen, tuning)` with params and tree carrying a
leading chain axis B, tuning [B] and lp the chain-axis posterior (params,
tree) -> [B]. `propose_chains` runs it with the posterior bound by
`bind_log_posterior_chains`; `propose`, one chain's proposal, runs it on
the batch of one (`batch_of_one`), with the posterior bound by
`bind_log_posterior` lifted to return [1] (`one_chain_posterior`). Each
chain has its own step size, momentum and Hastings term, and a gradient
of all B chains is one backward of the sum of their potentials (the
chains are independent), so a proposal makes the single chain's launches
for the whole batch, 2 * n_leapfrog + 1 with the chain's acceptance
evaluation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from beast_mcmc_tpu_torch.inference.mcmc import map_tensors
from beast_mcmc_tpu_torch.inference.operators import NEG_INF, Operator
from beast_mcmc_tpu_torch.utils.transforms import over_chains


def value_grad(fn: Callable, y: torch.Tensor) -> torch.Tensor:
    """d fn(y) / dy at y, whatever the caller's grad mode."""
    return value_and_grad(fn, y)[1]


def value_and_grad(fn: Callable, y: torch.Tensor):
    """(fn(y), d fn(y) / dy) from one forward and its backward: one kernel
    launch on a CUDA device. fn(y) may be [B], one value a chain: the
    gradient of their sum is each chain's gradient in its own rows."""
    y = y.detach().requires_grad_(True)
    with torch.enable_grad():
        out = fn(y)
    return out.detach(), torch.autograd.grad(out.sum(), y)[0]


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


def per_chain(x, like: torch.Tensor):
    """A chain batch's [B] values (step sizes, flags) shaped to broadcast
    against like [B, ...]."""
    x = torch.as_tensor(x)
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _finish(y0, y1, logh):
    """Reject (logh = -inf, y back to y0) a trajectory that left the finite
    reals, each chain [B] on its own."""
    ok = torch.isfinite(y1).flatten(logh.dim()).all(-1) & torch.isfinite(logh)
    return (torch.where(per_chain(ok, y1), y1, y0),
            torch.where(ok, logh, torch.full_like(logh, NEG_INF)))


def _flat(params, names):
    """The named entries of a chain batch packed into one vector a chain:
    [B, dim]."""
    b_n = params[names[0]].shape[0]
    return torch.cat([params[n].reshape(b_n, -1) for n in names], -1)


def _put(params, names, x):
    """params with the named entries read back from the packed x [B,
    dim]."""
    out, i = dict(params), 0
    for n in names:
        v = params[n]
        k = v[0].numel()
        out[n] = x[..., i:i + k].reshape(v.shape).to(v.dtype)
        i += k
    return out


def batch_of_one(x):
    """One chain's params, tree or values as a chain batch of one: every
    tensor gains a leading axis of 1."""
    return map_tensors(lambda t: t[None], x)


def _only_chain(x):
    """The chain of a batch of one: `batch_of_one` undone."""
    return map_tensors(lambda t: t[0], x)


class _Binds:
    """Binding to the chain's log posterior, and to a chain batch's
    ([B] a batch), for the operators that evaluate it in their proposal.
    Each proposal is written once, over a chain batch: `_propose(lp,
    params, tree, gen, tuning)`. `_reports` names the attributes a
    proposal sets to one value a chain (`last_n_leapfrog`, ...); after
    one chain's proposal they hold that chain's value."""

    _log_posterior_chains = None
    _reports = ()

    def bind_log_posterior(self, log_posterior):
        self._log_posterior = log_posterior

    def bind_log_posterior_chains(self, log_posterior_chains):
        self._log_posterior_chains = log_posterior_chains

    def one_chain_posterior(self):
        """The posterior bound by `bind_log_posterior` as the chain-axis
        posterior of a batch of one: (params, tree) [1, ...] -> [1]."""
        lp = self._log_posterior
        assert lp is not None, f"{type(self).__name__} not bound"
        return lambda params, tree: lp(_only_chain(params),
                                       _only_chain(tree))[None]

    def propose(self, params, tree, gen, tuning):
        """One chain's proposal: the chain batch of one."""
        if tuning is not None:
            tuning = torch.as_tensor(tuning, device=tree.heights.device)
        out = self._propose(self.one_chain_posterior(), batch_of_one(params),
                            batch_of_one(tree), gen, batch_of_one(tuning))
        for name in self._reports:
            setattr(self, name, getattr(self, name)[0])
        return _only_chain(out)

    def propose_chains(self, params, tree, gen, tuning):
        """The proposal of every chain of a batch at once: params and tree
        with the leading chain axis, tuning [B]; log Hastings [B]."""
        lp = self._log_posterior_chains
        assert lp is not None, f"{type(self).__name__} not bound"
        return self._propose(lp, params, tree, gen, tuning)


class _Bound(_Binds):
    """A step size adapted in log space, shared by the HMC operators
    below."""

    def initial_adapt(self) -> float:
        return math.log(self.step_size)

    def tuning(self, adapt_value):
        return torch.exp(adapt_value)


@dataclasses.dataclass
class HmcOperator(_Bound, Operator):
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
    Over a chain batch each chain takes its own block of the
    (block-diagonal) Hessian. The step size adapts by Robbins-Monro toward
    target_acceptance."""

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

    def _pack(self, params):
        flat = _flat(params, self.parameters)
        if self.transform is not None:
            return over_chains(self.transform.forward, flat)
        return torch.log(flat) if self.log_transform else flat

    def _ldj(self, y):
        """log |d constrained / d unconstrained| at y [B, dim]: [B]."""
        if self.transform is not None:
            return over_chains(self.transform.log_det_jacobian_inverse, y)
        if self.log_transform:
            return torch.sum(y, dim=-1)
        return torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)

    def _unpack(self, params, y):
        if self.transform is not None:
            x = over_chains(self.transform.inverse, y)
        else:
            x = torch.exp(y) if self.log_transform else y
        return _put(params, self.parameters, x)

    def neg_log_density(self, lp, params, tree):
        """y [B, dim] -> -(log pi_x(x(y)) + ldj(y)) [B]: the potential
        energy of the chain-axis posterior lp."""
        def u(y):
            return -(lp(self._unpack(params, y), tree) + self._ldj(y))
        return u

    def _mass(self, u, y0):
        """(velocity, kinetic, momentum draw) of the mass matrix, each
        chain's own at y0 [B, dim]."""
        dt = y0.dtype
        if self.precondition in ("diag", "low_rank"):
            h = torch.autograd.functional.hessian(
                lambda y: u(y).sum(), y0.detach())
            # each chain's diagonal block
            h = torch.diagonal(h, dim1=0, dim2=2).permute(2, 0, 1)
        if self.precondition == "low_rank":
            h = 0.5 * (h + h.transpose(-1, -2))
            evals, evecs = torch.linalg.eigh(h)
            mag = torch.clamp(torch.abs(evals), 1e-8, 1e8)
            top = torch.argsort(-mag, dim=-1)[
                ..., :min(self.low_rank, y0.shape[-1])]
            u_k = torch.take_along_dim(evecs, top[..., None, :], -1)
            l_k = torch.take_along_dim(mag, top, -1)
            # the median, as jnp.median
            l_fill = torch.quantile(mag, 0.5, dim=-1, keepdim=True)

            def proj(v):
                return torch.einsum("...dk,...d->...k", u_k, v)

            def lift(w):
                return torch.einsum("...dk,...k->...d", u_k, w)

            def m_solve(v):
                pr = proj(v)
                return lift(pr / l_k) + (v - lift(pr)) / l_fill

            def draw(gen):
                z = _normal(gen, y0)
                pr = proj(z)
                return (lift(torch.sqrt(l_k) * pr)
                        + torch.sqrt(l_fill) * (z - lift(pr)))

            return (m_solve, lambda p: 0.5 * torch.sum(p * m_solve(p), dim=-1),
                    draw)
        if self.precondition == "diag":
            mass = torch.clamp(torch.abs(torch.diagonal(h, dim1=-2, dim2=-1)),
                               1e-8, 1e8)
        else:
            mass = torch.as_tensor(self.mass, dtype=dt, device=y0.device)
        return (lambda p: p / mass,
                lambda p: 0.5 * torch.sum(p * p / mass, dim=-1),
                lambda gen: _normal(gen, y0) * torch.sqrt(mass))

    def _propose(self, lp, params, tree, gen, tuning):
        y0 = self._pack(params).to(tree.heights.dtype).detach()
        u = self.neg_log_density(lp, params, tree)
        velocity, kinetic, draw = self._mass(u, y0)
        p0 = draw(gen)
        y1, p1 = leapfrog(lambda y: value_grad(u, y), y0, p0,
                          per_chain(tuning, y0), self.n_leapfrog, velocity)
        logh = (kinetic(p0) - kinetic(p1)) + self._ldj(y1) - self._ldj(y0)
        y1, logh = _finish(y0, y1, logh)
        return self._unpack(params, y1), tree, logh


@dataclasses.dataclass
class NodeHeightHmcOperator(_Bound, Operator):
    """HMC over all internal node heights of the current topology.

    Unconstrained coordinates (tree/transforms.py): z_i = logit(ratio_i)
    for the internal non-root nodes, z_root = log(root height - max tip
    height). HMC targets pi_z(z) = pi_h(h(z)) |dh/dz|; the chain compares
    pi_h, so the Hastings term is K_old - K_new + log|dh/dz|(z1) -
    log|dh/dz|(z0). The topology is fixed through a proposal, so its
    levels and anchors are computed once (one host copy); over a chain
    batch each chain's tree is its own, its levels aligned at the roots."""

    n_leapfrog: int = 10
    step_size: float = 0.02
    mass: float = 1.0
    adaptable: bool = True
    target_acceptance: float = 0.8
    modifies_params = ()  # a tree-only proposal
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def coordinates(self, lp, params, tree):
        """(z0, h_of_z, u) of a chain batch under the chain-axis posterior
        lp: the start point [B, n_int], z -> (heights, log|dh/dz|), and the
        potential energy z -> -(log pi_h(h(z)) + log|dh/dz|) [B]."""
        from beast_mcmc_tpu_torch.tree.transforms import (
            heights_to_ratios,
            internal_levels,
            ratios_to_heights,
            subtree_anchors,
        )

        parent, children, root = tree.parent, tree.children, tree.root
        m = parent.shape[-1]
        n_taxa = (m + 1) // 2
        dt = tree.heights.dtype
        tip_h = tree.heights[..., :n_taxa]
        max_tip = torch.amax(tip_h, -1)
        levels = internal_levels(parent, n_taxa)
        anchors = subtree_anchors(parent, children, tip_h, n_taxa, levels)
        is_root = (torch.arange(n_taxa, m, device=parent.device)
                   == torch.as_tensor(root, device=parent.device)[..., None])
        ratios, rh = heights_to_ratios(parent, children, tree.heights, root,
                                       n_taxa, levels)
        z0 = torch.where(is_root, torch.log(rh - max_tip)[..., None],
                         torch.logit(torch.clamp(ratios, 1e-12, 1.0 - 1e-12))
                         ).to(dt)
        zero = torch.zeros((), dtype=dt, device=z0.device)

        def h_of_z(z):
            r = torch.sigmoid(z)
            root_h = max_tip + torch.exp(torch.sum(torch.where(is_root, z,
                                                               zero), dim=-1))
            heights, logj = ratios_to_heights(parent, children, tip_h, r,
                                              root_h, root, n_taxa, levels,
                                              anchors)
            # |dh/dz| = J(ratios -> heights) prod r(1-r) (root - max tip)
            logdet = logj + torch.sum(torch.where(
                is_root, z, torch.log(r) + torch.log1p(-r)), dim=-1)
            return heights, logdet

        def u(z):
            heights, logdet = h_of_z(z)
            return -(lp(params, tree.replace(heights=heights)) + logdet)

        return z0.detach(), h_of_z, u

    def _propose(self, lp, params, tree, gen, tuning):
        z0, h_of_z, u = self.coordinates(lp, params, tree)
        p0 = _normal(gen, z0) * math.sqrt(self.mass)
        z1, p1 = leapfrog(lambda z: value_grad(u, z), z0, p0,
                          per_chain(tuning, z0), self.n_leapfrog,
                          lambda p: p / self.mass)
        k_old = 0.5 * torch.sum(p0 * p0, dim=-1) / self.mass
        k_new = 0.5 * torch.sum(p1 * p1, dim=-1) / self.mass
        h1, logdet1 = h_of_z(z1)
        _, logdet0 = h_of_z(z0)
        logh = (k_old - k_new) + logdet1 - logdet0
        ok = torch.isfinite(h1).all(-1) & torch.isfinite(logh)
        logh = torch.where(ok, logh, torch.full_like(logh, NEG_INF))
        heights = torch.where(per_chain(ok, h1), h1, tree.heights)
        return params, tree.replace(heights=heights), logh


@dataclasses.dataclass
class ReflectiveHmcOperator(_Bound, Operator):
    """HMC with the position reflected at fixed bounds
    (ReflectiveHamiltonianMonteCarloOperator.java:47): leapfrog in the
    constrained space; a step that crosses a bound folds back and negates
    that momentum component. Volume-preserving, so the Hastings term is the
    kinetic-energy difference."""

    parameters: Sequence[str] = ()
    n_leapfrog: int = 10
    step_size: float = 0.1
    mass: float = 1.0
    lower: float = 0.0
    upper: float = math.inf
    adaptable: bool = True
    target_acceptance: float = 0.8
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _reflect(self, y, p):
        lo, hi = self.lower, self.upper
        if math.isfinite(lo) and math.isfinite(hi):
            span = hi - lo
            # remainder, not fmod: the result takes the divisor's sign, as
            # the % of the JAX operator does, also for y below lo
            z = torch.remainder(y - lo, 2 * span)
            y2 = lo + torch.minimum(z, 2 * span - z)
            flip = z > span
        elif math.isfinite(lo):
            y2, flip = lo + torch.abs(y - lo), y < lo
        elif math.isfinite(hi):
            y2, flip = hi - torch.abs(hi - y), y > hi
        else:
            return y, p
        return y2, torch.where(flip, -p, p)

    def trajectory(self, lp, params, tree, y0, p0, eps):
        """(y, p) [B, dim] after n_leapfrog reflected leapfrog steps from
        (y0, p0) under the chain-axis posterior lp, eps [B, 1]."""
        grad = lambda y: value_grad(  # noqa: E731
            lambda v: -lp(_put(params, self.parameters, v), tree), y)
        mass = torch.as_tensor(self.mass, dtype=y0.dtype, device=y0.device)
        y, p = y0, p0
        for _ in range(self.n_leapfrog):
            p = p - 0.5 * eps * grad(y)
            y, p = self._reflect(y + eps * p / mass, p)
            p = p - 0.5 * eps * grad(y)
        return y, p

    def _propose(self, lp, params, tree, gen, tuning):
        y0 = _flat(params, self.parameters).to(tree.heights.dtype).detach()
        mass = torch.as_tensor(self.mass, dtype=y0.dtype, device=y0.device)
        p0 = _normal(gen, y0) * torch.sqrt(mass)
        y1, p1 = self.trajectory(lp, params, tree, y0, p0,
                                 per_chain(tuning, y0))
        y1, logh = _finish(y0, y1, 0.5 * torch.sum((p0 * p0 - p1 * p1)
                                                   / mass, dim=-1))
        return _put(params, self.parameters, y1), tree, logh


def _tangent(y, v):
    """v projected on the tangent spaces of the unit spheres of y's rows."""
    return v - torch.sum(v * y, dim=-1, keepdim=True) * y


def _sum_rows(x):
    """The sum over a [..., rows, cols] block: one value a chain."""
    return torch.sum(x, dim=(-2, -1))


@dataclasses.dataclass
class GeodesicHmcOperator(_Bound, Operator):
    """HMC on a product of unit spheres
    (GeodesicHamiltonianMonteCarloOperator.java): `parameter` read as
    [n_blocks, block_dim] rows, each of norm 1. Tangent-space kicks
    alternate with exact great-circle moves, so the constraint holds to
    round-off at every step."""

    parameter: str = ""
    block_dim: int = 2
    n_leapfrog: int = 10
    step_size: float = 0.1
    adaptable: bool = True
    target_acceptance: float = 0.8
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    @staticmethod
    def _geodesic(y, p, t):
        """The great-circle flow of each row for time t."""
        speed = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        u = p / torch.clamp_min(speed, 1e-30)
        a = speed * t
        y2 = y * torch.cos(a) + u * torch.sin(a)
        p2 = (-y * torch.sin(a) + u * torch.cos(a)) * speed
        moved = speed > 1e-20
        return torch.where(moved, y2, y), torch.where(moved, p2, p)

    def trajectory(self, lp, params, tree, y0, p0, eps):
        x0 = params[self.parameter]

        def neg_lp(y):
            return -lp({**params, self.parameter: y.reshape(x0.shape).to(
                x0.dtype)}, tree)

        y, p = y0, p0
        for _ in range(self.n_leapfrog):
            p = _tangent(y, p - 0.5 * eps * value_grad(neg_lp, y))
            y, p = self._geodesic(y, p, eps)
            p = _tangent(y, p - 0.5 * eps * value_grad(neg_lp, y))
        return y, p

    def _propose(self, lp, params, tree, gen, tuning):
        x0 = params[self.parameter]
        y0 = x0.reshape(x0.shape[0], -1, self.block_dim).to(
            tree.heights.dtype)
        y0 = y0 / torch.linalg.vector_norm(y0, dim=-1, keepdim=True)
        p0 = _tangent(y0, _normal(gen, y0))
        y1, p1 = self.trajectory(lp, params, tree, y0, p0,
                                 per_chain(tuning, y0))
        y1, logh = _finish(y0, y1, 0.5 * (_sum_rows(p0 * p0)
                                          - _sum_rows(p1 * p1)))
        return ({**params, self.parameter: y1.reshape(x0.shape).to(x0.dtype)},
                tree, logh)


@dataclasses.dataclass
class SimplexHmcOperator(_Bound, Operator):
    """HMC over a simplex-valued parameter in additive log-ratio
    coordinates (the reference's UnitSimplexTransform path): y_i = log(x_i /
    x_K), x = softmax([y, 0]), log|J| = sum log x_i."""

    parameter: str = ""
    n_leapfrog: int = 5
    step_size: float = 0.01
    mass: float = 1.0
    adaptable: bool = True
    target_acceptance: float = 0.8
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    @staticmethod
    def x_of(y):
        return torch.softmax(torch.cat([y, y.new_zeros(y.shape[:-1] + (1,))],
                                       -1), dim=-1)

    def trajectory(self, lp, params, tree, y0, p0, eps):
        old = params[self.parameter]

        def neg_log_py(y):
            x = self.x_of(y)
            return -(lp({**params, self.parameter: x.to(old.dtype).reshape(
                old.shape)}, tree) + torch.sum(torch.log(x), dim=-1))

        y, p = y0, p0
        for _ in range(self.n_leapfrog):
            p = p - 0.5 * eps * value_grad(neg_log_py, y)
            y = y + eps * p / self.mass
            p = p - 0.5 * eps * value_grad(neg_log_py, y)
        return y, p

    def _propose(self, lp, params, tree, gen, tuning):
        old = params[self.parameter]
        x0 = old.reshape(old.shape[0], -1).to(tree.heights.dtype)
        y0 = torch.log(x0[..., :-1]) - torch.log(x0[..., -1:])
        p0 = math.sqrt(self.mass) * _normal(gen, y0)
        y1, p1 = self.trajectory(lp, params, tree, y0, p0,
                                 per_chain(tuning, y0))
        x1 = self.x_of(y1)
        # the chain compares pi(x); exp(H0 - H1) leaves the log-Jacobian and
        # kinetic differences
        logh = (torch.sum(torch.log(x1) - torch.log(x0), dim=-1)
                + 0.5 * torch.sum(p0 * p0 - p1 * p1, dim=-1) / self.mass)
        x1, logh = _finish(x0, x1, logh)
        return ({**params,
                 self.parameter: x1.to(old.dtype).reshape(old.shape)},
                tree, logh)

"""Geodesic HMC on the Stiefel manifold (matrices with orthonormal columns).

Counterpart of beast_mcmc_tpu/inference/geodesic.py, the reference's
geodesic leapfrog (GeodesicHamiltonianMonteCarloOperator.java:
updatePosition :453-563, the Edelman-Arias-Smith flow
[X M] exp(t [[A, -M^T M], [I, A]]) diag(e^{-tA}, e^{-tA}) followed by a
Cholesky re-orthonormalisation; projectMomentum :565-586, M -= X (A + A^T)
/ 2 with A = X^T M) and its report protocol (getReport :65-111).

Two forms, as in JAX:
  * the numpy float64 functions (block structure from a mask or an
    orthogonality structure), the package's own copies, used as the
    report oracle;
  * `StiefelGeodesicHmcOperator`, a chain operator over one whole-matrix
    block on tensors (torch.linalg.matrix_exp, cholesky and
    solve_triangular on 2k x 2k and k x k matrices).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.hmc import (
    _Bound,
    _finish,
    _normal,
    _sum_rows,
    per_chain,
    value_grad,
)
from beast_mcmc_tpu_torch.inference.operators import Operator

# ---------------------------------------------------------------------------
# block structure (GeodesicLeapFrogEngine, parseStructureFromMask,
# setOrthogonalityStructure)
# ---------------------------------------------------------------------------


def blocks_from_mask(p: int, k: int, mask: Optional[np.ndarray]
                     ) -> List[Tuple[List[int], List[int]]]:
    """[(cols, rows)] orthonormality blocks. mask is the flat column-major
    0/1 vector (length p*k) or None (one whole-matrix block).
    GeodesicHamiltonianMonteCarloOperator.java:147-202."""
    if mask is None:
        return [(list(range(k)), list(range(p)))]
    mask = np.ravel(np.asarray(mask))
    blocks: List[Tuple[List[int], List[int]]] = []
    for col in range(k):
        rows = [r for r in range(p) if mask[col * p + r] == 1]
        if not rows:
            continue
        for bc, br in blocks:
            if br == rows:
                bc.append(col)
                break
        else:
            blocks.append(([col], rows))
    return blocks


def apply_orthogonality_structure(blocks, groups):
    """Split blocks so that each `group` of columns is an orthonormal block
    of its own (setOrthogonalityStructure :373-404; 0-based columns)."""
    for cols in groups:
        cols = sorted(cols)
        for bi, (bc, br) in enumerate(blocks):
            rem, ci = [], 0
            for c in bc:
                if ci < len(cols) and c == cols[ci]:
                    ci += 1
                else:
                    rem.append(c)
            if ci == len(cols):
                if rem:
                    blocks[bi] = (rem, br)
                    blocks.append((cols, br))
                break
        else:
            raise ValueError(
                "orthogonality structure incompatible with mask")
    return blocks


# ---------------------------------------------------------------------------
# numpy float64 leapfrog (the report oracle)
# ---------------------------------------------------------------------------


def _update_position_np(X, M, blocks, eps):
    from scipy.linalg import expm, solve_triangular

    for cols, rows in blocks:
        nC = len(cols)
        ix = np.ix_(rows, cols)
        Xb, Mb = X[ix], M[ix]
        A = Xb.T @ Mb
        S2 = Mb.T @ Mb
        VtV = np.block([[A, -S2], [np.eye(nC), A]])
        E1 = expm(-eps * A)
        Z = expm(eps * VtV) @ np.block(
            [[E1, np.zeros((nC, nC))], [np.zeros((nC, nC)), E1]])
        W = np.hstack([Xb, Mb]) @ Z
        Xn, Mn = W[:, :nC], W[:, nC:]
        # X <- X L^{-T} with L L^T = X^T X (:530-553)
        L = np.linalg.cholesky(Xn.T @ Xn)
        Xn = solve_triangular(L, Xn.T, lower=True).T
        X[ix], M[ix] = Xn, Mn


def _project_momentum_np(X, M, blocks):
    for cols, rows in blocks:
        ix = np.ix_(rows, cols)
        Xb, Mb = X[ix], M[ix]
        A = Xb.T @ Mb
        M[ix] = Mb - Xb @ ((A + A.T) / 2.0)


def geodesic_leapfrog_np(
    X0: np.ndarray,
    M0: np.ndarray,
    grad_fn: Callable[[np.ndarray], np.ndarray],
    n_steps: int,
    eps: float,
    blocks,
    grad_mask: Optional[np.ndarray] = None,
    draw_variance: float = 1.0,
) -> Tuple[np.ndarray, float]:
    """The reference's leapFrogGivenMomentum
    (HamiltonianMonteCarloOperator.java:482-521): (final position,
    hastings). X0 and M0 are (p, k); grad_fn returns the (p, k) gradient of
    the log density; grad_mask, an optional (p, k) 0/1 mask on the gradient
    (masked momenta are inert and cancel in the hastings difference)."""
    X = np.array(X0, float)
    M = np.array(M0, float)

    def kinetic():
        return 0.5 * draw_variance * float(np.sum(M * M))

    def kick(step):
        g = np.asarray(grad_fn(X), float)
        if grad_mask is not None:
            g = g * grad_mask
        M[:] = M + step * g
        _project_momentum_np(X, M, blocks)

    _project_momentum_np(X, M, blocks)
    prop = kinetic()
    kick(eps / 2.0)
    for i in range(n_steps):
        _update_position_np(X, M, blocks, eps)
        if i < n_steps - 1:
            kick(eps)
    kick(eps / 2.0)
    return X, prop - kinetic()


def deterministic_momentum(p: int, k: int) -> np.ndarray:
    """The report protocol's momentum: flat column-major m[i] = i
    (GeodesicHamiltonianMonteCarloOperator.getReport:80-83)."""
    return np.arange(p * k, dtype=float).reshape((k, p)).T.copy()


# ---------------------------------------------------------------------------
# chain operator (one whole-matrix Stiefel block)
# ---------------------------------------------------------------------------


def project_momentum(X, M):
    A = X.transpose(-1, -2) @ M
    return M - X @ ((A + A.transpose(-1, -2)) / 2.0)


def update_position(X, M, eps):
    """The geodesic flow of (X, M) for time eps, then X re-orthonormalised;
    X and M may carry a leading chain axis, eps then [B, 1, 1]."""
    k = X.shape[-1]
    A = X.transpose(-1, -2) @ M
    eye = torch.eye(k, dtype=X.dtype, device=X.device).expand(A.shape)
    zero = X.new_zeros(A.shape)
    vtv = torch.cat([torch.cat([A, -M.transpose(-1, -2) @ M], -1),
                     torch.cat([eye, A], -1)], -2)
    e1 = torch.linalg.matrix_exp(-eps * A)
    z = torch.linalg.matrix_exp(eps * vtv) @ torch.cat(
        [torch.cat([e1, zero], -1), torch.cat([zero, e1], -1)], -2)
    w = torch.cat([X, M], -1) @ z
    xn, mn = w[..., :k], w[..., k:]
    # a failure shows as NaN
    L = torch.linalg.cholesky_ex(xn.transpose(-1, -2) @ xn)[0]
    return torch.linalg.solve_triangular(
        L, xn.transpose(-1, -2), upper=False).transpose(-1, -2), mn


@dataclasses.dataclass
class StiefelGeodesicHmcOperator(_Bound, Operator):
    """In-chain geodesic HMC over column parameters that form a (p, k)
    matrix with orthonormal columns; momentum N(0, draw_variance) in the
    tangent space. Over a chain batch X is [B, p, k], each chain its own
    step size."""

    parameters: Tuple[str, ...] = ()  # column parameters, each of length p
    n_leapfrog: int = 5
    step_size: float = 0.05
    draw_variance: float = 1.0
    adaptable: bool = True
    target_acceptance: float = 0.8
    _log_posterior: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _put(self, params, X):
        out = dict(params)
        for j, n in enumerate(self.parameters):
            out[n] = X[..., :, j].to(params[n].dtype).reshape(params[n].shape)
        return out

    def trajectory(self, lp, params, tree, X0, M0, eps):
        grad = lambda X: value_grad(  # noqa: E731
            lambda x: lp(self._put(params, x), tree), X)
        X, M = X0, M0
        for _ in range(self.n_leapfrog):
            M = project_momentum(X, M + 0.5 * eps * grad(X))
            X, M = update_position(X, M, eps)
            M = project_momentum(X, M + 0.5 * eps * grad(X))
        return X, M

    def _propose(self, lp, params, tree, gen, tuning):
        b_n = params[self.parameters[0]].shape[0]
        X0 = torch.stack([params[n].reshape(b_n, -1).to(tree.heights.dtype)
                          for n in self.parameters], dim=-1)
        M0 = project_momentum(X0, math.sqrt(self.draw_variance)
                              * _normal(gen, X0))
        X1, M1 = self.trajectory(lp, params, tree, X0, M0,
                                 per_chain(tuning, X0))
        X1, logh = _finish(X0, X1, 0.5 * (_sum_rows(M0 * M0)
                                          - _sum_rows(M1 * M1))
                           / self.draw_variance)
        return self._put(params, X1), tree, logh

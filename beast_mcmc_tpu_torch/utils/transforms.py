"""Parameter transforms between a constrained space and R^n.

Counterpart of beast_mcmc_tpu/utils/transforms.py (the reference's
Transform.java hierarchy), with its conventions:
  forward(x)  constrained -> unconstrained (the space samplers move in)
  inverse(y)  unconstrained -> constrained
  log_det_jacobian_inverse(y) = log |d inverse(y) / dy| (summed)
so a density over x becomes, in y-space,
  log p_Y(y) = log p_X(inverse(y)) + log_det_jacobian_inverse(y),
the correction an HMC operator adds when it samples y. Gradients come from
autograd. The default log-Jacobian is the log-determinant of the autograd
Jacobian; subclasses override it with closed forms.

A transform acts on one chain's vector; `over_chains` maps one of its
methods over a chain batch's rows ([B, n] -> [B, ...], the log-Jacobian
[B], each chain's own).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from beast_mcmc_tpu_torch.utils.accum import prefix_sum


def over_chains(fn, y):
    """fn (a transform's forward, inverse or log_det_jacobian_inverse) of
    each chain's row of y [B, n], stacked."""
    return torch.stack([fn(row) for row in y])


def _zero_like(y):
    y = torch.as_tensor(y)
    return torch.zeros((), dtype=y.dtype, device=y.device)


def _offsets(k, like):
    """log(k-1), ..., log(1): the simplex map's centring offsets."""
    return torch.log(torch.arange(k - 1, 0, -1, dtype=like.dtype,
                                  device=like.device))


class Transform:
    """Bijection between a constrained parameter space and R^n."""

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def log_det_jacobian_inverse(self, y):
        """log |d inverse(y)/dy| summed over elements: the log-determinant
        of the autograd Jacobian of the flattened map (subclasses override
        it with closed forms)."""
        y = torch.atleast_1d(torch.as_tensor(y))
        jac = torch.autograd.functional.jacobian(
            lambda v: torch.atleast_1d(self.inverse(v)).reshape(-1), y,
            create_graph=torch.is_grad_enabled() and y.requires_grad)
        return torch.linalg.slogdet(jac.reshape(jac.shape[0], -1))[1]

    def log_jacobian(self, x):
        """The reference's logJacobian at x (Transform.java:95):
        log |d forward(x)/dx| = -log_det_jacobian_inverse(forward(x))."""
        return -self.log_det_jacobian_inverse(self.forward(x))


@dataclasses.dataclass
class NoTransform(Transform):
    """Transform.java:1631 (NoTransform)."""

    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def log_det_jacobian_inverse(self, y):
        return _zero_like(y)


@dataclasses.dataclass
class LogTransform(Transform):
    """(0, inf) <-> R. Transform.java:815."""

    def forward(self, x):
        return torch.log(x)

    def inverse(self, y):
        return torch.exp(y)

    def log_det_jacobian_inverse(self, y):
        return torch.sum(y)


@dataclasses.dataclass
class LogitTransform(Transform):
    """(0, 1) <-> R. Transform.java:1125."""

    def forward(self, x):
        return torch.log(x) - torch.log1p(-x)

    def inverse(self, y):
        return torch.sigmoid(y)

    def log_det_jacobian_inverse(self, y):
        # d sigmoid/dy = sigmoid(y) sigmoid(-y)
        return torch.sum(F.logsigmoid(y) + F.logsigmoid(-y))


@dataclasses.dataclass
class ScaledLogitTransform(Transform):
    """(lower, upper) <-> R. Transform.java:1188."""

    lower: float = 0.0
    upper: float = 1.0

    def forward(self, x):
        z = (x - self.lower) / (self.upper - self.lower)
        return torch.log(z) - torch.log1p(-z)

    def inverse(self, y):
        return self.lower + (self.upper - self.lower) * torch.sigmoid(y)

    def log_det_jacobian_inverse(self, y):
        width = math.log(self.upper - self.lower)
        return torch.sum(F.logsigmoid(y) + F.logsigmoid(-y) + width)


@dataclasses.dataclass
class FisherZTransform(Transform):
    """(-1, 1) <-> R (correlations). Transform.java:1252."""

    def forward(self, x):
        return torch.atanh(x)

    def inverse(self, y):
        return torch.tanh(y)

    def log_det_jacobian_inverse(self, y):
        # d tanh/dy = sech^2(y); log sech^2 = 2(log 2 - y - softplus(-2y))
        return torch.sum(2.0 * (math.log(2.0) - y - F.softplus(-2.0 * y)))


@dataclasses.dataclass
class AffineTransform(Transform):
    """y = a*x + b. Transform.java:1555."""

    a: float = 1.0
    b: float = 0.0

    def forward(self, x):
        return self.a * x + self.b

    def inverse(self, y):
        return (y - self.b) / self.a

    def log_det_jacobian_inverse(self, y):
        y = torch.as_tensor(y)
        return _zero_like(y) - y.numel() * math.log(abs(self.a))


@dataclasses.dataclass
class NegateTransform(Transform):
    """y = -x. Transform.java:1307."""

    def forward(self, x):
        return -x

    def inverse(self, y):
        return -y

    def log_det_jacobian_inverse(self, y):
        return _zero_like(y)


@dataclasses.dataclass
class PowerTransform(Transform):
    """y = x^p on (0, inf). Transform.java:1362."""

    power: float = 2.0

    def forward(self, x):
        return torch.pow(x, self.power)

    def inverse(self, y):
        return torch.pow(y, 1.0 / self.power)

    def log_det_jacobian_inverse(self, y):
        p = self.power
        return torch.sum(-math.log(abs(p)) + (1.0 / p - 1.0) * torch.log(y))


@dataclasses.dataclass
class ReciprocalTransform(Transform):
    """y = 1/x on (0, inf). Transform.java:1438. Self-inverse; the image is
    (0, inf), not R: compose it with Log for samplers."""

    def forward(self, x):
        return 1.0 / x

    def inverse(self, y):
        return 1.0 / y

    def log_det_jacobian_inverse(self, y):
        return torch.sum(-2.0 * torch.log(y))


@dataclasses.dataclass
class PositiveOrderedTransform(Transform):
    """0 < x_0 < x_1 < ... <-> R^n by log-increments: y_0 = log x_0,
    y_i = log(x_i - x_{i-1})."""

    def forward(self, x):
        return torch.log(torch.diff(x, prepend=torch.zeros_like(x[:1])))

    def inverse(self, y):
        return prefix_sum(torch.exp(y))

    def log_det_jacobian_inverse(self, y):
        # triangular Jacobian, diagonal exp(y)
        return torch.sum(y)


@dataclasses.dataclass
class SimplexTransform(Transform):
    """Probability simplex (K) <-> R^{K-1} by stick-breaking with centring
    offsets: the bijection that stands in for the reference's
    LogConstrainedSumTransform (Transform.java:881), which keeps K
    coordinates and renormalises, and so is no bijection."""

    k: int = 2

    def forward(self, x):
        x = torch.atleast_1d(x)
        rem = 1.0 - torch.cat([torch.zeros_like(x[:1]), prefix_sum(x[:-1])])
        z = x[:-1] / rem[:-1]
        return torch.log(z) - torch.log1p(-z) + _offsets(self.k, x)

    def inverse(self, y):
        y = torch.atleast_1d(y)
        z = torch.sigmoid(y - _offsets(self.k, y))
        rem = torch.ones((), dtype=y.dtype, device=y.device)
        xs = []
        for zi in z:
            xs.append(rem * zi)
            rem = rem - xs[-1]
        return torch.stack([*xs, rem])

    def log_det_jacobian_inverse(self, y):
        y = torch.atleast_1d(y)
        u = y - _offsets(self.k, y)
        z = torch.sigmoid(u)
        rem = torch.ones((), dtype=y.dtype, device=y.device)
        total = _zero_like(y)
        for zi, ui in zip(z, u):
            # d x_i = rem dz_i; log dz/du = log sig(u) + log sig(-u)
            total = total + (torch.log(rem) + F.logsigmoid(ui)
                             + F.logsigmoid(-ui))
            rem = rem * (1.0 - zi)
        return total


@dataclasses.dataclass
class LKJCorrelationTransform(Transform):
    """Correlation-matrix off-diagonals (row-major upper triangle, length
    d(d-1)/2) <-> unconstrained canonical partial correlations (the
    reference's LKJTransformConstrained: z -> tanh -> CPCs -> Cholesky rows
    -> R = L L^T, and back through the Cholesky factor)."""

    d: int = 2

    def _tri(self):
        return np.triu_indices(self.d, 1)

    def inverse(self, z):
        d = self.d
        c = torch.tanh(torch.ravel(z))
        iu = self._tri()
        cpc = {(int(i), int(j)): c[k] for k, (i, j) in enumerate(zip(*iu))}
        zero = torch.zeros((), dtype=c.dtype, device=c.device)
        rows = []
        for i in range(d):
            row, rem = [], torch.ones_like(zero)
            for j in range(i):
                row.append(cpc[(j, i)] * torch.sqrt(rem))
                rem = rem * (1.0 - cpc[(j, i)] ** 2)
            row.append(torch.sqrt(rem))
            row.extend([zero] * (d - i - 1))
            rows.append(torch.stack(row))
        lmat = torch.stack(rows)
        r = lmat @ lmat.T
        return r[tuple(torch.as_tensor(a) for a in iu)]

    def forward(self, x):
        d = self.d
        iu = tuple(torch.as_tensor(a) for a in self._tri())
        x = torch.as_tensor(x)
        r = torch.eye(d, dtype=x.dtype, device=x.device)
        r = r.index_put(iu, x).index_put((iu[1], iu[0]), x)
        lmat = torch.linalg.cholesky(r)
        zs = []
        for i, j in zip(*self._tri()):
            denom = torch.sqrt(1.0 - torch.sum(lmat[j, :i] ** 2))
            zs.append(torch.atanh(lmat[j, i] / denom))
        return torch.stack(zs)


@dataclasses.dataclass
class ComposeTransform(Transform):
    """outer o inner: forward = outer.forward(inner.forward(x)).
    Transform.java:1793."""

    outer: Transform = None
    inner: Transform = None

    def forward(self, x):
        return self.outer.forward(self.inner.forward(x))

    def inverse(self, y):
        return self.inner.inverse(self.outer.inverse(y))

    def log_det_jacobian_inverse(self, y):
        mid = self.outer.inverse(y)
        return (self.outer.log_det_jacobian_inverse(y)
                + self.inner.log_det_jacobian_inverse(mid))


@dataclasses.dataclass
class ArrayTransform(Transform):
    """Blockwise transform over a flat vector: [(transform, size), ...].
    Transform.java:2169 (Array), 2344 (Collection)."""

    blocks: Sequence[Tuple[Transform, int]] = ()

    @staticmethod
    def _y_size(t: Transform, n: int) -> int:
        # the simplex maps n constrained coordinates to n - 1
        return n - 1 if isinstance(t, SimplexTransform) else n

    def _split(self, v, space: str):
        out, i = [], 0
        for t, n in self.blocks:
            m = n if space == "x" else self._y_size(t, n)
            out.append(v[i:i + m])
            i += m
        return out

    def forward(self, x):
        return torch.cat([torch.atleast_1d(t.forward(p)) for (t, _), p in
                          zip(self.blocks, self._split(x, "x"))])

    def inverse(self, y):
        return torch.cat([torch.atleast_1d(t.inverse(p)) for (t, _), p in
                          zip(self.blocks, self._split(y, "y"))])

    def log_det_jacobian_inverse(self, y):
        return sum(t.log_det_jacobian_inverse(p) for (t, _), p in
                   zip(self.blocks, self._split(y, "y")))


def parse_transform(name: str, **kw) -> Transform:
    """The reference's transform vocabulary (Transform.java Type enum)."""
    table = {
        "none": NoTransform,
        "log": LogTransform,
        "logit": LogitTransform,
        "scaledLogit": ScaledLogitTransform,
        "fisherZ": FisherZTransform,
        "negate": NegateTransform,
        "power": PowerTransform,
        "reciprocal": ReciprocalTransform,
        "affine": AffineTransform,
        "positiveOrdered": PositiveOrderedTransform,
        "logConstrainedSum": SimplexTransform,
        "simplex": SimplexTransform,
    }
    if name not in table:
        raise ValueError(f"unknown transform '{name}'")
    return table[name](**kw)

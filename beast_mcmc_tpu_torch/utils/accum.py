"""High-precision accumulation of log densities.

The reference's full-evaluation self-check tolerates 0.1 log units
(MarkovChain.java:55). At |logL| ~ 1e6 a float32 sum carries O(1) error, so
every such sum is taken in float64. The card does float64 natively, so no
compensated (Kahan) float32 path is needed.
"""

import torch


def accum_dtype() -> torch.dtype:
    """dtype in which carried log-density scalars are held."""
    return torch.float64


def stable_dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum(w * x) in float64; returns a 0-d float64 tensor."""
    return torch.dot(w.reshape(-1).to(torch.float64),
                     x.reshape(-1).to(torch.float64))


def stable_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x) in float64."""
    return torch.sum(x.to(torch.float64))


def prefix_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum."""
    return torch.cumsum(x, dim=dim)

"""The Bayesian-bridge shrinkage Gibbs operator.

Counterpart of beast_mcmc_tpu/inference/bridge_gibbs.py
(BayesianBridgeShrinkageOperator.java):

  - the global scale: the conjugate update of nu = tau^-alpha, nu | beta ~
    Gamma(c + p / alpha, rate d + sum |beta_j|^alpha), tau = nu^(-1/alpha)
    (:104-117), drawn on the device;
  - the local scales: lambda_j = sqrt(1 / (2 S_j)), S_j an exponentially
    tilted one-sided stable(alpha / 2) variate with tilt (beta_j / tau)^2
    (:154-176), drawn on the host with numpy: Kanter's representation of
    the stable variate, tilting by rejection, and the divide-and-conquer
    split S = sum_{i<=n} S_i (each of scale n^(-1/gamma)) that keeps each
    piece's acceptance away from zero under a large tilt. `tilted_stable`
    and `draw_local_scales` are JAX's functions line for line, so one
    numpy seed gives the same numbers in both packages.

JAX draws the local scales' seed from the chain's key and calls the host
through pure_callback; here the seed comes from the chain's generator, one
a chain, and the host draw follows one copy of the seeds and the tilts.
That host step cannot be vmapped: over a chain batch the operator runs its
own chain-axis proposal (`propose_chains`), the global scales drawn for
all chains at once.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.hmc import _only_chain, batch_of_one
from beast_mcmc_tpu_torch.inference.operators import Operator, gamma_draw


def _one_sided_stable(rng, gamma: float, size) -> np.ndarray:
    """Standard positive stable(gamma) draws by Kanter's representation."""
    u = rng.uniform(0.0, np.pi, size)
    e = rng.exponential(1.0, size)
    a = (np.sin(gamma * u) ** gamma
         * np.sin((1.0 - gamma) * u) ** (1.0 - gamma)
         / np.sin(u)) ** (1.0 / (1.0 - gamma))
    return (a / e) ** ((1.0 - gamma) / gamma)


def tilted_stable(rng, gamma: float, tilt: float) -> float:
    """An exponentially tilted one-sided stable draw: density proportional
    to e^(-tilt s) f_gamma(s). Divide and conquer: n with tilt
    n^(-1/gamma) = O(1), so that each of the n rescaled pieces accepts
    with probability about e^-1 or more."""
    n = max(1, int(np.ceil(tilt ** gamma)))
    scale = n ** (-1.0 / gamma)
    total = 0.0
    for _ in range(n):
        while True:
            s = float(_one_sided_stable(rng, gamma, ())) * scale
            if rng.uniform() <= math.exp(-tilt * s):
                total += s
                break
    return total


def draw_local_scales(seed: int, gamma: float,
                      ratios2: np.ndarray) -> np.ndarray:
    """lambda_j = sqrt(1 / (2 S_j)), S_j tilted-stable(gamma, tilt =
    ratios2_j), from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(int(seed))
    out = np.empty(ratios2.shape[0])
    for j, t in enumerate(np.ravel(ratios2)):
        s = tilted_stable(rng, gamma, float(max(t, 1e-300)))
        out[j] = math.sqrt(1.0 / (2.0 * s))
    return out


def _gamma(gen, shape, like, size=()):
    """Gamma(shape, 1) draws of `size` (operators.gamma_draw)."""
    return gamma_draw(gen, shape, like, size)


def _seeds(gen, n: int, like) -> torch.Tensor:
    """n local-scale seeds in [0, 2^31 - 1), JAX's range."""
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=gen,
                         device=like.device)


@dataclasses.dataclass
class BayesianBridgeGibbsOperator(Operator):
    """The Gibbs update of (globalScale, localScale) of a Bayesian-bridge
    prior over `coefficient`; local_scale "" for none. A declared local
    scale longer than the coefficients keeps its extra entries."""

    coefficient: str = ""
    global_scale: str = ""
    local_scale: str = ""
    exponent: float = 0.25
    prior_shape: float = 0.0  # a gamma prior on phi = tau^-alpha
    prior_scale: float = 1.0
    adaptable: bool = False

    def modified_params(self):
        out = [self.global_scale]
        if self.local_scale:
            out.append(self.local_scale)
        return tuple(out)

    @property
    def modifies_params(self):
        return self.modified_params()

    def propose(self, params, tree, gen, tuning):
        return _only_chain(self.propose_chains(
            batch_of_one(params), batch_of_one(tree), gen, tuning))

    def propose_chains(self, params, tree, gen, tuning):
        """Every chain of a batch at once: params with the leading chain
        axis; log Hastings [B] (+inf)."""
        alpha = self.exponent
        old_g = params[self.global_scale]
        b_n = old_g.shape[0]
        beta = params[self.coefficient].reshape(b_n, -1)
        shape = beta.shape[1] / alpha
        rate = torch.sum(torch.abs(beta) ** alpha, dim=1)
        if self.prior_shape > 0.0:
            shape = shape + self.prior_shape
            rate = rate + 1.0 / self.prior_scale
        phi = _gamma(gen, shape, beta, (b_n,)) / rate
        tau = phi ** (-1.0 / alpha)
        out = {**params, self.global_scale: tau.reshape(old_g.shape).to(
            old_g.dtype)}
        if self.local_scale:
            ratios2 = torch.square(beta / tau[:, None])
            seeds = _seeds(gen, b_n, beta).tolist()
            r2 = ratios2.detach().double().cpu().numpy()
            lam = torch.as_tensor(
                np.stack([draw_local_scales(sd, alpha / 2.0, r2[b])
                          for b, sd in enumerate(seeds)]),
                dtype=beta.dtype, device=beta.device)
            old_l = params[self.local_scale]
            flat = old_l.reshape(b_n, -1)
            out[self.local_scale] = torch.cat(
                [lam.to(old_l.dtype), flat[:, lam.shape[1]:]],
                dim=1).reshape(old_l.shape)
        return out, tree, torch.full((b_n,), math.inf, dtype=beta.dtype,
                                     device=beta.device)

"""Marginal-likelihood estimation: path sampling and stepping stones.

Counterpart of beast_mcmc_tpu/inference/marginal_likelihood.py, the role of
dr.inference.mcmc.MarginalLikelihoodEstimator and PathLikelihood
(MarginalLikelihoodEstimator.java:55-115,185: the path parameter beta
annealed over a beta-quantile schedule; PathLikelihood.java:44: pathLogL =
beta logL + logPrior) and of the trace-side estimators
(PathSamplingAnalysis.java, SteppingStoneSamplingAnalysis.java,
GeneralizedSteppingStoneSamplingAnalysis.java).

A rung is a tempered target, logP_beta = beta logLik + logPrior (or, on the
generalized path, beta (logLik + logPrior) + (1 - beta) logRef), run by the
port's chain (inference/mcmc.py) with one make_mcmc_step a rung. The ladder
is sequential: each rung starts from the state the previous one ended in,
its posterior re-evaluated under the new beta first (one evaluation, one
kernel launch on a CUDA device), as in the reference's chain of steps and
the JAX package; the rungs are never run as independent chains. The
collector evaluates the integrand every `log_every` states and the samples
come back to the host once a rung. The estimators are host numpy over the
collected arrays, JAX's arithmetic line for line.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.mcmc import (
    init_mcmc_state,
    make_mcmc_step,
    run_chain,
)
from beast_mcmc_tpu_torch.utils.accum import accum_dtype

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def beta_quantile_schedule(n_steps: int, alpha: float = 0.3) -> np.ndarray:
    """The Beta(alpha, 1)-quantile ladder from 1 to 0 (the reference's
    default 'betaquantile' schedule; alpha = 0.3 puts the rungs near beta
    = 0, where the integrand varies fastest)."""
    q = np.linspace(1.0, 0.0, n_steps)
    return q ** (1.0 / alpha)


def make_power_posterior(log_likelihood, log_prior):
    """beta -> lp(params, tree) = beta logLik + logPrior."""
    def power_log_post(beta):
        def lp(params, tree):
            return beta * log_likelihood(params, tree) + log_prior(params,
                                                                   tree)

        return lp

    return power_log_post


def make_gss_path(log_likelihood, log_prior, log_reference):
    """The generalized stepping-stone path: beta -> lp = beta (logLik +
    logPrior) + (1 - beta) logRef, from a normalized working distribution
    (beta = 0) to the posterior (beta = 1)
    (GeneralizedSteppingStoneSamplingAnalysis.java:45; Fan et al. 2011)."""
    def power_log_post(beta):
        def lp(params, tree):
            joint = log_likelihood(params, tree) + log_prior(params, tree)
            return beta * joint + (1.0 - beta) * log_reference(params, tree)

        return lp

    return power_log_post


def _ladder(path, integrand, operators, params0, tree0, betas, chain_length,
            log_every, generator, burnin_fraction):
    """Run the rungs in order, the state handed down; [n_betas, n_samples]
    of integrand(params, tree) every log_every states, less each rung's
    burn-in. Each rung runs (chain_length // log_every) * log_every
    states, as JAX's collecting run_chain does."""
    all_samples = []
    state = None
    n_steps = (chain_length // log_every) * log_every
    for beta in betas:
        lp = path(float(beta))
        step = make_mcmc_step(lp, operators)
        if state is None:
            state = init_mcmc_state(params0, tree0, generator, operators, lp)
        else:
            # the inherited state's posterior under the new beta
            state = state.replace(
                log_posterior=lp(state.params, state.tree).to(accum_dtype()))

        def collector(s):
            return {"x": integrand(s.params, s.tree).reshape(())}

        state, out = run_chain(step, state, n_steps, log_every, collector)
        samples = out["x"].detach().cpu().numpy().astype(np.float64)
        n_burn = int(len(samples) * burnin_fraction)
        all_samples.append(samples[n_burn:])
    return np.asarray(all_samples)


def sample_power_posteriors(log_likelihood, log_prior, operators, params0,
                            tree0, betas: Sequence[float], chain_length: int,
                            log_every: int, generator: torch.Generator,
                            burnin_fraction: float = 0.1) -> np.ndarray:
    """One chain a beta, in order, the state handed down the ladder;
    logLik samples [n_betas, n_samples]. `generator` lives on the tree's
    device and seeds the chain."""
    return _ladder(make_power_posterior(log_likelihood, log_prior),
                   log_likelihood, operators, params0, tree0, betas,
                   chain_length, log_every, generator, burnin_fraction)


def sample_gss_ratios(log_likelihood, log_prior, log_reference, operators,
                      params0, tree0, betas: Sequence[float],
                      chain_length: int, log_every: int,
                      generator: torch.Generator,
                      burnin_fraction: float = 0.1) -> np.ndarray:
    """The generalized stepping-stone ladder; per-rung samples of logLik +
    logPrior - logRef (what the GSS estimator exponentiates), [n_betas,
    n_samples]."""
    def ratio(params, tree):
        return (log_likelihood(params, tree) + log_prior(params, tree)
                - log_reference(params, tree))

    return _ladder(make_gss_path(log_likelihood, log_prior, log_reference),
                   ratio, operators, params0, tree0, betas, chain_length,
                   log_every, generator, burnin_fraction)


def path_sampling_logml(log_liks: np.ndarray, betas: Sequence[float]) -> float:
    """The trapezoidal path-sampling estimator (PathSamplingAnalysis.java):
    log m = int_0^1 E_beta[logL] dbeta."""
    means = log_liks.mean(axis=1)
    betas = np.asarray(betas, np.float64)
    order = np.argsort(betas)
    return float(_trapezoid(means[order], betas[order]))


def _stepping_stones(log_x: np.ndarray, betas: Sequence[float]) -> float:
    """sum_k log E_{beta_k}[exp((beta_{k+1} - beta_k) x)], each term by a
    log-sum-exp."""
    betas = np.asarray(betas, np.float64)
    order = np.argsort(betas)
    b = betas[order]
    lx = log_x[order]
    total = 0.0
    for k in range(len(b) - 1):
        x = (b[k + 1] - b[k]) * lx[k]
        xmax = x.max()
        total += xmax + np.log(np.mean(np.exp(x - xmax)))
    return float(total)


def stepping_stone_logml(log_liks: np.ndarray,
                         betas: Sequence[float]) -> float:
    """The stepping-stone estimator (SteppingStoneSamplingAnalysis.java):
    log m = sum_k log E_{beta_k}[exp((beta_{k+1} - beta_k) logL)]."""
    return _stepping_stones(log_liks, betas)


def generalized_stepping_stone_logml(log_ratios: np.ndarray,
                                     betas: Sequence[float]) -> float:
    """The generalized stepping-stone estimator
    (GeneralizedSteppingStoneSamplingAnalysis.java:45 computeLogX): the
    stepping stones over logJoint - logRef, with samples from each rung's
    path target and a normalized reference (beta = 0 adds log Z_ref = 0)."""
    return _stepping_stones(log_ratios, betas)


def harmonic_mean_logml(log_liks_posterior: np.ndarray) -> float:
    """The Newton-Raftery harmonic mean, for parity; known to be
    unstable."""
    x = -np.asarray(log_liks_posterior)
    xmax = x.max()
    return float(-(xmax + np.log(np.mean(np.exp(x - xmax)))))

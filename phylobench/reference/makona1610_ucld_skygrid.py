"""Plain reference of the Makona-1610 GTR+G4, UCLD and skygrid posterior.

log posterior = Felsenstein's likelihood of the alignment (GTR generator
from six exchangeabilities AC, AG, AT, CG, CT, GT and fixed frequencies,
four Gamma categories, each branch's time times its clock rate)
+ the skygrid coalescent of the node times + the RW1 GMRF on its log
populations + Gamma(0.001, 1000) on the GMRF precision + an exponential on
the clock mean + Gamma priors on the exchangeabilities.
"""

from __future__ import annotations

import numpy as np
import torch

from phylobench.reference import _plain

_EXCHANGE = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _chain_parts(cfg, inputs, params, tree, dtype, device):
    """Per-chain numpy and tensors: branch lengths in substitutions, the
    generators, category rates and the tree's arrays."""
    b_n, m = tree["parent"].shape
    n = (m + 1) // 2
    f = lambda k: params[k].detach().to(torch.float64).cpu().numpy()
    parent = tree["parent"].cpu().numpy()
    heights = tree["heights"].to(dtype).to(device)
    rates6 = torch.as_tensor(f("p1.gtr.rates"), dtype=dtype, device=device)
    exch = torch.zeros((b_n, 4, 4), dtype=dtype, device=device)
    for col, (i, j) in enumerate(_EXCHANGE):
        exch[:, i, j] = exch[:, j, i] = rates6[:, col]
    freqs = torch.tensor(cfg["frequencies"], dtype=dtype, device=device)
    q = _plain.reversible_q(exch, freqs)
    cat = torch.as_tensor(_plain.gamma_category_rates(
        f("p1.alpha"), cfg["gamma_categories"]), dtype=dtype, device=device)
    clock = torch.as_tensor(_plain.lognormal_category_rates(
        params["branchRates.categories"].cpu().numpy(), f("ucld.mean"),
        f("ucld.stdev"), m - 1), dtype=dtype, device=device)
    return n, parent, heights, q, freqs, cat, clock


def _lengths(heights, parent, clock):
    """Branch lengths in substitutions [M] of one chain (0 at the root)."""
    par = torch.as_tensor(np.maximum(parent, 0), device=heights.device)
    t = torch.where(torch.as_tensor(parent >= 0, device=heights.device),
                    heights[par] - heights, torch.zeros_like(heights))
    return t * clock


def _prior(cfg, params, heights, n, b, dtype, device):
    """The prior terms of chain b (its heights [M] may carry a gradient)."""
    g = lambda k: params[k][b].detach().to(dtype).to(device)
    cells = cfg["skygrid_cells"]
    cuts = torch.as_tensor(np.linspace(0, cfg["skygrid_cutoff"],
                                       cells)[1:], dtype=dtype,
                           device=device)
    log_pop, tau = g("skygrid.logPopSizes"), g("skygrid.precision")
    shape, scale = cfg["gtr_rates_prior"]
    return (_plain.skygrid_coalescent(heights, n, log_pop, cuts)
            + _plain.gmrf_rw1(log_pop, tau)
            + _plain.gamma_logpdf(tau, *cfg["precision_prior"])
            + _plain.exponential_logpdf(g("ucld.mean"),
                                        cfg["ucld_mean_prior_mean"])
            + _plain.gamma_logpdf(g("p1.gtr.rates"), shape, scale).sum())


def log_posterior(cfg, inputs, params, tree, dtype, device):
    """[B] log posteriors of the chains' states, in `dtype` throughout."""
    n, parent, heights, q, freqs, cat, clock = _chain_parts(
        cfg, inputs, params, tree, dtype, device)
    b_n, m = parent.shape
    tips = _plain.one_hot_tips(inputs["states"], 4, dtype, device)
    weights = torch.as_tensor(inputs["weights"], dtype=dtype, device=device)
    children = tree["children"].cpu().numpy()
    roots = tree["root"].cpu().numpy().reshape(b_n)
    c = cfg["gamma_categories"]
    cat_w = torch.full((b_n, c), 1.0 / c, dtype=dtype, device=device)
    out = []
    step = _plain.block_size(m, c, 4, tips.shape[-1], tips.element_size())
    for lo in range(0, b_n, step):
        idx = range(lo, min(b_n, lo + step))
        pm = torch.stack([_plain.transition_matrices(
            q[b], _lengths(heights[b], parent[b], clock[b]), cat[b])
            for b in idx])
        out.append(_plain.peel_block(tips, pm, children[lo:lo + step],
                                     roots[lo:lo + step], n, freqs,
                                     cat_w[lo:lo + step], weights))
        del pm
    lik = torch.cat(out)
    prior = torch.stack([_prior(cfg, params, heights[b], n, b, dtype, device)
                         for b in range(b_n)])
    return lik + prior


def grad_heights(cfg, inputs, params, tree, dtype, device):
    """[B, M] gradients of each chain's log posterior in its node heights
    (the tips' rows included, as the program's autograd gives them)."""
    n, parent, heights, q, freqs, cat, clock = _chain_parts(
        cfg, inputs, params, tree, dtype, device)
    b_n, m = parent.shape
    tips = _plain.one_hot_tips(inputs["states"], 4, dtype, device)
    weights = torch.as_tensor(inputs["weights"], dtype=dtype, device=device)
    children = tree["children"].cpu().numpy()
    roots = tree["root"].cpu().numpy().reshape(b_n)
    c = cfg["gamma_categories"]
    cat_w = torch.full((c,), 1.0 / c, dtype=dtype, device=device)
    grads = []
    for b in range(b_n):
        h = heights[b].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            pm = _plain.spectral_transition_matrices(
                q[b], freqs, _lengths(h, parent[b], clock[b]), cat[b])
            lp = (_plain.peel_chain(tips, pm, children[b], roots[b], n,
                                    freqs, cat_w, weights)
                  + _prior(cfg, params, h, n, b, dtype, device))
        grads.append(torch.autograd.grad(lp, h)[0])
    return torch.stack(grads)

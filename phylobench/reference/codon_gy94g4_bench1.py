"""Plain reference of the GY94+G4 codon posterior at benchmark1's size.

log posterior = Felsenstein's likelihood of the codon alignment under
Goldman and Yang's generator (single-nucleotide changes between the 61
sense codons of the universal code, in ACGT order, at kappa for a
transition and omega for a non-synonymous change, uniform frequencies,
scaled to a mean rate of 1), four Gamma categories and a strict clock
+ the constant-size coalescent + 1/x on the population size
+ LogNormal(0, 1) on the clock rate.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from phylobench.reference import _plain

NUC = "ACGT"
_AMINO = ("KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF")


def _codon_tables():
    """(single, transition, non-synonymous) [61, 61] over the sense
    codons: single marks codons one nucleotide apart."""
    codons = ["".join(c) for c in itertools.product(NUC, repeat=3)]
    amino = dict(zip(codons, _AMINO))
    sense = [c for c in codons if amino[c] != "*"]
    k = len(sense)
    single = np.zeros((k, k))
    ts = np.zeros((k, k))
    nonsyn = np.zeros((k, k))
    for i, a in enumerate(sense):
        for j, b in enumerate(sense):
            diff = [(x, y) for x, y in zip(a, b) if x != y]
            if len(diff) != 1:
                continue
            single[i, j] = 1.0
            ts[i, j] = float(set(diff[0]) in ({"A", "G"}, {"C", "T"}))
            nonsyn[i, j] = float(amino[a] != amino[b])
    return single, ts, nonsyn


def _generators(params, dtype, device):
    single, ts, nonsyn = (torch.as_tensor(a, dtype=dtype, device=device)
                          for a in _codon_tables())
    kappa = params["kappa"].detach().to(dtype).to(device)[:, None, None]
    omega = params["omega"].detach().to(dtype).to(device)[:, None, None]
    exch = single * kappa ** ts * omega ** nonsyn
    freqs = torch.full((61,), 1.0 / 61, dtype=dtype, device=device)
    return _plain.reversible_q(exch, freqs), freqs


def _parts(cfg, inputs, params, tree, dtype, device):
    b_n, m = tree["parent"].shape
    q, freqs = _generators(params, dtype, device)
    cat = torch.as_tensor(_plain.gamma_category_rates(
        params["alpha"].detach().to(torch.float64).cpu().numpy(),
        cfg["gamma_categories"]), dtype=dtype, device=device)
    tips = _plain.one_hot_tips(inputs["states"], 61, dtype, device)
    weights = torch.as_tensor(inputs["weights"], dtype=dtype, device=device)
    return ((m + 1) // 2, tree["parent"].cpu().numpy(),
            tree["heights"].to(dtype).to(device), q, freqs, cat, tips,
            weights, tree["children"].cpu().numpy(),
            tree["root"].cpu().numpy().reshape(b_n))


def _lengths(heights, parent, rate):
    par = torch.as_tensor(np.maximum(parent, 0), device=heights.device)
    t = torch.where(torch.as_tensor(parent >= 0, device=heights.device),
                    heights[par] - heights, torch.zeros_like(heights))
    return t * rate


def _prior(params, heights, n, b, dtype, device):
    pop = params["pop.size"][b].detach().to(dtype).to(device)
    rate = params["clock.rate"][b].detach().to(dtype).to(device)
    return (_plain.constant_coalescent(heights, n, pop) - torch.log(pop)
            + _plain.lognormal_logpdf(rate, 0.0, 1.0))


def log_posterior(cfg, inputs, params, tree, dtype, device):
    """[B] log posteriors of the chains' states, in `dtype` throughout."""
    n, parent, heights, q, freqs, cat, tips, weights, children, roots = (
        _parts(cfg, inputs, params, tree, dtype, device))
    b_n, m = parent.shape
    c = cfg["gamma_categories"]
    cat_w = torch.full((b_n, c), 1.0 / c, dtype=dtype, device=device)
    rate = params["clock.rate"].detach().to(dtype).to(device)
    step = _plain.block_size(m, c, 61, tips.shape[-1], tips.element_size())
    out = []
    for lo in range(0, b_n, step):
        idx = range(lo, min(b_n, lo + step))
        pm = torch.stack([_plain.transition_matrices(
            q[b], _lengths(heights[b], parent[b], rate[b]), cat[b])
            for b in idx])
        out.append(_plain.peel_block(tips, pm, children[lo:lo + step],
                                     roots[lo:lo + step], n, freqs,
                                     cat_w[lo:lo + step], weights))
        del pm
    prior = torch.stack([_prior(params, heights[b], n, b, dtype, device)
                         for b in range(b_n)])
    return torch.cat(out) + prior


def grad_heights(cfg, inputs, params, tree, dtype, device):
    """[B, M] gradients of each chain's log posterior in its node heights."""
    n, parent, heights, q, freqs, cat, tips, weights, children, roots = (
        _parts(cfg, inputs, params, tree, dtype, device))
    c = cfg["gamma_categories"]
    cat_w = torch.full((c,), 1.0 / c, dtype=dtype, device=device)
    rate = params["clock.rate"].detach().to(dtype).to(device)
    grads = []
    for b in range(parent.shape[0]):
        h = heights[b].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            pm = _plain.spectral_transition_matrices(
                q[b], freqs, _lengths(h, parent[b], rate[b]), cat[b])
            lp = (_plain.peel_chain(tips, pm, children[b], roots[b], n,
                                    freqs, cat_w, weights)
                  + _prior(params, h, n, b, dtype, device))
        grads.append(torch.autograd.grad(lp, h)[0])
    return torch.stack(grads)

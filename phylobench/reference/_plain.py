"""Plain pieces the configurations' references share.

Plain PyTorch, numpy and scipy only: nothing of the program under test and
nothing of JAX. Every quantity is worked out from the inputs the benchmark
made and the chains' states: the generator from the exchangeabilities,
P(t) by `torch.linalg.matrix_exp`, the Gamma category rates by scipy's
inverse incomplete gamma, the relaxed clock's rates by scipy's normal
quantile, the coalescent by sorting the node times, and Felsenstein's peel
node by node in post-order with a rescale at every node.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import gammaincinv, ndtri

# bytes of partials a block of chains may hold while the peel runs
BLOCK_BYTES = 12 * 2 ** 30


def postorder(children: np.ndarray, root: int, n_taxa: int) -> np.ndarray:
    """The internal nodes of one tree, every child before its parent."""
    out, stack = [], [int(root)]
    while stack:
        node = stack.pop()
        if node >= n_taxa:
            out.append(node)
            stack.extend(int(c) for c in children[node])
    return np.asarray(out[::-1], np.int64)


def one_hot_tips(states: np.ndarray, n_states: int, dtype, device):
    """[N, S, P] tip partials of unambiguous states [N, P]."""
    st = torch.as_tensor(np.asarray(states, np.int64), device=device)
    return torch.nn.functional.one_hot(st, n_states).to(dtype).permute(
        0, 2, 1).contiguous()


def reversible_q(exchange: torch.Tensor, freqs: torch.Tensor):
    """Q[i, j] = R[i, j] pi_j off the diagonal, rows summing to 0, scaled to
    a mean rate of 1; R [..., S, S] symmetric (its diagonal ignored)."""
    s = freqs.shape[-1]
    off = 1.0 - torch.eye(s, dtype=exchange.dtype, device=exchange.device)
    q = exchange * off * freqs[..., None, :]
    q = q - torch.diag_embed(q.sum(-1))
    rate = -(freqs * torch.diagonal(q, dim1=-2, dim2=-1)).sum(-1)
    return q / rate[..., None, None]


def gamma_category_rates(alpha: np.ndarray, k: int) -> np.ndarray:
    """[B, K] median rates of K equal-weight Gamma(alpha, 1/alpha)
    categories at (2i + 1) / 2K, normalised to mean 1 (Yang 1994)."""
    p = (2.0 * np.arange(k) + 1.0) / (2.0 * k)
    q = gammaincinv(np.asarray(alpha, np.float64)[:, None], p[None, :])
    return q / q.mean(-1, keepdims=True)


def lognormal_category_rates(categories: np.ndarray, mean: np.ndarray,
                             stdev: np.ndarray, k: int) -> np.ndarray:
    """[B, M] branch rates of a discretised lognormal clock: the quantile
    at (c + 0.5) / K of a lognormal of real-space mean `mean`."""
    sigma = np.asarray(stdev, np.float64)[:, None]
    mu = np.log(np.asarray(mean, np.float64))[:, None] - 0.5 * sigma ** 2
    return np.exp(mu + sigma * ndtri((categories + 0.5) / k))


def transition_matrices(q: torch.Tensor, lengths: torch.Tensor,
                        cat_rates: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] = exp(Q t_m r_c) of one chain by scaling and squaring
    (`torch.linalg.matrix_exp`); lengths [M] in substitutions a unit rate,
    cat_rates [C]."""
    scaled = lengths[:, None, None, None] * cat_rates[None, :, None, None]
    return torch.linalg.matrix_exp(q[None, None] * scaled)


def spectral_transition_matrices(q, freqs, lengths, cat_rates):
    """The same matrices from the spectrum of the pi-symmetrised Q: exp(Q
    t) = D^-1 V exp(W t) V^T D, D = diag(sqrt pi). The spectrum is a
    constant of the node times, so a gradient in the lengths is exact
    (matrix_exp's own backward takes the exponential of a block matrix
    whose norm grows with the incoming gradient)."""
    d = torch.sqrt(freqs)
    a = q * d[:, None] / d[None, :]
    w, v = torch.linalg.eigh(0.5 * (a + a.T))
    t = lengths[:, None, None] * cat_rates[None, :, None]  # [M, C, 1]
    e = torch.exp(w.detach() * t)  # [M, C, S]
    v = v.detach()
    # an entry that is 0 to rounding may come out a rounding below it
    return (((v * e[..., None, :]) @ v.T) * (d[None, :] / d[:, None])
            ).clamp_min(0.0)


def peel_block(tips, pm, children, roots, n_taxa, freqs, cat_w, weights):
    """[B] log-likelihoods of a block of chains, without gradient: every
    chain peels its own tree node by node in post-order, the chains side
    by side (the i-th node of each chain's order at once). pm [B, M, C, S,
    S]; children [B, M, 2] and roots [B] numpy; freqs [S], cat_w [B, C],
    weights [P]."""
    b_n, m, c, s, _ = pm.shape
    p = tips.shape[-1]
    dev = pm.device
    order = torch.as_tensor(np.stack(
        [postorder(children[b], roots[b], n_taxa) for b in range(b_n)]),
        device=dev)
    ch = torch.as_tensor(np.asarray(children, np.int64), device=dev)
    ar = torch.arange(b_n, device=dev)
    buf = tips.new_empty((b_n, m, c, s, p))
    buf[:, :n_taxa] = tips[None, :, None]
    logs = tips.new_zeros((b_n, p))
    for i in range(order.shape[1]):
        node = order[:, i]
        kids = ch[ar, node]
        v = torch.matmul(pm[ar[:, None], kids], buf[ar[:, None], kids])
        v = v[:, 0] * v[:, 1]
        scale = v.amax(dim=(1, 2))
        buf[ar, node] = v / scale[:, None, None]
        logs += torch.log(scale)
    root = buf[ar, torch.as_tensor(np.asarray(roots, np.int64), device=dev)]
    site = torch.log(torch.einsum("bcsp,s,bc->bp", root, freqs, cat_w))
    return (site + logs) @ weights


def peel_chain(tips, pm, children, root, n_taxa, freqs, cat_w, weights):
    """One chain's log-likelihood, node by node, differentiable in pm."""
    part = {}
    logs = 0.0
    for node in postorder(children, root, n_taxa):
        v = 1.0
        for kid in children[node]:
            kid = int(kid)
            x = tips[kid] if kid < n_taxa else part.pop(kid)
            v = v * torch.matmul(pm[kid], x)
        # a constant for the gradient: the peel is linear in each partial,
        # so the scales cancel exactly (and a float32 control's tiny scale
        # squared would underflow in the quotient's backward)
        scale = v.amax(dim=(0, 1)).detach()
        part[int(node)] = v / scale
        logs = logs + torch.log(scale)
    site = torch.log(torch.einsum("csp,s,c->p", part[int(root)], freqs,
                                  cat_w))
    return (site + logs) @ weights


def block_size(n_nodes, n_cat, n_states, n_patterns, itemsize) -> int:
    """Chains a block: what BLOCK_BYTES holds of the peel's buffer."""
    per_chain = 2 * n_nodes * n_cat * n_states * n_patterns * itemsize
    return max(1, BLOCK_BYTES // per_chain)


def coalescent_events(heights: torch.Tensor, n_taxa: int):
    """(times [M], lineages after each event [M], coalescence flags [M]) of
    one tree: node times sorted, a tip before a coalescence at equal
    times."""
    m = heights.shape[0]
    is_coal = torch.arange(m, device=heights.device) >= n_taxa
    key = np.lexsort((is_coal.cpu().numpy(),
                      heights.detach().cpu().numpy()))
    order = torch.as_tensor(key, device=heights.device)
    times = heights[order]
    coal = is_coal[order]
    lineages = torch.cumsum(torch.where(coal, -1, 1), 0)
    return times, lineages, coal


def skygrid_coalescent(heights, n_taxa, log_pop, cuts):
    """Coalescent log density under N(t) = exp(log_pop[k]) on grid cell k,
    cells bounded by `cuts` (K - 1 increasing times; the last cell open);
    an event on a boundary belongs to the cell below it."""
    times, lineages, coal = coalescent_events(heights, n_taxa)
    lo = torch.cat([cuts.new_zeros(1), cuts])
    hi = torch.cat([cuts, cuts.new_full((1,), math.inf)])
    t0, t1 = times[:-1, None], times[1:, None]
    overlap = torch.clamp(torch.minimum(t1, hi) - torch.maximum(t0, lo),
                          min=0.0)
    k = lineages[:-1].to(heights.dtype)
    pairs = k * (k - 1) / 2
    interval = -(pairs[:, None] * overlap * torch.exp(-log_pop)[None]).sum()
    cell = torch.searchsorted(cuts, times.detach(), side="left")
    return interval - log_pop[cell][coal].sum()


def constant_coalescent(heights, n_taxa, pop):
    """Coalescent log density under a constant population size."""
    times, lineages, coal = coalescent_events(heights, n_taxa)
    k = lineages[:-1].to(heights.dtype)
    dt = times[1:] - times[:-1]
    return -(k * (k - 1) / 2 * dt).sum() / pop - coal.sum() * torch.log(pop)


def gmrf_rw1(log_pop, precision):
    """First-order random-walk GMRF log density of the log populations."""
    d = torch.diff(log_pop)
    k1 = d.shape[0]
    return (0.5 * k1 * (torch.log(precision) - math.log(2 * math.pi))
            - 0.5 * precision * (d * d).sum())


def gamma_logpdf(x, shape, scale):
    return ((shape - 1) * torch.log(x) - x / scale - math.lgamma(shape)
            - shape * math.log(scale))


def exponential_logpdf(x, mean):
    return -math.log(mean) - x / mean


def lognormal_logpdf(x, mu, sigma):
    lx = torch.log(x)
    return (-lx - math.log(sigma * math.sqrt(2 * math.pi))
            - (lx - mu) ** 2 / (2 * sigma * sigma))

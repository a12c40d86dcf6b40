"""Felsenstein pruning (peeling), plain PyTorch — the forward pass only.

Counterpart of beast_mcmc_tpu/ops/peeling.py. Partials are [nodes,
categories, states, patterns] with patterns innermost; the post-order
schedule is a sort of internal-node heights computed on the device; every
internal node rescales each pattern by its max over (category, state).

This is the plain version of the CUDA kernels in ops/cuda_peeling.py and
ops/cuda_stream.py: CPU tensors take it, and the tests and chip_smoke.py
hold the kernels against it. (The level-parallel variant and the backward
come with the gradients.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from beast_mcmc_tpu_torch.utils.accum import stable_dot


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def peel_order_from_heights(heights: torch.Tensor, n_taxa: int,
                            parent: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Child-before-parent order over the internal nodes: int64[N-1] node
    indices sorted by height. With `parent`, ties (zero-length internal
    branches) break by depth from the root, deeper first. Runs on the
    tensors' device, with no host copy."""
    h = heights[n_taxa:]
    if parent is None:
        return _stable_argsort(h) + n_taxa
    m = heights.shape[0]
    ar = torch.arange(m, device=heights.device)
    # depth (edge count from the root) by pointer doubling
    jump = torch.where(parent >= 0, parent.long(), ar)
    d = (parent >= 0).long()
    for _ in range(max(1, math.ceil(math.log2(max(m, 2))))):
        d = d + d[jump]
        jump = jump[jump]
    # lexsort from two stable sorts: secondary key (depth, descending)
    # first, then the primary key (height, ascending)
    sec = _stable_argsort(-d[n_taxa:])
    prim = _stable_argsort(h[sec])
    return sec[prim] + n_taxa


def _peel_forward(tip_partials, children, order, root, p_matrices, freqs,
                  cat_w):
    """Sequential peel. Returns (site_logl [P], post [M,C,S,P])."""
    n_tips, s, p = tip_partials.shape
    m = children.shape[0]
    c = p_matrices.shape[1]
    dt = p_matrices.dtype
    post = torch.zeros((m, c, s, p), dtype=dt, device=p_matrices.device)
    post[:n_tips] = tip_partials.to(dt)[:, None]
    acc = torch.zeros(p, dtype=dt, device=p_matrices.device)
    # the loop indexes with host integers: one copy of the schedule
    order_h = order.tolist()
    ch_h = children.tolist()
    for node in order_h:
        l, r = ch_h[node]
        x = (p_matrices[l] @ post[l]) * (p_matrices[r] @ post[r])
        scale = torch.amax(x, dim=(0, 1))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        post[node] = x / scale
        acc = acc + torch.log(scale)
    root_node = order_h[-1]
    wcs = cat_w[:, None] * freqs[None, :]
    site_lik = torch.einsum("cs,csp->p", wcs, post[root_node])
    return torch.log(site_lik) + acc, post


def peel_site_loglik(tip_partials, children, order, root, p_matrices, freqs,
                     category_weights) -> torch.Tensor:
    """Per-pattern log-likelihood [P]. Sum with pattern weights outside."""
    return _peel_forward(tip_partials, children, order, root, p_matrices,
                         freqs, category_weights)[0]


def peel_loglikelihood(tip_partials, children, order, root, p_matrices, freqs,
                       category_weights, pattern_weights) -> torch.Tensor:
    """Pattern-weighted total log-likelihood, summed in float64."""
    site_logl = peel_site_loglik(tip_partials, children, order, root,
                                 p_matrices, freqs, category_weights)
    return stable_dot(pattern_weights, site_logl)


def pad_patterns(tip_partials: torch.Tensor, pattern_weights: torch.Tensor,
                 multiple: int = 128):
    """Pad the pattern axis to a multiple; padded columns get all-ones
    partials (numerically inert) and zero weight."""
    n, s, p = tip_partials.shape
    pad = -(-p // multiple) * multiple - p
    if pad == 0:
        return tip_partials, pattern_weights
    tp = torch.nn.functional.pad(tip_partials, (0, pad), value=1.0)
    w = torch.nn.functional.pad(pattern_weights, (0, pad))
    return tp, w

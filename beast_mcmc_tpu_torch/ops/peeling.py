"""Felsenstein pruning (peeling), plain PyTorch, and its adjoint.

Counterpart of beast_mcmc_tpu/ops/peeling.py. Partials are [nodes,
categories, states, patterns] with patterns innermost; the post-order
schedule is a sort of internal-node heights computed on the device; every
internal node rescales each pattern by its max over (category, state).

`peel_site_loglik` is a torch.autograd.Function, as the JAX one is a
custom VJP: its forward (`_peel_fwd`) keeps the rescaled partials `post`
and the root's site likelihoods, and its backward (`_peel_bwd`) is the
linear-time pre-order adjoint, node by node, returning the gradients of
the branch matrices, the frequencies and the category weights. The scale
factors are a stop-gradient, exact because the likelihood does not depend
on them. Where C * P <= 8 both take the level form (`_peel_forward_levels`,
`_peel_bwd_levels`), unless `sequential_peel_only` is in force.

`peel_with_adjoint` is the same adjoint behind the CUDA kernels
(ops/cuda_peeling.py, cuda_stream.py, cuda_stream2.py, cuda_mxu.py): the
route's forward, kernel or plain version, returns `post` by node with the
residual, and `peel_adjoint_levels` walks the kernels' level schedule
(ops/cuda_stream.py::level_schedule) from the root down, one batched step
a level, for K partitions at once. The node form stays as its oracle.

This is also the plain version of the CUDA kernels: CPU tensors take it,
and the tests and chip_smoke.py hold the kernels against it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from beast_mcmc_tpu_torch.utils.accum import stable_dot


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=-1, stable=True).indices


def node_depths(parent: torch.Tensor) -> torch.Tensor:
    """int64[..., M] edge count from the root of every node (`parent` -1 at
    the root), by pointer doubling on the device: ceil(log2 M) rounds of
    gathers, whatever the tree's depth, so the host learns nothing. A
    leading chain axis [B, M] gives each row its own tree's depths."""
    m = parent.shape[-1]
    ar = torch.arange(m, device=parent.device).expand(parent.shape)
    jump = torch.where(parent >= 0, parent.long(), ar)
    d = (parent >= 0).long()
    for _ in range(max(1, math.ceil(math.log2(max(m, 2))))):
        d = d + torch.gather(d, -1, jump)
        jump = torch.gather(jump, -1, jump)
    return d


def peel_order_from_heights(heights: torch.Tensor, n_taxa: int,
                            parent: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Child-before-parent order over the internal nodes: int64[N-1] node
    indices sorted by height. With `parent`, ties (zero-length internal
    branches) break by depth from the root, deeper first. Runs on the
    tensors' device, with no host copy. A leading chain axis ([B, M]
    heights and parent) gives [B, N-1], row by row."""
    h = heights[..., n_taxa:]
    if parent is None:
        return _stable_argsort(h) + n_taxa
    d = node_depths(parent)
    # lexsort from two stable sorts: secondary key (depth, descending)
    # first, then the primary key (height, ascending)
    sec = _stable_argsort(-d[..., n_taxa:])
    prim = _stable_argsort(torch.gather(h, -1, sec))
    return torch.gather(sec, -1, prim) + n_taxa


def _node_op(p_l, p_r, post_l, post_r):
    """One peeling node op: (P_l @ post_l) * (P_r @ post_r); p_* [C,S,S],
    post_* [C,S,P] -> [C,S,P]."""
    return (p_l @ post_l) * (p_r @ post_r)


def _rescale(x, dims):
    """The per-pattern max of x over `dims`, 1 where it is 0."""
    scale = torch.amax(x, dim=dims)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


# C * P at or below which the level form is taken: small-pattern partitions
# are bound by the number of sequential steps, not by arithmetic
_LEVEL_PEEL_MAX_CP = 8
_LEVEL_PEEL_ENABLED = True


class sequential_peel_only:
    """Context manager: force the node-by-node peel (re-entrant)."""

    def __enter__(self):
        global _LEVEL_PEEL_ENABLED
        self._prev = _LEVEL_PEEL_ENABLED
        _LEVEL_PEEL_ENABLED = False
        return self

    def __exit__(self, *exc):
        global _LEVEL_PEEL_ENABLED
        _LEVEL_PEEL_ENABLED = self._prev
        return False


def _level_form(c: int, p: int) -> bool:
    return _LEVEL_PEEL_ENABLED and c * p <= _LEVEL_PEEL_MAX_CP


def parent_from_children(children: torch.Tensor, n_tips: int) -> torch.Tensor:
    """int64[M] parent of every node (-1 at the root), by scatter; children
    [B, M, 2] with a leading chain axis give [B, M]."""
    m = children.shape[-2]
    lead = children.shape[:-2]
    kids = children[..., n_tips:, :].long().reshape(*lead, -1)
    parent = torch.full((*lead, m), -1, dtype=torch.long,
                        device=children.device)
    return parent.scatter_(-1, kids, torch.arange(
        n_tips, m, device=children.device).repeat_interleave(2).expand(
            kids.shape))


def _internal_depths(children: torch.Tensor, n_tips: int) -> torch.Tensor:
    """Depth from the root (edge count) of every node, from the children
    arrays alone."""
    return node_depths(parent_from_children(children, n_tips))


def internal_levels(parent: torch.Tensor, n_tips: int):
    """The internal nodes of each depth, the root's level first, ties by
    node index: int64 tensors on the tree's device, from one host copy of
    the level sizes."""
    depth = node_depths(parent)[n_tips:]
    top_down = n_tips + torch.sort(depth, stable=True).indices
    return list(torch.split(top_down, torch.bincount(depth).tolist()))


def _tip_post(tip_partials, m, c, dt):
    """[M, C, S, P] partials with the tips' rows filled, for every
    category."""
    n_tips, s, p = tip_partials.shape
    post = torch.zeros((m, c, s, p), dtype=dt, device=tip_partials.device)
    post[:n_tips] = tip_partials.to(dt)[:, None]
    return post


def _peel_forward(tip_partials, children, order, root, p_matrices, freqs,
                  cat_w):
    """Sequential peel. Returns (site_logl [P], post [M,C,S,P]); the root is
    the last node of `order`. Where C * P <= 8, `_peel_forward_levels`."""
    n_tips, s, p = tip_partials.shape
    m = children.shape[0]
    c = p_matrices.shape[1]
    if _level_form(c, p):
        return _peel_forward_levels(tip_partials, children, order[-1],
                                    p_matrices, freqs, cat_w)
    dt = p_matrices.dtype
    post = _tip_post(tip_partials, m, c, dt)
    acc = torch.zeros(p, dtype=dt, device=p_matrices.device)
    # the loop indexes with host integers: one copy of the schedule
    order_h = order.tolist()
    ch_h = children.tolist()
    for node in order_h:
        l, r = ch_h[node]
        x = _node_op(p_matrices[l], p_matrices[r], post[l], post[r])
        scale = _rescale(x, (0, 1))
        post[node] = x / scale
        acc = acc + torch.log(scale)
    root_node = order_h[-1]
    wcs = cat_w[:, None] * freqs[None, :]
    site_lik = torch.einsum("cs,csp->p", wcs, post[root_node])
    return torch.log(site_lik) + acc, post


def _peel_forward_levels(tip_partials, children, root, p_matrices, freqs,
                         cat_w):
    """Level-parallel forward peel: one batched node op a level of depth,
    deepest first, over that level's nodes only. The same post and
    log-scales as the sequential peel (the nodes of a level are
    independent). Returns (site_logl [P], post [M,C,S,P])."""
    n_tips, s, p = tip_partials.shape
    m = children.shape[0]
    c = p_matrices.shape[1]
    dt = p_matrices.dtype
    post = _tip_post(tip_partials, m, c, dt)
    logscale = torch.zeros((m, p), dtype=dt, device=p_matrices.device)
    ch = children.long()
    levels = internal_levels(parent_from_children(children, n_tips), n_tips)
    for nodes in reversed(levels):
        l, r = ch[nodes, 0], ch[nodes, 1]
        x = (p_matrices[l] @ post[l]) * (p_matrices[r] @ post[r])
        scale = _rescale(x, (1, 2))
        post[nodes] = x / scale[:, None, None]
        logscale[nodes] = logscale[l] + logscale[r] + torch.log(scale)
    wcs = cat_w[:, None] * freqs[None, :]
    site_lik = torch.einsum("cs,csp->p", wcs, post[root])
    return torch.log(site_lik) + logscale[root], post


def _peel_fwd(tip_partials, children, order, root, p_matrices, freqs, cat_w):
    """The forward with its residuals: (site_logl, (children, order, root,
    p_matrices, freqs, cat_w, post, site_lik))."""
    site_logl, post = _peel_forward(tip_partials, children, order, root,
                                    p_matrices, freqs, cat_w)
    root_node = order[-1]
    site_lik = torch.einsum("c,s,csp->p", cat_w, freqs, post[root_node])
    return site_logl, (children, order, root_node, p_matrices, freqs, cat_w,
                       post, site_lik)


def _peel_bwd(residuals, g):
    """Pre-order adjoint sweep, node by node. g: cotangent of site_logl
    [P]. Returns (d_p [M,C,S,S], d_freqs [S], d_cat_w [C])."""
    children, order, root, p_matrices, freqs, cat_w, post, site_lik = \
        residuals
    m, c, s, p = post.shape
    if _level_form(c, p):
        return _peel_bwd_levels(residuals, g)
    g_over_lik = (g / site_lik).to(post.dtype)
    # adjoint with respect to the stored (rescaled) partials
    adj = torch.zeros_like(post)
    adj[root] = cat_w[:, None, None] * freqs[None, :, None] * g_over_lik
    d_p = torch.zeros_like(p_matrices)
    ch_h = children.tolist()
    for node in reversed(order.tolist()):
        l, r = ch_h[node]
        xl = p_matrices[l] @ post[l]
        xr = p_matrices[r] @ post[r]
        scale = _rescale(xl * xr, (0, 1))  # a stop-gradient: exact
        b = adj[node] / scale  # adjoint with respect to the unscaled x
        bl, br = b * xr, b * xl
        # A_child[c,j,p] = sum_i b_other[c,i,p] P[c,i,j]
        adj[l] = p_matrices[l].transpose(-1, -2) @ bl
        adj[r] = p_matrices[r].transpose(-1, -2) @ br
        # dP[c,i,j] = sum_p b_other[c,i,p] post[c,j,p]
        d_p[l] = bl @ post[l].transpose(-1, -2)
        d_p[r] = br @ post[r].transpose(-1, -2)
    d_freqs = torch.einsum("c,csp,p->s", cat_w, post[root], g_over_lik)
    d_cat_w = torch.einsum("s,csp,p->c", freqs, post[root], g_over_lik)
    return d_p, d_freqs, d_cat_w


def _peel_bwd_levels(residuals, g):
    """Level-parallel adjoint sweep: a parent lies strictly shallower than
    its children, so the levels taken shallowest first keep the pre-order
    dependency; the same outputs as `_peel_bwd`."""
    children, order, root, p_matrices, freqs, cat_w, post, site_lik = \
        residuals
    n_tips = (post.shape[0] + 1) // 2
    levels = internal_levels(parent_from_children(children, n_tips), n_tips)
    d_p, d_wcs = _adjoint_over_levels(
        post[None], (g / site_lik)[None], p_matrices[None],
        (cat_w[:, None] * freqs[None, :])[None], root.reshape(1),
        [(nodes, children.long()[nodes]) for nodes in levels])
    return (d_p[0], torch.einsum("cs,c->s", d_wcs[0], cat_w),
            torch.einsum("cs,s->c", d_wcs[0], freqs))


def _adjoint_over_levels(post, g_over_lik, p_matrices, wcs, root, levels):
    """The pre-order adjoint of K peels on one tree, one batched step a
    level: post [K,M,C,S,P] by node (tips' rows holding the tips),
    g_over_lik [K,P], p_matrices [K,M,C,S,S], wcs [K,C,S], `root` the root
    node as an int64[1] tensor (no host copy), `levels` [(nodes [L], their
    children [L, 2])] from the root down. Returns (d_p [K,M,C,S,S], d_wcs
    [K,C,S]). The scale is recomputed from the children's partials, as the
    forward took it."""
    adj = torch.zeros_like(post)
    adj[:, root] = (wcs[..., None] * g_over_lik[:, None, None, :])[:, None]
    d_p = torch.zeros_like(p_matrices)
    for nodes, ch in levels:
        pm = p_matrices[:, ch]  # [K, L, 2, C, S, S]
        child = post[:, ch]  # [K, L, 2, C, S, P]
        v = pm @ child
        scale = _rescale(v[:, :, 0] * v[:, :, 1], (2, 3))  # [K, L, P]
        b = adj[:, nodes] / scale[:, :, None, None]  # [K, L, C, S, P]
        bb = b[:, :, None] * v.flip(2)  # left: b * xr; right: b * xl
        adj[:, ch] = pm.transpose(-1, -2) @ bb
        d_p[:, ch] = bb @ child.transpose(-1, -2)
    d_wcs = torch.einsum("kcsp,kp->kcs", post[:, root][:, 0], g_over_lik)
    return d_p, d_wcs


def peel_adjoint_levels(post, site_lik, g, p_matrices, wcs, schedule):
    """The adjoint behind the CUDA kernels, on either device: K peels on one
    tree, post [K,M,C,S,P] by node, site_lik and the cotangent g [K,P],
    p_matrices [K,M,C,S,S], wcs [K,C,S]; `schedule` is
    level_schedule(children, N, parent), whose order ends at the root and
    whose `level_start` is the one copy to the host. Each level's own nodes
    only, from the root down. Returns (d_p, d_wcs)."""
    order, lr_ids, _, level_start = schedule
    bounds = level_start.tolist()[::-1]
    order, lr_ids = order.long(), lr_ids.long()
    levels = [(order[a:b], lr_ids[a:b])
              for a, b in zip(bounds[1:], bounds) if a < b]
    return _adjoint_over_levels(post, g / site_lik, p_matrices, wcs,
                                order[-1:], levels)


class _PeelSiteLoglik(torch.autograd.Function):
    """peel_site_loglik with the custom adjoint `_peel_bwd`."""

    @staticmethod
    def forward(ctx, tip_partials, children, order, root, p_matrices, freqs,
                cat_w):
        site_logl, residuals = _peel_fwd(tip_partials, children, order, root,
                                         p_matrices, freqs, cat_w)
        ctx.residuals = residuals
        return site_logl

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        d_p, d_freqs, d_cat_w = _peel_bwd(ctx.residuals, g)
        del ctx.residuals
        # tip partials are data; the integer arrays have no gradient
        return None, None, None, None, d_p, d_freqs, d_cat_w


def peel_site_loglik(tip_partials, children, order, root, p_matrices, freqs,
                     category_weights) -> torch.Tensor:
    """Per-pattern log-likelihood [P]. Sum with pattern weights outside."""
    return _PeelSiteLoglik.apply(tip_partials, children, order, root,
                                 p_matrices, freqs, category_weights)


def wants_grad(*tensors) -> bool:
    """True where autograd would take a gradient through these tensors: the
    wrappers then take the route's forward with its residual."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def post_by_node(post_pos, tip_partials, order):
    """Rescaled partials by peel position [K, n_int, C, S, P] as the
    adjoint takes them, by node [K, M, C, S, P], with the tips' rows holding
    the tip partials [K, N, S, P] for every category. `order` [n_int] is
    the node at each position."""
    k, n_int, c, s, p = post_pos.shape
    n_tips = tip_partials.shape[1]
    post = torch.empty((k, n_tips + n_int, c, s, p), dtype=post_pos.dtype,
                       device=post_pos.device)
    post[:, :n_tips] = tip_partials.to(post_pos.dtype)[:, :, None]
    post[:, order.long()] = post_pos
    return post


class _PeelWithAdjoint(torch.autograd.Function):
    """K peels on one tree through a route's forward, with the level
    adjoint. `forward(p_matrices, freqs, cat_w)` returns (site_logl [K,P],
    post [K,M,C,S,P] by node); it runs with autograd off, so a kernel
    wrapper's guard passes inside it."""

    @staticmethod
    def forward(ctx, forward, schedule, p_matrices, freqs, cat_w):
        site, post = forward(p_matrices, freqs, cat_w)
        ctx.schedule = schedule
        ctx.save_for_backward(post, p_matrices, freqs, cat_w)
        return site

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        post, p_matrices, freqs, cat_w = ctx.saved_tensors
        wcs = cat_w[:, :, None] * freqs[:, None, :]
        root = ctx.schedule[0][-1:]  # int64[1]: indexing it stays on the device
        site_lik = torch.einsum("kcs,kcsp->kp", wcs, post[:, root][:, 0])
        d_p, d_wcs = peel_adjoint_levels(post, site_lik, g.to(post.dtype),
                                         p_matrices, wcs, ctx.schedule)
        d_freqs = torch.einsum("kcs,kc->ks", d_wcs, cat_w)
        d_cat_w = torch.einsum("kcs,ks->kc", d_wcs, freqs)
        return None, None, d_p, d_freqs, d_cat_w


def peel_with_adjoint(forward, schedule, p_matrices, freqs, cat_w):
    """site_logl [K, P] of `forward` (see _PeelWithAdjoint), differentiable
    in p_matrices [K,M,C,S,S], freqs [K,S] and cat_w [K,C] through
    `peel_adjoint_levels` over `schedule` (level_schedule)."""
    return _PeelWithAdjoint.apply(forward, schedule, p_matrices, freqs,
                                  cat_w)


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

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
a level, for K partitions at once, and for a chain batch for all B
chains' trees at once: (chain, partition, node) flattened into one row
index, the chains' levels aligned at their roots (`schedule_levels`). The
node form stays as its oracle.

This is also the plain version of the CUDA kernels: CPU tensors take it,
and the tests and chip_smoke.py hold the kernels against it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
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


_ADJOINT_PEEL = True


class autograd_peel:
    """Context manager: `peel_site_loglik` runs its plain forward
    (`_peel_forward_functional`), and
    ops/eigen.py::transition_probs its plain I + U expm1(values t) U_inv,
    under autograd, which differentiates both to any order, in place of
    their custom backwards (once differentiable); re-entrant. The tree
    likelihoods (models/treelikelihood.py) then take that plain peel on
    every route and device, the kernels' included. A diagonal Hessian
    (config/xml_assert.py::gradient_report) takes it with
    `sequential_peel_only`, as the JAX package takes its scan peel."""

    def __enter__(self):
        global _ADJOINT_PEEL
        from beast_mcmc_tpu_torch.ops import eigen

        self._prev = (_ADJOINT_PEEL, eigen._CUSTOM_EXPM_GRAD)
        _ADJOINT_PEEL = eigen._CUSTOM_EXPM_GRAD = False
        return self

    def __exit__(self, *exc):
        global _ADJOINT_PEEL
        from beast_mcmc_tpu_torch.ops import eigen

        _ADJOINT_PEEL, eigen._CUSTOM_EXPM_GRAD = self._prev
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
    the level sizes. B chains' trees ([B, M] parent) give their nodes as
    rows b M + node of one flat node axis, the l-th level below every
    chain's root in the l-th step (chain by chain within it)."""
    m = parent.shape[-1]
    rows = torch.arange(n_tips, m, device=parent.device)
    if parent.dim() == 2:
        rows = rows + m * torch.arange(parent.shape[0],
                                       device=parent.device)[:, None]
    depth = node_depths(parent)[..., n_tips:].reshape(-1)
    top_down = rows.reshape(-1)[torch.sort(depth, stable=True).indices]
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


def _peel_forward_functional(tip_partials, children, order, p_matrices,
                             freqs, cat_w):
    """The sequential peel's site log-likelihoods [P] without in-place
    writes, each node's partials a tensor of its own, so that autograd
    differentiates it to any order (`autograd_peel`)."""
    n_tips, s, p = tip_partials.shape
    c = p_matrices.shape[1]
    dt = p_matrices.dtype
    post = {i: tip_partials[i].to(dt)[None].expand(c, s, p)
            for i in range(n_tips)}
    acc = torch.zeros(p, dtype=dt, device=p_matrices.device)
    order_h = order.tolist()
    ch_h = children.tolist()
    for node in order_h:
        l, r = ch_h[node]
        x = _node_op(p_matrices[l], p_matrices[r], post[l], post[r])
        scale = _rescale(x, (0, 1))
        post[node] = x / scale
        acc = acc + torch.log(scale)
    wcs = cat_w[:, None] * freqs[None, :]
    site_lik = torch.einsum("cs,csp->p", wcs, post[order_h[-1]])
    return torch.log(site_lik) + acc


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
        post, (g / site_lik)[None], p_matrices,
        (cat_w[:, None] * freqs[None, :])[None], root.reshape(1),
        [(nodes, children.long()[nodes]) for nodes in levels])
    return (d_p, torch.einsum("cs,c->s", d_wcs[0], cat_w),
            torch.einsum("cs,s->c", d_wcs[0], freqs))


def _adjoint_over_levels(post, g_over_lik, p_matrices, wcs, roots, levels):
    """The pre-order adjoint of R peels over one flat node axis, one batched
    step a level: post [N, C, S, P] the rescaled partials of every peel's
    nodes (tips' rows holding the tips), p_matrices [N, C, S, S] their
    branch matrices, `roots` int64[R] the rows of the R roots (no host
    copy), g_over_lik [R, P], wcs [R, C, S], `levels` [(rows [L], their
    children's rows [L, 2])] from the roots down, a level of every peel at
    once. Returns (d_p [N, C, S, S], d_wcs [R, C, S]). The scale is
    recomputed from the children's partials, as the forward took it."""
    adj = torch.zeros_like(post)
    adj[roots] = wcs[..., None] * g_over_lik[:, None, None, :]
    d_p = torch.zeros_like(p_matrices)
    for nodes, ch in levels:
        pm = p_matrices[ch]  # [L, 2, C, S, S]
        child = post[ch]  # [L, 2, C, S, P]
        v = pm @ child
        scale = _rescale(v[:, 0] * v[:, 1], (1, 2))  # [L, P]
        b = adj[nodes] / scale[:, None, None]  # [L, C, S, P]
        bb = b[:, None] * v.flip(1)  # left: b * xr; right: b * xl
        adj[ch] = pm.transpose(-1, -2) @ bb
        d_p[ch] = bb @ child.transpose(-1, -2)
    d_wcs = torch.einsum("rcsp,rp->rcs", post[roots], g_over_lik)
    return d_p, d_wcs


def schedule_levels(schedule, k_parts: int, m: int):
    """The flat rows of `_adjoint_over_levels` for B chains' trees, K peels
    on each: (roots int64[B K], levels). Row (b K + k) M + node is node of
    partition k on chain b. `schedule` is the chain-axis
    level_schedule(children, N, parent), whose rows count each chain's
    levels from its deepest; a child lies exactly one level below its
    parent, so the l-th level below every chain's root is one batched step,
    the chains' level counts aligned at their roots. Its `level_start` [B,
    n_int + 1] is the one copy to the host."""
    order, lr_ids, _, level_start = schedule
    b_n, n_int = order.shape
    dev = order.device
    counts = np.diff(level_start.cpu().numpy().astype(np.int64), axis=1)
    n_lv = (counts > 0).sum(1)
    # each position's level counted from its chain's root
    depth = np.concatenate([n_lv[b] - 1 - np.repeat(np.arange(n_int),
                                                    counts[b])
                            for b in range(b_n)])
    perm = torch.from_numpy(np.argsort(depth, kind="stable")).to(dev)
    sizes = (np.bincount(depth) * k_parts).tolist()
    off = torch.arange(b_n, device=dev)[:, None] * (k_parts * m)
    parts = torch.arange(k_parts, device=dev) * m
    nodes = (order.long() + off).reshape(-1)[perm]
    kids = (lr_ids.long() + off[..., None]).reshape(-1, 2)[perm]
    nodes = (nodes[:, None] + parts).reshape(-1)
    kids = (kids[:, None, :] + parts[:, None]).reshape(-1, 2)
    roots = (order[:, -1:].long() + off + parts).reshape(-1)
    return roots, list(zip(torch.split(nodes, sizes),
                           torch.split(kids, sizes)))


def peel_adjoint_levels(post, g, p_matrices, wcs, schedule):
    """The adjoint behind the CUDA kernels, on either device, for K peels
    on each of B chains' trees (one tree is the case B = 1): post [B, K,
    M, C, S, P] by node, the cotangent g [B, K, P], p_matrices [B, K, M, C,
    S, S], wcs [B, K, C, S], `schedule` the chain-axis
    level_schedule(children, N, parent). Each level's own nodes only, from
    the roots down, every chain's in one step (`schedule_levels`). Returns
    (d_p, d_wcs) in the shapes of p_matrices and wcs."""
    b_n, k_parts, m = post.shape[:3]
    roots, levels = schedule_levels(schedule, k_parts, m)
    post = post.reshape(-1, *post.shape[3:])
    wcs = wcs.reshape(-1, *wcs.shape[2:])
    site_lik = torch.einsum("rcs,rcsp->rp", wcs, post[roots])
    d_p, d_wcs = _adjoint_over_levels(
        post, g.reshape(-1, g.shape[-1]) / site_lik,
        p_matrices.reshape(-1, *p_matrices.shape[3:]), wcs, roots, levels)
    return (d_p.reshape(b_n, k_parts, m, *d_p.shape[1:]),
            d_wcs.reshape(b_n, k_parts, *d_wcs.shape[1:]))


def one_chain(schedule):
    """One tree's schedule (any route's tuple of tensors) as the chain-axis
    schedule of a batch of one; None stays None."""
    return None if schedule is None else tuple(t[None] for t in schedule)


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
    if not _ADJOINT_PEEL:
        return _peel_forward_functional(tip_partials, children, order,
                                        p_matrices, freqs, category_weights)
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
    the node at each position. B chains' trees (post_pos [B, K, n_int, C,
    S, P], `order` [B, n_int], the tips shared) give [B, K, M, C, S, P]."""
    *lead, n_int, c, s, p = post_pos.shape
    n_tips = tip_partials.shape[-3]
    post = torch.empty((*lead, n_tips + n_int, c, s, p),
                       dtype=post_pos.dtype, device=post_pos.device)
    post[..., :n_tips, :, :, :] = tip_partials.to(post_pos.dtype)[
        ..., None, :, :]
    if order.dim() == 1:
        post[:, order.long()] = post_pos
    else:
        rows = torch.arange(order.shape[0], device=order.device)[:, None]
        post[rows, :, order.long()] = post_pos.transpose(1, 2)
    return post


class _PeelWithAdjoint(torch.autograd.Function):
    """K peels on each of B chains' trees through a route's forward, with
    the level adjoint. `forward(p_matrices, freqs, cat_w, True)` returns
    (site_logl [B, K, P], post [B, K, M, C, S, P] by node); it runs with
    autograd off, so a kernel wrapper's guard passes inside it."""

    @staticmethod
    def forward(ctx, forward, schedule, p_matrices, freqs, cat_w):
        site, post = forward(p_matrices, freqs, cat_w, True)
        ctx.schedule = schedule
        ctx.save_for_backward(post, p_matrices, freqs, cat_w)
        return site

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        post, p_matrices, freqs, cat_w = ctx.saved_tensors
        wcs = cat_w[..., :, None] * freqs[..., None, :]
        d_p, d_wcs = peel_adjoint_levels(post, g.to(post.dtype), p_matrices,
                                         wcs, ctx.schedule)
        d_freqs = torch.einsum("...cs,...c->...s", d_wcs, cat_w)
        d_cat_w = torch.einsum("...cs,...s->...c", d_wcs, freqs)
        return None, None, d_p, d_freqs, d_cat_w


def peel_with_adjoint(forward, schedule, p_matrices, freqs, cat_w):
    """site_logl [B, K, P] of a route's chain-axis peel
    `forward(p_matrices, freqs, cat_w, want_post)`: where autograd asks for
    a gradient, differentiable in p_matrices [B, K, M, C, S, S], freqs [B,
    K, S] and cat_w [B, K, C] through one forward with the partials and
    `peel_adjoint_levels` over `schedule` (the chain-axis level_schedule),
    for all B chains at once; else the forward alone, without the
    partials."""
    if wants_grad(p_matrices, freqs, cat_w):
        return _PeelWithAdjoint.apply(forward, schedule, p_matrices, freqs,
                                      cat_w)
    return forward(p_matrices, freqs, cat_w, False)


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

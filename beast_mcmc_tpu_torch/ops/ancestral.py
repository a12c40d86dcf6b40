"""Joint ancestral state reconstruction by pre-order sampling.

Counterpart of beast_mcmc_tpu/ops/ancestral.py, the role of
AncestralStateBeagleTreeLikelihood (AncestralStateBeagleTreeLikelihood.java:
274,414 traverseSample): a joint draw of the states of every node given
the tip data. A category is drawn per site first, from
w_c sum_i pi_i post_root[c, i]; then the root's state given that category,
from pi_i post_root[c, i]; then each child given its parent's state s,

  P(child = j | parent = s)  proportional to  P_child[c, s, j] post_child[c, j]

The JAX package walks the internal nodes one by one in a scan. Here the
walk goes by levels of depth from the root down (ops/peeling.py::
internal_levels): the children of one level are drawn in one batched step,
since each depends on its parent alone. The partials are the plain level
peel's (ops/peeling.py::_peel_forward_levels); no kernel is launched.
Every draw comes from the generator the caller passes, on the tensors'
device.
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops.peeling import (
    _peel_forward_levels,
    internal_levels,
    parent_from_children,
)


def _categorical(weights: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """int64[...] draws with probability proportional to the last axis of
    the non-negative weights [..., S], by the inverse CDF: a state of zero
    weight is never drawn."""
    cdf = torch.cumsum(weights, dim=-1)
    u = torch.rand(cdf.shape[:-1], generator=gen, dtype=cdf.dtype,
                   device=cdf.device) * cdf[..., -1]
    idx = torch.searchsorted(cdf, u[..., None], right=True)[..., 0]
    return idx.clamp_max(weights.shape[-1] - 1)


def sample_ancestral_states(tip_partials: torch.Tensor,
                            children: torch.Tensor, root,
                            p_matrices: torch.Tensor, freqs: torch.Tensor,
                            category_weights: torch.Tensor,
                            generator: torch.Generator):
    """tip_partials [N, S, P], children [M, 2], root (0-d or int),
    p_matrices [M, C, S, S]. Returns (states int64[M, P], categories
    int64[P], site_logl [P])."""
    n_tips, _, p = tip_partials.shape
    dev = p_matrices.device
    root = torch.as_tensor(root, device=dev).reshape(1)
    site_logl, post = _peel_forward_levels(
        tip_partials, children, root[0], p_matrices, freqs,
        category_weights)
    post_root = post[root][0]  # [C, S, P]
    cat_post = torch.einsum("c,i,cip->pc", category_weights, freqs,
                            post_root)
    cats = _categorical(cat_post, generator)  # [P]
    sites = torch.arange(p, device=dev)
    root_probs = freqs[None, :, None] * post_root  # [C, S, P]
    states = torch.full((post.shape[0], p), -1, dtype=torch.long,
                        device=dev)
    states = states.index_put(
        (root,), _categorical(root_probs[cats, :, sites], generator)[None])

    ch = children.long()
    levels = internal_levels(parent_from_children(ch, n_tips), n_tips)
    for nodes in levels:  # the root's level first
        kids = ch[nodes].reshape(-1)  # [2L]: each node's two children
        above = states[nodes].repeat_interleave(2, dim=0)  # [2L, P]
        k = torch.arange(kids.shape[0], device=dev)[:, None]
        pr = p_matrices[kids][k, cats[None, :], above]  # [2L, P, S]
        po = post[kids].permute(0, 3, 1, 2)[k, sites[None, :],
                                            cats[None, :]]  # [2L, P, S]
        states = states.index_put((kids,), _categorical(pr * po, generator))
    return states, cats, site_logl

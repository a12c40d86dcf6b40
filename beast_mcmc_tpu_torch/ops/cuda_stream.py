"""The v1 streaming CUDA peel: any state count, partials returned.

Counterpart of beast_mcmc_tpu/ops/pallas_stream.py. The kernel
(csrc/peel_stream_ring.cu) replaces pallas_stream.py::_stream_kernel: it
returns the per-pattern log-likelihood and the rescaled partials by peel
position, keeps the last two nodes in a shared-memory ring, fetches the
other children one step ahead and streams the peel-ordered branch
matrices through shared memory; see the source for what bounds it and
what the design does about that. It takes 2 <= S <= 64 states and up to 8
rate categories in float32 or float64; the dispatcher sends it the shapes
that neither the S = 4 kernels nor the matrix-product kernel
(ops/cuda_mxu.py, S >= 16) take.

`stream_schedule` is the gather of pallas_stream.py:277-284: `lr_ids`
[n_int, 2] are each step's children, `lr_pos` their peel positions (-1
for a tip); `p_matrices[lr_ids]` is `pm_ord` [n_int, 2, C, S, S]. The
plain version `_stream_plain` peels from these, so a CPU tensor checks the
gather as well as the arithmetic. `level_schedule` is the same gather in
the deep kernel's order (ops/cuda_stream2.py): by depth, deepest first,
with the first position of every level.

The planners are derived from the 227 KB of shared memory a Hopper block
may take. A block holds, in elements of the working type,
    3 ring slots + 2 x 2 staged children, each [C*S, BP]     7*C*S*BP
    two matrix slots                                         2*unit
    the per-pattern max reduction [R, BP]                    R*BP
`_pick_chunk` sizes a matrix slot: whole nodes while one node's 2*C*S*S
matrices fit CHUNK_BYTES, else 0, and the kernel then streams one child's
one category ([S, S]) at a time. `_pick_bp` takes the widest pattern tile
(at most 32) that leaves the whole within SMEM_BUDGET, and a narrower one
while the grid would leave more than half of the 132 SMs without a block.

Gradients: where autograd asks for one, `peel_stream_chains` (and
`peel_site_loglik_stream`, its batch of one) takes `_stream_forward`, chain
by chain, as the forward of ops/peeling.py::peel_with_adjoint: its
partials by height-order position go to their nodes through `order`, and
the adjoint walks `level_schedule` of the same tree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.cuda_peeling import check_kernel_inputs
from beast_mcmc_tpu_torch.ops.peeling import (
    node_depths,
    one_chain,
    parent_from_children,
    peel_with_adjoint,
    post_by_node,
    wants_grad,
)
from beast_mcmc_tpu_torch.utils.accum import stable_dot

SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may take
CHUNK_BYTES = 32 * 1024  # one of the two matrix slots, whole-node mode
TR = 4  # output rows one thread accumulates at a time (csrc)
MAX_THREADS = 512
N_SM = 132  # streaming multiprocessors of an H100
STATES = range(2, 65)
MAX_CATEGORIES = 8

launches = 0  # kernel launches since the caller last set this to 0


def _pick_chunk(c: int, s: int, itemsize: int) -> int:
    """Nodes per matrix slot; 0 when one node's matrices exceed a slot and
    the kernel streams [S, S] pieces instead."""
    return min(64, CHUNK_BYTES // (2 * c * s * s * itemsize))


class StreamPlan(NamedTuple):
    bp: int  # patterns per block
    rows: int  # threads along the output rows; a block is rows * bp threads
    chunk: int  # nodes per matrix slot, 0 for [S, S] pieces
    smem: int  # bytes of shared memory


def _plan(c: int, s: int, itemsize: int, bp: int) -> StreamPlan:
    chunk = _pick_chunk(c, s, itemsize)
    groups = -(-s // TR) * (c if chunk else 1)
    rows = min(groups, MAX_THREADS // bp)
    unit = chunk * 2 * c * s * s if chunk else s * s
    smem = (7 * c * s * bp + 2 * unit + rows * bp) * itemsize
    return StreamPlan(bp, rows, chunk, smem)


def _pick_bp(p: int, c: int, s: int, itemsize: int) -> int:
    """Patterns per block: 32 where the block's buffers fit SMEM_BUDGET,
    else the widest power of two that does (4 at S = 64, C = 8, float64);
    then halved, down to 8, while twice the blocks still find an SM each:
    a block's time does not depend on its width, so idle SMs are the gain."""
    bp = 32
    while bp > 4 and _plan(c, s, itemsize, bp).smem > SMEM_BUDGET:
        bp //= 2
    while bp > 8 and 2 * -(-p // bp) <= N_SM:
        bp //= 2
    return bp


def stream_plan(p: int, c: int, s: int, itemsize: int,
                bp: int | None = None) -> StreamPlan:
    """The launch plan at these shapes; raises outside the envelope. `bp`
    forces the patterns per block (a measurement of the tile width); by
    default `_pick_bp` chooses."""
    if s not in STATES or not 1 <= c <= MAX_CATEGORIES:
        raise ValueError(f"the streaming peel takes 2..64 states and 1..8 "
                         f"categories, got S = {s}, C = {c}")
    plan = _plan(c, s, itemsize, bp or _pick_bp(p, c, s, itemsize))
    if plan.smem > SMEM_BUDGET:
        raise ValueError(f"no plan within shared memory: {plan}")
    return plan


def stream_schedule(children, order):
    """(lr_ids, lr_pos), int32 [n_int, 2]: each peel step's children and
    their positions in the order (-1 for tips). With a leading chain axis,
    children [B, M, 2] and order [B, n_int] give [B, n_int, 2], row by
    row."""
    m = children.shape[-2]
    n_int = order.shape[-1]
    lead = order.shape[:-1]
    order = order.long()
    pos_of = torch.full((*lead, m), -1, dtype=torch.int32,
                        device=children.device)
    pos_of = pos_of.scatter(-1, order, torch.arange(
        n_int, dtype=torch.int32, device=children.device).expand(order.shape))
    lr_ids = torch.gather(children.long(), -2,
                          order[..., None].expand(*lead, n_int, 2))
    lr_pos = torch.gather(pos_of, -1, lr_ids.reshape(*lead, 2 * n_int))
    return lr_ids.to(torch.int32), lr_pos.reshape(lr_ids.shape)


def level_schedule(children, n_tips, parent=None):
    """(order, lr_ids, lr_pos, level_start) of the deep kernel: the
    internal nodes by depth from the root, deepest first (ties by node
    index), and stream_schedule's two arrays in that order. A child lies exactly one
    level deeper than its parent, so the order is child-before-parent and
    the nodes of a level are independent. `level_start` int32 [n_int + 1]
    holds each level's first position; every entry past the last level is
    n_int. All on the device, with no host synchronisation; `parent` is
    derived from `children` when not given. With a leading chain axis
    (children [B, M, 2], parent [B, M]) every array gains it, and row b is
    the schedule of chain b's tree: a row-wise stable sort, scatter-add and
    cumulative sum."""
    m = children.shape[-2]
    lead = children.shape[:-2]
    n_int = m - n_tips
    dev = children.device
    if parent is None:
        parent = parent_from_children(children, n_tips)
    d = node_depths(parent)[..., n_tips:]
    # 0 for the deepest level. An invalid proposal (a cycle, which its
    # operator rejects whatever the likelihood) has depths past n_int: the
    # clamp keeps its schedule in range, and is a no-op on a tree.
    lvl = (d.amax(-1, keepdim=True) - d).clamp_(0, n_int - 1)
    order = torch.sort(lvl, dim=-1, stable=True).indices + n_tips
    counts = torch.zeros((*lead, n_int), dtype=torch.int32, device=dev)
    counts.scatter_add_(-1, lvl, torch.ones_like(counts))
    level_start = torch.zeros((*lead, n_int + 1), dtype=torch.int32,
                              device=dev)
    level_start[..., 1:] = torch.cumsum(counts, -1, dtype=torch.int32)
    return (order, *stream_schedule(children, order), level_start)


def _stream_plain(tip_partials, lr_ids, lr_pos, pm_ord, wcs):
    """Plain PyTorch version of the streaming kernel: the same peel, read
    from the peel-ordered schedule. Returns (site_logl [P], post_pos
    [n_int, C, S, P])."""
    n_int = lr_ids.shape[0]
    c = pm_ord.shape[2]
    _, s, p = tip_partials.shape
    dt = pm_ord.dtype
    tips = tip_partials.to(dt)
    post = torch.empty((n_int, c, s, p), dtype=dt, device=pm_ord.device)
    acc = torch.zeros(p, dtype=dt, device=pm_ord.device)
    ids = lr_ids.tolist()
    pos = lr_pos.tolist()
    for i in range(n_int):
        x = None
        for k in range(2):
            child = tips[ids[i][k]][None] if pos[i][k] < 0 else post[pos[i][k]]
            v = pm_ord[i, k] @ child
            x = v if x is None else x * v
        scale = torch.amax(x, dim=(0, 1))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        post[i] = x / scale
        acc = acc + torch.log(scale)
    site = torch.log(torch.einsum("cs,csp->p", wcs, post[n_int - 1])) + acc
    return site, post


def prepare_stream(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w,
                   bp: int | None = None) -> _build.KernelCall:
    """Check the inputs and allocate the outputs of one launch of the
    streaming kernel. The call's `out` is (site_logl, post_pos). `bp` is
    passed to `stream_plan`."""
    n_int = lr_ids.shape[0]
    n_tips, s, p = tips.shape
    c = pm_ord.shape[2]
    dt = pm_ord.dtype
    check_kernel_inputs(tips, pm_ord.reshape(-1, c, s, s), freqs, cat_w,
                        lr_ids, lr_pos, states=STATES,
                        max_categories=MAX_CATEGORIES)
    if n_int != n_tips - 1 or lr_pos.shape != (n_int, 2):
        raise ValueError("the schedule must cover the N-1 internal nodes")
    plan = stream_plan(p, c, s, pm_ord.element_size(), bp)
    lib = _build.load("peel_stream_ring",
                      ["peel_stream_ring_f64", "peel_stream_ring_f32"], 7)
    fn = (lib.peel_stream_ring_f64 if dt == torch.float64
          else lib.peel_stream_ring_f32)
    wcs = (cat_w[:, None] * freqs[None, :]).contiguous()
    ids32 = lr_ids.to(torch.int32).contiguous()
    pos32 = lr_pos.to(torch.int32).contiguous()
    pm_ord = pm_ord.contiguous()
    post_pos = torch.empty((n_int, c, s, p), dtype=dt, device=tips.device)
    site = torch.empty(p, dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_stream_ring", fn,
        (tips, pm_ord, ids32, pos32, wcs, post_pos, site),
        (n_int, c, s, p, plan.bp, plan.rows, plan.chunk), (site, post_pos))


def _peel_stream_ring_kernel(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w):
    global launches
    out = prepare_stream(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w).launch()
    launches += 1
    return out


def _stream_forward(tip_partials, children, order, p_matrices, freqs, cat_w,
                    schedule=None):
    """(site_logl [P], post_pos [n_int, C, S, P]) through the streaming
    kernel; CPU tensors take the plain version. `schedule` is
    stream_schedule(children, order) where the caller already has it
    (several partitions on one tree)."""
    lr_ids, lr_pos = schedule or stream_schedule(children, order)
    pm_ord = p_matrices[lr_ids]
    if not tip_partials.is_cuda:
        wcs = cat_w[:, None] * freqs[None, :]
        return _stream_plain(tip_partials, lr_ids, lr_pos, pm_ord, wcs)
    return _peel_stream_ring_kernel(tip_partials.contiguous(), lr_ids, lr_pos,
                                    pm_ord, freqs, cat_w)


def peel_stream_chains(tip_partials, children, order, p_matrices, freqs,
                       cat_w, schedule=None) -> torch.Tensor:
    """The v1 streaming peel of a chain batch, one launch a chain (the
    kernel has no chain axis yet): children [B, M, 2], `order` [B, n_int]
    each chain's peel order, p_matrices [B, M, C, S, S], freqs [B, S] and
    cat_w [B, C] give [B, P]. `schedule` is the chain-axis
    stream_schedule(children, order) where the caller has it. A CPU tensor
    takes the plain version. Differentiable in every chain's p_matrices,
    freqs and cat_w: each launch returns its chain's partials by position,
    `post_by_node` puts them at their nodes, and one level adjoint over
    level_schedule takes all B chains."""
    lr_ids, lr_pos = schedule or stream_schedule(children, order)

    def forward(pm, fr, cw, want_post):  # [B, 1, ...]: one partition
        outs = [_stream_forward(tip_partials, children[b], order[b],
                                pm[b, 0], fr[b, 0], cw[b, 0],
                                (lr_ids[b], lr_pos[b]))
                for b in range(pm.shape[0])]
        site = torch.stack([o[0] for o in outs])[:, None]
        if not want_post:
            return site
        pos = torch.stack([o[1] for o in outs])[:, None]
        return site, post_by_node(pos, tip_partials[None], order)

    levels = (level_schedule(children, tip_partials.shape[0])
              if wants_grad(p_matrices, freqs, cat_w) else None)
    return peel_with_adjoint(forward, levels, p_matrices[:, None],
                             freqs[:, None], cat_w[:, None])[:, 0]


def peel_site_loglik_stream(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights,
                            schedule=None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the streaming kernel,
    differentiable in p_matrices, freqs and category_weights:
    `peel_stream_chains`' batch of one. `root` is kept for interface parity
    (the peel order ends at the root)."""
    return peel_stream_chains(tip_partials, children[None], order[None],
                              p_matrices[None], freqs[None],
                              category_weights[None], one_chain(schedule))[0]


def peel_loglikelihood_stream(tip_partials, children, order, root, p_matrices,
                              freqs, category_weights, pattern_weights,
                              schedule=None) -> torch.Tensor:
    """Pattern-weighted total through the streaming kernel, in float64."""
    site = peel_site_loglik_stream(tip_partials, children, order, root,
                                   p_matrices, freqs, category_weights,
                                   schedule)
    return stable_dot(pattern_weights, site)

"""The v1 streaming CUDA peel: any state count, partials returned, B chains
in one launch.

Counterpart of beast_mcmc_tpu/ops/pallas_stream.py. The kernel
(csrc/peel_stream_ring.cu) replaces pallas_stream.py::_stream_kernel: it
returns the per-pattern log-likelihood and the rescaled partials of every
internal node. It walks the tree by levels of depth (`level_schedule`, the
schedule of the other three kernels), the nodes of a level side by side in
a block, one barrier a level, with its partials in device memory by level
position, tile-major; below 16 states on the CUDA cores in slots of pw
patterns x C categories of a warp, from 16 states on the FP64 tensor cores
in teams of warps over 8 patterns, as ops/cuda_mxu.py's kernel; see the
source for what bounds it and what the design does about that. It takes 2
<= S <= 64 states and up to 8 rate categories in float32 or float64; the
dispatcher (ops/cuda_peeling.py::peel_route) sends it the shapes that
neither the S = 4 kernels nor the matrix-product kernel take: S = 2, S = 8
and the other S below 16, and S >= 16 on trees too large for the
matrix-product kernel's route rule (e.g. 61 codon states x 4 categories at
1,441 taxa).

A chain batch is the grid's second axis: `prepare_stream` with [B, ...]
matrices and a chain-axis schedule launches once for all B chains; the
tips are shared, and one tree is B = 1. `_stream_plain` is the plain
version of the same level walk (ops/cuda_stream2.py::_deep_plain, chain by
chain), the path of CPU tensors. `stream_schedule` is the gather of
pallas_stream.py:277-284 in the caller's order; `level_schedule` builds it
in the kernels' order.

The planner (`stream_plan`), from the 227 KB of shared memory a Hopper
block may take (SMEM_BUDGET of it) and its 132 SMs. Below 16 states a
slot is pw x C lanes of a warp; its shared memory is two buffers of one
node's two [C, S, S] matrix blocks (each rounded up to 16 bytes) and its
log-scale sums [pw] in float64. pw is the widest power of two with pw x C
<= 32 lanes, halved while the grid of ceil(P / pw) x B blocks leaves SMs
idle, down to one 32-byte sector of a state row (4 patterns in float64, 8
in float32); a block is 16 warps, fewer where their slots would overflow
shared memory. From 16 states a block is 8 patterns and `teams` teams of
`tw` warps: a team's slot holds two buffers of g pieces [mp, lda] of a
node's matrices (mp = S rounded up to 8, lda the inner dimension rounded up
to 4 and then to 4 mod 8), which its steps take in turns, and its two
children's tiles [C, kp, 8]; g is the most of a whole node (2C), a
category's pair (2) or one piece that leaves room for a second team, else
that fits one; then as many teams as fit (at most 15, the named barriers),
and the warps left to each team, a warp owning at most 8 output tiles.
Shapes outside
the envelope raise. `chip_smoke.py --tiles` times the pattern and warp
choices below 16 states and the team choices from 16.

Gradients: where autograd asks for one, `peel_stream_chains` (and
`peel_site_loglik_stream`, its batch of one) takes the kernel's one launch
with every chain's partials as the forward of
ops/peeling.py::peel_with_adjoint: `deep_positions` turns the tile-major
partials into positions, `post_by_node` puts them at their nodes, and one
level adjoint over the same schedule takes all B chains.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.cuda_mxu import pad_pieces, piece_dims
from beast_mcmc_tpu_torch.ops.cuda_peeling import (
    _chain_lead,
    check_kernel_inputs,
)
from beast_mcmc_tpu_torch.ops.peeling import (
    node_depths,
    one_chain,
    parent_from_children,
    peel_with_adjoint,
    post_by_node,
)
from beast_mcmc_tpu_torch.utils.accum import stable_dot

SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may take
N_SM = 132  # streaming multiprocessors of an H100
MAX_WARPS = 16  # of one block (csrc: 512 threads)
MMA_MIN_STATES = 16  # from here teams of warps on the tensor cores
TILE_W = 8  # patterns of a block from MMA_MIN_STATES (csrc: W)
MAX_UNITS = 8  # output tiles one warp may own (csrc: the register tile)
MAX_TEAMS = 15  # a named barrier each (1..15)
STATES = range(2, 65)
MAX_CATEGORIES = 8

launches = 0  # kernel launches since the caller last set this to 0


class StreamPlan(NamedTuple):
    pw: int  # patterns of a slot (S < 16) or of a block (S >= 16, TILE_W)
    warps: int  # warps of a block
    nodes: int  # nodes a block peels side by side: slots or teams
    g: int  # [S, S] matrix pieces a team's slot holds; 0 below 16 states
    smem: int  # bytes of shared memory


def _slots_smem(c: int, s: int, pw: int, slots: int, itemsize: int) -> int:
    """Bytes of shared memory of a block of slots (csrc, slots_smem)."""
    per16 = 16 // itemsize
    ne_pad = -(-c * s * s // per16) * per16
    return slots * (4 * ne_pad * itemsize + 8 * pw)


def _teams_smem(c: int, s: int, g: int, teams: int, tw: int,
                itemsize: int) -> int:
    """Bytes of shared memory of a block of teams (csrc, teams_smem)."""
    kp, mp, lda = piece_dims(s)
    slot = 2 * g * mp * lda + 2 * c * kp * TILE_W
    elems = teams * slot + (teams + 1) * tw * TILE_W
    return (-(-16 * teams // 16) * 16 + -(-elems * itemsize // 8) * 8
            + teams * TILE_W * 8)


def _slots_plan(p, c, s, itemsize, b, pw, warps) -> StreamPlan:
    if pw is None:
        pw = 1 << ((32 // c).bit_length() - 1)
        while pw > 32 // itemsize and -(-p // pw) * b < N_SM:
            pw //= 2
    if pw & (pw - 1) or not 2 <= pw * c <= 32:
        raise ValueError(f"a slot is a power of two of patterns by the C "
                         f"categories, 2..32 lanes: pw {pw}, C = {c}")
    groups = 32 // (pw * c)
    if warps is None:
        warps = MAX_WARPS
        while (warps > 1 and _slots_smem(c, s, pw, warps * groups, itemsize)
               > SMEM_BUDGET):
            warps //= 2
    slots = warps * groups
    return StreamPlan(pw, warps, slots, 0,
                      _slots_smem(c, s, pw, slots, itemsize))


def _teams_plan(c, s, itemsize, teams, warps) -> StreamPlan:
    units = c * -(-s // 8)
    tw_min = -(-units // MAX_UNITS)

    def tw_for(teams_):  # the warps left to each team
        if warps is not None:
            return warps // teams_
        return min(units, max(tw_min, MAX_WARPS // teams_))

    def fits(g, teams_):
        return (_teams_smem(c, s, g, teams_, tw_for(teams_), itemsize)
                <= SMEM_BUDGET)

    # the most pieces a buffer where a second team fits beside, else where
    # one team does
    g = next((g for t in (2, 1) for g in (2 * c, 2, 1) if fits(g, t)), 1)
    if teams is None:
        teams = 1
        while (teams + 1 <= MAX_TEAMS and (teams + 1) * tw_min <= MAX_WARPS
               and _teams_smem(c, s, g, teams + 1, tw_for(teams + 1),
                               itemsize) <= SMEM_BUDGET):
            teams += 1
    tw = tw_for(teams)
    if tw < 1 or -(-units // tw) > MAX_UNITS or teams > MAX_TEAMS:
        raise ValueError(f"no plan: {teams} teams x {tw} warps at S = {s}, "
                         f"C = {c}")
    return StreamPlan(TILE_W, teams * tw, teams, g,
                      _teams_smem(c, s, g, teams, tw, itemsize))


def stream_plan(p: int, c: int, s: int, itemsize: int, b: int = 1,
                pw: int | None = None, warps: int | None = None,
                teams: int | None = None) -> StreamPlan:
    """The launch plan of B chains' trees of P patterns at these shapes;
    raises outside the envelope. Below 16 states `pw` and `warps` force
    the block, from 16 `teams` and `warps` (a measurement of them)."""
    if s not in STATES or not 1 <= c <= MAX_CATEGORIES:
        raise ValueError(f"the streaming peel takes 2..64 states and 1..8 "
                         f"categories, got S = {s}, C = {c}")
    plan = (_slots_plan(p, c, s, itemsize, b, pw, warps)
            if s < MMA_MIN_STATES else _teams_plan(c, s, itemsize, teams,
                                                   warps))
    if plan.smem > SMEM_BUDGET or plan.warps > MAX_WARPS:
        raise ValueError(f"no plan within shared memory and {MAX_WARPS} "
                         f"warps: {plan}")
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
    n_int = children.shape[-2] - n_tips
    if parent is None:
        parent = parent_from_children(children, n_tips)
    d = node_depths(parent)[..., n_tips:]
    # 0 for the deepest level. An invalid proposal (a cycle, which its
    # operator rejects whatever the likelihood) has depths past n_int: the
    # clamp keeps its schedule in range, and is a no-op on a tree.
    lvl = (d.amax(-1, keepdim=True) - d).clamp_(0, n_int - 1)
    return schedule_from_levels(children, n_tips, lvl)


def schedule_from_levels(children, n_tips, lvl):
    """`level_schedule` from each internal node's level lvl int64 [...,
    n_int] (0 the deepest, peeled first; the root's level last and the
    root alone in it), for graphs whose levels are not the depths from
    one root (models/arg.py)."""
    lead = children.shape[:-2]
    n_int = children.shape[-2] - n_tips
    dev = children.device
    order = torch.sort(lvl, dim=-1, stable=True).indices + n_tips
    counts = torch.zeros((*lead, n_int), dtype=torch.int32, device=dev)
    counts.scatter_add_(-1, lvl, torch.ones_like(counts))
    level_start = torch.zeros((*lead, n_int + 1), dtype=torch.int32,
                              device=dev)
    level_start[..., 1:] = torch.cumsum(counts, -1, dtype=torch.int32)
    return (order, *stream_schedule(children, order), level_start)


def _stream_plain(tip_partials, schedule, p_matrices, wcs):
    """Plain PyTorch version of the kernel: the same level walk, one batched
    step a level (ops/cuda_stream2.py::_deep_plain), chain by chain. The
    chain-axis level_schedule(children, N, parent), p_matrices [B, M, C, S,
    S] and wcs [B, C, S] give (site_logl [B, P], the rescaled partials by
    level position [B, n_int, C, S, P])."""
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import (
        _deep_plain,
        chains_pm_ord,
    )

    _, lr_ids, lr_pos, level_start = schedule
    site, post = _deep_plain(tip_partials[None], lr_ids, lr_pos, level_start,
                             chains_pm_ord(p_matrices[:, None], lr_ids),
                             wcs[:, None], want_post=True)
    return site[:, 0], post[:, 0]


def prepare_stream(tips, schedule, p_matrices, freqs, cat_w,
                   pw: int | None = None, warps: int | None = None,
                   teams: int | None = None) -> _build.KernelCall:
    """Check the inputs and allocate the outputs of one launch of the
    kernel: the call's `out` is (site_logl, partials), the partials
    tile-major by level position [tiles, n_int, C, S, pw]
    (`deep_positions` gives [n_int, C, S, P]). `schedule` is
    level_schedule(children, N, parent); `pw`, `warps` and `teams` go to
    `stream_plan`.

    A chain batch is one launch: a chain-axis schedule, p_matrices [B, M, C,
    S, S], freqs [B, S] and cat_w [B, C] give ([B, P], [B, tiles, n_int, C,
    S, pw]); the tips [N, S, P] are shared. One tree is the B = 1 case of
    the same launch."""
    chains = p_matrices.dim() == 5
    p_matrices, freqs, cat_w = _chain_lead(chains, p_matrices, freqs, cat_w)
    _, lr_ids, lr_pos, level_start = (schedule if chains
                                      else one_chain(schedule))
    n_tips, s, p = tips.shape
    b_n, m, c = p_matrices.shape[:3]
    n_int = n_tips - 1
    dt = p_matrices.dtype
    check_kernel_inputs(tips, p_matrices[0], freqs[0], cat_w[0], lr_ids,
                        lr_pos, level_start, states=STATES,
                        max_categories=MAX_CATEGORIES)
    if m != 2 * n_tips - 1:
        raise ValueError("p_matrices must be [2N-1,C,S,S], with the chain "
                         "axis where there is one")
    if (lr_ids.shape != (b_n, n_int, 2) or lr_pos.shape != (b_n, n_int, 2)
            or level_start.shape != (b_n, n_int + 1)):
        raise ValueError("the schedule must cover the N-1 internal nodes of "
                         "every chain")
    if freqs.shape[0] != b_n or cat_w.shape[0] != b_n:
        raise ValueError("freqs and cat_w must share the chain axis")
    plan = stream_plan(p, c, s, p_matrices.element_size(), b_n, pw, warps,
                       teams)
    lib = _build.load("peel_stream_ring",
                      ["peel_stream_ring_f64", "peel_stream_ring_f32"], 9,
                      n_ptrs=8)
    fn = (lib.peel_stream_ring_f64 if dt == torch.float64
          else lib.peel_stream_ring_f32)
    wcs = (cat_w[:, :, None] * freqs[:, None, :]).contiguous()
    if s >= MMA_MIN_STATES:  # a team copies each piece in one bulk copy
        p_matrices = pad_pieces(p_matrices)
    tiles = -(-p // plan.pw)
    post = torch.empty((b_n, tiles, n_int, c, s, plan.pw), dtype=dt,
                       device=tips.device)
    site = torch.empty((b_n, p), dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_stream_ring", fn,
        (tips, p_matrices.contiguous(), lr_ids.to(torch.int32).contiguous(),
         lr_pos.to(torch.int32).contiguous(),
         level_start.to(torch.int32).contiguous(), wcs, post, site),
        (n_tips, c, s, p, plan.pw, plan.warps, plan.nodes, plan.g, b_n),
        (site, post) if chains else (site[0], post[0]))


def _peel_stream_ring_kernel(tips, schedule, p_matrices, freqs, cat_w):
    global launches
    out = prepare_stream(tips, schedule, p_matrices, freqs, cat_w).launch()
    launches += 1
    return out


def _stream_chains(tips, schedule, p_matrices, freqs, cat_w, want_post):
    """(site_logl [B, P], partials by level position [B, n_int, C, S, P] or
    None) of a chain batch (the chain-axis level_schedule, p_matrices [B,
    M, C, S, S], freqs [B, S], cat_w [B, C]) through the kernel; CPU
    tensors take the plain version."""
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import deep_positions

    if not tips.is_cuda:
        site, post = _stream_plain(tips, schedule, p_matrices,
                                   cat_w[:, :, None] * freqs[:, None, :])
        return site, (post if want_post else None)
    site, post = _peel_stream_ring_kernel(tips.contiguous(), schedule,
                                          p_matrices.contiguous(), freqs,
                                          cat_w)
    return site, (deep_positions(post, tips.shape[-1]) if want_post
                  else None)


def _stream_forward(tip_partials, children, order, p_matrices, freqs, cat_w,
                    schedule=None):
    """(site_logl [P], post_pos [n_int, C, S, P]) of one tree through the
    kernel; CPU tensors take the plain version. The kernel peels by levels
    of depth, so the partials are by level position: `schedule` =
    level_schedule(children, N, parent) (computed here when not given)
    holds the node of each position first. `order` is kept for interface
    parity."""
    schedule = one_chain(schedule) or level_schedule(children[None],
                                                     tip_partials.shape[0])
    site, post = _stream_chains(tip_partials, schedule, p_matrices[None],
                                freqs[None], cat_w[None], True)
    return site[0], post[0]


def peel_stream_chains(tip_partials, children, p_matrices, freqs, cat_w,
                       schedule=None) -> torch.Tensor:
    """The v1 streaming peel of a chain batch in one launch: children [B, M,
    2], p_matrices [B, M, C, S, S], freqs [B, S] and cat_w [B, C] give [B,
    P]; the tips [N, S, P] are shared. `schedule` is the chain-axis
    level_schedule(children, N, parent), computed here when not given. A
    CPU tensor takes the plain version. Differentiable in every chain's
    p_matrices, freqs and cat_w: the one launch returns every chain's
    partials, and one level adjoint takes all B chains."""
    if schedule is None:
        schedule = level_schedule(children, tip_partials.shape[0])

    def forward(pm, fr, cw, want_post):  # [B, 1, ...]: one partition
        site, post = _stream_chains(tip_partials, schedule, pm[:, 0],
                                    fr[:, 0], cw[:, 0], want_post)
        if not want_post:
            return site[:, None]
        return site[:, None], post_by_node(post[:, None], tip_partials[None],
                                           schedule[0])

    return peel_with_adjoint(forward, schedule, p_matrices[:, None],
                             freqs[:, None], cat_w[:, None])[:, 0]


def peel_site_loglik_stream(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights,
                            schedule=None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the kernel, differentiable in
    p_matrices, freqs and category_weights: `peel_stream_chains`' batch of
    one. `schedule` is level_schedule(children, N, parent) where the caller
    has it; the kernel peels by levels of depth, so `order` and `root` are
    kept for interface parity."""
    return peel_stream_chains(tip_partials, children[None], p_matrices[None],
                              freqs[None], category_weights[None],
                              one_chain(schedule))[0]


def peel_loglikelihood_stream(tip_partials, children, order, root, p_matrices,
                              freqs, category_weights, pattern_weights,
                              schedule=None) -> torch.Tensor:
    """Pattern-weighted total through the kernel, in float64."""
    site = peel_site_loglik_stream(tip_partials, children, order, root,
                                   p_matrices, freqs, category_weights,
                                   schedule)
    return stable_dot(pattern_weights, site)

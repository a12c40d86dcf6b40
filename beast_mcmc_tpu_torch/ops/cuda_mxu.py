"""The matrix-product CUDA peel for large state spaces (amino acid S = 20,
codon S = 61).

Counterpart of beast_mcmc_tpu/ops/pallas_mxu.py. The kernel
(csrc/peel_mxu.cu) replaces pallas_mxu.py::_peel_kernel_mxu: it peels the
tree by levels of depth (ops/cuda_stream.py::level_schedule), the nodes of a
level side by side in the teams of warps of a block; per node and rate
category it computes the two products [S, S] x [S, 8 patterns] of the
children's partials with their branch matrices as 8 x 8 tiles, in float64 on
the FP64 tensor cores (mma.sync.m8n8k4), in float32 by FMA (single-pass TF32
would lose precision), and rescales by the per-pattern max; see the source
for what bounds it and what the design does about that. It returns the
per-pattern log-likelihood and, where asked, the rescaled partials of every
node [M, C, S, P] (the gradient's residuals).

It is not the TPU kernel carried over. That one packs the categories into one
[C*S, BP] tile and multiplies by a block-diagonal [M, 2, C*S, C*S] operand
(`_blockdiag_w`) to fill the matrix unit's sublanes; C - 1 of every C blocks
of it are zero, which on this card is C times the bytes and operations for
nothing. This kernel takes the dense [M, C, S, S] matrices and does C products
per child. The TPU kernel keeps the [M, C*S, BP] partials on chip; here they
go to device memory by node, and a team of warps copies a node's matrices
and its children's tiles into its own shared-memory slot.

The planner. A block of 8 patterns holds `teams` teams of `tw` warps; a team
computes whole nodes in its own shared-memory slot, its warps sharing the
node's C * ceil(S / 8) output tiles, at most MAX_UNITS a warp (the register
tile). S is padded in shared memory: output rows to `mp` (a multiple of 8),
the inner dimension to `kp` (a multiple of 4); leading dimensions are 4 mod
8 elements. The wrapper pads the matrices to [M, C, mp, lda] with zeros, so
that the bulk copy engine moves each in one piece. A slot holds, in elements
of the working type,
    g matrix pieces [mp, lda]                           g*piece
    the two children's tiles [C, kp, 8]                 2*C*kp*8
where g is the most pieces that fit one slot within SMEM_BUDGET: a whole
node (2*C), one category's pair (2), or one piece (1). Beside the slots, the
schedule (16 bytes a node and `level_start`) and an mbarrier a team, the max
reduction [teams, tw, 8] and the root's parts [tw, 8] in the working type
and the log-scale sums [teams, 8] in double. `mxu_plan` takes as many teams
as fit shared memory and MAX_WARPS (at most 15, the named barriers), and the
warps that are left to each team (`chip_smoke.py --tiles` sweeps the
teams). Every shape that `resident_mxu_fits` admits has a plan: one team
with one piece takes less than the route rule's arithmetic allows.

`resident_mxu_fits` is the route rule: the shapes the kernel's earlier,
node-by-node design could stage in shared memory (six [C, S, 8] child tiles,
two [S, S] matrix pieces and the schedule). The kernel no longer stages
them, but the rule is kept as it was, so that no shape changes route;
outside it the dispatcher keeps the v1 streaming kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.cuda_peeling import check_kernel_inputs
from beast_mcmc_tpu_torch.utils.accum import stable_dot

SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may take
MAX_WARPS = 16  # of one block (csrc: 512 threads)
MAX_UNITS = 8  # output tiles one warp may own (csrc: the register tile)
MAX_TEAMS = 15  # a named barrier each (1..15)
STATES = range(2, 65)
MAX_CATEGORIES = 8

launches = 0  # kernel launches since the caller last set this to 0


class MxuPlan(NamedTuple):
    teams: int  # teams per block of 8 patterns: a level's nodes side by side
    tw: int  # warps per team: a node's output tiles
    g: int  # matrix pieces [S, S] per team slot
    smem: int  # bytes of shared memory


def _route_smem(n_int: int, c: int, s: int, itemsize: int) -> int:
    """Shared memory the node-by-node design took at its smallest plan (8
    patterns a block, one [S, S] piece a slot): the route rule's
    arithmetic."""
    kp, mp = -(-s // 4) * 4, -(-s // 8) * 8
    lda = kp + (4 - kp) % 8
    units = c * mp // 8
    w = max(min(units, 12), -(-units // 8))
    return (6 * c * kp * 12 + 2 * mp * lda + 16 * w) * itemsize + 16 * n_int


def resident_mxu_fits(m: int, c: int, s: int, itemsize: int = 8) -> bool:
    """The route rule of the matrix-product kernel: 2..64 states, 1..8
    categories, and `_route_smem` of the (M - 1) / 2 internal nodes within
    SMEM_BUDGET."""
    return (s in STATES and 1 <= c <= MAX_CATEGORIES
            and _route_smem(m // 2, c, s, itemsize) <= SMEM_BUDGET)


def _smem(n_int: int, c: int, s: int, g: int, teams: int, tw: int,
          itemsize: int) -> int:
    """Bytes of shared memory of a block (csrc/peel_mxu.cu, smem_bytes)."""
    kp, mp = -(-s // 4) * 4, -(-s // 8) * 8
    lda = kp + (4 - kp) % 8
    slot = g * mp * lda + 2 * c * kp * 8
    elems = teams * slot + (teams + 1) * tw * 8
    head = -(-(-(-(16 * n_int + 4 * (n_int + 1)) // 8) * 8 + 8 * teams)
             // 16) * 16  # the schedule and an mbarrier a team
    return head + -(-elems * itemsize // 8) * 8 + teams * 64


def mxu_plan(n_int: int, c: int, s: int, itemsize: int,
             teams: int | None = None, tw: int | None = None) -> MxuPlan:
    """The launch plan at these shapes (any pattern count: a block is 8
    patterns); raises outside the envelope. `teams` and `tw` force the block
    (a measurement of it)."""
    if s not in STATES or not 1 <= c <= MAX_CATEGORIES:
        raise ValueError(f"the matrix-product peel takes 2..64 states and "
                         f"1..8 categories, got S = {s}, C = {c}")
    units = c * -(-s // 8)
    tw_min = -(-units // MAX_UNITS)

    def tw_for(teams_):  # the warps left to each team
        return tw or min(units, max(tw_min, MAX_WARPS // teams_))

    g = next((g for g in (2 * c, 2, 1)
              if _smem(n_int, c, s, g, 1, tw_for(1), itemsize)
              <= SMEM_BUDGET), 1)
    if teams is None:
        teams = 1
        while (teams + 1 <= MAX_TEAMS and (teams + 1) * tw_min <= MAX_WARPS
               and _smem(n_int, c, s, g, teams + 1, tw_for(teams + 1),
                         itemsize) <= SMEM_BUDGET):
            teams += 1
    tw = tw_for(teams)
    smem = _smem(n_int, c, s, g, teams, tw, itemsize)
    if (-(-units // tw) > MAX_UNITS or teams * tw > MAX_WARPS
            or teams > MAX_TEAMS or smem > SMEM_BUDGET):
        raise ValueError(f"no plan: {teams} teams x {tw} warps at S = {s}, "
                         f"C = {c}, {smem} bytes")
    return MxuPlan(teams, tw, g, smem)


def _mxu_plain(tip_partials, schedule, p_matrices, wcs):
    """Plain PyTorch version of the kernel: the same level schedule, one
    batched step a level (ops/cuda_stream2.py::_deep_plain). Returns
    (site_logl [P], post [M, C, S, P]) with the partials by node and the
    tips' rows holding the tip partials for every category."""
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import _deep_plain

    order, lr_ids, lr_pos, level_start = schedule
    n_tips = tip_partials.shape[0]
    m, c, s = p_matrices.shape[:3]
    dt = p_matrices.dtype
    site, post_pos = _deep_plain(tip_partials[None], lr_ids, lr_pos,
                                 level_start, p_matrices[lr_ids.long()][None],
                                 wcs[None], want_post=True)
    post = torch.empty((m, c, s, tip_partials.shape[2]), dtype=dt,
                       device=p_matrices.device)
    post[:n_tips] = tip_partials.to(dt)[:, None]
    post[order.long()] = post_pos[0]
    return site[0], post


def prepare_mxu(tips, children, order, p_matrices, freqs, cat_w,
                schedule=None, teams: int | None = None,
                tw: int | None = None) -> _build.KernelCall:
    """Check the inputs and allocate the outputs of one launch of the
    kernel. The call's `out` is (site_logl, post); the kernel writes the
    internal nodes' rows of `post` only. `schedule` is
    level_schedule(children, N, parent) where the caller has it (the kernel
    reads it, not `order`); `teams` and `tw` go to `mxu_plan`."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule

    n_tips, s, p = tips.shape
    check_kernel_inputs(tips, p_matrices, freqs, cat_w, children,
                        states=STATES, max_categories=MAX_CATEGORIES)
    m, c = p_matrices.shape[:2]
    dt = p_matrices.dtype
    if m != 2 * n_tips - 1 or children.shape != (m, 2):
        raise ValueError("p_matrices must be [2N-1,C,S,S] and children "
                         "[2N-1,2]")
    plan = mxu_plan(n_tips - 1, c, s, p_matrices.element_size(), teams, tw)
    lvl_order, lr_ids, _, level_start = schedule or level_schedule(children,
                                                                   n_tips)
    lib = _build.load("peel_mxu", ["peel_mxu_f64", "peel_mxu_f32"], 7,
                      n_ptrs=8)
    fn = lib.peel_mxu_f64 if dt == torch.float64 else lib.peel_mxu_f32
    wcs = (cat_w[:, None] * freqs[None, :]).contiguous()
    # the matrices padded as the kernel's shared memory holds them, [mp, lda]
    # (zeros beyond S), so that one bulk copy moves one of them
    kp, mp = -(-s // 4) * 4, -(-s // 8) * 8
    pm_pad = torch.nn.functional.pad(p_matrices,
                                     (0, kp + (4 - kp) % 8 - s, 0, mp - s))
    post = torch.empty((m, c, s, p), dtype=dt, device=tips.device)
    site = torch.empty(p, dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_mxu", fn,
        (tips, pm_pad, lvl_order.to(torch.int32), lr_ids.contiguous(),
         level_start, wcs, post, site),
        (n_tips, c, s, p, plan.teams, plan.tw, plan.g),
        (site, post))


def _peel_mxu_kernel(tips, children, order, p_matrices, freqs, cat_w,
                     schedule):
    global launches
    out = prepare_mxu(tips, children, order, p_matrices, freqs, cat_w,
                      schedule).launch()
    launches += 1
    return out


def _peel_forward_mxu(tip_partials, children, order, p_matrices, freqs, cat_w,
                      want_post=True, schedule=None):
    """(site_logl [P], post [M, C, S, P] or None) through the kernel; CPU
    tensors take the plain version. Both peel by levels of depth
    (`schedule` = level_schedule(children, N, parent), computed here when
    not given), so `order` is kept for interface parity. `post` is the
    layout the pre-order adjoint takes: rescaled partials by node, the tips'
    rows holding the tip partials."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule

    if not tip_partials.is_cuda:
        wcs = cat_w[:, None] * freqs[None, :]
        site, post = _mxu_plain(
            tip_partials,
            schedule or level_schedule(children, tip_partials.shape[0]),
            p_matrices, wcs)
        return site, (post if want_post else None)
    site, post = _peel_mxu_kernel(tip_partials.contiguous(), children, order,
                                  p_matrices.contiguous(), freqs, cat_w,
                                  schedule)
    if not want_post:
        return site, None
    post[:tip_partials.shape[0]] = tip_partials[:, None]
    return site, post


def peel_site_loglik_mxu(tip_partials, children, order, root, p_matrices,
                         freqs, cat_w, schedule=None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the kernel. `root` is kept for
    interface parity (the level schedule ends at the root)."""
    return _peel_forward_mxu(tip_partials, children, order, p_matrices, freqs,
                             cat_w, want_post=False, schedule=schedule)[0]


def peel_loglikelihood_mxu(tip_partials, children, order, root, p_matrices,
                           freqs, category_weights,
                           pattern_weights) -> torch.Tensor:
    """Pattern-weighted total through the kernel, in float64."""
    site = peel_site_loglik_mxu(tip_partials, children, order, root,
                                p_matrices, freqs, category_weights)
    return stable_dot(pattern_weights, site)

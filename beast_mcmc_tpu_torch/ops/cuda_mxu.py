"""The matrix-product CUDA peel for large state spaces (amino acid S = 20,
codon S = 61).

Counterpart of beast_mcmc_tpu/ops/pallas_mxu.py. The kernel
(csrc/peel_mxu.cu) replaces pallas_mxu.py::_peel_kernel_mxu: per internal
node and rate category it computes the two products [S, S] x [S, BP] of the
children's partials with their branch matrices as 8 x 8 tiles, in float64 on
the FP64 tensor cores (mma.sync.m8n8k4), in float32 by register-tiled FMA
(single-pass TF32 would lose precision), and rescales by the per-pattern max;
see the source for what bounds it and what the design does about that. It
returns the per-pattern log-likelihood and, where asked, the rescaled
partials of every node [M, C, S, P] (the gradient's residuals).

It is not the TPU kernel carried over. That one packs the categories into one
[C*S, BP] tile and multiplies by a block-diagonal [M, 2, C*S, C*S] operand
(`_blockdiag_w`) to fill the matrix unit's sublanes; C - 1 of every C blocks
of it are zero, which on this card is C times the bytes and operations for
nothing. This kernel takes the dense [M, C, S, S] matrices and does C products
per child. The TPU kernel keeps the [M, C*S, BP] partials on chip; here they
go to device memory by node and a block stages the two children's tiles and
the node's matrices in shared memory.

The planners are derived from the 227 KB of shared memory a Hopper block
may take. S is padded in shared memory only: output rows to `mp` (a multiple
of 8), the inner dimension to `kp` (a multiple of 4); leading dimensions are
4 mod 8 elements. A block holds, in elements of the working type,
    2 output slots + 2 x 2 staged children, each [C, kp, BP + 4]   6*xslot
    two matrix slots of g pieces [mp, lda]                         2*g*piece
    the per-pattern max reduction [2, warps of a tile, BP]
and the peel schedule, 16 bytes an internal node. `_plan` takes the most
pieces per slot that fit: a whole node (g = 2*C), one category's pair (2), or
one piece (1). `_pick_block` takes the widest pattern tile (at most 32) with
a plan, and a narrower one while the grid would leave more than half of the
132 SMs without a block. `resident_mxu_fits` says whether any plan exists;
where none does the dispatcher keeps the v1 streaming kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.cuda_peeling import check_kernel_inputs
from beast_mcmc_tpu_torch.utils.accum import stable_dot

SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may take
MAX_WARPS = 16  # of one block (csrc: 512 threads)
MAX_UNITS = 8  # output tiles one warp may own (csrc: the register tile)
WARPS_PER_TILE = 12  # most warps that share one 8-pattern tile
N_SM = 132  # streaming multiprocessors of an H100
STATES = range(2, 65)
MAX_CATEGORIES = 8

launches = 0  # kernel launches since the caller last set this to 0


class MxuPlan(NamedTuple):
    bp: int  # patterns per block: 8, 16 or 32
    w: int  # warps of one 8-pattern tile; a block is bp / 8 * w warps
    g: int  # matrix pieces [S, S] per shared-memory slot
    smem: int  # bytes of shared memory


def _plan(n_int: int, c: int, s: int, itemsize: int,
          bp: int) -> Optional[MxuPlan]:
    """The launch plan at pattern-tile width `bp`, or None where even
    single pieces overflow shared memory."""
    kp, mp = -(-s // 4) * 4, -(-s // 8) * 8
    lda = kp + (4 - kp) % 8
    units = c * mp // 8  # output tiles [8 rows, 8 patterns] of a node
    w = max(min(units, WARPS_PER_TILE, MAX_WARPS // (bp // 8)),
            -(-units // MAX_UNITS))
    xslot, piece = c * kp * (bp + 4), mp * lda
    for g in (2 * c, 2, 1):
        smem = ((6 * xslot + 2 * g * piece + 2 * w * bp) * itemsize
                + 16 * n_int)
        if smem <= SMEM_BUDGET:
            return MxuPlan(bp, w, g, smem)
    return None


def resident_mxu_fits(m: int, c: int, s: int, itemsize: int = 8) -> bool:
    """True when the kernel has a plan at the narrowest pattern tile: six
    [C, S, 8] child tiles, two [S, S] matrix pieces and the schedule of the
    (M - 1) / 2 internal nodes within shared memory."""
    return (s in STATES and 1 <= c <= MAX_CATEGORIES
            and _plan(m // 2, c, s, itemsize, 8) is not None)


def _pick_block(n_int: int, c: int, s: int, p: int, itemsize: int) -> int:
    """Patterns per block: the widest of 32, 16, 8 with a plan; then halved,
    down to 8, while twice the blocks still find an SM each (a block's time
    hardly depends on its width, so idle SMs are the gain)."""
    bp = 32
    while bp > 8 and _plan(n_int, c, s, itemsize, bp) is None:
        bp //= 2
    while bp > 8 and 2 * -(-p // bp) <= N_SM:
        bp //= 2
    return bp


def mxu_plan(n_int: int, c: int, s: int, p: int, itemsize: int) -> MxuPlan:
    """The launch plan at these shapes; raises outside the envelope."""
    if s not in STATES or not 1 <= c <= MAX_CATEGORIES:
        raise ValueError(f"the matrix-product peel takes 2..64 states and "
                         f"1..8 categories, got S = {s}, C = {c}")
    plan = _plan(n_int, c, s, itemsize, _pick_block(n_int, c, s, p, itemsize))
    if plan is None:
        raise ValueError(f"no plan within shared memory at S = {s}, C = {c}, "
                         f"{n_int} internal nodes; use the streaming peel")
    return plan


def _mxu_plain(tip_partials, children, order, p_matrices, wcs):
    """Plain PyTorch version of the kernel: the same peel, node by node.
    Returns (site_logl [P], post [M, C, S, P]) with the tips' rows of `post`
    holding the tip partials for every category."""
    n_tips, s, p = tip_partials.shape
    m, c = p_matrices.shape[:2]
    dt = p_matrices.dtype
    post = torch.empty((m, c, s, p), dtype=dt, device=p_matrices.device)
    post[:n_tips] = tip_partials.to(dt)[:, None]
    acc = torch.zeros(p, dtype=dt, device=p_matrices.device)
    nodes = order.tolist()
    kids = children.tolist()
    for node in nodes:
        left, right = kids[node]
        x = (p_matrices[left] @ post[left]) * (p_matrices[right] @ post[right])
        scale = torch.amax(x, dim=(0, 1))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        post[node] = x / scale
        acc = acc + torch.log(scale)
    site = torch.log(torch.einsum("cs,csp->p", wcs, post[nodes[-1]])) + acc
    return site, post


def prepare_mxu(tips, children, order, p_matrices, freqs,
                cat_w) -> _build.KernelCall:
    """Check the inputs and allocate the outputs of one launch of the
    kernel. The call's `out` is (site_logl, post); the kernel writes the
    internal nodes' rows of `post` only."""
    n_tips, s, p = tips.shape
    check_kernel_inputs(tips, p_matrices, freqs, cat_w, children, order,
                        states=STATES, max_categories=MAX_CATEGORIES)
    m, c = p_matrices.shape[:2]
    dt = p_matrices.dtype
    if (m != 2 * n_tips - 1 or children.shape != (m, 2)
            or order.shape != (n_tips - 1,)):
        raise ValueError("p_matrices must be [2N-1,C,S,S], children [2N-1,2] "
                         "and order [N-1]")
    plan = mxu_plan(n_tips - 1, c, s, p, p_matrices.element_size())
    lib = _build.load("peel_mxu", ["peel_mxu_f64", "peel_mxu_f32"], 8)
    fn = lib.peel_mxu_f64 if dt == torch.float64 else lib.peel_mxu_f32
    wcs = (cat_w[:, None] * freqs[None, :]).contiguous()
    ch32 = children.to(torch.int32).contiguous()
    ord32 = order.to(torch.int32).contiguous()
    post = torch.empty((m, c, s, p), dtype=dt, device=tips.device)
    site = torch.empty(p, dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_mxu", fn, (tips, p_matrices, ch32, ord32, wcs, post, site),
        (n_tips, n_tips - 1, c, s, p, plan.bp, plan.w, plan.g),
        (site, post))


def _peel_mxu_kernel(tips, children, order, p_matrices, freqs, cat_w):
    global launches
    out = prepare_mxu(tips, children, order, p_matrices, freqs,
                      cat_w).launch()
    launches += 1
    return out


def _peel_forward_mxu(tip_partials, children, order, p_matrices, freqs, cat_w,
                      want_post=True):
    """(site_logl [P], post [M, C, S, P] or None) through the kernel; CPU
    tensors take the plain version. `post` is the layout the pre-order
    adjoint takes: rescaled partials by node, the tips' rows holding the tip
    partials."""
    if not tip_partials.is_cuda:
        wcs = cat_w[:, None] * freqs[None, :]
        site, post = _mxu_plain(tip_partials, children, order, p_matrices, wcs)
        return site, (post if want_post else None)
    site, post = _peel_mxu_kernel(tip_partials, children, order, p_matrices,
                                  freqs, cat_w)
    if not want_post:
        return site, None
    post[:tip_partials.shape[0]] = tip_partials[:, None]
    return site, post


def peel_site_loglik_mxu(tip_partials, children, order, root, p_matrices,
                         freqs, cat_w) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the kernel. `root` is kept for
    interface parity (the peel order ends at the root)."""
    return _peel_forward_mxu(tip_partials, children, order, p_matrices, freqs,
                             cat_w, want_post=False)[0]


def peel_loglikelihood_mxu(tip_partials, children, order, root, p_matrices,
                           freqs, category_weights,
                           pattern_weights) -> torch.Tensor:
    """Pattern-weighted total through the kernel, in float64."""
    site = peel_site_loglik_mxu(tip_partials, children, order, root,
                                p_matrices, freqs, category_weights)
    return stable_dot(pattern_weights, site)

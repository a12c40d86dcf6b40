"""The deep streaming CUDA peel, for S = 4 trees whose branch matrices
overflow shared memory, all partitions of one tree in one launch.

Counterpart of beast_mcmc_tpu/ops/pallas_stream2.py. The kernel
(csrc/peel_stream.cu) replaces pallas_stream2.py::_deep_kernel. It peels
the tree level by level: the internal nodes sorted by depth from the root,
deepest first, the nodes of one level side by side in the warps of a block,
one barrier a level; partials in device memory by peel position; the grid
is (pattern tiles, partitions). See the source for what bounds it and what
the design does about that.

The schedule is ops/cuda_stream.py::level_schedule, built on the device:
`lr_ids` [n_int, 2] are each step's children, `lr_pos` their peel
positions (-1 for a tip), `level_start` [n_int + 1] the first position of
each level (n_int past the last). `pm_ord` [K, n_int, 2, C, S, S] are the
children's branch matrices in that order, gathered once an evaluation for
all K partitions. The plain version `_deep_plain` peels from the same
arrays, level by level, batched over the nodes of a level and over the
partitions, so a CPU tensor checks the gather as well as the arithmetic.

Both take the logarithms of the scales in float64 and sum them in float64
whatever the working type, the kernel slot by slot (as a running product)
and the plain version level by level: float32 sums over ~1,600 nodes in
different orders would differ by more than the 5e-5 the float32 checks
allow.

The planner: a slot is pw patterns x C categories of one warp (pw x C <=
32 lanes), so a block of W warps peels W * (32 // (pw C)) nodes side by
side and a grid has ceil(P / pw) * K blocks. `deep_plan` takes the widest
pw, halved while the grid would leave SMs of the 132 without a block, down
to one 32-byte sector of a state row (pw = 4 in f64, 8 in f32), and
WARPS = 16 warps, fewer where their buffers would overflow shared memory
(C > 16 in f64).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.cuda_peeling import (
    MAX_CATEGORIES,
    check_kernel_inputs,
)
from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule
from beast_mcmc_tpu_torch.utils.accum import stable_dot

N_SM = 132  # streaming multiprocessors of an H100
WARPS = 16  # warps per block (chip_smoke.py --tiles)
SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may take

launches = 0  # kernel launches since the caller last set this to 0


class DeepPlan(NamedTuple):
    pw: int  # patterns per slot and per block
    warps: int  # warps per block
    slots: int  # nodes a block peels side by side
    smem: int  # bytes of shared memory


def deep_plan(p: int, k: int, c: int, itemsize: int, pw: int | None = None,
              warps: int | None = None) -> DeepPlan:
    """The launch plan of the deep kernel for K partitions of P patterns;
    `pw` and `warps` force the tile (a measurement of it)."""
    if not 1 <= c <= MAX_CATEGORIES:
        raise ValueError(f"the deep peel takes 1..{MAX_CATEGORIES} "
                         f"categories, got {c}")
    if pw is None:
        pw = 1 << ((32 // c).bit_length() - 1)
        while pw > 32 // itemsize and -(-p // pw) * k < N_SM:
            pw //= 2
    # per slot: two buffers of one node's [2, C, 4, 4] matrices and schedule
    # row, and its log-scale sums in float64
    per_slot = 2 * (2 * c * 16 * itemsize + 16) + 8 * pw
    groups = 32 // (pw * c)
    if warps is None:
        warps = WARPS
        while warps > 1 and warps * groups * per_slot > SMEM_BUDGET:
            warps //= 2
    slots = warps * groups
    smem = slots * per_slot
    if smem > SMEM_BUDGET:
        raise ValueError(f"no deep plan within shared memory: pw {pw}, "
                         f"{warps} warps, {smem} bytes")
    return DeepPlan(pw, warps, slots, smem)


def _deep_plain(tips, lr_ids, lr_pos, level_start, pm_ord, wcs,
                want_post=False):
    """Plain PyTorch version of the deep kernel: tips [K, N, S, P], pm_ord
    [K, n_int, 2, C, S, S], wcs [K, C, S]; returns the per-pattern
    log-likelihood [K, P], and with `want_post` the rescaled partials by
    peel position [K, n_int, C, S, P] too. One batched step a level. It is
    the plain version of the resident and the matrix-product kernels as well
    (K = 1), which peel the same schedule."""
    k_parts, n_tips, s, p = tips.shape
    n_int = lr_ids.shape[0]
    c = pm_ord.shape[3]
    dt = pm_ord.dtype
    tips = tips.to(dt)
    post = torch.empty((k_parts, n_int, c, s, p), dtype=dt,
                       device=pm_ord.device)
    acc = torch.zeros((k_parts, p), dtype=torch.float64, device=pm_ord.device)
    ids, pos = lr_ids.long(), lr_pos.long()
    bounds = level_start.tolist()
    for a, b in zip(bounds, bounds[1:]):
        if a == n_int:
            break
        tip = tips[:, ids[a:b].clamp_max(n_tips - 1)][:, :, :, None]
        inner = post[:, pos[a:b].clamp_min(0)]  # [K, L, 2, C, S, P]
        child = torch.where((pos[a:b] < 0)[None, :, :, None, None, None],
                            tip, inner)  # [K, L, 2, C, S, P]
        v = pm_ord[:, a:b] @ child
        x = v[:, :, 0] * v[:, :, 1]  # [K, L, C, S, P]
        scale = torch.amax(x, dim=(2, 3))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        post[:, a:b] = x / scale[:, :, None, None]
        acc += torch.log(scale.to(torch.float64)).sum(1)
    site = torch.log(torch.einsum("kcs,kcsp->kp", wcs, post[:, n_int - 1]))
    site = (site.to(torch.float64) + acc).to(dt)
    return (site, post) if want_post else site


def prepare_deep(tips, lr_ids, lr_pos, level_start, pm_ord, freqs, cat_w,
                 pw: int | None = None,
                 warps: int | None = None) -> _build.KernelCall:
    """Check the inputs and allocate the output [K, P] and scratch of one
    launch of the deep kernel: tips [K, N, 4, P], pm_ord [K, n_int, 2, C,
    4, 4], freqs [K, 4], cat_w [K, C]. `pw` and `warps` go to `deep_plan`."""
    k_parts, n_tips, s, p = tips.shape
    n_int = lr_ids.shape[0]
    c = pm_ord.shape[3]
    dt = pm_ord.dtype
    check_kernel_inputs(tips[0], pm_ord[0].reshape(-1, c, s, s), freqs[0],
                        cat_w[0], lr_ids, lr_pos, level_start,
                        max_categories=MAX_CATEGORIES)
    if (pm_ord.shape != (k_parts, n_int, 2, c, s, s)
            or freqs.shape != (k_parts, s) or cat_w.shape != (k_parts, c)):
        raise ValueError("tips, pm_ord, freqs and cat_w must share the "
                         "partition axis K")
    if n_int != n_tips - 1 or level_start.shape != (n_int + 1,):
        raise ValueError("the schedule must cover the N-1 internal nodes")
    plan = deep_plan(p, k_parts, c, pm_ord.element_size(), pw, warps)
    lib = _build.load("peel_stream", ["peel_stream_f64", "peel_stream_f32"],
                      8, n_ptrs=8)
    fn = lib.peel_stream_f64 if dt == torch.float64 else lib.peel_stream_f32
    wcs = (cat_w[:, :, None] * freqs[:, None, :]).contiguous()
    ids32 = lr_ids.to(torch.int32).contiguous()
    pos32 = lr_pos.to(torch.int32).contiguous()
    ls32 = level_start.to(torch.int32).contiguous()
    if not pm_ord.is_contiguous() or pm_ord.data_ptr() % 16:
        pm_ord = pm_ord.clone()  # the kernel copies it 16 bytes at a time
    tiles = -(-p // plan.pw)
    scratch = torch.empty((k_parts, tiles, n_int, c, s, plan.pw), dtype=dt,
                          device=tips.device)
    out = torch.empty((k_parts, p), dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_stream", fn,
        (tips, pm_ord, ids32, pos32, ls32, wcs, scratch, out),
        (n_tips, n_int, c, s, p, k_parts, plan.pw, plan.warps), out)


def _peel_deep_kernel(tips, lr_ids, lr_pos, level_start, pm_ord, freqs,
                      cat_w):
    global launches
    out = prepare_deep(tips, lr_ids, lr_pos, level_start, pm_ord, freqs,
                       cat_w).launch()
    launches += 1
    return out


def peel_site_loglik_deep(tip_partials, children, order, root, p_matrices,
                          freqs, category_weights,
                          schedule=None) -> torch.Tensor:
    """Per-pattern log-likelihood through the deep kernel; a CPU tensor
    takes the plain version. One tree: tip_partials [N, S, P], p_matrices
    [M, C, S, S], freqs [S], category_weights [C] give [P]; K partitions on
    it: [K, N, S, P], [K, M, C, S, S], [K, S], [K, C] give [K, P], in one
    launch. The peel order comes from depth alone, so `order` and `root`
    are kept for interface parity only. `schedule` is
    level_schedule(children, N, parent) where the caller already has it."""
    single = tip_partials.dim() == 3
    if single:
        tip_partials, p_matrices = tip_partials[None], p_matrices[None]
        freqs, category_weights = freqs[None], category_weights[None]
    _, lr_ids, lr_pos, level_start = schedule or level_schedule(
        children, tip_partials.shape[1])
    pm_ord = p_matrices[:, lr_ids.long()]
    if not tip_partials.is_cuda:
        wcs = category_weights[:, :, None] * freqs[:, None, :]
        site = _deep_plain(tip_partials, lr_ids, lr_pos, level_start, pm_ord,
                           wcs)
    else:
        site = _peel_deep_kernel(tip_partials.contiguous(), lr_ids, lr_pos,
                                 level_start, pm_ord, freqs, category_weights)
    return site[0] if single else site


def peel_loglikelihood_deep(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights, pattern_weights,
                            schedule=None) -> torch.Tensor:
    """Pattern-weighted total through the deep kernel, in float64, summed
    over the partitions where there are K."""
    site = peel_site_loglik_deep(tip_partials, children, order, root,
                                 p_matrices, freqs, category_weights,
                                 schedule)
    return stable_dot(pattern_weights, site)

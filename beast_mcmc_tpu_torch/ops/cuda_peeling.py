"""The resident CUDA peel and the shape dispatcher of the likelihood.

Counterpart of beast_mcmc_tpu/ops/pallas_peeling.py. The kernel
(csrc/peel_resident.cu) replaces pallas_peeling.py::_peel_kernel: it stages
every branch matrix of the tree in shared memory once per block and peels
the tree by levels, the nodes of a level side by side, from the deep
kernel's schedule (ops/cuda_stream.py::level_schedule); see the source for
what bounds it and what the design does about that. Its plain version,
`_resident_plain`, peels the same schedule level by level
(ops/cuda_stream2.py::_deep_plain with one partition); a CPU tensor takes
it, a CUDA tensor launches the kernel or raises.

The planner: a slot is pw patterns x C categories of one warp (pw x C <=
32 lanes); a block of W warps holds `tiles` pattern tiles of pw patterns,
each with W * (32 // (pw C)) / tiles slots, so the grid has
ceil(P / (pw tiles)) blocks, each staging the matrices once. A block's
shared memory is the matrices [M, C, 4, 4] and the slots' log-scale sums
[slots, pw] in double; the partials go to a device-memory scratch [tiles of
the grid, n_int, 4, C, pw]. `resident_plan` takes the widest pw a warp holds
at C categories, WARPS warps and TILES tiles (fewer where the slots do not
divide among them). The defaults are the fastest of the sweep
`chip_smoke.py --tiles` at the benchmark2 shape.

`peel_route` names the kernel a shape goes to. For S = 4,
`resident_plan_fits` decides between this kernel and the deep streaming one
(ops/cuda_stream2.py) from the bytes of the branch matrices against the
shared memory a Hopper block may use, as the JAX dispatcher does. S >= 16
(amino acids, codons) goes to the matrix-product kernel (ops/cuda_mxu.py)
where `resident_mxu_fits` accepts it. Every other shape goes to the v1
streaming kernel (ops/cuda_stream.py), which takes any S up to 64.
`peel_schedule` builds the schedule each route's kernel reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.utils.accum import stable_dot

# shared memory one block may take on Hopper is 227 KB; keep headroom
SMEM_BUDGET = 200 * 1024
SMEM_LIMIT = 232448  # bytes a block may take on sm_90
MAX_CATEGORIES = 32  # a slot's pw x C lanes lie in one warp (S = 4 kernels)
WARPS, TILES = 8, 2  # the resident planner's defaults (chip_smoke.py --tiles)

launches = 0  # kernel launches since the caller last set this to 0


def resident_plan_fits(m: int, c: int, s: int, itemsize: int = 8) -> bool:
    """True when the [M,C,S,S] branch matrices plus a [2,C,32] reserve fit
    the shared-memory budget at this itemsize: the resident-vs-deep
    cut-over, where the JAX dispatcher's lies (benchmark2 resident, Makona
    deep)."""
    return (m * c * s * s + 2 * c * 32) * itemsize <= SMEM_BUDGET


class ResidentPlan(NamedTuple):
    pw: int  # patterns per slot and per pattern tile
    warps: int  # warps per block
    tiles: int  # pattern tiles per block
    slots: int  # slots per block; slots / tiles take a level side by side
    smem: int  # bytes of shared memory


def resident_plan(m: int, c: int, itemsize: int, pw: int | None = None,
                  warps: int | None = None,
                  tiles: int | None = None) -> ResidentPlan:
    """The launch plan of the resident kernel for [M, C, 4, 4] matrices;
    `pw`, `warps` and `tiles` force the tile (a measurement of it)."""
    if not 1 <= c <= MAX_CATEGORIES:
        raise ValueError(f"the resident peel takes 1..{MAX_CATEGORIES} "
                         f"categories, got {c}")
    pw = pw or 1 << ((32 // c).bit_length() - 1)
    warps = warps or WARPS
    slots = warps * (32 // (pw * c)) if pw * c <= 32 else 0
    if tiles is None:
        tiles = TILES
        while tiles > 1 and slots % tiles:
            tiles //= 2
    smem = m * c * 16 * itemsize + slots * pw * 8
    if (pw * c > 32 or pw & (pw - 1) or not 1 <= warps <= 32 or slots % tiles
            or smem > SMEM_LIMIT):
        raise ValueError(f"no resident plan: pw {pw}, {warps} warps, "
                         f"{tiles} tiles, {smem} bytes of shared memory")
    return ResidentPlan(pw, warps, tiles, slots, smem)


def check_kernel_inputs(tips, p_matrices, freqs, cat_w, *int_tensors,
                        states=(4,), max_categories=MAX_CATEGORIES):
    """Raise unless the tensors are what a peel kernel takes: one CUDA
    device, float32 or float64 throughout, contiguous, a state count in
    `states` and at most `max_categories` rate categories (the defaults are
    those of the two S = 4 kernels)."""
    dt = p_matrices.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"peel kernels take float32 or float64, got {dt}")
    for t in (tips, freqs, cat_w):
        if t.dtype != dt:
            raise TypeError(f"mixed dtypes {t.dtype} and {dt}")
    n_tips, s, p = tips.shape
    if s not in states:
        raise ValueError(f"this peel kernel takes {min(states)} to "
                         f"{max(states)} states, got {s}")
    if p_matrices.dim() != 4 or p_matrices.shape[2:] != (s, s):
        raise ValueError(f"p_matrices must be [M,C,{s},{s}], "
                         f"got {tuple(p_matrices.shape)}")
    c = p_matrices.shape[1]
    if c > max_categories:
        raise ValueError(f"at most {max_categories} rate categories, got {c}")
    if freqs.shape != (s,) or cat_w.shape != (c,):
        raise ValueError("freqs must be [S] and cat_w [C]")
    if not (tips.is_contiguous() and p_matrices.is_contiguous()):
        raise ValueError("tips and p_matrices must be contiguous")
    dev = tips.device
    for t in (tips, p_matrices, freqs, cat_w, *int_tensors):
        if not t.is_cuda or t.device != dev:
            raise ValueError("peel kernel inputs must all lie on one CUDA "
                             f"device, got {t.device} and {dev}")


def prepare_resident(tips, children, order, p_matrices, freqs, cat_w,
                     schedule=None, pw: int | None = None,
                     warps: int | None = None,
                     tiles: int | None = None) -> _build.KernelCall:
    """Check the inputs and allocate the output and scratch of one launch
    of the resident kernel. `schedule` is level_schedule(children, N,
    parent) where the caller has it (the kernel reads it, not `order`);
    `pw`, `warps` and `tiles` go to `resident_plan`."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule

    check_kernel_inputs(tips, p_matrices, freqs, cat_w, children)
    n_tips, s, p = tips.shape
    m, c = p_matrices.shape[:2]
    dt = p_matrices.dtype
    if children.shape != (m, 2) or m != 2 * n_tips - 1:
        raise ValueError("p_matrices must be [2N-1,C,S,S] and children "
                         "[2N-1,2]")
    if not resident_plan_fits(m, c, s, p_matrices.element_size()):
        raise ValueError("branch matrices exceed the resident kernel's "
                         "shared memory; use the streaming peel")
    plan = resident_plan(m, c, p_matrices.element_size(), pw, warps, tiles)
    _, lr_ids, lr_pos, level_start = schedule or level_schedule(children,
                                                                n_tips)
    lib = _build.load("peel_resident",
                      ["peel_resident_f64", "peel_resident_f32"], 8,
                      n_ptrs=8)
    fn = (lib.peel_resident_f64 if dt == torch.float64
          else lib.peel_resident_f32)
    wcs = (cat_w[:, None] * freqs[None, :]).contiguous()
    if p_matrices.data_ptr() % 16:
        p_matrices = p_matrices.clone()  # staged 16 bytes at a time
    blocks = -(-p // (plan.pw * plan.tiles))
    scratch = torch.empty((blocks * plan.tiles, n_tips - 1, s, c, plan.pw),
                          dtype=dt, device=tips.device)
    out = torch.empty(p, dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_resident", fn,
        (tips, p_matrices, lr_ids.contiguous(), lr_pos.contiguous(),
         level_start, wcs, scratch, out),
        (n_tips, m, c, s, p, plan.pw, plan.warps, plan.tiles), out)


def _resident_plain(tip_partials, lr_ids, lr_pos, level_start, p_matrices,
                    wcs):
    """Plain PyTorch version of the resident kernel: the same level
    schedule, one batched step a level (the deep kernel's plain version
    with one partition)."""
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import _deep_plain

    return _deep_plain(tip_partials[None], lr_ids, lr_pos, level_start,
                       p_matrices[lr_ids.long()][None], wcs[None])[0]


def _peel_resident_kernel(tips, children, order, p_matrices, freqs, cat_w,
                          schedule):
    global launches
    out = prepare_resident(tips, children, order, p_matrices, freqs, cat_w,
                           schedule).launch()
    launches += 1
    return out


def peel_site_loglik_cuda(tip_partials, children, order, root, p_matrices,
                          freqs, category_weights,
                          schedule=None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the resident kernel; a CPU
    tensor takes its plain version. Both peel by levels of depth
    (`schedule` = level_schedule(children, N, parent), computed here when
    not given), so `order` and `root` are kept for interface parity."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule

    if not tip_partials.is_cuda:
        _, lr_ids, lr_pos, level_start = schedule or level_schedule(
            children, tip_partials.shape[0])
        wcs = category_weights[:, None] * freqs[None, :]
        return _resident_plain(tip_partials, lr_ids, lr_pos, level_start,
                               p_matrices, wcs)
    return _peel_resident_kernel(tip_partials.contiguous(), children, order,
                                 p_matrices.contiguous(), freqs,
                                 category_weights, schedule)


MXU_MIN_STATES = 16  # from here a node's products fill 8 x 8 tiles


def peel_route(m: int, c: int, s: int, itemsize: int = 8) -> str:
    """The kernel a CUDA peel of these shapes goes to: "resident" or
    "deep" for S = 4, by `resident_plan_fits`; "mxu" for S >= 16 where
    `resident_mxu_fits`; "stream" for every other shape."""
    from beast_mcmc_tpu_torch.ops.cuda_mxu import resident_mxu_fits

    if s == 4:
        return "resident" if resident_plan_fits(m, c, s, itemsize) else "deep"
    if s >= MXU_MIN_STATES and resident_mxu_fits(m, c, s, itemsize):
        return "mxu"
    return "stream"


def peel_site_loglik_auto(tip_partials, children, order, root, p_matrices,
                          freqs, category_weights,
                          schedule=None) -> torch.Tensor:
    """Shape-dispatched peel (`peel_route`): per-pattern log-likelihood [P].
    `schedule` is the route's schedule where the caller already has it
    (`peel_schedule` builds it): level_schedule(children, N, parent) for
    the deep, the resident and the matrix-product kernels, which order by
    depth and do not read `order`; stream_schedule(children, order) for the
    v1 streaming one (several partitions on one tree)."""
    from beast_mcmc_tpu_torch.ops.cuda_mxu import peel_site_loglik_mxu
    from beast_mcmc_tpu_torch.ops.cuda_stream import peel_site_loglik_stream
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import peel_site_loglik_deep

    m, c, s = p_matrices.shape[:3]
    route = peel_route(m, c, s, p_matrices.element_size())
    args = (tip_partials, children, order, root, p_matrices, freqs,
            category_weights)
    if route == "resident":
        return peel_site_loglik_cuda(*args, schedule)
    if route == "deep":
        return peel_site_loglik_deep(*args, schedule)
    if route == "mxu":
        return peel_site_loglik_mxu(*args, schedule)
    return peel_site_loglik_stream(*args, schedule)



def peel_schedule(route: str, children, heights, parent):
    """(order, schedule) of a CUDA peel on `route` (`peel_route`): the
    schedule its kernel reads. The deep, resident and matrix-product kernels
    read level_schedule(children, N, parent), whose order is by depth (one
    sort); the v1 streaming kernel reads stream_schedule of the height
    order (two sorts)."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import (
        level_schedule,
        stream_schedule,
    )
    from beast_mcmc_tpu_torch.ops.peeling import peel_order_from_heights

    n_tips = (children.shape[0] + 1) // 2
    if route == "stream":
        order = peel_order_from_heights(heights, n_tips, parent)
        return order, stream_schedule(children, order)
    schedule = level_schedule(children, n_tips, parent)
    return schedule[0], schedule

def peel_loglikelihood_auto(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights, pattern_weights,
                            schedule=None) -> torch.Tensor:
    """`peel_site_loglik_auto` summed with the pattern weights, in float64."""
    site = peel_site_loglik_auto(tip_partials, children, order, root,
                                 p_matrices, freqs, category_weights, schedule)
    return stable_dot(pattern_weights, site)

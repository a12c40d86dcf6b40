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

A chain batch is the kernel's second grid axis: B chains' matrices,
schedules and outputs beside one another, the tips shared, one launch
(`prepare_resident` with [B, ...] inputs); `peel_site_loglik_auto` with
[B, M, 2] children dispatches a chain batch on every route, and one tree as
the batch of one (`peel_resident_chains` and its counterparts).

`peel_route` names the kernel a shape goes to. For S = 4,
`resident_plan_fits` decides between this kernel and the deep streaming one
(ops/cuda_stream2.py) from the bytes of the branch matrices against the
shared memory a Hopper block may use, as the JAX dispatcher does. S >= 16
(amino acids, codons) goes to the matrix-product kernel (ops/cuda_mxu.py)
where `resident_mxu_fits` accepts it. Every other shape goes to the v1
streaming kernel (ops/cuda_stream.py), which takes any S up to 64.
Every kernel reads ops/cuda_stream.py::level_schedule.

Gradients. Every route's entry point is differentiable in the branch
matrices, the frequencies and the category weights: where autograd asks for
a gradient, the route's forward (the kernel, or its plain version for a CPU
tensor) returns the rescaled partials with the site log-likelihoods, and
ops/peeling.py::peel_with_adjoint takes the level adjoint over the same
schedule. The resident kernel's partials are its scratch, gathered by node
(`resident_positions`, `post_by_node`); the kernel is the same either way. A
kernel entry called outside that wrapper with inputs that require grad
raises (`check_kernel_inputs`): its ctypes launch is invisible to autograd
and would drop the gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.peeling import (
    one_chain,
    peel_with_adjoint,
    post_by_node,
    wants_grad,
)
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
    """Raise unless the tensors are what a peel kernel takes: no gradient
    asked of them (a kernel's launch is invisible to autograd; the entry
    points take gradients through ops/peeling.py::peel_with_adjoint, whose
    forward runs with autograd off), one CUDA device, float32 or float64
    throughout, contiguous, a state count in `states` and at most
    `max_categories` rate categories (the defaults are those of the two
    S = 4 kernels)."""
    if wants_grad(tips, p_matrices, freqs, cat_w):
        raise RuntimeError("a peel kernel's inputs require grad: its launch "
                           "would drop the gradient; call the route's "
                           "differentiable entry point instead")
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


def _chain_lead(chains: bool, *tensors):
    """The tensors with a leading chain axis of 1 unless `chains`: a single
    tree is the B = 1 case of a chain-axis kernel."""
    return tensors if chains else tuple(t[None] for t in tensors)


def prepare_resident(tips, children, order, p_matrices, freqs, cat_w,
                     schedule=None, pw: int | None = None,
                     warps: int | None = None,
                     tiles: int | None = None,
                     want_post: bool = False) -> _build.KernelCall:
    """Check the inputs and allocate the output and scratch of one launch
    of the resident kernel. `schedule` is level_schedule(children, N,
    parent) where the caller has it (the kernel reads it, not `order`);
    `pw`, `warps` and `tiles` go to `resident_plan`. With `want_post` the
    call's `out` is (site_logl, scratch): the kernel writes every node's
    rescaled partials there, the root's included (`resident_positions`).

    A chain batch is one launch: children [B, M, 2], p_matrices [B, M, C,
    4, 4], freqs [B, 4], cat_w [B, C] and a chain-axis schedule give
    site_logl [B, P] (and scratch [B, ...]); the tips [N, 4, P] are shared.
    One tree is the B = 1 case of the same launch."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule

    chains = p_matrices.dim() == 5
    children, p_matrices, freqs, cat_w = _chain_lead(
        chains, children, p_matrices, freqs, cat_w)
    check_kernel_inputs(tips, p_matrices[0], freqs[0], cat_w[0], children)
    n_tips, s, p = tips.shape
    b_n, m, c = p_matrices.shape[:3]
    dt = p_matrices.dtype
    if children.shape != (b_n, m, 2) or m != 2 * n_tips - 1:
        raise ValueError("p_matrices must be [2N-1,C,S,S] and children "
                         "[2N-1,2], each with the chain axis where there is "
                         "one")
    if freqs.shape[0] != b_n or cat_w.shape[0] != b_n:
        raise ValueError("freqs and cat_w must share the chain axis")
    if not p_matrices.is_contiguous():
        raise ValueError("p_matrices must be contiguous")
    if not resident_plan_fits(m, c, s, p_matrices.element_size()):
        raise ValueError("branch matrices exceed the resident kernel's "
                         "shared memory; use the streaming peel")
    plan = resident_plan(m, c, p_matrices.element_size(), pw, warps, tiles)
    if schedule is None:
        schedule = level_schedule(children, n_tips)
    elif not chains:
        schedule = tuple(t[None] for t in schedule)
    _, lr_ids, lr_pos, level_start = schedule
    lib = _build.load("peel_resident",
                      ["peel_resident_f64", "peel_resident_f32"], 9,
                      n_ptrs=8)
    fn = (lib.peel_resident_f64 if dt == torch.float64
          else lib.peel_resident_f32)
    wcs = (cat_w[:, :, None] * freqs[:, None, :]).contiguous()
    if p_matrices.data_ptr() % 16:
        p_matrices = p_matrices.clone()  # staged 16 bytes at a time
    blocks = -(-p // (plan.pw * plan.tiles))
    scratch = torch.empty((b_n, blocks * plan.tiles, n_tips - 1, s, c,
                           plan.pw), dtype=dt, device=tips.device)
    out = torch.empty((b_n, p), dtype=dt, device=tips.device)
    out_ret, scr_ret = (out, scratch) if chains else (out[0], scratch[0])
    return _build.KernelCall(
        "peel_resident", fn,
        (tips, p_matrices, lr_ids.to(torch.int32).contiguous(),
         lr_pos.to(torch.int32).contiguous(),
         level_start.to(torch.int32).contiguous(), wcs, scratch, out),
        (n_tips, m, c, s, p, plan.pw, plan.warps, plan.tiles, b_n),
        (out_ret, scr_ret) if want_post else out_ret)


def resident_positions(scratch, p: int):
    """The resident kernel's scratch [tiles, n_int, S, C, pw] as the
    rescaled partials by peel position [n_int, C, S, P] (the padded
    patterns of the last tile cut away); a chain batch's [B, tiles, ...]
    gives [B, n_int, C, S, P]."""
    *lead, t, n_int, s, c, pw = scratch.shape
    d = len(lead)
    return scratch.permute(*range(d), d + 1, d + 3, d + 2, d, d + 4).reshape(
        *lead, n_int, c, s, t * pw)[..., :p]


def _resident_plain(tip_partials, lr_ids, lr_pos, level_start, p_matrices,
                    wcs, want_post=False):
    """Plain PyTorch version of the resident kernel: the same level
    schedule, one batched step a level (the deep kernel's plain version
    with one partition). With `want_post`, (site_logl, partials by peel
    position [n_int, C, S, P]). With a chain axis (a [B, n_int, 2]
    schedule, p_matrices [B, M, C, S, S], wcs [B, C, S]) it peels chain by
    chain and stacks: [B, P] (and [B, n_int, C, S, P])."""
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import _deep_plain

    if lr_ids.dim() == 3:
        outs = [_resident_plain(tip_partials, *a, want_post)
                for a in zip(lr_ids, lr_pos, level_start, p_matrices, wcs)]
        if want_post:
            return tuple(torch.stack(t) for t in zip(*outs))
        return torch.stack(outs)
    out = _deep_plain(tip_partials[None], lr_ids, lr_pos, level_start,
                      p_matrices[lr_ids.long()][None], wcs[None],
                      want_post=want_post)
    return tuple(t[0] for t in out) if want_post else out[0]


def _peel_resident_kernel(tips, children, order, p_matrices, freqs, cat_w,
                          schedule, want_post=False):
    """site_logl [P], and with `want_post` the partials by peel position
    [n_int, C, S, P], from one launch."""
    global launches
    out = prepare_resident(tips, children, order, p_matrices, freqs, cat_w,
                           schedule, want_post=want_post).launch()
    launches += 1
    if want_post:
        return out[0], resident_positions(out[1], tips.shape[-1])
    return out


def peel_resident_chains(tip_partials, children, p_matrices, freqs,
                         category_weights, schedule=None) -> torch.Tensor:
    """The resident peel of a chain batch in one launch: children [B, M,
    2], p_matrices [B, M, C, 4, 4], freqs [B, 4] and category_weights [B,
    C] give [B, P]; the tips [N, 4, P] are shared. `schedule` is the
    chain-axis level_schedule(children, N, parent), computed here when not
    given. A CPU tensor takes the plain version. Differentiable in every
    chain's p_matrices, freqs and category_weights: the one launch returns
    every chain's partials, and one level adjoint takes all B chains."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import level_schedule

    if schedule is None:
        schedule = level_schedule(children, tip_partials.shape[0])
    lvl_order, lr_ids, lr_pos, level_start = schedule
    tips = tip_partials.contiguous()

    def forward(pm, fr, cw, want_post):  # [B, 1, ...]: one partition
        pm, fr, cw = pm[:, 0], fr[:, 0], cw[:, 0]
        if tips.is_cuda:
            out = _peel_resident_kernel(tips, children, None,
                                        pm.contiguous(), fr, cw, schedule,
                                        want_post)
        else:
            out = _resident_plain(tips, lr_ids, lr_pos, level_start, pm,
                                  cw[:, :, None] * fr[:, None, :],
                                  want_post)
        if not want_post:
            return out[:, None]
        return out[0][:, None], post_by_node(out[1][:, None], tips[None],
                                             lvl_order)

    return peel_with_adjoint(forward, schedule, p_matrices[:, None],
                             freqs[:, None], category_weights[:, None])[:, 0]


def peel_site_loglik_cuda(tip_partials, children, order, root, p_matrices,
                          freqs, category_weights,
                          schedule=None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the resident kernel; a CPU
    tensor takes its plain version: `peel_resident_chains`' batch of one.
    Both peel by levels of depth (`schedule` = level_schedule(children, N,
    parent), computed when not given), so `order` and `root` are kept for
    interface parity. Differentiable in p_matrices, freqs and
    category_weights."""
    return peel_resident_chains(tip_partials, children[None],
                                p_matrices[None], freqs[None],
                                category_weights[None],
                                one_chain(schedule))[0]


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
    `schedule` is level_schedule(children, N, parent) where the caller
    already has it: every kernel orders by depth, and none reads `order`.

    A chain batch (children [B, M, 2], p_matrices [B, M, C, S, S], freqs
    [B, S], category_weights [B, C], `order` and `schedule` with the chain
    axis) gives [B, P] from one launch of the route's kernel for all B
    chains. On the deep route tip_partials [K, N, S, P] with
    p_matrices [B, K, M, C, S, S] gives [B, K, P] in one launch. One tree
    is the batch of one. A CPU tensor takes the route's plain chain-axis
    version. Differentiable in every chain's p_matrices, freqs and
    category_weights: one forward with the partials and one level adjoint
    for all B chains."""
    from beast_mcmc_tpu_torch.ops.cuda_mxu import peel_mxu_chains
    from beast_mcmc_tpu_torch.ops.cuda_stream import peel_stream_chains
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import peel_deep_chains

    m, c, s = p_matrices.shape[-4:-1]
    route = peel_route(m, c, s, p_matrices.element_size())
    one = children.dim() == 2
    if one:
        children, p_matrices = children[None], p_matrices[None]
        freqs, category_weights = freqs[None], category_weights[None]
        order = None if order is None else order[None]
        schedule = one_chain(schedule)
    args = (tip_partials, children, p_matrices, freqs, category_weights,
            schedule)
    if route == "resident":
        site = peel_resident_chains(*args)
    elif route == "deep":
        site = peel_deep_chains(*args)
    elif route == "mxu":
        site = peel_mxu_chains(*args)
    else:
        site = peel_stream_chains(*args)
    return site[0] if one else site


def peel_loglikelihood_auto(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights, pattern_weights,
                            schedule=None) -> torch.Tensor:
    """`peel_site_loglik_auto` summed with the pattern weights, in float64."""
    site = peel_site_loglik_auto(tip_partials, children, order, root,
                                 p_matrices, freqs, category_weights, schedule)
    return stable_dot(pattern_weights, site)

"""The resident CUDA peel and the shape dispatcher of the likelihood.

Counterpart of beast_mcmc_tpu/ops/pallas_peeling.py. The kernel
(csrc/peel_resident.cu) replaces pallas_peeling.py::_peel_kernel: it stages
every branch matrix of the tree in shared memory and peels one pattern tile
per block; see the source for what bounds it and what the design does about
that. Its plain version is ops/peeling.py::peel_site_loglik, which a CPU
tensor takes; a CUDA tensor launches the kernel or raises.

`peel_route` names the kernel a shape goes to. For S = 4,
`resident_plan_fits` decides between this kernel and the deep streaming one
(ops/cuda_stream2.py) from the bytes of the branch matrices against the
shared memory a Hopper block may use, as the JAX dispatcher does. S >= 16
(amino acids, codons) goes to the matrix-product kernel (ops/cuda_mxu.py)
where `resident_mxu_fits` finds it a plan. Every other shape goes to the v1
streaming kernel (ops/cuda_stream.py), which takes any S up to 64.
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops import peeling as _plain
from beast_mcmc_tpu_torch.utils.accum import stable_dot

PX = 32  # patterns per block (csrc/peel_common.cuh)
# shared memory one block may take on Hopper is 227 KB; keep headroom
SMEM_BUDGET = 200 * 1024

launches = 0  # kernel launches since the caller last set this to 0


def resident_plan_fits(m: int, c: int, s: int, itemsize: int = 8) -> bool:
    """True when the [M,C,S,S] branch matrices plus the kernel's [2,C,PX]
    reduction buffer fit the shared-memory budget at this itemsize."""
    return (m * c * s * s + 2 * c * PX) * itemsize <= SMEM_BUDGET


def check_kernel_inputs(tips, p_matrices, freqs, cat_w, *int_tensors,
                        states=(4,), max_categories=1024 // PX):
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


def prepare_resident(tips, children, order, p_matrices, freqs,
                     cat_w) -> _build.KernelCall:
    """Check the inputs and allocate the output and scratch of one launch
    of the resident kernel."""
    check_kernel_inputs(tips, p_matrices, freqs, cat_w, children, order)
    n_tips, s, p = tips.shape
    m, c = p_matrices.shape[:2]
    dt = p_matrices.dtype
    if children.shape != (m, 2) or order.shape != (n_tips - 1,):
        raise ValueError("children must be [M,2] and order [N-1]")
    if not resident_plan_fits(m, c, s, p_matrices.element_size()):
        raise ValueError("branch matrices exceed the resident kernel's "
                         "shared memory; use the streaming peel")
    lib = _build.load("peel_resident",
                      ["peel_resident_f64", "peel_resident_f32"], 5)
    fn = (lib.peel_resident_f64 if dt == torch.float64
          else lib.peel_resident_f32)
    wcs = (cat_w[:, None] * freqs[None, :]).contiguous()
    ch32 = children.to(torch.int32).contiguous()
    ord32 = order.to(torch.int32).contiguous()
    scratch = torch.empty((n_tips - 1, c, s, p), dtype=dt, device=tips.device)
    out = torch.empty(p, dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_resident", fn,
        (tips, p_matrices, ch32, ord32, wcs, scratch, out),
        (n_tips, m, c, s, p), out)


def _peel_resident_kernel(tips, children, order, p_matrices, freqs, cat_w):
    global launches
    out = prepare_resident(tips, children, order, p_matrices, freqs,
                           cat_w).launch()
    launches += 1
    return out


def peel_site_loglik_cuda(tip_partials, children, order, root, p_matrices,
                          freqs, category_weights) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the resident kernel; a CPU
    tensor takes the plain peel. `root` is kept for interface parity: the
    peel order ends at the root."""
    if not tip_partials.is_cuda:
        return _plain.peel_site_loglik(tip_partials, children, order, root,
                                       p_matrices, freqs, category_weights)
    return _peel_resident_kernel(tip_partials, children, order, p_matrices,
                                 freqs, category_weights)


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
    `schedule` is the route's schedule where the caller already has it:
    level_schedule(children, N, parent) for the deep kernel, which orders
    by depth and does not read `order`; stream_schedule(children, order)
    for the v1 streaming one (several partitions on one tree); the resident
    and the matrix-product kernel do not read it."""
    from beast_mcmc_tpu_torch.ops.cuda_mxu import peel_site_loglik_mxu
    from beast_mcmc_tpu_torch.ops.cuda_stream import peel_site_loglik_stream
    from beast_mcmc_tpu_torch.ops.cuda_stream2 import peel_site_loglik_deep

    m, c, s = p_matrices.shape[:3]
    route = peel_route(m, c, s, p_matrices.element_size())
    args = (tip_partials, children, order, root, p_matrices, freqs,
            category_weights)
    if route == "resident":
        return peel_site_loglik_cuda(*args)
    if route == "deep":
        return peel_site_loglik_deep(*args, schedule)
    if route == "mxu":
        return peel_site_loglik_mxu(*args)
    return peel_site_loglik_stream(*args, schedule)


def peel_loglikelihood_auto(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights, pattern_weights,
                            schedule=None) -> torch.Tensor:
    """`peel_site_loglik_auto` summed with the pattern weights, in float64."""
    site = peel_site_loglik_auto(tip_partials, children, order, root,
                                 p_matrices, freqs, category_weights, schedule)
    return stable_dot(pattern_weights, site)

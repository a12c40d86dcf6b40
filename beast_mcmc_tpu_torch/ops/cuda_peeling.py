"""The resident CUDA peel and the shape dispatcher of the likelihood.

Counterpart of beast_mcmc_tpu/ops/pallas_peeling.py. The kernel
(csrc/peel_resident.cu) replaces pallas_peeling.py::_peel_kernel: it stages
every branch matrix of the tree in shared memory and peels one pattern tile
per block; see the source for what bounds it and what the design does about
that. Its plain version is ops/peeling.py::peel_site_loglik, which a CPU
tensor takes; a CUDA tensor launches the kernel or raises.

`resident_plan_fits` decides between this kernel and the streaming one
(ops/cuda_stream.py) from the bytes of the branch matrices against the
shared memory a Hopper block may use.
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


def check_kernel_inputs(tips, p_matrices, freqs, cat_w, *int_tensors):
    """Raise unless the tensors are what the peel kernels take: one CUDA
    device, float32 or float64 throughout, S = 4, contiguous."""
    dt = p_matrices.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"peel kernels take float32 or float64, got {dt}")
    dev = tips.device
    for t in (tips, p_matrices, freqs, cat_w, *int_tensors):
        if not t.is_cuda or t.device != dev:
            raise ValueError("peel kernel inputs must all lie on one CUDA "
                             f"device, got {t.device} and {dev}")
    for t in (tips, freqs, cat_w):
        if t.dtype != dt:
            raise TypeError(f"mixed dtypes {t.dtype} and {dt}")
    n_tips, s, p = tips.shape
    if s != 4:
        raise ValueError(f"peel kernels are built for S = 4 states, got {s}")
    if p_matrices.dim() != 4 or p_matrices.shape[2:] != (s, s):
        raise ValueError(f"p_matrices must be [M,C,{s},{s}], "
                         f"got {tuple(p_matrices.shape)}")
    c = p_matrices.shape[1]
    if c * PX > 1024:
        raise ValueError(f"at most {1024 // PX} rate categories, got {c}")
    if freqs.shape != (s,) or cat_w.shape != (c,):
        raise ValueError("freqs must be [S] and cat_w [C]")
    if not (tips.is_contiguous() and p_matrices.is_contiguous()):
        raise ValueError("tips and p_matrices must be contiguous")


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


def peel_loglikelihood_auto(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights, pattern_weights
                            ) -> torch.Tensor:
    """Shape-dispatched peel: the resident kernel when the branch matrices
    fit in shared memory, the streaming kernel otherwise. Returns the
    pattern-weighted total in float64."""
    from beast_mcmc_tpu_torch.ops.cuda_stream import peel_site_loglik_stream

    m, c, s = p_matrices.shape[:3]
    if resident_plan_fits(m, c, s, p_matrices.element_size()):
        site = peel_site_loglik_cuda(tip_partials, children, order, root,
                                     p_matrices, freqs, category_weights)
    else:
        site = peel_site_loglik_stream(tip_partials, children, order, root,
                                       p_matrices, freqs, category_weights)
    return stable_dot(pattern_weights, site)

"""The deep streaming CUDA peel, for S = 4 trees whose branch matrices
overflow shared memory.

Counterpart of beast_mcmc_tpu/ops/pallas_stream2.py. The kernel
(csrc/peel_stream.cu) replaces pallas_stream2.py::_deep_kernel: branch
matrices gathered in peel order stream through shared memory in chunks
(cp.async, double buffered), and partials are indexed by peel position;
see the source for what bounds it and what the design does about that.

The peel-order gather of pallas_stream2.py:270-289 is
ops/cuda_stream.py::stream_schedule, shared with the v1 streaming peel
there: `lr_ids` [n_int, 2] are each step's children, `lr_pos` their peel
positions (-1 for a tip), `pm_ord` [n_int, 2, C, S, S] their branch
matrices. The plain version `_deep_plain` peels from the same three arrays,
so a CPU tensor checks the gather as well as the arithmetic.
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.cuda_peeling import check_kernel_inputs
from beast_mcmc_tpu_torch.ops.cuda_stream import _stream_plain, stream_schedule
from beast_mcmc_tpu_torch.utils.accum import stable_dot

CHUNK_BYTES = 32 * 1024  # one of the two shared-memory chunk slots

launches = 0  # kernel launches since the caller last set this to 0


def _pick_chunk(c: int, s: int, itemsize: int) -> int:
    """Nodes per streamed chunk: one slot holds CHUNK_BYTES of matrices."""
    return max(1, min(64, CHUNK_BYTES // (2 * c * s * s * itemsize)))


def _deep_plain(tip_partials, lr_ids, lr_pos, pm_ord, wcs):
    """Plain PyTorch version of the deep kernel: the same peel, read from
    the peel-ordered schedule. Returns the per-pattern log-likelihood."""
    return _stream_plain(tip_partials, lr_ids, lr_pos, pm_ord, wcs)[0]


def prepare_deep(tips, lr_ids, lr_pos, pm_ord, freqs,
                 cat_w) -> _build.KernelCall:
    """Check the inputs and allocate the output and scratch of one launch
    of the deep kernel."""
    n_int = lr_ids.shape[0]
    n_tips, s, p = tips.shape
    c = pm_ord.shape[2]
    dt = pm_ord.dtype
    check_kernel_inputs(tips, pm_ord.reshape(-1, c, s, s), freqs, cat_w,
                        lr_ids, lr_pos, states=(4,))
    if n_int != n_tips - 1:
        raise ValueError("the schedule must cover the N-1 internal nodes")
    lib = _build.load("peel_stream", ["peel_stream_f64", "peel_stream_f32"], 5)
    fn = lib.peel_stream_f64 if dt == torch.float64 else lib.peel_stream_f32
    chunk = _pick_chunk(c, s, pm_ord.element_size())
    wcs = (cat_w[:, None] * freqs[None, :]).contiguous()
    ids32 = lr_ids.to(torch.int32).contiguous()
    pos32 = lr_pos.to(torch.int32).contiguous()
    pm_ord = pm_ord.contiguous()
    scratch = torch.empty((n_int, c, s, p), dtype=dt, device=tips.device)
    out = torch.empty(p, dtype=dt, device=tips.device)
    return _build.KernelCall(
        "peel_stream", fn,
        (tips, pm_ord, ids32, pos32, wcs, scratch, out),
        (n_int, c, s, p, chunk), out)


def _peel_deep_kernel(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w):
    global launches
    out = prepare_deep(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w).launch()
    launches += 1
    return out


def peel_site_loglik_deep(tip_partials, children, order, root, p_matrices,
                          freqs, category_weights,
                          schedule=None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the deep kernel; a CPU tensor
    takes the plain version. `root` is kept for interface parity.
    `schedule` is stream_schedule(children, order) where the caller already
    has it (several partitions on one tree)."""
    lr_ids, lr_pos = schedule or stream_schedule(children, order)
    pm_ord = p_matrices[lr_ids]
    if not tip_partials.is_cuda:
        wcs = category_weights[:, None] * freqs[None, :]
        return _deep_plain(tip_partials, lr_ids, lr_pos, pm_ord, wcs)
    return _peel_deep_kernel(tip_partials.contiguous(), lr_ids, lr_pos,
                             pm_ord, freqs, category_weights)


def peel_loglikelihood_deep(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights, pattern_weights,
                            schedule=None) -> torch.Tensor:
    """Pattern-weighted total through the deep kernel, in float64."""
    site = peel_site_loglik_deep(tip_partials, children, order, root,
                                 p_matrices, freqs, category_weights,
                                 schedule)
    return stable_dot(pattern_weights, site)

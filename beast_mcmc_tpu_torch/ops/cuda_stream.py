"""The streaming CUDA peel, for trees whose branch matrices overflow shared
memory.

Counterpart of beast_mcmc_tpu/ops/pallas_stream2.py. The kernel
(csrc/peel_stream.cu) replaces pallas_stream2.py::_deep_kernel: branch
matrices gathered in peel order stream through shared memory in chunks
(cp.async, double buffered), and partials are indexed by peel position;
see the source for what bounds it and what the design does about that.

The wrapper does the gather of pallas_stream2.py:270-289 on the device:
`lr_ids` [n_int, 2] are each step's children, `lr_pos` their peel positions
(-1 for a tip), `pm_ord` [n_int, 2, C, S, S] their branch matrices. The
plain version `_stream_plain` peels from the same three arrays, so a CPU
tensor checks the gather as well as the arithmetic.
"""

from __future__ import annotations

import torch

from beast_mcmc_tpu_torch.ops import _build
from beast_mcmc_tpu_torch.ops.cuda_peeling import check_kernel_inputs

CHUNK_BYTES = 32 * 1024  # one of the two shared-memory chunk slots

launches = 0  # kernel launches since the caller last set this to 0


def _pick_chunk(c: int, s: int, itemsize: int) -> int:
    """Nodes per streamed chunk: one slot holds CHUNK_BYTES of matrices."""
    return max(1, min(64, CHUNK_BYTES // (2 * c * s * s * itemsize)))


def stream_schedule(children, order, p_matrices):
    """(lr_ids, lr_pos, pm_ord): the peel-order gather of the children,
    their positions in the order (-1 for tips) and their branch matrices."""
    m = children.shape[0]
    n_int = order.shape[0]
    order = order.long()
    pos_of = torch.full((m,), -1, dtype=torch.long, device=children.device)
    pos_of = pos_of.index_put(
        (order,), torch.arange(n_int, device=children.device))
    lr_ids = children.long()[order]
    lr_pos = pos_of[lr_ids]
    pm_ord = p_matrices[lr_ids]
    return lr_ids, lr_pos, pm_ord


def _stream_plain(tip_partials, lr_ids, lr_pos, pm_ord, wcs):
    """Plain PyTorch version of the streaming kernel: the same peel, read
    from the peel-ordered schedule."""
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
    return torch.log(torch.einsum("cs,csp->p", wcs, post[n_int - 1])) + acc


def prepare_stream(tips, lr_ids, lr_pos, pm_ord, freqs,
                   cat_w) -> _build.KernelCall:
    """Check the inputs and allocate the output and scratch of one launch
    of the streaming kernel."""
    n_int = lr_ids.shape[0]
    n_tips, s, p = tips.shape
    c = pm_ord.shape[2]
    dt = pm_ord.dtype
    check_kernel_inputs(tips, pm_ord.reshape(-1, c, s, s), freqs, cat_w,
                        lr_ids, lr_pos)
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


def _peel_stream_kernel(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w):
    global launches
    out = prepare_stream(tips, lr_ids, lr_pos, pm_ord, freqs, cat_w).launch()
    launches += 1
    return out


def peel_site_loglik_stream(tip_partials, children, order, root, p_matrices,
                            freqs, category_weights) -> torch.Tensor:
    """Per-pattern log-likelihood [P] through the streaming kernel; a CPU
    tensor takes the plain version. `root` is kept for interface parity."""
    lr_ids, lr_pos, pm_ord = stream_schedule(children, order, p_matrices)
    if not tip_partials.is_cuda:
        wcs = category_weights[:, None] * freqs[None, :]
        return _stream_plain(tip_partials, lr_ids, lr_pos, pm_ord, wcs)
    return _peel_stream_kernel(tip_partials.contiguous(), lr_ids, lr_pos,
                               pm_ord, freqs, category_weights)

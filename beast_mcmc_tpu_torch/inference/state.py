"""The MCMC state.

Counterpart of beast_mcmc_tpu/inference/state.py. A proposal builds new
params and tree tensors and rejection keeps the old ones, so params and
tree are never written in place. The per-operator statistics are device
tensors that the step updates in place. Randomness comes from two explicit
generators in place of a JAX key: `generator` on the state's device for
proposals and acceptance, `op_generator` on the CPU for the operator draw,
so that choosing an operator never waits on the device.

A chain batch is one MCMCState whose tensors carry a leading chain axis B:
params [B, ...], the tree's fields [B, M], [B, M, 2] and [B],
log_posterior [B] and the operator statistics [B, n_ops], with the one
pair of generators (inference/mc3.py::replicate_state builds it;
inference/mcmc.py::make_multichain_step steps it). `step` counts the
batch's steps. init_state and init_mcmc_state build one chain.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from beast_mcmc_tpu_torch.tree.topology import TreeState
from beast_mcmc_tpu_torch.utils.accum import accum_dtype

# offsets the CPU operator-draw seed from the device generator's seed, so
# that on a CPU run the two streams are not the same stream
_OP_SEED_OFFSET = 0x9E3779B9


@dataclasses.dataclass
class MCMCState:
    params: Dict[str, Any]
    tree: TreeState
    log_posterior: torch.Tensor  # 0-d ([B] for a chain batch), accum_dtype
    generator: torch.Generator  # on the device: proposals, acceptance
    op_generator: torch.Generator  # on the CPU: operator draw
    step: int
    op_adapt: torch.Tensor  # [(B,) n_ops] transformed adaptable tuning values
    op_adapt_count: torch.Tensor  # int64[n_ops]
    op_accept: torch.Tensor  # int64[n_ops]
    op_reject: torch.Tensor  # int64[n_ops]
    op_sum_accept: torch.Tensor  # [n_ops] sum of acceptance probabilities

    def replace(self, **kw) -> "MCMCState":
        return dataclasses.replace(self, **kw)


def init_state(params: Dict[str, Any], tree: TreeState,
               generator: torch.Generator, n_ops: int,
               init_adapt: torch.Tensor,
               dtype: torch.dtype = torch.float64) -> MCMCState:
    dev = tree.heights.device
    op_gen = torch.Generator().manual_seed(
        (generator.initial_seed() + _OP_SEED_OFFSET) % 2**63)
    zeros_i = lambda: torch.zeros(n_ops, dtype=torch.long, device=dev)
    return MCMCState(
        params=dict(params),
        tree=tree,
        log_posterior=torch.tensor(-float("inf"), dtype=accum_dtype(),
                                   device=dev),
        generator=generator,
        op_generator=op_gen,
        step=0,
        op_adapt=init_adapt.to(dtype=dtype, device=dev),
        op_adapt_count=zeros_i(),
        op_accept=zeros_i(),
        op_reject=zeros_i(),
        op_sum_accept=torch.zeros(n_ops, dtype=dtype, device=dev),
    )

"""Multi-process runtime on torch.distributed: one rank a device, a mesh over
the ranks.

Counterpart of beast_mcmc_tpu/parallel/distributed.py. The reference's only
multi-process story is vestigial MPI scaffolding (ref:
src/dr/app/beast/BeastMPI.java:50-70 Init/Finalize/Rank;
src/dr/inference/parallel/MPIServices.java:37-110). Here every rank calls
`initialize()` (under torchrun with no arguments: the launcher's
environment); a mesh over the ranks has the axes (chains, patterns); each
rank peels its pattern shard and the weighted totals reduce with one
all_reduce (`sharded_pattern_loglik`, where JAX's shard_map body has a
psum); MC3's swap decisions are drawn alike on every rank from a CPU
generator seeded alike (`mc3_swap_across_hosts`), and chain-sharded MC3
moves the two swapped slots' states between ranks by one all_reduce of
zero-padded rows (`swap_across_chain_shards`: what XLA inserts when JAX's
swap_states runs on chain-sharded states).

Backends: `nccl` for CUDA ranks, one GPU each; `gloo` for CPU ranks, and
for CUDA ranks that share one card (gloo takes CUDA tensors for all_reduce
and broadcast, through the host; every collective here is an all_reduce).
NCCL refuses two ranks on one device, so `initialize` raises there and
names backend="gloo". Nothing switches backend or device quietly.

Differences from the JAX package, by design:
  - `local_device_count` makes that many virtual CPU devices a process in
    JAX; a rank here is one device, so it may only be None or 1;
  - a mesh holds every rank of the world (parallel/mesh.py::device_mesh);
  - the swap's draws come from a torch.Generator on the CPU (JAX splits a
    key), and `swap_permutation` is their arithmetic given them;
  - `psum` is not differentiable: no operator of a sharded chain takes a
    gradient through it.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.rendezvous import rendezvous

from beast_mcmc_tpu_torch.inference.mc3 import swap_draws
from beast_mcmc_tpu_torch.inference.mcmc import map_tensors
from beast_mcmc_tpu_torch.inference.state import MCMCState
from beast_mcmc_tpu_torch.parallel.mesh import (
    CHAINS_AXIS,
    device_mesh,
    shard_slices,
)
from beast_mcmc_tpu_torch.utils.accum import chain_dot, stable_dot

# the rank's device, set by `initialize` and cleared by `shutdown`, as
# jax.distributed keeps its process state
_rank = {"device": None}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_count: Optional[int] = None, *,
               backend: Optional[str] = None,
               device=None) -> torch.device:
    """Join the world (ref role: BeastMPI.Init, BeastMPI.java:50-70) and
    return this rank's device. With every argument None the address, world
    size and rank come from the environment that torchrun sets (env://);
    else `coordinator_address` is host:port (tcp) or a URL (tcp://,
    file://). `device` defaults to cuda:<local rank> (LOCAL_RANK, else the
    rank), `backend` to nccl on a CUDA device and gloo on the CPU."""
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: a rank is one device "
            "here; start one process a device (torchrun --nproc_per_node)")
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, and no CUDA device is "
                           "available (device='cpu' makes a CPU rank)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend='nccl' takes CUDA ranks, got {dev}")
    store, rank, world = next(rendezvous(
        url, -1 if process_id is None else process_id,
        -1 if num_processes is None else num_processes))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          rank)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: {dev} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        _check_one_rank_a_gpu(store, rank, world, (
            f"{socket.gethostname()}/"
            f"{torch.cuda.get_device_properties(dev).uuid}"))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    _rank["device"] = dev
    return dev


def _check_one_rank_a_gpu(store, rank: int, world: int, ident: str) -> None:
    """Raise on every rank, before NCCL starts, where two ranks hold one
    GPU: each rank posts `ident`, its host and device id, to the store."""
    store.set(f"beast_mcmc_device/{rank}", ident)
    seen = {}
    for r in range(world):
        other = store.get(f"beast_mcmc_device/{r}").decode()
        if other in seen:
            raise ValueError(
                f"ranks {seen[other]} and {r} share one GPU ({other}): NCCL "
                "takes one rank a GPU; pass backend='gloo' for ranks that "
                "share a card")
        seen[other] = r


def shutdown() -> None:
    """ref role: BeastMPI.Finalize."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank["device"] = None


def process_index() -> int:
    """ref role: BeastMPI.COMM_WORLD.Rank (BeastMPI.java:64-66)."""
    return dist.get_rank()


def local_device() -> torch.device:
    """This rank's device, as `initialize` set it."""
    if _rank["device"] is None:
        raise RuntimeError("parallel.distributed.initialize() has not run in "
                           "this process")
    return _rank["device"]


def global_mesh(n_chains: int = 1, axis_names=("chains", "patterns")):
    """Mesh over ALL ranks: `chains` is the slow axis, `patterns` the fast
    one. n_chains must divide the world size."""
    n = dist.get_world_size()
    if n % n_chains:
        raise ValueError(f"{n_chains} chains do not divide {n} devices")
    return device_mesh(torch.arange(n).reshape(n_chains, -1), axis_names)


def psum(mesh, x: torch.Tensor,
         axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """x summed over the ranks of the named mesh axes (all of them by
    default) by one all_reduce, in place of XLA's psum: every rank of a
    group gets the same bits. A group of one rank is reduced too, so the
    backend runs on every path. Not differentiable."""
    axes = tuple(mesh.mesh_dim_names if axes is None else axes)
    if set(axes) == set(mesh.mesh_dim_names):
        group = None  # the mesh holds the world
    elif len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        raise ValueError(f"axes {axes} of a mesh {mesh.mesh_dim_names}")
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def sharded_pattern_loglik(mesh, site_logl_fn):
    """Wrap a per-pattern site-logL function into a pattern-sharded total
    over the full mesh: total(tips [N, S, P], weights [P], *args) runs
    site_logl_fn(its tips, *args) on this rank's slice of the patterns
    (split over every mesh axis, chains first, as JAX's P(None, None,
    ("chains", "patterns"))), takes the float64 weighted sum and reduces it
    over the mesh with one all_reduce: every rank gets the same 0-d tensor,
    or [B] where site_logl_fn gives a chain batch's [B, P] (the analog of
    pattern-splitting across BEAGLE instances,
    TreeDataLikelihoodParser.java:61-67)."""
    axes = tuple(mesh.mesh_dim_names)

    def total(tips, weights, *args):
        cols = shard_slices((None, None, axes), tips.shape, mesh.shape,
                            mesh.get_coordinate(), axes)[2]
        site = site_logl_fn(tips[..., cols], *args)
        w = weights[cols]
        local = chain_dot(w, site) if site.dim() == 2 else stable_dot(w, site)
        return psum(mesh, local)

    return total


def swap_permutation(energies: torch.Tensor, temperatures: torch.Tensor,
                     i: int, j_raw: int, log_u: float) -> torch.Tensor:
    """The temperature-slot permutation of `mc3_swap_across_hosts` given its
    draws: j = j_raw, or j_raw + 1 where j_raw >= i (j_raw is drawn from n -
    1), accepted on log u < (E_j - E_i)(T_i - T_j)."""
    n = energies.shape[0]
    j = j_raw + 1 if j_raw >= i else j_raw
    logr = (energies[j] - energies[i]) * (temperatures[i] - temperatures[j])
    perm = torch.arange(n, device=energies.device)
    swapped = perm.clone()
    swapped[i], swapped[j] = j, i
    return torch.where(log_u < logr, swapped, perm)


def mc3_swap_across_hosts(generator: torch.Generator, energies: torch.Tensor,
                          temperatures: torch.Tensor) -> torch.Tensor:
    """One parallel-tempering swap decision over chain energies gathered
    across ranks (ref: MCMCMC.swapChainTemperatures, MCMCMC.java:249-282 —
    logRatio = (E_j - E_i)(T_i - T_j)); every rank computes the SAME swap
    from a CPU `generator` seeded alike: i, then j_raw, then u. Returns the
    permutation of temperature slots."""
    n = energies.shape[0]
    i = int(torch.randint(0, n, (), generator=generator))
    j_raw = int(torch.randint(0, n - 1, (), generator=generator))
    u = float(torch.rand((), generator=generator, dtype=torch.float64))
    return swap_permutation(energies, temperatures, i, j_raw,
                            math.log(u) if u > 0 else -math.inf)


def swap_across_chain_shards(mesh, states: MCMCState,
                             temperatures: torch.Tensor,
                             generator: torch.Generator):
    """inference/mc3.py::swap_states over chains sharded on the mesh's
    chains axis: (this rank's states, accepted as a 0-d device bool, the
    same on every rank). The pair i != j and u are drawn alike on every
    rank by mc3.py::swap_draws from a CPU `generator` seeded alike; this
    rank holds the k slots from c k on (c its chains coordinate). The
    energies gather by one all_reduce of a zero-padded [n] vector over the
    chains axis; where i and j lie on two ranks, the two slots' params,
    tree and log posterior cross by one all_reduce of a zero-padded [2,
    ...] float64 buffer of their rows (index and integer fields exact
    below 2^53). Operator statistics and generators stay with the slot."""
    lp = states.log_posterior
    k, n = lp.shape[0], temperatures.shape[0]
    i, j, log_u = swap_draws(n, generator)
    lo = mesh.get_local_rank(CHAINS_AXIS) * k
    energies = lp.new_zeros(n)
    energies[lo:lo + k] = lp
    energies = psum(mesh, energies, (CHAINS_AXIS,))
    logr = (temperatures[i] - temperatures[j]) * (energies[j] - energies[i])
    accept = log_u < logr
    owns_i, owns_j = lo <= i < lo + k, lo <= j < lo + k
    if not (owns_i or owns_j) and i // k == j // k:
        return states, accept  # the pair lies on one other rank
    moved = {"params": states.params, "tree": states.tree, "lp": lp}
    rows = []

    def take(x):  # slot i's row in buffer row 0, slot j's in row 1
        row = torch.zeros((2, x[0].numel()), dtype=torch.float64,
                          device=lp.device)
        if owns_i:
            row[0] = x[i - lo].reshape(-1)
        if owns_j:
            row[1] = x[j - lo].reshape(-1)
        rows.append(row)
        return x

    map_tensors(take, moved)
    buf = torch.cat(rows, 1)
    if i // k != j // k:
        buf = psum(mesh, buf, (CHAINS_AXIS,))
    at = [0]

    def put(x):  # slot i takes row 1, slot j row 0, where accepted
        width = x[0].numel()
        got = buf[:, at[0]:at[0] + width].to(x.dtype).reshape(2, *x.shape[1:])
        at[0] += width
        x = x.clone()
        for s, r in ((i, 1), (j, 0)):
            if lo <= s < lo + k:
                x[s - lo] = torch.where(accept, got[r], x[s - lo])
        return x

    moved = map_tensors(put, moved)
    return states.replace(params=moved["params"], tree=moved["tree"],
                          log_posterior=moved["lp"]), accept

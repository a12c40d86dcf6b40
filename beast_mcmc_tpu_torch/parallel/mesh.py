"""Device meshes and sharding layouts over torch.distributed.

Counterpart of beast_mcmc_tpu/parallel/mesh.py. One rank is one device,
and the ranks of the world form a 2-D logical mesh

    ("chains", "patterns")

a torch.distributed.device_mesh.DeviceMesh whose per-axis process groups
come from `mesh.get_group(axis)`:
  - "patterns": site patterns are the data-parallel axis (the role of
    BEAGLE pattern-splitting across instances, -beagle_instances, ref:
    TreeDataLikelihoodParser.java:61-67). Each rank peels its slice of the
    pattern axis with the port's kernels, and the weighted totals are
    all-reduced (parallel/distributed.py::psum), where XLA inserts the
    psum.
  - "chains": MC3's chains (MCMCMC.java:227-247), each rank holding
    n_chains / n_chain_shards temperature slots.

A sharding is JAX's NamedSharding: a mesh and a spec naming, for each
leading array axis, the mesh axis (or axes, outer first) that splits it.
The peel kernels take plain tensors, so an array is never a DTensor here:
`shard_slices` gives the part of a global array that a mesh coordinate
holds, which is what JAX's shard_map body sees, and `shard_patterns`
takes this rank's part.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

CHAINS_AXIS = "chains"
PATTERNS_AXIS = "patterns"


def mesh_shape(n_chain_shards: Optional[int], n_pattern_shards: Optional[int],
               n: int) -> Tuple[int, int]:
    """JAX make_mesh's shape over n devices: a missing count is filled from
    n (both missing: one chain shard), and the product must be n."""
    if n_chain_shards is None and n_pattern_shards is None:
        n_chain_shards, n_pattern_shards = 1, n
    elif n_chain_shards is None:
        n_chain_shards = n // n_pattern_shards
    elif n_pattern_shards is None:
        n_pattern_shards = n // n_chain_shards
    if n_chain_shards * n_pattern_shards != n:
        raise ValueError(
            f"mesh {n_chain_shards}x{n_pattern_shards} != {n} devices")
    return n_chain_shards, n_pattern_shards


def device_mesh(ranks: torch.Tensor, axis_names) -> DeviceMesh:
    """A DeviceMesh of the [A, B] rank layout `ranks`, on the device type of
    this rank (parallel/distributed.py::initialize). Every rank of the
    world must call it, and the mesh must hold each rank once."""
    from beast_mcmc_tpu_torch.parallel.distributed import local_device

    world = dist.get_world_size()
    if sorted(ranks.flatten().tolist()) != list(range(world)):
        raise ValueError(f"a mesh holds each of the world's {world} ranks "
                         f"once, got {ranks.tolist()}")
    return DeviceMesh(local_device().type, ranks,
                      mesh_dim_names=tuple(axis_names))


def make_mesh(n_chain_shards: Optional[int] = None,
              n_pattern_shards: Optional[int] = None,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """The (chains, patterns) mesh over the world's ranks; `devices` lists
    them in mesh order (default 0 .. N-1). Raises JAX's ValueError when
    the shape does not cover them."""
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    shape = mesh_shape(n_chain_shards, n_pattern_shards, len(ranks))
    return device_mesh(torch.tensor(ranks).reshape(shape),
                       (CHAINS_AXIS, PATTERNS_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


class NamedSharding(NamedTuple):
    """An array's layout on a mesh, as jax.sharding.NamedSharding with its
    PartitionSpec: spec[a] is None (axis a replicated), a mesh axis name,
    or a tuple of names, outer first; axes past the spec are
    replicated."""
    mesh: DeviceMesh
    spec: tuple


def pattern_sharding(mesh: DeviceMesh, pattern_axis: int) -> NamedSharding:
    """Shard an array's pattern dimension over the patterns mesh axis,
    replicated over chains."""
    spec = [None] * (pattern_axis + 1)
    spec[pattern_axis] = PATTERNS_AXIS
    return NamedSharding(mesh, tuple(spec))


def chain_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Shard a leading chain-batch dimension over the chains mesh axis."""
    return NamedSharding(mesh, (CHAINS_AXIS,))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_slices(spec: tuple, shape: Sequence[int], mesh_sizes: Sequence[int],
                 coordinate: Sequence[int],
                 axis_names=(CHAINS_AXIS, PATTERNS_AXIS)) -> tuple:
    """The index (one slice an array axis) of the part of an array of
    `shape` that the device at `coordinate` of a mesh of `mesh_sizes` holds
    under `spec`: an axis split over several mesh axes is split by the
    first, each part by the next (JAX's order). Raises where a mesh axis
    does not divide the length it splits, as JAX's device_put does."""
    index = []
    for a, n in enumerate(shape):
        names = spec[a] if a < len(spec) else None
        names = () if names is None else (
            (names,) if isinstance(names, str) else tuple(names))
        start, length = 0, n
        for name in names:
            d = axis_names.index(name)
            if length % mesh_sizes[d]:
                raise ValueError(f"mesh axis {name!r} of {mesh_sizes[d]} "
                                 f"does not divide axis {a} of length "
                                 f"{length} (shape {tuple(shape)})")
            length //= mesh_sizes[d]
            start += coordinate[d] * length
        index.append(slice(start, start + length))
    return tuple(index)


def shard_patterns(mesh: DeviceMesh, arr: torch.Tensor, pattern_axis: int):
    """This rank's slice of `arr`'s pattern axis (a view): the pattern count
    must be a multiple of the patterns axis (ops/peeling.py::pad_patterns
    pads it)."""
    return arr[shard_slices(pattern_sharding(mesh, pattern_axis).spec,
                            arr.shape, mesh.shape, mesh.get_coordinate(),
                            mesh.mesh_dim_names)]

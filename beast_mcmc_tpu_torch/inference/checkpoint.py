"""Checkpoint and resume.

Counterpart of beast_mcmc_tpu/inference/checkpoint.py, the role of
dr.app.checkpoint.BeastCheckpointer (BeastCheckpointer.java:55,270-470):
the reference serialises the RNG state, the state number, lnL, every
parameter, every operator's accept/reject/tuning statistics and the tree.
Here the MCMCState is all of that, so a checkpoint is one numpy .npz of its
leaves (`leaf_0`, `leaf_1`, ...) with a JSON manifest beside it, as the
JAX package writes them. The leaves are the params (sorted by name, walked
through dicts, tuples and dataclasses), the tree's fields, the log
posterior, the step, the operator statistics and the states of both
generators (the device one for proposals and acceptance, the CPU one for
the operator draw), so that a resumed chain continues bit for bit. On load
the log posterior is recomputed and compared (the reference's
checkLoadState, MCMC.java:169-171).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.state import MCMCState

FORMAT_VERSION = 1
_STATS = ("log_posterior", "op_adapt", "op_adapt_count", "op_accept",
          "op_reject", "op_sum_accept")


def _walk(prefix: str, obj, out: List[Tuple[str, torch.Tensor]]) -> None:
    if isinstance(obj, torch.Tensor):
        out.append((prefix, obj))
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _walk(f"{prefix}/{k}", obj[k], out)
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            _walk(f"{prefix}/{i}", v, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _walk(f"{prefix}/{f.name}", getattr(obj, f.name), out)
    elif obj is not None:
        raise TypeError(f"cannot checkpoint {prefix}: {type(obj)}")


def _leaves(state: MCMCState) -> List[Tuple[str, object]]:
    """(name, tensor) of every tensor leaf, then the step and the two
    generators' states."""
    out: List[Tuple[str, torch.Tensor]] = []
    _walk("params", state.params, out)
    _walk("tree", state.tree, out)
    for name in _STATS:
        out.append((name, getattr(state, name)))
    out.append(("step", torch.tensor(state.step)))
    out.append(("generator", state.generator.get_state()))
    out.append(("op_generator", state.op_generator.get_state()))
    return out


def _rebuild(prefix: str, obj, leaves: dict):
    """obj's structure with every tensor leaf replaced by leaves[name],
    cast to the template leaf's dtype and device."""
    if isinstance(obj, torch.Tensor):
        return leaves[prefix].to(dtype=obj.dtype, device=obj.device)
    if isinstance(obj, dict):
        return {k: _rebuild(f"{prefix}/{k}", obj[k], leaves) for k in obj}
    if isinstance(obj, tuple):
        return tuple(_rebuild(f"{prefix}/{i}", v, leaves)
                     for i, v in enumerate(obj))
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _rebuild(f"{prefix}/{f.name}",
                                             getattr(obj, f.name), leaves)
                            for f in dataclasses.fields(obj)})
    return obj


def save_checkpoint(path: str, state: MCMCState) -> None:
    """Write the full chain state as an .npz and a manifest."""
    named = _leaves(state)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, (_, x) in enumerate(named)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    target = path if path.endswith(".npz") else path + ".npz"
    tmp = target + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz", target)
    manifest = {
        "version": FORMAT_VERSION,
        "n_leaves": len(named),
        "step": int(state.step),
        "log_posterior": float(state.log_posterior),
        "param_names": sorted(state.params.keys()),
        "leaf_names": [name for name, _ in named],
    }
    with open(path + ".manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str, template: MCMCState,
                    log_posterior: Optional[Callable] = None,
                    tolerance: float = 0.1) -> MCMCState:
    """Restore a chain state saved by save_checkpoint.

    template: a state of the same structure (from init_mcmc_state); its
    generators take the saved generator states. With log_posterior, the
    restored state's posterior is recomputed and must lie within
    `tolerance` log units of the saved one (the reference's self-check
    threshold, MarkovChain.java:55); the saved value is kept."""
    npz_path = path if os.path.exists(path) else path + ".npz"
    data = np.load(npz_path)
    names = [name for name, _ in _leaves(template)]
    if len(names) != len(data.files):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                         f"template has {len(names)}")
    if os.path.exists(path + ".manifest.json"):
        with open(path + ".manifest.json") as f:
            saved_names = json.load(f).get("leaf_names")
        if saved_names is not None and saved_names != names:
            raise ValueError("checkpoint leaves do not match the template: "
                             f"{sorted(set(saved_names) ^ set(names))}")
    leaves = {name: torch.from_numpy(data[f"leaf_{i}"])
              for i, name in enumerate(names)}
    template.generator.set_state(leaves["generator"])
    template.op_generator.set_state(leaves["op_generator"])
    state = template.replace(
        params=_rebuild("params", template.params, leaves),
        tree=_rebuild("tree", template.tree, leaves),
        step=int(leaves["step"]),
        **{name: _rebuild(name, getattr(template, name), leaves)
           for name in _STATS})
    if log_posterior is not None:
        lp = float(log_posterior(state.params, state.tree))
        saved = float(state.log_posterior)
        if abs(lp - saved) > tolerance:
            raise ValueError(
                f"checkpoint log-posterior mismatch: recomputed {lp:.6f} "
                f"vs saved {saved:.6f} (tolerance {tolerance})")
    return state

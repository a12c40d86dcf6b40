"""SMC particle restarts and online taxon insertion.

Counterpart of beast_mcmc_tpu/inference/smc.py: the reference's SMC
runner (SMC.java:61, short chains from a folder of particle start states
in checkpoint format; the CLI's -particles, BeastMain.java:434,527-532)
and online BEAST's taxon insertion (CheckPointUpdaterApp.java,
CheckPointTreeModifier.java: new taxa placed into a checkpointed analysis
by distance, then resumed).

The particles are a chain batch: `load_particles` stacks every checkpoint
of a folder into one MCMCState with a leading particle axis, and
`run_particles` advances it with one chain-axis step
(inference/mcmc.py::make_multichain_step), so that a step evaluates the
posterior of all K particles at once (one peel_deep_chains launch at the
Makona shape) where JAX vmaps its chain over the particles. Each particle
keeps its own step count ([K], as JAX's stacked state keeps it) and its
operator statistics. The batch has one device generator and one CPU
operator-draw generator (ROADMAP C5): it takes the first particle's (the
files sorted by name), so that a batch of one continues its checkpoint's
streams; each particle's law is JAX's, the particles' joint draws are not.

Insertion is host numpy surgery on the flat tree arrays, as in JAX.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from beast_mcmc_tpu_torch.inference.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from beast_mcmc_tpu_torch.inference.mc3 import chain_state
from beast_mcmc_tpu_torch.inference.mcmc import run_chain
from beast_mcmc_tpu_torch.inference.state import MCMCState
from beast_mcmc_tpu_torch.tree.topology import TreeState, make_tree_state


def load_particles(folder: str, template: MCMCState) -> MCMCState:
    """Every checkpoint of `folder` stacked into one chain batch (a
    leading particle axis), the reference's -particles input. `template`
    is a single-chain state of the analysis (init_mcmc_state); the batch
    takes its generators, set to the first particle's saved states, and
    its `step` is the particles' step counts, an int64 [K] tensor."""
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if f.endswith(".npz"))
    if not files:
        raise ValueError(f"no particle checkpoints in {folder}")
    states, gen_state = [], None
    for f in files:
        states.append(load_checkpoint(f, template))
        if gen_state is None:
            gen_state = (template.generator.get_state(),
                         template.op_generator.get_state())
    template.generator.set_state(gen_state[0])
    template.op_generator.set_state(gen_state[1])

    def stack(*xs):
        return torch.stack(xs)

    def stacked(name):
        return stack(*(getattr(s, name) for s in states))

    first = states[0]
    return first.replace(
        params={k: stack(*(s.params[k] for s in states))
                for k in first.params},
        tree=TreeState(*(stack(*(getattr(s.tree, f) for s in states))
                         for f in ("parent", "children", "heights",
                                   "root"))),
        log_posterior=stacked("log_posterior"),
        step=torch.tensor([s.step for s in states], dtype=torch.long),
        op_adapt=stacked("op_adapt"),
        op_adapt_count=stacked("op_adapt_count"),
        op_accept=stacked("op_accept"), op_reject=stacked("op_reject"),
        op_sum_accept=stacked("op_sum_accept"))


def particle(particles: MCMCState, i: int) -> MCMCState:
    """Particle i of a batch as a single-chain state (its own step)."""
    return chain_state(particles, i).replace(step=int(particles.step[i]))


def run_particles(step_fn, particles: MCMCState, n_steps: int,
                  out_folder: Optional[str] = None) -> MCMCState:
    """Advance every particle n_steps with the chain-axis step `step_fn`
    (make_multichain_step over the analysis's chain-axis posterior), in
    place of SMC.java's thread a particle; with `out_folder`, write each
    as <out_folder>/particleNNNN."""
    out, _ = run_chain(step_fn, particles, n_steps)
    if out_folder:
        os.makedirs(out_folder, exist_ok=True)
        for i in range(out.log_posterior.shape[0]):
            save_checkpoint(os.path.join(out_folder, f"particle{i:04d}"),
                            particle(out, i))
    return out


# ---------------------------------------------------------------------------
# online taxon insertion (CheckPointTreeModifier's role)
# ---------------------------------------------------------------------------


def insert_taxon(tree: TreeState, attach_node: int, new_tip_height: float,
                 attach_height: float) -> TreeState:
    """Graft one new tip onto the branch above `attach_node`, with a new
    internal node at `attach_height` (inside that branch, above the new
    tip). The new tip becomes node N (after the old tips), so the old
    tips keep their indices and the internal nodes shift by one
    (CheckPointTreeModifier.incorporateAdditionalTaxa's surgery; the
    placement comes from distance_based_attachment). The result is on the
    tree's device."""
    parent = tree.parent.cpu().numpy()
    children = tree.children.cpu().numpy()
    heights = tree.heights.cpu().numpy()
    m = parent.shape[0]
    n = (m + 1) // 2
    root = int(tree.root)

    def shift(i):
        if i < 0:
            return -1
        return i if i < n else i + 1

    m2 = m + 2
    new_tip, new_internal = n, m + 1
    parent2 = np.full(m2, -1, np.int64)
    children2 = np.full((m2, 2), -1, np.int64)
    heights2 = np.zeros(m2, heights.dtype)
    for i in range(m):
        j = shift(i)
        parent2[j] = shift(parent[i])
        heights2[j] = heights[i]
        children2[j, 0] = shift(children[i, 0])
        children2[j, 1] = shift(children[i, 1])

    a = shift(int(attach_node))
    ap = parent2[a]
    heights2[new_tip] = new_tip_height
    heights2[new_internal] = attach_height
    if not attach_height > max(new_tip_height, heights2[a]):
        raise ValueError("attach_height must exceed the tip and node")
    if ap >= 0 and not attach_height < heights2[ap]:
        raise ValueError("attach_height must be below the parent")
    # the new internal node takes a's place under ap
    parent2[new_internal] = ap
    children2[new_internal] = (a, new_tip)
    parent2[a] = new_internal
    parent2[new_tip] = new_internal
    new_root = shift(root)
    if ap >= 0:
        row = children2[ap]
        children2[ap] = np.where(row == a, new_internal, row)
    else:
        new_root = new_internal
    return make_tree_state(parent2, children2, heights2, new_root,
                           tree.heights.dtype, tree.heights.device)


def distance_based_attachment(tree: TreeState, tip_distances: np.ndarray,
                              new_tip_height: float) -> tuple:
    """The attachment CheckPointUpdater picks: the nearest existing tip
    (by the given genetic distances [N]), halfway up its pendant branch,
    walking up while the branch has no room. Returns (attach_node,
    attach_height)."""
    parent = tree.parent.cpu().numpy()
    heights = tree.heights.cpu().numpy()
    best = int(np.argmin(tip_distances))
    lo = max(float(heights[best]), float(new_tip_height))
    hi = float(heights[parent[best]])
    if hi <= lo:
        node = best
        while hi <= lo and parent[node] >= 0:
            node = int(parent[node])
            if parent[node] < 0:
                break
            lo = max(float(heights[node]), float(new_tip_height))
            hi = float(heights[parent[node]])
        best = node
    return best, float(lo + 0.5 * (hi - lo))

"""Carry parameters and trees from the JAX package into this one.

The JAX side hands over plain numpy: `params` is a dict whose values are
arrays or scalars, a tuple of them (the "site.rates" (rates, weights)
cache), or an object with `values`, `U` and `U_inv` attributes (the "eig"
EigenSystem cache, its leaves turned to numpy); the tree is numpy
parent / children / heights / root. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from beast_mcmc_tpu_torch.ops.eigen import EigenSystem
from beast_mcmc_tpu_torch.tree.topology import TreeState, make_tree_state
from beast_mcmc_tpu_torch.utils.dtypes import DEFAULT_DEVICE, DEFAULT_FLOAT


def _value(v, dtype, device):
    if all(hasattr(v, a) for a in ("values", "U", "U_inv")):
        return EigenSystem(*(_value(getattr(v, a), dtype, device)
                             for a in ("values", "U", "U_inv")))
    if isinstance(v, tuple):
        return tuple(_value(x, dtype, device) for x in v)
    a = np.asarray(v)
    return torch.tensor(a, device=device,
                        dtype=None if np.issubdtype(a.dtype, np.integer)
                        else dtype)


def params_from_numpy(params: Dict[str, Any], dtype=DEFAULT_FLOAT,
                      device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The JAX package's params dict (numpy leaves) as this package's."""
    return {k: _value(v, dtype, device) for k, v in params.items()}


def tree_from_numpy(parent, children, heights, root, dtype=DEFAULT_FLOAT,
                    device=DEFAULT_DEVICE) -> TreeState:
    return make_tree_state(parent, children, heights, root, dtype, device)

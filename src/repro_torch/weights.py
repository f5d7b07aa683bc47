"""Carry the JAX package's parameters across into the port.

``params_from_jax`` takes the reference's parameter pytree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a state dict
for :class:`repro_torch.models.DecoderLM`.  Superblock params, stacked on a
leading repeat dim under ``blocks/pos<j>``, are unstacked into layer
``r * len(pattern) + j``; the unscanned remainder layers under
``tail/tail<j>`` become layer ``n_repeats * len(pattern) + j``.
Weights keep their ``(d_in, d_out)`` orientation.  bf16 arrays (numpy dtype
named ``bfloat16``) cross through a ``uint16`` view, because
``torch.from_numpy`` does not take them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "to_torch"]


def to_torch(arr) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor that owns its memory."""
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: Dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = to_torch(val)


def params_from_jax(np_tree: Dict) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    _flatten({k: v for k, v in np_tree.items() if k not in ("blocks", "tail")},
             "", state)
    blocks = np_tree.get("blocks", {})
    k = len(blocks)
    n_repeats = 0
    for j in range(k):
        layer_leaves: Dict[str, torch.Tensor] = {}
        _flatten(blocks[f"pos{j}"], "", layer_leaves)
        for name, stacked in layer_leaves.items():
            n_repeats = stacked.shape[0]
            for r in range(n_repeats):
                state[f"blocks.{r * k + j}.{name}"] = stacked[r].clone()
    for j in range(len(np_tree.get("tail", {}))):
        _flatten(np_tree["tail"][f"tail{j}"], f"blocks.{n_repeats * k + j}.", state)
    return state

"""Carry parameter trees between the JAX package's layout and the port's.

``params_from_jax`` takes the reference's parameter pytree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a state dict
for :class:`repro_torch.models.DecoderLM`.  Superblock params, stacked on a
leading repeat dim under ``blocks/pos<j>``, are unstacked into layer
``r * len(pattern) + j``; the unscanned remainder layers under
``tail/tail<j>`` become layer ``n_repeats * len(pattern) + j``.  The
encoder-decoder's ``encoder`` and ``decoder`` trees, stacked on a leading
layer dim, become ``encoder.<l>.`` and ``decoder.<l>.``.  MoE expert
weights (E, D, F) are leaves like any other.  Weights keep their ``(d_in, d_out)`` orientation.  bf16 arrays (numpy dtype
named ``bfloat16``) cross through a ``uint16`` view, because
``torch.from_numpy`` does not take them.

``params_to_jax`` is the inverse, for any state-dict-shaped tree (params,
grads, the optimizer's m and v): it restacks layers on the leading repeat
dim.  Its bf16 leaves come back as their raw bits (``uint16``), since numpy
has no bf16 of its own; view them as bf16 on the JAX side
(``arr.view(jnp.bfloat16)``).  ``jax_layout`` is the name map both
directions and the checkpoints use.

``opt_state_to_jax`` and ``opt_state_from_jax`` carry an optimizer state the
same way: AdamW's ``m``/``v`` are state dicts; Adafactor's and 8-bit AdamW's
are already kept per reference leaf, keyed by its path (``{"v": {path:
{"vr", "vc"} or {"v"}}}``, ``{"m": {path: {"q", "scale"}}, ...}``), and
only nest or flatten.  ``reference_leaves`` walks a port tree in the
reference's layout; the checkpoints write their records from it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple, Union

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "jax_layout", "to_torch",
           "to_numpy", "reference_leaves", "opt_state_to_jax",
           "opt_state_from_jax"]


def to_torch(arr) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor that owns its memory."""
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as its raw bits (``uint16``)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _flatten(tree: Dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = to_torch(val)


# The encoder-decoder's layer stacks: one layer a step of the leading dim.
_STACKS = ("encoder", "decoder")


def params_from_jax(np_tree: Dict) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    _flatten({k: v for k, v in np_tree.items()
              if k not in ("blocks", "tail") + _STACKS}, "", state)
    for stack in _STACKS:
        leaves: Dict[str, torch.Tensor] = {}
        _flatten(np_tree.get(stack, {}), "", leaves)
        for name, stacked in leaves.items():
            for layer in range(stacked.shape[0]):
                state[f"{stack}.{layer}.{name}"] = stacked[layer].clone()
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


def jax_layout(names, period: int) -> Dict[str, Union[str, List[str]]]:
    """Where each leaf of a port state dict lives in the reference's tree.

    Maps each leaf path of the reference (``"embed"``,
    ``"blocks/pos0/ssm/in_proj"``, ``"tail/tail1/norm1/scale"``,
    ``"decoder/cross_attn/wq/w"``) to the state-dict name it holds or, for a
    leaf stacked on the repeat (or encoder/decoder layer) dim, the names of
    its layers in order.  ``period`` is the superblock's length,
    ``len(cfg.pattern)``; the layer counts are read off the names.
    """
    names = list(names)
    depth: Dict[str, int] = {}
    for n in names:
        head = n.split(".")[0]
        if head in ("blocks",) + _STACKS:
            depth[head] = max(depth.get(head, 0), int(n.split(".")[1]) + 1)
    n_repeats = depth.get("blocks", 0) // period
    out: Dict[str, Union[str, List[str]]] = {}
    for name in names:
        head = name.split(".")[0]
        if head not in depth:
            out[name.replace(".", "/")] = name
            continue
        _, layer, rest = name.split(".", 2)
        layer, rest = int(layer), rest.replace(".", "/")
        if head in _STACKS:
            out.setdefault(f"{head}/{rest}", [None] * depth[head])[layer] = name
        elif layer < n_repeats * period:
            stacked = out.setdefault(f"blocks/pos{layer % period}/{rest}",
                                     [None] * n_repeats)
            stacked[layer // period] = name
        else:
            out[f"tail/tail{layer - n_repeats * period}/{rest}"] = name
    return out


def reference_leaves(tree: Mapping, period: int, prefix: str = ""
                     ) -> Iterator[Tuple[str, Union[str, List[str]], Mapping]]:
    """(reference path, state-dict name or stacked names, the dict holding
    them) for every leaf of a port tree, in the reference's layout.  A dict
    whose values are all tensors is a state dict (``jax_layout`` places its
    layers); other dicts nest, as pytrees do."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        for path, names in jax_layout(tree, period).items():
            yield prefix + path, names, tree
        return
    for key, sub in tree.items():
        if isinstance(sub, torch.Tensor):
            yield prefix + key, key, tree
        else:
            yield from reference_leaves(sub, period, f"{prefix}{key}/")


def _nest(flat: Mapping[str, Any]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        *parents, key = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[key] = leaf
    return tree


def _tree_to_jax(tree: Mapping, period: int) -> Dict:
    flat = {}
    for path, names, src in reference_leaves(tree, period):
        flat[path] = (np.stack([to_numpy(src[n]) for n in names])
                      if isinstance(names, list) else to_numpy(src[names]))
    return _nest(flat)


def params_to_jax(state: Mapping[str, torch.Tensor], period: int) -> Dict:
    """A port state dict as the reference's nested tree of numpy arrays
    (see ``jax_layout``; bf16 as raw ``uint16`` bits)."""
    return _tree_to_jax(state, period)


def opt_state_to_jax(state: Mapping[str, Any], period: int) -> Dict:
    """A port optimizer state (AdamW, Adafactor or 8-bit AdamW) as the
    reference's nested tree of numpy arrays."""
    return _tree_to_jax(state, period)


def _flat_paths(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat_paths(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


def opt_state_from_jax(np_state: Mapping[str, Any],
                       params: Mapping[str, torch.Tensor], period: int
                       ) -> Dict[str, Any]:
    """The reference's optimizer state (nested dicts of numpy arrays) as the
    port's, on the CPU.  ``params`` (the port's state dict, any device) and
    ``period`` give the layout: a subtree whose leaves are the reference's
    param paths is a moment (AdamW's ``m``/``v``) and is unstacked into a
    state dict; one whose leaves sit one level below a param path is kept
    per reference leaf."""
    paths = set(jax_layout(params, period))
    out: Dict[str, Any] = {}
    for key, sub in np_state.items():
        if not isinstance(sub, dict):
            out[key] = to_torch(sub)
            continue
        flat = _flat_paths(sub)
        if set(flat) <= paths:
            out[key] = params_from_jax(sub)
            continue
        per_leaf: Dict[str, Dict[str, torch.Tensor]] = {}
        for path, arr in flat.items():
            leaf, field = path.rsplit("/", 1)
            if leaf not in paths:
                raise KeyError(f"optimizer state {key}/{path}: {leaf!r} is no "
                               "parameter of this model")
            per_leaf.setdefault(leaf, {})[field] = to_torch(arr)
        out[key] = per_leaf
    return out

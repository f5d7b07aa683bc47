"""Checkpointing THROUGH the dataset platform, port of
``repro.train.checkpoint``.

A checkpoint is a *dataset version*: each param/opt-state leaf is a record
(raw bytes + shape/dtype attrs) checked into the dataset manager, so it gets
the platform's versioning (step tags), access control, lineage (checkpoint
PRODUCED_BY train run, DERIVED_FROM the data snapshot it consumed) and
revocation impact.

The records are the reference's, name for name: ``params/<path>``,
``opt/<path>`` and ``extra.json``, with the attrs ``shape``, ``dtype`` and
``shard``, the tags ``step-N`` and ``latest``, and the same lineage.  Leaves
are written in the reference's stacked layout (superblock layers on a
leading repeat dim under ``blocks/pos<j>``, remainder layers under
``tail/tail<j>``; see :func:`repro_torch.weights.jax_layout`), so a
checkpoint written by either package loads in the other.  bf16 crosses as
raw bits under its dtype name ``bfloat16``.  ``period`` is the model's
superblock length, ``len(cfg.pattern)``.

Trees here are the port's: a state dict (name -> tensor) for the params, and
``{"m": state dict, "v": state dict, "step": tensor}`` for AdamW's state.
Each leaf is read or written one record at a time, so a full-width
checkpoint never sits on the host twice.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..core import DatasetManager, Record
from ..core.dataset import version_node_id
from ..core.lineage import EdgeKind, NodeKind
from ..weights import jax_layout, to_numpy

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "checkpoint_node_id"]

Tree = Dict[str, Any]
_READ_WORKERS = 8


def _leaves(tree: Tree, period: int, prefix: str
            ) -> Iterator[Tuple[str, Union[str, List[str]], Mapping]]:
    """(record name, state-dict name or stacked names, the dict holding
    them) for every leaf, in the reference's layout.  A dict whose values
    are all tensors is a state dict; other dicts nest, as pytrees do."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        for path, names in jax_layout(tree, period).items():
            yield prefix + path, names, tree
        return
    for key, sub in tree.items():
        if isinstance(sub, torch.Tensor):
            yield prefix + key, key, tree
        else:
            yield from _leaves(sub, period, f"{prefix}{key}/")


def _stacked(src: Mapping[str, torch.Tensor], names: List[str]) -> np.ndarray:
    arr = None
    for r, n in enumerate(names):
        layer = to_numpy(src[n])
        if arr is None:
            arr = np.empty((len(names),) + layer.shape, dtype=layer.dtype)
        arr[r] = layer
    return arr


def _leaf_records(tree: Tree, period: int, prefix: str) -> List[Record]:
    records = []
    for name, names, src in _leaves(tree, period, prefix):
        stacked = isinstance(names, list)
        arr = _stacked(src, names) if stacked else to_numpy(src[names])
        dtype = src[names[0] if stacked else names].dtype
        records.append(Record(name, arr.tobytes(), {
            "shape": list(arr.shape), "dtype": str(dtype).removeprefix("torch."),
            "shard": "full",  # multi-host: "host{i}:{index bounds}"
        }))
        del arr
    return records


def checkpoint_node_id(dataset: str, step: int) -> str:
    return f"checkpoint:{dataset}@step{step}"


def save_checkpoint(
    dm: DatasetManager,
    dataset: str,
    step: int,
    params: Mapping[str, torch.Tensor],
    opt_state: Optional[Tree] = None,
    extra: Optional[Dict[str, Any]] = None,
    actor: str = "trainer",
    data_snapshot_id: Optional[str] = None,
    run_node: Optional[str] = None,
    *,
    period: int,
) -> str:
    """Returns the commit id of the checkpoint version."""
    records = _leaf_records(dict(params), period, "params/")
    if opt_state is not None:
        records += _leaf_records(opt_state, period, "opt/")
    meta = {"step": step, "kind": "checkpoint"}
    if extra is not None:
        records.append(Record("extra.json", json.dumps(extra).encode(),
                              {"kind": "extra"}))
    commit = dm.check_in(
        dataset, records, actor=actor, message=f"checkpoint step {step}",
        version_tags=[f"step-{step}", "latest"], meta=meta,
        derived_from=[data_snapshot_id] if data_snapshot_id else [],
        produced_by=run_node,
    )
    del records
    node = checkpoint_node_id(dataset, step)
    dm.lineage.add_node(node, NodeKind.CHECKPOINT, dataset=dataset,
                        step=step, commit=commit.commit_id)
    dm.lineage.add_edge(node, version_node_id(dataset, commit.commit_id),
                        EdgeKind.DERIVED_FROM)
    if data_snapshot_id:
        dm.lineage.add_edge(node, data_snapshot_id, EdgeKind.DERIVED_FROM)
    dm.lineage.flush()
    return commit.commit_id


def _read_leaf(snap, name: str) -> Tuple[np.ndarray, str]:
    attrs = snap.attrs(name)
    dtype = attrs["dtype"]
    arr = np.frombuffer(snap.read(name),
                        dtype=np.uint16 if dtype == "bfloat16" else np.dtype(dtype))
    return arr.reshape(attrs["shape"]), dtype


def _place(arr: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    """``arr`` (bf16 as raw bits) as a tensor of ``like``'s dtype and device."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


def _read_tree(read, like: Tree, period: int, prefix: str) -> Tree:
    """``like``'s tree, each leaf from ``read(record name)`` -> (array,
    dtype name)."""
    if all(isinstance(v, torch.Tensor) for v in like.values()):
        out: Tree = {}
        for path, names in jax_layout(like, period).items():
            arr, dtype = read(prefix + path)
            if isinstance(names, list):
                for r, n in enumerate(names):
                    out[n] = _place(arr[r], dtype, like[n])
            else:
                out[names] = _place(arr, dtype, like[names])
            del arr
        return out
    return {k: (_place(*read(prefix + k), v) if isinstance(v, torch.Tensor)
                else _read_tree(read, v, period, f"{prefix}{k}/"))
            for k, v in like.items()}


def load_checkpoint(
    dm: DatasetManager,
    dataset: str,
    like_params: Mapping[str, torch.Tensor],
    like_opt: Optional[Tree] = None,
    rev: str = "latest",
    actor: str = "trainer",
    *,
    period: int,
) -> Tuple[Dict[str, torch.Tensor], Optional[Tree], Dict[str, Any]]:
    """Restore (params, opt_state, extra).  ``like_*`` give the trees' names,
    dtypes and devices (the model's parameters and ``opt.init`` of them, for
    instance); the restored tensors are new, on those devices.

    The store decodes and verifies a record's chunks in the reading thread
    (zlib and sha256 release the GIL), so ``_READ_WORKERS`` threads read the
    records while this one places them, in order."""
    snap = dm.checkout(dataset, actor, rev=rev, register_snapshot=False)
    trees = [("params/", dict(like_params))]
    if like_opt is not None:
        trees.append(("opt/", like_opt))
    names = [name for prefix, like in trees
             for name, _, _ in _leaves(like, period, prefix)]
    with ThreadPoolExecutor(max_workers=_READ_WORKERS,
                            thread_name_prefix="checkpoint-read") as pool:
        pending = {name: pool.submit(_read_leaf, snap, name) for name in names}

        def read(name: str):
            return pending.pop(name).result()

        restored = [_read_tree(read, like, period, prefix) for prefix, like in trees]
    params = restored[0]
    opt_state = restored[1] if like_opt is not None else None
    extra: Dict[str, Any] = {}
    if any(rid == "extra.json" for rid in snap.iter_record_ids()):
        extra = json.loads(snap.read("extra.json").decode())
    return params, opt_state, extra


def latest_step(dm: DatasetManager, dataset: str) -> Optional[int]:
    tags = dm.versions.list_tags(dataset)
    steps = [int(t[5:]) for t in tags if t.startswith("step-")]
    return max(steps) if steps else None

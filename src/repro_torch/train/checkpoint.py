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
for the optimizer ``{"m": state dict, "v": state dict, "step": tensor}``
(AdamW), ``{"v": {path: {"vr", "vc"} or {"v"}}, "step"}`` (Adafactor) or
``{"m": {path: {"q", "scale"}}, "v": ..., "step"}`` (8-bit AdamW), the last
two kept per reference leaf already, so their records are the reference's
(``opt/v/<path>/vr``, ``opt/m/<path>/q``, ...).  Each leaf is read or
written one record at a time, so a full-width checkpoint never sits on the
host twice.

Restore is elastic: ``param_shardings``, a dict of
:class:`~repro_torch.train.sharding.Sharding` by param name, lays each
restored param onto its DeviceMesh with ``distribute_tensor``, so a
checkpoint written on one topology restores onto another.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core import DatasetManager, Record
from ..core.dataset import version_node_id
from ..core.lineage import EdgeKind, NodeKind
from ..weights import jax_layout, reference_leaves, to_numpy

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "checkpoint_node_id"]

Tree = Dict[str, Any]
_READ_WORKERS = 8


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
    for name, names, src in reference_leaves(tree, period, prefix):
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


def _read_tree(read, like: Tree, period: int, prefix: str,
               shardings: Optional[Mapping] = None) -> Tree:
    """``like``'s tree, each leaf from ``read(record name)`` -> (array,
    dtype name); a state dict's leaves laid onto the mesh of their entry in
    ``shardings``, where it has one."""
    shardings = shardings or {}

    def place(arr, dtype, like_leaf, sharding=None):
        t = _place(arr, dtype, like_leaf)
        if sharding is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t.to(sharding.mesh.device_type), sharding.mesh,
                                 sharding.placements)

    if all(isinstance(v, torch.Tensor) for v in like.values()):
        out: Tree = {}
        for path, names in jax_layout(like, period).items():
            arr, dtype = read(prefix + path)
            if isinstance(names, list):
                for r, n in enumerate(names):
                    out[n] = place(arr[r], dtype, like[n], shardings.get(n))
            else:
                out[names] = place(arr, dtype, like[names], shardings.get(names))
            del arr
        return out
    return {k: (place(*read(prefix + k), v) if isinstance(v, torch.Tensor)
                else _read_tree(read, v, period, f"{prefix}{k}/"))
            for k, v in like.items()}


def load_checkpoint(
    dm: DatasetManager,
    dataset: str,
    like_params: Mapping[str, torch.Tensor],
    like_opt: Optional[Tree] = None,
    rev: str = "latest",
    param_shardings: Optional[Mapping] = None,
    actor: str = "trainer",
    *,
    period: int,
) -> Tuple[Dict[str, torch.Tensor], Optional[Tree], Dict[str, Any]]:
    """Restore (params, opt_state, extra).  ``like_*`` give the trees' names,
    dtypes and devices (the model's parameters and ``opt.init`` of them, for
    instance); the restored tensors are new, on those devices, or DTensors
    on the mesh of their sharding in ``param_shardings``.

    The store decodes and verifies a record's chunks in the reading thread
    (zlib and sha256 release the GIL), so ``_READ_WORKERS`` threads read the
    records while this one places them, in order."""
    snap = dm.checkout(dataset, actor, rev=rev, register_snapshot=False)
    trees = [("params/", dict(like_params), param_shardings)]
    if like_opt is not None:
        trees.append(("opt/", like_opt, None))
    names = [name for prefix, like, _ in trees
             for name, _, _ in reference_leaves(like, period, prefix)]
    with ThreadPoolExecutor(max_workers=_READ_WORKERS,
                            thread_name_prefix="checkpoint-read") as pool:
        pending = {name: pool.submit(_read_leaf, snap, name) for name in names}

        def read(name: str):
            return pending.pop(name).result()

        restored = [_read_tree(read, like, period, prefix, sh)
                    for prefix, like, sh in trees]
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

"""Layout presets: the reference's measured layouts as selectable configs;
port of ``repro.launch.presets``.

``resolve_layout(cfg, shape, mesh, layout)`` returns (ShardingRules,
rt_overrides, tc_overrides).  ``layout="auto"`` picks per workload family:

- prefill / long-context   -> context-parallel attention (seq over tp)
- dense train              -> ZeRO-3 (fsdp over both axes), dots remat
- MoE train                -> shard_map expert parallelism + ZeRO-3 dense
- decode / small models    -> baseline TP x FSDP

The rules are the reference's, verbatim; ``mesh`` is a DeviceMesh or a
mesh-like object with ``axis_names`` and a name -> size ``shape``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..train.sharding import ShardingRules, mesh_shape

__all__ = ["LAYOUTS", "resolve_layout"]

LAYOUTS = ("baseline", "seqpar", "zero3", "moe_ep", "auto")


def resolve_layout(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   layout: str = "auto"
                   ) -> Tuple[ShardingRules, Dict[str, Any], Dict[str, Any]]:
    if layout == "auto":
        if cfg.n_experts and shape.kind == "train":
            layout = "moe_ep"
        elif shape.kind == "train" and cfg.n_params() > 5e9:
            layout = "zero3"
        elif shape.kind == "prefill":
            layout = "seqpar"
        else:
            layout = "baseline"

    if layout == "baseline":
        return ShardingRules(mesh), {}, {}
    if layout == "seqpar":
        return (ShardingRules(mesh, attn_shard_mode="seq"),
                {"constrain_attn_heads": True}, {})
    n_dev = math.prod(mesh_shape(mesh).values())
    # ZeRO-3 wants one batch row per device; when global_batch < devices
    # (the multi-pod mesh), shard the SEQUENCE over the model axis instead
    # (ZeRO-3 + sequence parallelism, DeepSpeed-Ulysses style).
    seq_par = shape.global_batch % n_dev != 0
    if layout == "zero3":
        rules = ShardingRules(
            mesh, tp_axis=None, fsdp_axis=("data", "model"),
            batch_axes=(("pod", "data") if seq_par
                        else ("pod", "data", "model")),
            seq_axis="model" if seq_par else None,
            attn_shard_mode="seq" if seq_par else "heads")
        rt = {"remat": "dots"}
        if seq_par:
            rt["constrain_attn_heads"] = True
        return rules, rt, {"microbatches": 1}
    if layout == "moe_ep":
        rules = ShardingRules(
            mesh, tp_axis=None, fsdp_axis=("data", "model"),
            batch_axes=(("pod", "data") if seq_par
                        else ("pod", "data", "model")),
            seq_axis="model" if seq_par else None,
            attn_shard_mode="seq" if seq_par else "heads")
        rt = {"moe_impl": "shard_map", "remat": "full"}
        if seq_par:
            rt["constrain_attn_heads"] = True
        return rules, rt, {"microbatches": 1}
    raise ValueError(f"unknown layout {layout!r}; choose from {LAYOUTS}")

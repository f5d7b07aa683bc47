"""Meta-tensor stand-ins for every model input (no memory), plus the
per-cell runtime, optimizer and microbatch policy; port of
``repro.launch.specs``.

``input_specs(cfg, shape)`` mirrors what the data pipeline emits for that
architecture family, as tensors on the ``meta`` device (the counterpart of
``jax.ShapeDtypeStruct``).  ``runtime_for`` names the reference's impls in
the port's terms: its ``"xla"`` attention and SSD are the port's
``"chunked"``, its ``"xla"`` RG-LRU the port's ``"scan"``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import RuntimeConfig
from ..train.optimizer import OptimizerConfig
from ..train.step import TrainConfig

__all__ = ["input_specs", "serve_token_specs", "runtime_for",
           "train_config_for", "pick_microbatches"]


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training-batch stand-ins: {tokens, labels, segments, positions,
    [frontend_embeds]} sized for (arch x shape)."""
    B, S = shape.global_batch, shape.seq_len
    i32, emb = torch.int32, torch.bfloat16
    if cfg.is_encoder_decoder:
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32),
                "frontend_embeds": _meta((B, S, cfg.d_model), emb)}
    batch: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        P = cfg.frontend_tokens
        batch["frontend_embeds"] = _meta((B, P, cfg.d_model), emb)
        batch["tokens"] = _meta((B, S - P), i32)
        batch["labels"] = _meta((B, S - P), i32)
    else:
        batch["tokens"] = _meta((B, S), i32)
        batch["labels"] = _meta((B, S), i32)
    batch["segments"] = _meta((B, S), i32)      # full length (prefix incl.)
    batch["positions"] = _meta((B, S), i32)
    return batch


def serve_token_specs(cfg: ModelConfig, shape: ShapeConfig):
    return _meta((shape.global_batch, 1), torch.int32), _meta((), torch.int32)


def runtime_for(cfg: ModelConfig, shape: ShapeConfig, **overrides) -> RuntimeConfig:
    big = cfg.n_params() > 5e9
    rt = RuntimeConfig(
        param_dtype=torch.bfloat16 if big else torch.float32,
        compute_dtype=torch.bfloat16,
        attn_impl="chunked",         # the reference's "xla": chunked flash
        ssd_impl="chunked",
        rglru_impl="scan",
        remat="full" if shape.kind == "train" else "none",
        scan_layers=True,
        attn_block_q=512,
        attn_block_k=1024,
        moe_group_size=512,
        max_cache_len=shape.seq_len,
    )
    return rt.with_(**overrides) if overrides else rt


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                      data_parallel: int) -> int:
    """Per-device-per-microbatch token target keeps activations in memory."""
    if shape.kind != "train":
        return 1
    b_loc = max(1, shape.global_batch // data_parallel)
    tokens_loc = b_loc * shape.seq_len
    target = 8_192 if cfg.n_params() > 2e10 else 16_384
    micro = min(max(1, tokens_loc // target), b_loc)
    while b_loc % micro:
        micro -= 1
    return micro


def train_config_for(cfg: ModelConfig, shape: ShapeConfig,
                     data_parallel: int, **opt_overrides) -> TrainConfig:
    opt = OptimizerConfig(
        name="adafactor" if cfg.n_params() > 1e11 else "adamw",
        lr=3e-4, grad_clip=1.0, **opt_overrides)
    return TrainConfig(optimizer=opt,
                       microbatches=pick_microbatches(cfg, shape, data_parallel))

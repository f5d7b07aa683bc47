"""internvl2-2b — InternViT (STUB) + InternLM2 language backbone.

[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
(padded to 92672).  The vision frontend is a stub: ``input_specs()`` provides
precomputed patch embeddings occupying the sequence prefix.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    pattern=("attn",),
    frontend="vision",
    frontend_tokens=1024,      # ViT patch embeddings occupying the prefix
    norm="rmsnorm",
    act="silu",
    source="arXiv:2404.16821; hf",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, frontend_tokens=8,
    )

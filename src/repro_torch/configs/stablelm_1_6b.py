"""stablelm-1.6b — dense transformer, kv=32 (effectively MHA).

[hf:stabilityai/stablelm-2-1_6b; unverified] 24L d_model=2048 32H (GQA kv=32)
d_ff=5632 vocab=100352.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    qkv_bias=False,
    rope_theta=10_000.0,
    pattern=("attn",),
    norm="layernorm",
    act="silu",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
    )

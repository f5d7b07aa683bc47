"""arctic-480b — 128-expert top-2 MoE with a dense residual MLP per layer.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,                 # the DENSE residual MLP width
    vocab_size=32000,
    rope_theta=10_000.0,
    pattern=("attn",),
    n_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    norm="rmsnorm",
    act="silu",
    source="hf:Snowflake/snowflake-arctic-base; hf",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512, n_experts=4, experts_per_token=2, moe_d_ff=96,
    )

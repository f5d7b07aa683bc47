"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,                    # no dense MLP; MoE only
    vocab_size=32768,
    rope_theta=1_000_000.0,
    sliding_window=4096,       # SWA bounds the KV cache -> long_500k runs
    pattern=("attn",),
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    dense_residual=False,
    norm="rmsnorm",
    act="silu",
    source="arXiv:2401.04088; hf",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab_size=512, n_experts=4, experts_per_token=2, moe_d_ff=128,
        sliding_window=32,
    )

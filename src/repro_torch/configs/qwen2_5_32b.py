"""qwen2.5-32b — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )

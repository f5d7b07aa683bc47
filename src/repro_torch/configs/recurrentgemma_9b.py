"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000.  Pattern: (rec, rec, local) repeating; 38 = 12x3 + 2.
Sub-quadratic (recurrence + bounded window) -> long_500k runs.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,              # MQA on the attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    local_window=2048,
    pattern=("rec", "rec", "local"),
    lru_width=4096,
    ssm_conv_width=4,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2402.19427; unverified",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, local_window=32, lru_width=64,
    )

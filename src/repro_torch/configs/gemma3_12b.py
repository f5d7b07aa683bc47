"""gemma3-12b — dense GQA with 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified] 48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    local_window=1024,
    pattern=("local", "local", "local", "local", "local", "global"),
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    post_norms=True,
    scale_embed=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, local_window=32,
    )

"""gemma2-9b — dense GQA, alternating local/global attention, logit softcap.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=10_000.0,
    local_window=4096,
    pattern=("local", "global"),
    attn_softcap=50.0,
    final_softcap=30.0,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    post_norms=True,
    scale_embed=True,
    source="arXiv:2408.00118; hf",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, local_window=32,
    )

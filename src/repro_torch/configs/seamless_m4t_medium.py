"""seamless-m4t-medium — encoder-decoder multimodal (audio frontend STUB).

[arXiv:2308.11596; hf] 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206.  The speech frontend is a stub: ``input_specs()`` provides
precomputed frame embeddings (B, S_enc, d_model).
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder layers
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,         # padded to 256256 for sharding
    pattern=("attn",),
    frontend="audio",
    norm="layernorm",
    act="gelu",
    source="arXiv:2308.11596; hf",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    )

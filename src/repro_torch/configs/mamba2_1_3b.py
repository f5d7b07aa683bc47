"""mamba2-1.3b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified] 48L d_model=2048 (attn-free) vocab=50280
(padded to 50432), ssm_state=128.  O(1) state -> long_500k runs.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=512, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16,
    )

"""Config system: architecture + shape definitions for the assigned pool.

Every architecture in the assignment is a :class:`ModelConfig`; every
input-shape a :class:`ShapeConfig`.  A *cell* is (arch × shape); the dry-run
and roofline sweep iterate cells.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "Cell", "round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention flavour -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None    # SWA on EVERY attn layer (mixtral)
    local_window: Optional[int] = None      # window for "local" layers
    # Layer pattern within a repeating superblock, e.g.:
    #   ("attn",)                                  uniform dense
    #   ("local",)*5 + ("global",)                 gemma3 5:1
    #   ("local", "global")                        gemma2 alternating
    #   ("rec", "rec", "local")                    recurrentgemma 1:2
    #   ("ssm",)                                   mamba2
    pattern: Tuple[str, ...] = ("attn",)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False            # arctic: dense FFN ∥ MoE
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (RG-LRU) ------------------------------------------------------
    lru_width: Optional[int] = None

    # --- encoder-decoder -------------------------------------------------------
    n_encoder_layers: int = 0
    is_encoder_decoder: bool = False

    # --- modality frontend (STUB: precomputed embeddings via input_specs) ------
    frontend: Optional[str] = None          # "audio" | "vision"
    frontend_tokens: int = 0                # patches/frames occupying the prefix

    # --- misc ---------------------------------------------------------------------
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    act: str = "silu"                       # silu (SwiGLU) | gelu (GeGLU)
    post_norms: bool = False                # gemma2/3: extra post-sublayer norms
    scale_embed: bool = False               # gemma family: x *= sqrt(D)
    tie_embeddings: bool = False
    source: str = ""                        # provenance tag from the assignment

    # --- port-only (the reference's ModelConfig has neither) ----------------------
    # RoPE on the first int(rotary_fraction * head_dim) dims of each head, the
    # rest passed through (stablelm-2: 0.25); every norm's eps (stablelm-2: 1e-5).
    # The defaults are the reference's whole-head rotation and fixed 1e-6.
    rotary_fraction: float = 1.0
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------ derived

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so it always shards over 16-way axes."""
        return round_up(self.vocab_size, 256)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True iff *no* layer attends to unbounded context (long_500k ok)."""
        if self.family == "ssm":
            return True
        kinds = set(self.pattern)
        if "global" in kinds or "attn" in kinds:
            # plain/global attention is unbounded unless SWA caps it
            return self.sliding_window is not None
        # only local/rec/ssm kinds left -> bounded windows
        return True

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Total parameter count (for 6ND model-flops accounting)."""
        V, D, F, L = self.padded_vocab, self.d_model, self.d_ff, self.n_layers
        Hq, Hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        per_layer: Dict[str, int] = {}
        attn = D * Hq * dh + 2 * D * Hkv * dh + Hq * dh * D
        mlp_dense = 3 * D * F if F else 0
        moe = self.n_experts * 3 * D * self.moe_d_ff if self.n_experts else 0
        router = D * self.n_experts if self.n_experts else 0
        ssm = 0
        if self.family == "ssm":
            Din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj -> (2*Din + 2*G*N + H), conv, out_proj, norm/dt
            ssm = D * (2 * Din + 2 * N + H) + Din * D + self.ssm_conv_width * (
                Din + 2 * N) + H
        rec = 0
        if "rec" in self.pattern:
            W = self.lru_width or D
            rec = 2 * D * W + W * D + 2 * W * self.ssm_conv_width + 4 * W

        n_rec = n_attn = n_ssm = 0
        pat = self.pattern
        for i in range(self.n_layers):
            k = pat[i % len(pat)]
            if k == "rec":
                n_rec += 1
            elif k == "ssm":
                n_ssm += 1
            else:
                n_attn += 1
        total += n_attn * attn + n_rec * rec + n_ssm * ssm
        if self.n_experts:
            total += self.n_layers * (moe + router)
            if self.dense_residual:
                total += self.n_layers * mlp_dense
        else:
            total += (n_attn + n_rec) * mlp_dense if self.family != "ssm" else 0
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder already counted; add
            # cross-attention for decoder layers.
            total += self.n_encoder_layers * (attn + mlp_dense)
            total += self.n_layers * attn  # cross-attn per decoder layer
        return int(total)

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.n_params()
        full = self.n_params()
        all_experts = self.n_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        active = self.n_layers * self.experts_per_token * 3 * self.d_model * self.moe_d_ff
        return int(full - all_experts + active)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    runnable: bool
    skip_reason: str = ""

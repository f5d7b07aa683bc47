"""GQA attention module: prefill via the flash kernel, decode via a
single-token cache read.

Port of ``repro.models.attention``: QKV bias, RoPE, sliding windows, logit
softcap, MQA..MHA, packed segments, and cross-attention: ``attn_apply(kv_x=)``
takes K/V from the encoder output, with no RoPE on either side and no causal
or segment mask (Sq and Sk may differ), and ``attn_decode(cross_kv=)``
attends precomputed encoder K/V without touching a cache.

The module's parameters are an ``nn.ModuleDict`` of ``{"w", "b"?}``
``nn.ParameterDict``s under the reference's names (``wq``, ``wk``, ``wv``,
``wo``).  ``attn_decode`` writes the new token's K/V into the cache tensors
in place (the reference returns updated copies); the cache dict it returns
holds the same tensors.  With DTensor params and activations (the sharded
step) the attention itself runs per shard: ``flash_attention`` and
:func:`_decode_attend`'s scores and softmax go through
:func:`repro_torch.kernels._local.per_shard`.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels._local import is_dtensor, per_shard, split_dim
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ops import QKV_ROLES, gqa_per_shard
from .common import (Initializer, RuntimeConfig, apply_rope, dense_apply,
                     dense_init)

__all__ = ["attn_init", "attn_apply", "attn_decode", "init_kv_cache"]

NEG_INF = -1e30


def attn_init(ini: Initializer, cfg: ModelConfig, dtype) -> nn.ModuleDict:
    D = cfg.d_model
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return nn.ModuleDict({
        "wq": dense_init(ini, D, Hq * dh, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(ini, D, Hkv * dh, dtype, bias=cfg.qkv_bias),
        "wv": dense_init(ini, D, Hkv * dh, dtype, bias=cfg.qkv_bias),
        "wo": dense_init(ini, Hq * dh, D, dtype, bias=False),
    })


def _project(p, x: torch.Tensor, n_heads: int, dh: int) -> torch.Tensor:
    B, S, _ = x.shape
    return split_dim(dense_apply(p, x), -1, n_heads).reshape(B, S, n_heads, dh)


def attn_apply(
    params,
    x: torch.Tensor,                     # (B, S, D)
    cfg: ModelConfig,
    rt: RuntimeConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    segments: Optional[torch.Tensor] = None,
    kv_x: Optional[torch.Tensor] = None,    # cross-attention source (B, Sk, D)
    use_rope: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention (training / prefill / encoder).  With
    ``kv_x``, cross-attention: K/V from ``kv_x``, no RoPE, not causal, and
    no segment mask (the reference passes q segments alone, which its
    masking ignores)."""
    B, S, _ = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = rt.heads_constraint(_project(params["wq"], x, Hq, dh))
    k = rt.heads_constraint(_project(params["wk"], src, Hkv, dh))
    v = rt.heads_constraint(_project(params["wv"], src, Hkv, dh))
    if use_rope and kv_x is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_x is not None:
        segments = None
    out = flash_attention(
        q, k, v, causal=causal and kv_x is None, window=window,
        softcap=cfg.attn_softcap, q_segments=segments, kv_segments=segments,
        impl=rt.attn_impl, block_q=rt.attn_block_q, block_k=rt.attn_block_k)
    y = out.reshape(B, S, Hq * dh) @ params["wo"]["w"].to(x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, Hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, Hkv, dh), dtype=dtype, device=device),
    }


def attn_decode(
    params,
    x_t: torch.Tensor,                   # (B, 1, D)
    cache: Dict[str, torch.Tensor],      # k/v: (B, S_max, Hkv, dh)
    pos: int,                            # current absolute position
    cfg: ModelConfig,
    rt: RuntimeConfig,
    *,
    window: Optional[int] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cross_len: Optional[int] = None,
    context_start: Optional[torch.Tensor] = None,   # (B,) first valid slot
):
    """One-token decode.  Returns (y: (B, 1, D), cache).

    Self-attention: writes k/v at slot ``pos`` (or ``pos % L`` when the
    cache is a window-sized ring buffer) then attends over the valid
    entries.  ``pos`` is always the *absolute* position (RoPE uses it).
    Cross-attention (``cross_kv``, each (B, S_kv, Hkv, dh)): attends the
    first ``cross_len`` (default all) precomputed encoder K/V, without RoPE
    and without touching ``cache``.
    """
    B = x_t.shape[0]
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _project(params["wq"], x_t, Hq, dh)             # (B, 1, Hq, dh)
    if cross_kv is not None:
        k, v = cross_kv
        S_kv = k.shape[1]
        valid = torch.arange(S_kv, device=x_t.device) < (
            S_kv if cross_len is None else cross_len)
        return _decode_attend(params, q, k, v, valid[None, :].expand(B, S_kv),
                              cfg, x_t.dtype), cache
    pos = int(pos)
    k_t = _project(params["wk"], x_t, Hkv, dh)
    v_t = _project(params["wv"], x_t, Hkv, dh)
    pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k_t = apply_rope(k_t, pos_arr, cfg.rope_theta)
    L = cache["k"].shape[1]
    ring = window is not None
    if not ring and pos >= L:
        # (the reference's update clamps to the last slot: a wrong cache)
        raise ValueError(f"position {pos} is past the KV cache's {L} slots: "
                         "raise RuntimeConfig.max_cache_len")
    slot = (pos % L) if ring else pos
    cache["k"][:, slot] = k_t[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_t[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    slots = torch.arange(L, device=x_t.device)
    if ring:
        # absolute position stored in slot s: pos - ((pos - s) mod L)
        abs_pos = pos - torch.remainder(pos - slots, L)
        valid = (abs_pos >= 0) & (pos - abs_pos < window)
    else:
        abs_pos = slots
        valid = slots <= pos
    valid = valid[None, :].expand(B, L)
    if context_start is not None:
        valid = valid & (abs_pos[None, :] >= context_start[:, None])
    return _decode_attend(params, q, k, v, valid, cfg, x_t.dtype), cache


def _decode_attend(params, q, k, v, valid, cfg: ModelConfig, dtype):
    """One query a row against k/v (B, L, Hkv, dh), keys masked by ``valid``
    (B, L); in fp32, then the output projection in ``dtype``."""
    B = q.shape[0]
    Hq, dh = cfg.n_heads, cfg.head_dim
    if is_dtensor(q) or is_dtensor(k):
        k, v = gqa_per_shard(q, k, v)
        out = per_shard(partial(_decode_core, softcap=cfg.attn_softcap),
                        (q, k, v, valid), (QKV_ROLES, QKV_ROLES, QKV_ROLES,
                                           ("batch", None)),
                        QKV_ROLES, heads=(Hq, k.shape[2]))
    else:
        out = _decode_core(q, k, v, valid, softcap=cfg.attn_softcap)
    out = out.reshape(B, 1, Hq * dh).to(dtype)
    return out @ params["wo"]["w"].to(dtype)


def _decode_core(q, k, v, valid, *, softcap):
    """(B, 1, Hq, dh) attention output of one query a row, in fp32."""
    B, _, Hq, dh = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qf = q.float() * (dh ** -0.5)
    s = _decode_scores(qf, k.float(), B, group, Hkv, dh)   # (B, Hkv, group, L)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngk,bknd->bngd", p, v.float())
    # (B, Hkv, group, dh) is already q-head order (h = n * group + g).
    return out.reshape(B, 1, Hq, dh)


def _decode_scores(qf, kf, B, group, Hkv, dh):
    # qf: (B, 1, Hq, dh) with Hq = group * Hkv (head-major grouping:
    # q head h attends kv head h // group).
    q5 = qf.reshape(B, Hkv, group, dh)                  # squeeze S=1
    return torch.einsum("bngd,bknd->bngk", q5, kf)

"""Encoder-decoder LM (the seamless-m4t backbone).

Port of ``repro.models.encdec.EncDecLM``.  Encoder: bidirectional
self-attention (with RoPE over the frame positions) over precomputed frame
embeddings: the speech frontend is a stub, as in the reference, so frames
arrive as (B, S_enc, d_model).  Decoder: causal self-attention, then
cross-attention to the encoder output, then the MLP.  The reference stacks
each side's layers on a leading dim and scans them; here each side is an
``nn.ModuleList`` with one entry per layer (``repro_torch.weights`` carries
``encoder/...`` and ``decoder/...`` to ``encoder.<l>.`` and
``decoder.<l>.``).

``forward`` and ``loss`` run the cross-attention through flash attention
(``attn_apply(kv_x=...)``, non-causal, Sq != Sk); ``prefill`` and
``decode_step`` precompute each layer's encoder K/V once and run the
cross-attention as the plain ``_cross_apply``, as the reference does.  The
module holds its parameters, so ``init_cache(batch, enc_out)`` builds the
cross K/V itself (the reference's equivalent passes no params and raises).

The decode cache is ``{"self": [per-layer {"k", "v"}], "cross": [per-layer
{"k", "v"}]}``; the self-attention caches are linear, of
``RuntimeConfig.max_cache_len`` slots.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels._local import is_dtensor, per_shard, split_dim
from ..kernels.flash_attention.ops import QKV_ROLES, gqa_per_shard
from .attention import attn_apply, attn_decode, attn_init, init_kv_cache
from .common import (Initializer, RuntimeConfig, dense_apply, mlp_apply,
                     mlp_init, norm_apply, norm_init, on_use, resolve_device,
                     softcap)
from .decoder import check_remat, embed_lookup, remat_call, shard_cache, xent_loss

__all__ = ["EncDecLM"]


class EncDecLM(nn.Module):
    """Encoder-decoder LM on ``device`` (CUDA unless the caller asks for
    CPU)."""

    def __init__(self, cfg: ModelConfig, rt: RuntimeConfig = RuntimeConfig(),
                 *, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        check_remat(rt)
        self.cfg, self.rt = cfg, rt
        self.pattern = cfg.pattern
        self.device = resolve_device(device)
        ini = Initializer(seed, self.device)
        D, dtype = cfg.d_model, rt.param_dtype
        self.embed = ini.normal((cfg.padded_vocab, D), 1.0, dtype)
        self.enc_final_norm = norm_init(ini, D, cfg.norm, dtype)
        self.final_norm = norm_init(ini, D, cfg.norm, dtype)
        self.lm_head = ini.normal((D, cfg.padded_vocab), D ** -0.5, dtype)
        self.encoder = nn.ModuleList(nn.ModuleDict({
            "norm1": norm_init(ini, D, cfg.norm, dtype),
            "attn": attn_init(ini, cfg, dtype),
            "norm2": norm_init(ini, D, cfg.norm, dtype),
            "mlp": mlp_init(ini, D, cfg.d_ff, dtype),
        }) for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(nn.ModuleDict({
            "norm1": norm_init(ini, D, cfg.norm, dtype),
            "self_attn": attn_init(ini, cfg, dtype),
            "norm2": norm_init(ini, D, cfg.norm, dtype),
            "cross_attn": attn_init(ini, cfg, dtype),
            "norm3": norm_init(ini, D, cfg.norm, dtype),
            "mlp": mlp_init(ini, D, cfg.d_ff, dtype),
        }) for _ in range(cfg.n_layers))

    def load_jax_params(self, np_tree: Dict) -> None:
        """Load the JAX package's parameter pytree (nested dicts of numpy)."""
        from ..weights import params_from_jax
        self.load_state_dict(params_from_jax(np_tree))

    def _layers(self, fn, layers, x, *args):
        """x through ``fn(p, x, *args)`` for each layer, each recomputed in
        the backward pass per ``RuntimeConfig.remat`` (``"full"``: nothing
        saved; ``"dots"``: the matrix products without batch dims saved)."""
        for p in layers:
            x = self.rt.hidden(remat_call(self.rt.remat, fn, p, x, *args))
        return x

    # ------------------------------------------------------------------ encoder

    def _enc_block(self, p, x: torch.Tensor) -> torch.Tensor:
        cfg, rt = self.cfg, self.rt
        p = on_use(p)
        x = x + attn_apply(p["attn"], norm_apply(p["norm1"], x, cfg.norm), cfg, rt,
                           causal=False)
        return x + mlp_apply(p["mlp"], norm_apply(p["norm2"], x, cfg.norm), cfg.act)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, D) precomputed frontend embeddings."""
        x = self._layers(self._enc_block, self.encoder,
                         frames.to(self.rt.compute_dtype))
        return norm_apply(on_use(self.enc_final_norm), x, self.cfg.norm)

    # ------------------------------------------------------------------ train

    def _dec_block(self, p, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        cfg, rt = self.cfg, self.rt
        p = on_use(p)
        x = x + attn_apply(p["self_attn"], norm_apply(p["norm1"], x, cfg.norm), cfg,
                           rt, causal=True)
        x = x + attn_apply(p["cross_attn"], norm_apply(p["norm2"], x, cfg.norm), cfg,
                           rt, kv_x=enc_out)
        return x + mlp_apply(p["mlp"], norm_apply(p["norm3"], x, cfg.norm), cfg.act)

    def _dec_trunk(self, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        return self._layers(self._dec_block, self.decoder, x, enc_out)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self.embed, tokens).to(self.rt.compute_dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm_apply(on_use(self.final_norm), x, cfg.norm)
        logits = softcap((x @ on_use(self.lm_head).to(x.dtype)).float(),
                         cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            iota = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return self.rt.logits_constraint(logits)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``batch["frontend_embeds"]`` (B, S_enc, D) and ``batch["tokens"]``
        (B, S) -> fp32 logits (B, S, V_pad)."""
        enc_out = self.encode(batch["frontend_embeds"])
        return self._logits(self._dec_trunk(self._embed(batch["tokens"]), enc_out))

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token cross entropy; labels < 0 are masked.  Returns
        (loss, {"loss", "n_tokens"})."""
        return xent_loss(self.forward(batch), batch["labels"])

    # ------------------------------------------------------------------ serve

    def _self_cache(self, batch: int) -> List[Dict[str, torch.Tensor]]:
        length = self.rt.max_cache_len
        if length <= 0:
            raise ValueError("the decoder's self-attention needs a KV cache: set "
                             "RuntimeConfig.max_cache_len > 0")
        return shard_cache(self, [init_kv_cache(self.cfg, batch, length,
                                                self.rt.compute_dtype, self.device)
                                  for _ in range(self.cfg.n_layers)], batch)

    def init_cache(self, batch: int, enc_out: Optional[torch.Tensor] = None) -> Dict:
        """Self-attention KV caches, plus each layer's cross K/V of
        ``enc_out`` when it is given."""
        cache: Dict = {"self": self._self_cache(batch)}
        if enc_out is not None:
            cache["cross"] = self._cross_kv(enc_out)
        return cache

    def _cross_kv(self, enc_out: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """Each decoder layer's (K, V) of the encoder output."""
        B, S, _ = enc_out.shape
        Hkv, dh = self.cfg.n_kv_heads, self.cfg.head_dim
        cross = [on_use(p["cross_attn"]) for p in self.decoder]
        return [{"k": split_dim(dense_apply(p["wk"], enc_out), -1, Hkv).reshape(B, S, Hkv, dh),
                 "v": split_dim(dense_apply(p["wv"], enc_out), -1, Hkv).reshape(B, S, Hkv, dh)}
                for p in cross]

    @torch.inference_mode()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor):
        """Encode, then run the decoder prompt; returns (last-position logits,
        cache, length)."""
        cfg, rt = self.cfg, self.rt
        enc_out = self.encode(frames)
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(S, device=x.device).expand(B, S)
        self_cache = self._self_cache(B)
        if S > self_cache[0]["k"].shape[1]:
            raise ValueError(f"a {S}-token prompt does not fit the KV cache's "
                             f"{self_cache[0]['k'].shape[1]} slots: raise "
                             "RuntimeConfig.max_cache_len")
        cross = self._cross_kv(enc_out)
        for p, sc, cr in zip(map(on_use, self.decoder), self_cache, cross):
            mix, (k, v) = attn_apply(p["self_attn"], norm_apply(p["norm1"], x, cfg.norm),
                                     cfg, rt, positions=positions, causal=True,
                                     return_kv=True)
            x = x + mix
            sc["k"][:, :S] = k.to(sc["k"].dtype)
            sc["v"][:, :S] = v.to(sc["v"].dtype)
            x = x + _cross_apply(p["cross_attn"], norm_apply(p["norm2"], x, cfg.norm),
                                 cr, cfg)
            x = x + mlp_apply(p["mlp"], norm_apply(p["norm3"], x, cfg.norm), cfg.act)
        return self._logits(x[:, -1:, :]), {"self": self_cache, "cross": cross}, S

    @torch.inference_mode()
    def decode_step(self, cache: Dict, token: torch.Tensor, pos: int):
        """token: (B, 1) int; pos: its absolute position.  Returns (logits
        (B, 1, V_pad), cache)."""
        cfg, rt = self.cfg, self.rt
        x = self._embed(token)
        new_self = []
        for p, sc, cr in zip(map(on_use, self.decoder), cache["self"], cache["cross"]):
            mix, sc = attn_decode(p["self_attn"], norm_apply(p["norm1"], x, cfg.norm),
                                  sc, pos, cfg, rt)
            new_self.append(sc)
            x = x + mix
            x = x + _cross_apply(p["cross_attn"], norm_apply(p["norm2"], x, cfg.norm),
                                 cr, cfg)
            x = x + mlp_apply(p["mlp"], norm_apply(p["norm3"], x, cfg.norm), cfg.act)
        return self._logits(x), {"self": new_self, "cross": cache["cross"]}


def _cross_apply(p, x: torch.Tensor, cross_kv: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (prefill and decode),
    in fp32 with a full softmax, as the reference computes it."""
    B, S, _ = x.shape
    Hq, dh = cfg.n_heads, cfg.head_dim
    q = split_dim(dense_apply(p["wq"], x), -1, Hq).reshape(B, S, Hq, dh)
    k, v = cross_kv["k"], cross_kv["v"]
    if is_dtensor(q):
        k, v = gqa_per_shard(q, k, v)
        out = per_shard(_cross_core, (q, k, v), (QKV_ROLES,) * 3, QKV_ROLES,
                        heads=(Hq, k.shape[2]))
    else:
        out = _cross_core(q, k, v)
    return out.reshape(B, S, Hq * dh).to(x.dtype) @ p["wo"]["w"].to(x.dtype)


def _cross_core(q, k, v):
    """Unmasked attention of q (B, S, Hq, dh) on k/v (B, Sk, Hkv, dh) in
    fp32: (B, S, Hq, dh)."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    q5 = (q.float() * (dh ** -0.5)).reshape(B, S, Hkv, Hq // Hkv, dh)
    s = torch.einsum("bsngd,bknd->bsngk", q5, k.float())
    out = torch.einsum("bsngk,bknd->bsngd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(B, S, Hq, dh)

"""Decoder-only LM, ported for the ``("ssm",)`` pattern (mamba2).

Port of ``repro.models.decoder.DecoderLM``.  The reference stacks each
superblock's params on a leading repeat dim and scans over it
(``_scan_or_unroll``); here each layer is one entry of an ``nn.ModuleList``
and the scan is a Python loop over it.  Block kinds that are not ported yet
raise ``NotImplementedError`` naming the ROADMAP item that ports them.

The serving methods keep the reference's signatures minus ``params`` (the
module holds them).  The decode cache is a list with one ``{"ssd", "conv"}``
dict per layer.
"""

from __future__ import annotations

from typing import Dict, List, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import (Initializer, RuntimeConfig, norm_apply, norm_init,
                     resolve_device, softcap)
from .ssm_block import init_ssm_cache, ssm_apply, ssm_decode, ssm_init

__all__ = ["DecoderLM"]

_NOT_PORTED = {
    "attn": "ROADMAP Queue 1 item 3 (attention slice)",
    "local": "ROADMAP Queue 1 item 3 (attention slice)",
    "global": "ROADMAP Queue 1 item 3 (attention slice)",
    "rec": "ROADMAP Queue 1 item 4 (recurrent slice)",
}


class DecoderLM(nn.Module):
    """Decoder-only LM on ``device`` (CUDA unless the caller asks for CPU)."""

    def __init__(self, cfg: ModelConfig, rt: RuntimeConfig = RuntimeConfig(),
                 *, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        for kind in cfg.pattern:
            if kind != "ssm":
                raise NotImplementedError(
                    f"block kind {kind!r} is not ported yet: "
                    f"{_NOT_PORTED.get(kind, 'ROADMAP Queue 1')}")
        if cfg.n_experts:
            raise NotImplementedError(
                "MoE is not ported yet: ROADMAP Queue 1 item 5")
        if cfg.frontend:
            raise NotImplementedError(
                "frontend embeddings are not ported yet: ROADMAP Queue 1 item 6")
        self.cfg, self.rt = cfg, rt
        self.pattern = cfg.pattern
        self.device = resolve_device(device)
        ini = Initializer(seed, self.device)
        dtype = rt.param_dtype
        self.embed = ini.normal((cfg.padded_vocab, cfg.d_model), 1.0, dtype)
        self.final_norm = norm_init(ini, cfg.d_model, cfg.norm, dtype)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"norm1": norm_init(ini, cfg.d_model, cfg.norm, dtype),
                           "ssm": ssm_init(ini, cfg, dtype)})
            for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = ini.normal((cfg.d_model, cfg.padded_vocab),
                                      cfg.d_model ** -0.5, dtype)

    def load_jax_params(self, np_tree: Dict) -> None:
        """Load the JAX package's parameter pytree (nested dicts of numpy)."""
        from ..weights import params_from_jax
        self.load_state_dict(params_from_jax(np_tree))

    # ------------------------------------------------------------------ fwd

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens].to(self.rt.compute_dtype)
        if self.cfg.scale_embed:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm_apply(self.final_norm, x, cfg.norm)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = softcap((x @ head.to(x.dtype)).float(), cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            iota = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return logits

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.blocks:
            h = norm_apply(layer["norm1"], x, self.cfg.norm)
            x = x + ssm_apply(layer["ssm"], h, self.cfg, self.rt)
        return x

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training/eval forward -> fp32 logits (B, S, V_pad)."""
        return self._logits(self._trunk(self._embed(batch["tokens"])))

    # ------------------------------------------------------------------ serve

    def init_cache(self, batch: int) -> List[Dict]:
        """Allocate the decode cache: one {"ssd", "conv"} dict per layer."""
        return [init_ssm_cache(self.cfg, batch, self.rt.compute_dtype,
                               self.device) for _ in self.blocks]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor):
        """Run the full prompt, return (last-position logits, cache, length)."""
        x = self._embed(tokens)
        cache = []
        for layer in self.blocks:
            h = norm_apply(layer["norm1"], x, self.cfg.norm)
            y, state = ssm_apply(layer["ssm"], h, self.cfg, self.rt,
                                 return_state=True)
            state["conv"] = state["conv"].to(self.rt.compute_dtype)
            cache.append(state)
            x = x + y
        return self._logits(x[:, -1:, :]), cache, x.shape[1]

    @torch.inference_mode()
    def decode_step(self, cache: List[Dict], token: torch.Tensor, pos: int):
        """token: (B, 1) int; pos: absolute position (unused by SSM layers).

        Returns (logits (B, 1, V_pad), new cache).
        """
        x = self._embed(token)
        new_cache = []
        for layer, layer_cache in zip(self.blocks, cache):
            h = norm_apply(layer["norm1"], x, self.cfg.norm)
            y, state = ssm_decode(layer["ssm"], h, layer_cache, self.cfg,
                                  self.rt)
            new_cache.append(state)
            x = x + y
        return self._logits(x), new_cache

"""Plain float32 reference of StableLM 2 (hf:stabilityai/stablelm-2-1_6b,
``StableLmForCausalLM``; arXiv:2402.17834), and its float8 control.

The decoder's reference (:mod:`portbench.reference.decoder`) with one
change: RoPE rotates only the first r = int(``partial_rotary_factor`` x
head_dim) dims of each head (16 of 64 at the published 0.25), split in
halves within them (dims 0..r/2 with r/2..r) at inverse frequencies
theta^(-2i/r), and passes dims r..head_dim through.  The rest is the
decoder's as it stands: LayerNorm with bias at the file's
``layer_norm_eps``, the q/k/v bias, multi-head attention, the SwiGLU MLP,
the untied head; so are the parameters, the dtypes, what it lacks and the
counts (RoPE is not counted).  It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import decoder
from .decoder import *  # noqa: F401,F403

__all__ = list(decoder.__all__)

# the decoder's keys, and the program's rotary fraction and norm eps
CONFIG_KEYS: Dict = dict(decoder.CONFIG_KEYS, partial_rotary_factor="rotary_fraction",
                         layer_norm_eps="norm_eps")


class Reference(decoder.Reference):
    """The reference model of ``cfg``, rotating part of each head."""

    def _check(self) -> None:
        """Refuses a fraction that does not rotate a positive, even number
        of each head's dims."""
        r = self._rotated()
        if r <= 0 or r % 2 or r > self.cfg["head_dim"]:
            raise ValueError(f"partial_rotary_factor {self.cfg['partial_rotary_factor']} "
                             f"rotates {r} of {self.cfg['head_dim']} dims")

    def _rotated(self) -> int:
        return int(self.cfg["partial_rotary_factor"] * self.cfg["head_dim"])

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, H, dh) at positions 0..S-1: the first r dims rotated."""
        S, _, r = x.shape[0], x.shape[1], self._rotated()
        inv = self.cfg["rope_theta"] ** (
            -torch.arange(0, r, 2, dtype=torch.float64, device=x.device) / r)
        ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
        sin, cos = torch.sin(ang).float()[:, None], torch.cos(ang).float()[:, None]
        x1, x2, rest = x[..., : r // 2], x[..., r // 2: r], x[..., r:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)

"""Plain-torch oracle for flash attention (naive, materialises the scores),
as ``repro.kernels.flash_attention.ref``, and the error bound that a bf16
tensor-core kernel is held to against it.

fp32 softmax (fp64 when q is fp64), GQA, causal / sliding-window / softcap /
segment (packed-sequence) masking.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_reference", "bf16_flash_limit"]

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Sk, Hkv, D)
    v: torch.Tensor,              # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_segments: Optional[torch.Tensor] = None,   # (B, Sq) int32
    kv_segments: Optional[torch.Tensor] = None,  # (B, Sk) int32
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    cdt = torch.promote_types(q.dtype, torch.float32)

    # GQA: expand kv heads to q heads (q head h reads kv head h // group).
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)

    qf = q.to(cdt) * scale
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(cdt))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)

    q_pos = torch.arange(Sq, device=q.device) + q_offset     # absolute positions
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    mask4 = mask[None, None]
    if q_segments is not None and kv_segments is not None:
        mask4 = mask4 & (q_segments[:, None, :, None] == kv_segments[:, None, None, :])

    scores = torch.where(mask4, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # Fully-masked rows (can happen with segments) -> zero output.
    probs = torch.where(mask4.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(cdt))
    return out.to(q.dtype)


def bf16_flash_limit(want: torch.Tensor, want_absv: torch.Tensor,
                     atol: float = 1e-4) -> torch.Tensor:
    """Per-element limit on ``|out - want|`` for a bf16 attention output from
    a kernel that rounds the probabilities P to bf16 for the PV product.

    ``want`` is the plain result on (q, k, v) and ``want_absv`` the plain
    result on (q, k, |v|), both in float64: ``want_absv = sum_s p_s |v_s| /
    l``.  Rounding each p_s to bf16 moves the output by at most bf16's unit
    roundoff (2^-8) times that; rounding the output to bf16 once adds one
    bf16 ulp (2^-7 |want|); ``atol`` covers fp32 accumulation.
    """
    return atol + 2.0 ** -7 * want.abs() + 2.0 ** -8 * want_absv

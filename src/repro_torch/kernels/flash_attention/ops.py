"""Public attention op with implementation dispatch (cuda / chunked / ref).

``impl="auto"`` launches the Hopper kernel for CUDA tensors and runs the
kernel's plain version, :func:`_flash_chunked`, for CPU tensors.  Nothing
falls back: a CUDA tensor under ``"cuda"`` or ``"auto"`` launches the kernel
or raises.  ``"ref"`` is :func:`attention_reference`, which materialises the
scores.  The kernel's launch count is ``kernel.flash_cuda.launches``.
DTensor inputs run per shard (:func:`repro_torch.kernels._local.per_shard`):
the batch where q shards it, the heads over the other mesh dims where both
head counts divide (K/V are repeated to the q heads where only Hq divides).

Any Sq and Sk are taken, as the serving engine's padded waves need: the
kernels tile by their own sizes and mask ragged tiles, and the plain version
masks its short last q and kv blocks by position.  (The reference's
``_flash_xla`` and Pallas route assert that the blocks divide Sq and Sk.)
"""

from __future__ import annotations

from typing import Optional

import torch

from .._local import is_dtensor, per_shard, shard_layout
from .ref import NEG_INF, attention_reference

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_segments: Optional[torch.Tensor] = None,
    kv_segments: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
    impl: str = "auto",
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    if is_dtensor(q) or is_dtensor(k):
        return _flash_per_shard(q, k, v, q_segments, kv_segments, causal=causal,
                                window=window, softcap=softcap, q_offset=q_offset,
                                scale=scale, impl=impl, block_q=block_q,
                                block_k=block_k)
    common = dict(causal=causal, window=window, softcap=softcap,
                  q_segments=q_segments, kv_segments=kv_segments,
                  q_offset=q_offset, scale=scale)
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "chunked"
    if impl == "ref":
        return attention_reference(q, k, v, **common)
    if impl not in ("cuda", "chunked"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda":
        from .kernel import flash_cuda        # builds the kernel on first use
        return flash_cuda(q, k, v, **common)
    return _flash_chunked(q, k, v, block_q=block_q, block_k=block_k, **common)


QKV_ROLES = ("batch", None, "heads", None)


def gqa_per_shard(q, k, v):
    """(k, v) as per-shard attention takes them: repeated to the q heads
    when the q heads can be sharded over a mesh dim that the KV heads do not
    divide (each rank then holds the KV heads of its own q heads)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    _, with_kv = shard_layout(q, QKV_ROLES, (Hq, Hkv))
    _, q_only = shard_layout(q, QKV_ROLES, (Hq,))
    if Hq != Hkv and q_only.count("heads") > with_kv.count("heads"):
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    return k, v


def _flash_per_shard(q, k, v, q_segments, kv_segments, **kw):
    def local(q, k, v, q_segments, kv_segments):
        return flash_attention(q, k, v, q_segments=q_segments,
                               kv_segments=kv_segments, **kw)

    k, v = gqa_per_shard(q, k, v)
    seg = ("batch", None)
    return per_shard(local, (q, k, v, q_segments, kv_segments),
                     (QKV_ROLES, QKV_ROLES, QKV_ROLES,
                      seg if q_segments is not None else None,
                      seg if kv_segments is not None else None),
                     QKV_ROLES, heads=(q.shape[2], k.shape[2]))


def _flash_chunked(
    q, k, v, *, causal, window, softcap, q_segments, kv_segments, q_offset,
    scale, block_q, block_k,
):
    """Chunked online-softmax attention in plain torch: port of
    ``repro.kernels.flash_attention.ops._flash_xla`` and the plain version of
    the CUDA kernel.  A loop over q blocks and, inside, over kv blocks; the
    transient scores are (B, Hq, bq, bk), never (Sq, Sk).  The last q and
    kv blocks may be short (Sq or Sk not a multiple of the block): they are
    sliced to the rows and keys that exist.  Computes in fp32, or fp64 when q
    is fp64."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    n_q, n_k = -(-Sq // bq), -(-Sk // bk)
    use_segments = q_segments is not None

    if n_q == 1 and n_k == 1:
        return attention_reference(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_segments=q_segments if use_segments else None,
            kv_segments=kv_segments if use_segments else None,
            q_offset=q_offset, scale=scale)

    cdt = torch.promote_types(q.dtype, torch.float32)
    kf, vf = k.to(cdt), v.to(cdt)
    outs = []
    for qi in range(n_q):
        qs = slice(qi * bq, min((qi + 1) * bq, Sq))
        rows = qs.stop - qs.start
        qf = q[:, qs].to(cdt) * scale                       # (B, rows, Hq, D)
        q_pos = q_offset + qs.start + torch.arange(rows, device=q.device)
        m = torch.full((B, Hq, rows), NEG_INF, dtype=cdt, device=q.device)
        l = torch.zeros((B, Hq, rows), dtype=cdt, device=q.device)
        acc = torch.zeros((B, Hq, rows, D), dtype=cdt, device=q.device)
        for ki in range(n_k):
            ks = slice(ki * bk, min((ki + 1) * bk, Sk))
            k_rep = kf[:, ks].repeat_interleave(group, dim=2)   # (B, keys, Hq, D)
            v_rep = vf[:, ks].repeat_interleave(group, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, k_rep)
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            k_pos = torch.arange(ks.start, ks.stop, device=q.device)
            mask = torch.ones((rows, len(k_pos)), dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            mask = mask[None, None]
            if use_segments:
                mask = mask & (q_segments[:, None, qs, None]
                               == kv_segments[:, None, None, ks])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            alpha = torch.where(m <= NEG_INF * 0.5, 0.0, torch.exp(m - m_safe))
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v_rep)
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l_safe[..., None]).transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)

"""Wrapper of the hand-written Hopper flash-attention kernels
(``csrc/flash_fwd_wgmma.cu`` and ``csrc/flash_fwd.cu``).

Counterpart of ``repro.kernels.flash_attention.kernel.flash_attention_pallas``:
the same inputs, options and output, computed by a CUDA kernel compiled for
``sm_90a`` on first use (see ``kernels/_build.py``).  Two kernels compute the
same function; the route is chosen by dtype and head_dim alone:

=========================  ===========================================
bf16, head_dim 64/128/256  ``flash_fwd_wgmma``: bf16 tensor cores (wgmma,
                           TMA, 128-row q tiles, 64-key KV tiles)
fp32 (head_dim 16..256),   ``flash_fwd``: fp32 on CUDA cores (64-row q
bf16 head_dim 16/32        tiles, 64 keys, 32 at head_dim 256)
=========================  ===========================================

The route is not a fallback: each shape has one kernel, and a failure to
build or launch raises.  The kernels tile by their own sizes, so the
caller's block sizes are those of the plain version alone.  Ragged Sq and Sk
are masked inside both kernels.

``flash_cuda.launches`` counts every launch of either kernel, so that a run
can show that its model path went through one;
``flash_cuda.wgmma_launches`` counts the tensor-core route's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._autograd import refuse_grad
from .._build import load

__all__ = ["flash_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)      # one kernel instance per head_dim
WGMMA_HEAD_DIMS = (64, 128, 256)        # bf16 head_dims of flash_fwd_wgmma
_INT_MAX = 2**31 - 1


def _launcher(name: str, n_ints: int):
    """The C launch function ``<name>_launch`` of kernel ``name``: six
    pointers, ``n_ints`` ints, scale and softcap, the stream."""
    fn = getattr(load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (flash_fwd reads 16-byte vectors; TMA
    needs a 16-byte aligned base)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_cuda(
    q: torch.Tensor,              # (B, Sq, Hq, D) fp32 or bf16
    k: torch.Tensor,              # (B, Sk, Hkv, D), q's dtype
    v: torch.Tensor,              # (B, Sk, Hkv, D), q's dtype
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_segments: Optional[torch.Tensor] = None,   # (B, Sq) int
    kv_segments: Optional[torch.Tensor] = None,  # (B, Sk) int
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns the attention output (B, Sq, Hq, D) in q.dtype.  Launches or
    raises."""
    refuse_grad("flash_cuda", 'flash_attention(..., impl="ref" or "chunked")',
                q, k, v)
    if not q.is_cuda:
        raise ValueError(f"flash_cuda needs CUDA tensors, got q on {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_cuda takes q in {_DTYPES}, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != (B, Sk, Hkv, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(B, Sk, Hkv, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_cuda takes head_dim in {HEAD_DIMS}, got {D}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("pass both q_segments and kv_segments, or neither")
    if q_segments is not None:
        if tuple(q_segments.shape) != (B, Sq) or tuple(kv_segments.shape) != (B, Sk):
            raise ValueError(f"segments have shapes {tuple(q_segments.shape)}, "
                             f"{tuple(kv_segments.shape)}, expected {(B, Sq)}, {(B, Sk)}")
    tensors = [q, k, v] + ([q_segments, kv_segments] if q_segments is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_cuda inputs lie on different devices")
    if min(B, Sq, Hq, Sk) <= 0:
        raise ValueError(f"flash_cuda needs non-empty inputs, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if q_segments is not None:
        q_segments = q_segments.to(torch.int32).contiguous()
        kv_segments = kv_segments.to(torch.int32).contiguous()

    wgmma = q.dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
    name = "flash_fwd_wgmma" if wgmma else "flash_fwd"
    # flash_fwd takes one more int than flash_fwd_wgmma: is_bf16.
    dtype_arg = () if wgmma else (int(q.dtype == torch.bfloat16),)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher(name, 9 + len(dtype_arg))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segments.data_ptr() if q_segments is not None else None,
            kv_segments.data_ptr() if kv_segments is not None else None,
            out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal),
            _INT_MAX if window is None else int(window), int(q_offset), *dtype_arg,
            float(scale), 0.0 if softcap is None else float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    flash_cuda.launches += 1
    if wgmma:
        flash_cuda.wgmma_launches += 1
    return out


flash_cuda.launches = 0
flash_cuda.wgmma_launches = 0

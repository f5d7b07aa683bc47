"""Wrapper of the hand-written Hopper flash-attention kernel
(``csrc/flash_fwd.cu``).

Counterpart of ``repro.kernels.flash_attention.kernel.flash_attention_pallas``:
the same inputs, options and output, computed by a CUDA kernel compiled for
``sm_90a`` on first use (see ``kernels/_build.py``).  The kernel tiles by its
own sizes (64 query rows; 64 keys, 32 at head_dim 256), so the caller's
block sizes only decide the reference's divisibility asserts in ``ops.py``.
Ragged Sq and Sk are masked inside the kernel.

``flash_cuda.launches`` counts the kernel's launches, so that a run can show
that its model path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import load

__all__ = ["flash_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)      # one kernel instance per head_dim
_INT_MAX = 2**31 - 1


def _lib() -> ctypes.CDLL:
    lib = load("flash_fwd")
    fn = lib.flash_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel reads 16-byte vectors)."""
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

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_segments.data_ptr() if q_segments is not None else None,
            kv_segments.data_ptr() if kv_segments is not None else None,
            out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal),
            _INT_MAX if window is None else int(window), int(q_offset),
            int(q.dtype == torch.bfloat16),
            float(scale), 0.0 if softcap is None else float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {rc}")
    flash_cuda.launches += 1
    return out


flash_cuda.launches = 0

"""Wrapper of the hand-written Hopper RG-LRU kernel (``csrc/rglru_fwd.cu``).

Counterpart of ``repro.kernels.rglru.kernel.rglru_pallas``: the same inputs
and outputs, computed by a CUDA kernel compiled for ``sm_90a`` on first use
(see ``kernels/_build.py``).  One thread walks one (batch, channel) pair
through the sequence; the TPU kernel's chunk size has no counterpart.

``rglru_cuda.launches`` counts the kernel's launches, so that a run can show
that its model path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .._build import load

__all__ = ["rglru_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = load("rglru_fwd")
    fn = lib.rglru_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def rglru_cuda(
    x: torch.Tensor,                     # (B, S, W) fp32 or bf16
    r: torch.Tensor,                     # (B, S, W), x's dtype
    i: torch.Tensor,                     # (B, S, W), x's dtype
    lam: torch.Tensor,                   # (W,)
    initial_h: Optional[torch.Tensor] = None,   # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y in x.dtype, final h in fp32).  Launches or raises."""
    if not x.is_cuda:
        raise ValueError(f"rglru_cuda needs CUDA tensors, got x on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, W), got shape {tuple(x.shape)}")
    Bsz, S, W = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"rglru_cuda takes x in {_DTYPES}, got {x.dtype}")
    for name, t in (("r", r), ("i", i)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(x.shape)}")
    if tuple(lam.shape) != (W,):
        raise ValueError(f"lam has shape {tuple(lam.shape)}, expected {(W,)}")
    if initial_h is not None and tuple(initial_h.shape) != (Bsz, W):
        raise ValueError(f"initial_h has shape {tuple(initial_h.shape)}, "
                         f"expected {(Bsz, W)}")
    tensors = [x, r, i, lam] + ([initial_h] if initial_h is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("rglru_cuda inputs lie on different devices")
    if Bsz == 0 or S == 0 or W == 0:
        raise ValueError(f"rglru_cuda needs a non-empty input, got {tuple(x.shape)}")
    x, r, i = x.contiguous(), r.contiguous(), i.contiguous()
    lam = lam.to(torch.float32).contiguous()
    if initial_h is not None:
        initial_h = initial_h.to(torch.float32).contiguous()

    y = torch.empty_like(x)
    h = torch.empty((Bsz, W), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().rglru_fwd_launch(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
            initial_h.data_ptr() if initial_h is not None else None,
            y.data_ptr(), h.data_ptr(), Bsz, S, W,
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_fwd launch failed with CUDA error {rc}")
    rglru_cuda.launches += 1
    return y, h


rglru_cuda.launches = 0

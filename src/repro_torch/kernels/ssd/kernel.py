"""Wrapper of the hand-written Hopper SSD kernel (``csrc/ssd_fwd.cu``).

Counterpart of ``repro.kernels.ssd.kernel.ssd_pallas``: the same inputs and
outputs, computed by a CUDA kernel compiled for ``sm_90a`` on first use (see
``kernels/_build.py``).  The kernel walks the sequence at its own chunk length
of 64 steps; the caller's chunk only changes fp32 rounding (see the note at
the top of the source).

``ssd_cuda.launches`` counts the kernel's launches, so that a run can show
that its model path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .._build import load

__all__ = ["ssd_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = load("ssd_fwd")
    fn = lib.ssd_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ssd_cuda(
    x: torch.Tensor,                     # (B, S, H, P) fp32 or bf16
    a: torch.Tensor,                     # (B, S, H) in (0, 1]
    B_mat: torch.Tensor,                 # (B, S, N), x's dtype
    C_mat: torch.Tensor,                 # (B, S, N), x's dtype
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y in x.dtype, final state in fp32).  Launches or raises."""
    if not x.is_cuda:
        raise ValueError(f"ssd_cuda needs CUDA tensors, got x on {x.device}")
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_cuda takes x in {_DTYPES}, got {x.dtype}")
    for name, t in (("B_mat", B_mat), ("C_mat", C_mat)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if tuple(t.shape) != (Bsz, S, N):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(Bsz, S, N)}")
    if tuple(a.shape) != (Bsz, S, H):
        raise ValueError(f"a has shape {tuple(a.shape)}, expected {(Bsz, S, H)}")
    if P % 16 or P > 64 or N > 128:
        raise ValueError(f"ssd_cuda takes P a multiple of 16 up to 64 and N up "
                         f"to 128, got P={P}, N={N}")
    tensors = [x, a, B_mat, C_mat] + ([initial_state] if initial_state is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_cuda inputs lie on different devices")
    x, B_mat, C_mat = x.contiguous(), B_mat.contiguous(), C_mat.contiguous()
    a = a.to(torch.float32).contiguous()
    if initial_state is not None:
        if tuple(initial_state.shape) != (Bsz, H, P, N):
            raise ValueError(f"initial_state has shape {tuple(initial_state.shape)}, "
                             f"expected {(Bsz, H, P, N)}")
        initial_state = initial_state.to(torch.float32).contiguous()

    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().ssd_fwd_launch(
            x.data_ptr(), a.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            y.data_ptr(), final.data_ptr(), Bsz, S, H, P, N,
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_fwd launch failed with CUDA error {rc}")
    ssd_cuda.launches += 1
    return y, final


ssd_cuda.launches = 0

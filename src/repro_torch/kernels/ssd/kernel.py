"""Wrapper of the hand-written Hopper SSD kernels (``csrc/ssd_fwd_wgmma.cu``
and ``csrc/ssd_fwd.cu``).

Counterpart of ``repro.kernels.ssd.kernel.ssd_pallas``: the same inputs and
outputs, computed by a CUDA kernel compiled for ``sm_90a`` on first use (see
``kernels/_build.py``).  Two kernels compute the same function; the route is
chosen by dtype and shape alone:

======================  ==================================================
bf16, P 64, N 128       ``ssd_fwd_wgmma``: bf16 tensor cores (wgmma, TMA),
(mamba2-1.3b's)         chunk-parallel in three launches, at the caller's
                        chunk rounded up to a multiple of 64
fp32; bf16 at other     ``ssd_fwd``: fp32 on CUDA cores, one CTA per
P (16..64) and N        (batch, head) walking its own chunks of 64
(up to 128)
======================  ==================================================

The route is not a fallback: each input has one kernel, and a failure to
build or launch raises.  The chunk only changes rounding; any S is taken
(ragged ends are masked inside both kernels).

``ssd_cuda.launches`` counts every call that launched either kernel, so that
a run can show that its model path went through one;
``ssd_cuda.wgmma_launches`` counts the tensor-core route's calls (each is
three CUDA launches, counted once).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .._autograd import refuse_grad
from .._build import load

__all__ = ["ssd_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)
WGMMA_SHAPE = (64, 128)                 # (P, N) of ssd_fwd_wgmma
TILE = 64                               # ssd_fwd_wgmma's tile of steps


def _launcher(name: str, n_ptrs: int, n_ints: int):
    """The C launch function ``<name>_launch`` of kernel ``name``: ``n_ptrs``
    pointers, ``n_ints`` ints, the stream."""
    fn = getattr(load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (TMA needs a 16-byte aligned base; the
    state passes read 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_chunk(chunk: int, S: int) -> int:
    """ssd_fwd_wgmma's chunk: the caller's, no longer than S, rounded up to a
    multiple of the 64-step tile."""
    return -(-min(chunk, S) // TILE) * TILE


def ssd_cuda(
    x: torch.Tensor,                     # (B, S, H, P) fp32 or bf16
    a: torch.Tensor,                     # (B, S, H) in (0, 1]
    B_mat: torch.Tensor,                 # (B, S, N), x's dtype
    C_mat: torch.Tensor,                 # (B, S, N), x's dtype
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y in x.dtype, final state in fp32).  Launches or raises."""
    refuse_grad("ssd_cuda", 'ssd(..., impl="chunked")', x, a, B_mat, C_mat,
                initial_state)
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
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if P % 16 or P > 64 or N > 128:
        raise ValueError(f"ssd_cuda takes P a multiple of 16 up to 64 and N up "
                         f"to 128, got P={P}, N={N}")
    tensors = [x, a, B_mat, C_mat] + ([initial_state] if initial_state is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_cuda inputs lie on different devices")
    x, B_mat, C_mat = _aligned(x), _aligned(B_mat), _aligned(C_mat)
    a = _aligned(a.to(torch.float32))
    if initial_state is not None:
        if tuple(initial_state.shape) != (Bsz, H, P, N):
            raise ValueError(f"initial_state has shape {tuple(initial_state.shape)}, "
                             f"expected {(Bsz, H, P, N)}")
        initial_state = _aligned(initial_state.to(torch.float32))
    s0_ptr = initial_state.data_ptr() if initial_state is not None else None

    wgmma = x.dtype == torch.bfloat16 and (P, N) == WGMMA_SHAPE
    name = "ssd_fwd_wgmma" if wgmma else "ssd_fwd"
    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wgmma:
            Q = kernel_chunk(chunk, S)
            nc = -(-S // Q)
            # Scratch: la per chunk, each chunk's state contribution (fp32)
            # and each chunk's entering state (bf16, an operand of the scan).
            la = torch.empty((Bsz, H, nc * Q), dtype=torch.float32, device=x.device)
            dstate = torch.empty((Bsz, H, nc, P, N), dtype=torch.float32, device=x.device)
            states = torch.empty((Bsz, H, nc, P, N), dtype=torch.bfloat16, device=x.device)
            rc = _launcher(name, 10, 6)(
                x.data_ptr(), a.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(), s0_ptr,
                y.data_ptr(), final.data_ptr(), la.data_ptr(), dstate.data_ptr(),
                states.data_ptr(), Bsz, S, H, P, N, Q, stream)
        else:
            rc = _launcher(name, 7, 6)(
                x.data_ptr(), a.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(), s0_ptr,
                y.data_ptr(), final.data_ptr(), Bsz, S, H, P, N,
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    ssd_cuda.launches += 1
    if wgmma:
        ssd_cuda.wgmma_launches += 1
    return y, final


ssd_cuda.launches = 0
ssd_cuda.wgmma_launches = 0

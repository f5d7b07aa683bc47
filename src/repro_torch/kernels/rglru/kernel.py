"""Wrapper of the hand-written Hopper RG-LRU kernel (``csrc/rglru_fwd.cu``).

Counterpart of ``repro.kernels.rglru.kernel.rglru_pallas``: the same inputs
and outputs, computed by a CUDA kernel compiled for ``sm_90a`` on first use
(see ``kernels/_build.py``).  The kernel is a chunk-parallel, single-pass
scan: persistent CTAs take tiles of (batch, 128 channels, ``kernel_chunk()``
steps) from a ticket counter, each tile scanning its steps from zero and
then folding in the h at the end of the tile before it in its column (a
chained look-back).  Every h is composed in the same order on every run, so
the kernel is deterministic: the same inputs give the same bits.  Its chunk
is its own and any S is taken; the caller's ``chunk`` (the TPU kernel's
block of steps) only gates the reference's ``S % chunk`` assert in
``ops.rglru``.

The look-back's scratch (one 64-bit word per channel and tile, and the
ticket counter) is kept between calls, one set per (device, stream), and
grows when a call needs more.  Each call tags its words with a new epoch, so
nothing is cleared between calls.

``rglru_cuda.launches`` counts the kernel's launches, so that a run can show
that its model path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .._autograd import refuse_grad
from .._build import load

__all__ = ["rglru_cuda", "kernel_chunk"]

_DTYPES = (torch.float32, torch.bfloat16)
TILE_W = 128                            # channels a tile holds
_EPOCHS = 1 << 31                       # the C side takes a positive int


def _lib() -> ctypes.CDLL:
    lib = load("rglru_fwd")
    fn = lib.rglru_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rglru_fwd_chunk.argtypes = []
        lib.rglru_fwd_chunk.restype = ctypes.c_int
    return lib


def kernel_chunk() -> int:
    """Steps in each of the kernel's tiles (builds the kernel on first use)."""
    return _lib().rglru_fwd_chunk()


class _Scratch:
    """The look-back's state for one (device, stream)."""

    def __init__(self, tiles: int, device: torch.device):
        self.tiles = tiles
        self.words = torch.zeros((tiles, TILE_W), dtype=torch.int64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch == _EPOCHS:       # words of 2^31 calls ago would match
            self.words.zero_()
            self.epoch = 1
        return self.epoch


_SCRATCH: Dict[Tuple[int, int], _Scratch] = {}


def _scratch(device: torch.device, stream: int, tiles: int) -> _Scratch:
    key = (device.index, stream)
    sc = _SCRATCH.get(key)
    if sc is None or sc.tiles < tiles:
        sc = _SCRATCH[key] = _Scratch(tiles, device)
    return sc


def rglru_cuda(
    x: torch.Tensor,                     # (B, S, W) fp32 or bf16
    r: torch.Tensor,                     # (B, S, W), x's dtype
    i: torch.Tensor,                     # (B, S, W), x's dtype
    lam: torch.Tensor,                   # (W,)
    initial_h: Optional[torch.Tensor] = None,   # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y in x.dtype, final h in fp32).  Launches or raises."""
    refuse_grad("rglru_cuda", 'rglru(..., impl="scan")', x, r, i, lam, initial_h)
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
    lib = _lib()
    tiles = -(-S // lib.rglru_fwd_chunk()) * Bsz * -(-W // TILE_W)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        sc = _scratch(x.device, stream, tiles)
        rc = lib.rglru_fwd_launch(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
            initial_h.data_ptr() if initial_h is not None else None,
            y.data_ptr(), h.data_ptr(), sc.words.data_ptr(), sc.counter.data_ptr(),
            Bsz, S, W,
            int(x.dtype == torch.bfloat16), sc.tiles, sc.next_epoch(), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_fwd launch failed with CUDA error {rc}")
    rglru_cuda.launches += 1
    return y, h


rglru_cuda.launches = 0

"""Public RG-LRU op with implementation dispatch (cuda / scan / ref).

``impl="auto"`` launches the Hopper kernel for CUDA tensors and runs the
kernel's plain version, :func:`_rglru_scan`, for CPU tensors.  Nothing falls
back: a CUDA tensor under ``"cuda"`` or ``"auto"`` launches the kernel or
raises.  The kernel's launch count is ``kernel.rglru_cuda.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ref import _gates, rglru_reference, rglru_step_reference

__all__ = ["rglru", "rglru_step"]


def rglru(
    x: torch.Tensor,                     # (B, S, W)
    r: torch.Tensor,
    i: torch.Tensor,
    lam: torch.Tensor,                   # (W,)
    initial_h: Optional[torch.Tensor] = None,
    *,
    chunk: int = 256,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU scan.  Returns (y in x.dtype, final h in fp32)."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "scan"
    if impl == "ref":
        return rglru_reference(x, r, i, lam, initial_h)
    if impl == "scan":
        return _rglru_scan(x, r, i, lam, initial_h)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}")
    S = x.shape[1]
    # The reference's kernel route asserts this; the CUDA kernel itself
    # takes any S.
    assert S % min(chunk, S) == 0, (S, chunk)
    from .kernel import rglru_cuda          # builds the kernel on first use
    return rglru_cuda(x, r, i, lam, initial_h)


def rglru_step(h, x_t, r_t, i_t, lam):
    """Single-token decode step (plain torch; the op is tiny)."""
    return rglru_step_reference(h, x_t, r_t, i_t, lam)


def _rglru_scan(x, r, i, lam, initial_h=None):
    """Log-depth scan in plain torch: port of ``repro.kernels.rglru.ops.
    _rglru_xla`` and the plain version of the CUDA kernel.

    h_t = a_t h_{t-1} + u_t is associative under
    (a1, u1) o (a2, u2) = (a1 a2, u1 a2 + u2); ceil(log2 S) doubling steps
    (Hillis-Steele) combine each element with the one ``off`` steps back.
    The initial h folds into the first element.  Computes in fp32, or fp64
    when x is fp64; the final h comes back in that type.
    """
    S = x.shape[1]
    a, u = _gates(x, r, i, lam)
    if initial_h is not None:
        u = torch.cat([u[:, :1] + a[:, :1] * initial_h.to(a.dtype)[:, None],
                       u[:, 1:]], dim=1)
    off = 1
    while off < S:
        u = torch.cat([u[:, :off], u[:, off:] + a[:, off:] * u[:, :-off]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return u.to(x.dtype), u[:, -1]

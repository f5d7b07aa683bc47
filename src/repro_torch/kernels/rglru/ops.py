"""Public RG-LRU op with implementation dispatch (cuda / scan / ref).

``impl="auto"`` launches the Hopper kernel for CUDA tensors and runs the
kernel's plain version, :func:`_rglru_scan`, for CPU tensors.  Nothing falls
back: a CUDA tensor under ``"cuda"`` or ``"auto"`` launches the kernel or
raises.  The kernel's launch count is ``kernel.rglru_cuda.launches``.
DTensor inputs run per shard (:func:`repro_torch.kernels._local.per_shard`):
the batch where x shards it, the channels over the other mesh dims where
they divide; the decode step in its state's own layout.

:func:`_rglru_chunked` repeats the kernel's blocking and its evaluation of
1 - a^2 (chunk aggregates, the chained look-back, the apply pass) in plain
torch, for the tests alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .._local import is_dtensor, per_shard
from .ref import RGLRU_C, _gates, rglru_reference, rglru_step_reference

__all__ = ["rglru", "rglru_step"]


def rglru(
    x: torch.Tensor,                     # (B, S, W)
    r: torch.Tensor,
    i: torch.Tensor,
    lam: torch.Tensor,                   # (W,)
    initial_h: Optional[torch.Tensor] = None,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU scan.  Returns (y in x.dtype, final h in fp32).  Any S is taken:
    the CUDA kernel scans in chunks of its own (``kernel.kernel_chunk()``).
    (The reference's ``chunk`` argument sizes its Pallas blocks, and its
    kernel route asserts S % chunk == 0; no route here has such a block.)"""
    if is_dtensor(x):
        def local(x, r, i, lam, initial_h):
            return rglru(x, r, i, lam, initial_h, impl=impl)

        return per_shard(local, (x, r, i, lam, initial_h),
                         (_X, _X, _X, ("heads",), _H if initial_h is not None else None),
                         [_X, _H], heads=(x.shape[2],))
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "scan"
    if impl == "ref":
        return rglru_reference(x, r, i, lam, initial_h)
    if impl == "scan":
        return _rglru_scan(x, r, i, lam, initial_h)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}")
    from .kernel import rglru_cuda          # builds the kernel on first use
    return rglru_cuda(x, r, i, lam, initial_h)


_X = ("batch", None, "heads")                   # (B, S, W)
_H = ("batch", "heads")                         # (B, W)


def rglru_step(h, x_t, r_t, i_t, lam):
    """Single-token decode step (plain torch; the op is tiny).  With
    DTensors, elementwise in the state's own layout (``cache_specs`` shards
    its width): nothing moves where the inputs arrive laid out as h."""
    if is_dtensor(x_t) or is_dtensor(h):
        return per_shard(rglru_step_reference, (h, x_t, r_t, i_t, lam),
                         (_H, _H, _H, _H, ("heads",)), [_H, _H], heads=None)
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


def _kernel_gates(x, r, i, lam):
    """``_gates`` as the kernel evaluates them: 1 - a^2 = -expm1(2 log a)
    (the kernel: -(a - 1)(a + 1), a - 1 from its series near 1), which keeps
    its digits where a is within 1e-7 of 1; the reference's 1 - a * a loses
    up to a third of itself there to the rounding of a in fp32."""
    cdt = torch.promote_types(x.dtype, torch.float32)
    log_a = -RGLRU_C * F.softplus(lam.to(cdt)) * torch.sigmoid(r.to(cdt))
    mult = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), mult * torch.sigmoid(i.to(cdt)) * x.to(cdt)


def _chunk_scan(a, u):
    """Each chunk's scan from zero.  a, u: (B, nc, L, W).  Returns (prod of
    a through each step, h through each step), both (B, nc, L, W); their
    last steps are the chunk's aggregate (A_c, H_c)."""
    p, h = torch.ones_like(a[:, :, 0]), torch.zeros_like(u[:, :, 0])
    ps, hs = [], []
    for t in range(a.shape[2]):
        h = a[:, :, t] * h + u[:, :, t]
        p = p * a[:, :, t]
        ps.append(p)
        hs.append(h)
    return torch.stack(ps, dim=2), torch.stack(hs, dim=2)


def _look_back(A, H, h0):
    """The h entering each chunk, (B, nc, W), from the chunk aggregates (B,
    nc, W) and h0 (B, W), as the kernel chains them: chunk 0 takes h0, chunk
    c the h at the end of chunk c-1, H_{c-1} + A_{c-1} h_in(c-1)."""
    h_in = [h0]
    for c in range(1, A.shape[1]):
        h_in.append(H[:, c - 1] + A[:, c - 1] * h_in[-1])
    return torch.stack(h_in, dim=1)


def _rglru_chunked(x, r, i, lam, initial_h=None, chunk=64, look_back=_look_back):
    """The CUDA kernel's blocking in plain torch, for the tests: gates once
    an element (as ``_kernel_gates``), chunks of ``chunk`` steps scanned from
    zero to their aggregates (steps past S padded with a = 1, u = 0, so they
    enter no aggregate), the h entering each chunk from ``look_back(A, H,
    h0)``, and the apply pass y = h_local + prod(a) h_in.  Computes in fp32
    (fp64 when x is fp64); returns (y in x.dtype, final h)."""
    Bsz, S, W = x.shape
    a, u = _kernel_gates(x, r, i, lam)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    a = F.pad(a, (0, 0, 0, pad), value=1.0).reshape(Bsz, nc, chunk, W)
    u = F.pad(u, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, W)
    p, h_loc = _chunk_scan(a, u)
    h0 = (torch.zeros((Bsz, W), dtype=a.dtype, device=x.device)
          if initial_h is None else initial_h.to(a.dtype))
    h_in = look_back(p[:, :, -1], h_loc[:, :, -1], h0)
    h = h_loc + p * h_in[:, :, None]
    h = h.reshape(Bsz, nc * chunk, W)
    return h[:, :S].to(x.dtype), h[:, -1]

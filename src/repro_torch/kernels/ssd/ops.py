"""Public SSD op with implementation dispatch (cuda / chunked / ref).

``impl="auto"`` launches a Hopper kernel for CUDA tensors (``kernel.ssd_cuda``
picks it by dtype and shape) and runs the kernels' plain version,
:func:`_ssd_chunked`, for CPU tensors.  Nothing falls back: a CUDA tensor
under ``"cuda"`` or ``"auto"`` launches a kernel or raises.  The launch counts
are ``kernel.ssd_cuda.launches`` and ``.wgmma_launches``.  DTensor inputs
run per shard (:func:`repro_torch.kernels._local.per_shard`): the batch where
x shards it, the heads over the other mesh dims where they divide; the
decode step in its state's own layout (:func:`ssd_step`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._local import is_dtensor, move_split, per_shard
from .ref import ssd_reference, ssd_step_reference

__all__ = ["ssd", "ssd_step"]


def ssd(
    x: torch.Tensor,                     # (B, S, H, P)
    a: torch.Tensor,                     # (B, S, H)
    B_mat: torch.Tensor,                 # (B, S, N)
    C_mat: torch.Tensor,                 # (B, S, N)
    initial_state: Optional[torch.Tensor] = None,
    *,
    chunk: int = 256,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space duality scan.  Returns (y, final_state)."""
    if is_dtensor(x):
        def local(x, a, B_mat, C_mat, initial_state):
            return ssd(x, a, B_mat, C_mat, initial_state, chunk=chunk, impl=impl)

        return per_shard(local, (x, a, B_mat, C_mat, initial_state),
                         (_X, _A, _BC, _BC, _STATE if initial_state is not None else None),
                         [_X, _STATE], heads=(x.shape[2],))
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "chunked"
    if impl == "ref":
        return ssd_reference(x, a, B_mat, C_mat, initial_state)
    if impl not in ("cuda", "chunked"):
        raise ValueError(f"unknown impl {impl!r}")
    S = x.shape[1]
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    if impl == "cuda":
        from .kernel import ssd_cuda          # builds the kernel on first use
        return ssd_cuda(x, a, B_mat, C_mat, initial_state, chunk=chunk)
    return _ssd_chunked(x, a, B_mat, C_mat, initial_state, chunk=chunk)


_X = ("batch", None, "heads", None)             # (B, S, H, P)
_A = ("batch", None, "heads")                   # (B, S, H)
_BC = ("batch", None, None)                     # (B, S, N)
_STATE = ("batch", "heads", None, None)         # (B, H, P, N)
# The decode state runs in its own layout (``cache_specs`` shards its last
# dim, N): the update is local given B's slice of N, and y = C . state
# contracts N, so y leaves each rank as a partial sum.
_STATE_T = ("batch", "heads", None, "inner")    # (B, H, P, N)
_X_T = ("batch", "heads", None)                 # (B, H, P): one step's x, and y
_A_T = ("batch", "heads")                       # (B, H)
_BC_T = ("batch", "inner")                      # (B, N)


def ssd_step(state, x_t, a_t, b_t, c_t):
    """Single-token decode step (plain torch; the op is tiny).  With
    DTensors, in the state's own layout: y's partial sums over N's shards
    are reduce-scattered onto its heads (all-reduced where the heads do not
    divide the mesh dim) in fp32, then cast to x's dtype."""
    if not (is_dtensor(x_t) or is_dtensor(state)):
        return ssd_step_reference(state, x_t, a_t, b_t, c_t)
    def local(state, x_t, a_t, b_t, c_t):
        return ssd_step_reference(state, x_t.float(), a_t, b_t, c_t)

    y, state = per_shard(local, (state, x_t, a_t, b_t, c_t),
                         (_STATE_T, _X_T, _A_T, _BC_T, _BC_T), [_X_T, _STATE_T],
                         heads=None, partial_over=[("inner",)])
    return move_split(y, "partial", 1, whole_rest=True).to(x_t.dtype), state


def _ssd_chunked(x, a, B_mat, C_mat, initial_state=None, *, chunk):
    """Blocked SSD in plain torch: matmuls within chunks, a loop across them.

    Port of ``repro.kernels.ssd.ops._ssd_xla`` and the plain version of the
    CUDA kernel.  Computes in fp32, or in fp64 when x is fp64 (a reference
    for the kernel); the final state comes back in that type.
    """
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    chunk = min(chunk, S)
    assert S % chunk == 0
    n_chunks = S // chunk
    cdt = torch.promote_types(x.dtype, torch.float32)

    xf = x.to(cdt).reshape(Bsz, n_chunks, chunk, H, P)
    af = a.to(cdt).reshape(Bsz, n_chunks, chunk, H)
    Bf = B_mat.to(cdt).reshape(Bsz, n_chunks, chunk, N)
    Cf = C_mat.to(cdt).reshape(Bsz, n_chunks, chunk, N)

    la = torch.cumsum(torch.log(af), dim=2)              # (B, nc, c, H)
    total = la[:, :, -1, :]                              # (B, nc, H)

    # Intra-chunk, all chunks at once (they don't depend on the state).
    scores = torch.einsum("bgtn,bgrn->bgtr", Cf, Bf)     # (B, nc, c, c)
    t_idx = torch.arange(chunk, device=x.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    # Masked before the exp (the reference masks after it, with the same
    # forward values): off the causal triangle la_t - la_r > 0 overflows at
    # fast decays, and the gradient through where() of an inf is NaN.
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]             # (B,nc,c,c,H)
    m = torch.exp(torch.where(causal[None, None, :, :, None], diff, -torch.inf))
    y_intra = torch.einsum("bgtrh,bgrhp->bgthp", scores[..., None] * m, xf)

    # Chunk -> state contribution (independent per chunk).
    w = torch.exp(total[:, :, None, :] - la)             # (B, nc, c, H)
    dstate = torch.einsum("bgthp,bgtn->bghpn", xf * w[..., None], Bf)

    # Sequential state passing across chunks.
    state = (torch.zeros((Bsz, H, P, N), dtype=cdt, device=x.device)
             if initial_state is None else initial_state.to(cdt))
    y_inter = []
    for g in range(n_chunks):
        y_inter.append(torch.exp(la[:, g])[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cf[:, g], state))          # (B, c, H, P)
        state = torch.exp(total[:, g])[:, :, None, None] * state + dstate[:, g]
    y = y_intra + torch.stack(y_inter, dim=1)            # (B, nc, c, H, P)
    return y.reshape(Bsz, S, H, P).to(x.dtype), state

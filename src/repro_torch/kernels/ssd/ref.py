"""Plain-torch oracle for the Mamba-2 SSD (state-space duality) operator.

Sequential-over-time reference, as ``repro.kernels.ssd.ref``:

    s_t = a_t * s_{t-1} + x_t (outer) B_t          s: (P, N) per (batch, head)
    y_t = s_t @ C_t

with x: (B, S, H, P), a: (B, S, H) in (0, 1], B/C: (B, S, N) shared across
heads (single SSD group, as in mamba2).

Also the error bound that a bf16 tensor-core SSD kernel is held to against
the float64 plain result (:func:`bf16_ssd_limit`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_reference", "ssd_step_reference", "bf16_ssd_limit"]


def ssd_reference(
    x: torch.Tensor,                     # (B, S, H, P)
    a: torch.Tensor,                     # (B, S, H)
    B_mat: torch.Tensor,                 # (B, S, N)
    C_mat: torch.Tensor,                 # (B, S, N)
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, H, P), final_state: (B, H, P, N) fp32)."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    xf, af = x.float(), a.float()
    Bf, Cf = B_mat.float(), C_mat.float()
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        state = state * af[:, t, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y, state


def ssd_step_reference(
    state: torch.Tensor,                 # (B, H, P, N) f32
    x_t: torch.Tensor,                   # (B, H, P)
    a_t: torch.Tensor,                   # (B, H)
    b_t: torch.Tensor,                   # (B, N)
    c_t: torch.Tensor,                   # (B, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step; returns (y_t: (B, H, P), new_state)."""
    state = state * a_t.float()[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", x_t.float(), b_t.float())
    y_t = torch.einsum("bhpn,bn->bhp", state, c_t.float())
    return y_t.to(x_t.dtype), state


def bf16_ssd_limit(
    y_want: torch.Tensor,                # (B, S, H, P) float64 plain result
    x: torch.Tensor,                     # (B, S, H, P)
    a: torch.Tensor,                     # (B, S, H)
    B_mat: torch.Tensor,                 # (B, S, N)
    C_mat: torch.Tensor,                 # (B, S, N)
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
    *,
    chunk: int,
    atol: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element limits on ``|y - y_want|`` and ``|final - final_want|``
    for a bf16 SSD kernel that works in chunks of ``chunk`` steps and rounds
    three operands to bf16 for the tensor cores, as ``ssd_fwd_wgmma`` does.

    Rounding to bf16 moves an element by at most bf16's unit roundoff 2^-8
    of its size.  With LA the cumulative sum of log a over the sequence,
    step r reaches y_t (r <= t) as ``exp(LA_t - LA_r) (C_t . B_r) x_r``, and
    on that path the kernel rounds one operand: the decayed score when r
    lies in t's chunk, ``w_r x_r`` in r's chunk state when it lies in an
    earlier one.  Either error is at most 2^-8 of the term's size, and the
    rounding of ``w_r x_r[p]`` is shared by every n, so it scales ``C_t .
    B_r`` as a whole.  The third rounding, of the (fp32-passed) state s_g
    entering t's chunk, adds at most 2^-8 ``exp(la_t) |C_t| |s_g|^T`` (la
    from the chunk's start).  So, in float64 from these inputs,

        y_limit = atol + 2^-7 |y_want|
                  + 2^-8 (Σ_{r<=t} exp(LA_t - LA_r) |C_t . B_r| |x_r|
                          + exp(la_t) |C_t| |s_g|^T)

    where 2^-7 |y_want| is one bf16 ulp for rounding y once and ``atol``
    covers fp32 accumulation.  The final state is fp32 and has only the
    ``w_r x_r`` roundings on its path, each scaled by one B_r[n]:
    ``atol + 2^-8 Σ_r exp(LA_S - LA_r) |x_r| |B_r|^T``.
    """
    Bsz, S, H, P = x.shape
    f64 = torch.float64
    xf, Bf, Cf = x.to(f64), B_mat.to(f64), C_mat.to(f64)
    LA = torch.cumsum(torch.log(a.to(f64)), dim=1)                      # (B, S, H)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril_()[..., None]
    y_sens = torch.empty((Bsz, S, H, P), dtype=f64, device=x.device)
    for b in range(Bsz):
        # exp(LA_t - LA_r) masked before exp: it overflows for r > t.
        m = torch.exp(torch.where(causal, LA[b, :, None] - LA[b, None], float("-inf")))
        m *= (Cf[b] @ Bf[b].T).abs_()[..., None]                           # (t, r, H)
        y_sens[b] = torch.einsum("trh,rhp->thp", m, xf[b].abs())
        del m
    state = (torch.zeros((Bsz, H, P, B_mat.shape[-1]), dtype=f64, device=x.device)
             if initial_state is None else initial_state.to(f64))
    for start in range(0, S, chunk):
        end = min(start + chunk, S)
        la = LA[:, start:end] - (LA[:, start - 1:start] if start else 0.0)   # (B, c, H)
        y_sens[:, start:end] += torch.exp(la)[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cf[:, start:end].abs(), state.abs())
        w = torch.exp(la[:, -1:] - la)
        state = torch.exp(la[:, -1])[..., None, None] * state + torch.einsum(
            "bthp,btn->bhpn", xf[:, start:end] * w[..., None], Bf[:, start:end])
    w = torch.exp(LA[:, -1:] - LA)
    s_sens = torch.einsum("bthp,btn->bhpn", xf.abs() * w[..., None], Bf.abs())
    return (atol + 2.0 ** -7 * y_want.abs() + 2.0 ** -8 * y_sens,
            atol + 2.0 ** -8 * s_sens)

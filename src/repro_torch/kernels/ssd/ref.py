"""Plain-torch oracle for the Mamba-2 SSD (state-space duality) operator.

Sequential-over-time reference, as ``repro.kernels.ssd.ref``:

    s_t = a_t * s_{t-1} + x_t (outer) B_t          s: (P, N) per (batch, head)
    y_t = s_t @ C_t

with x: (B, S, H, P), a: (B, S, H) in (0, 1], B/C: (B, S, N) shared across
heads (single SSD group, as in mamba2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_reference", "ssd_step_reference"]


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

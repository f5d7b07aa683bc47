"""Plain-torch oracle for the RG-LRU (Real-Gated Linear Recurrent Unit,
Griffin / RecurrentGemma), as ``repro.kernels.rglru.ref``:

    log_a_t = -c * softplus(Lambda) * sigmoid(r_t)          (per channel)
    a_t     = exp(log_a_t)
    h_t     = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(i_t) * x_t)

x, r, i: (B, S, W); Lambda: (W,).  c = 8 (paper constant).  The gates and
the recurrence run in fp32 (fp64 when x is fp64, as a yardstick for the
kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["rglru_reference", "rglru_step_reference", "RGLRU_C"]

RGLRU_C = 8.0


def _gates(x, r, i, lam):
    cdt = torch.promote_types(x.dtype, torch.float32)
    log_a = -RGLRU_C * F.softplus(lam.to(cdt)) * torch.sigmoid(r.to(cdt))
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    gated_x = torch.sigmoid(i.to(cdt)) * x.to(cdt)
    return a, mult * gated_x


def rglru_reference(
    x: torch.Tensor,                     # (B, S, W)
    r: torch.Tensor,                     # (B, S, W) pre-sigmoid recurrence gate
    i: torch.Tensor,                     # (B, S, W) pre-sigmoid input gate
    lam: torch.Tensor,                   # (W,)
    initial_h: Optional[torch.Tensor] = None,   # (B, W) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, W) in x.dtype, final_h: (B, W) f32)."""
    B, S, W = x.shape
    a, u = _gates(x, r, i, lam)
    h = (torch.zeros((B, W), dtype=a.dtype, device=x.device)
         if initial_h is None else initial_h.to(a.dtype))
    ys = []
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1).to(x.dtype), h


def rglru_step_reference(
    h: torch.Tensor,                     # (B, W) f32
    x_t: torch.Tensor,                   # (B, W)
    r_t: torch.Tensor,
    i_t: torch.Tensor,
    lam: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: returns (y_t in x_t.dtype, h in f32)."""
    a, u = _gates(x_t, r_t, i_t, lam)
    h = a * h.to(a.dtype) + u
    return h.to(x_t.dtype), h

"""Mixture-of-Experts layer: GShard-style capacity-based top-k dispatch.

Port of ``repro.models.moe`` (``moe_init``, ``moe_apply``, ``moe_decode``).

Train/prefill: the B*S tokens are split into G groups of g, the largest
divisor of B*S that is at most ``rt.moe_group_size``; within a group each
token's top-k experts receive it up to a per-group expert capacity
C = ceil(g * k * capacity_factor / E).  Every token's first choice takes its
slot before any token's second choice.  Dispatch and combine are the
reference's one-hot einsums.  Tokens over capacity are dropped for that
expert; the router runs in fp32.  So under drops a row's output depends on
the other rows of its batch (a group can span two rows).

Decode: all experts are computed densely for the new token and combined with
the top-k gate weights; nothing is dropped, so prefill and decode agree with
``forward`` only where no token drops (``capacity_factor = n_experts``).

The reference's ``moe_apply_shardmap`` (explicit all-to-all expert
parallelism) needs the sharding rules of the distribution slice and is not
ported here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import Initializer, RuntimeConfig

__all__ = ["moe_init", "moe_apply", "moe_decode", "moe_groups"]


def moe_init(ini: Initializer, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return nn.ParameterDict({
        "router": ini.normal((D, E), D ** -0.5, torch.float32),
        "wi": ini.normal((E, D, Fd), D ** -0.5, dtype),
        "wg": ini.normal((E, D, Fd), D ** -0.5, dtype),
        "wo": ini.normal((E, Fd, D), Fd ** -0.5, dtype),
    })


def _route(p, x: torch.Tensor, cfg: ModelConfig):
    """Router logits and top-k in fp32.  x: (..., D) -> gates and expert ids
    (..., K), the first the top choice, and the probabilities (..., E)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.experts_per_token, dim=-1, sorted=True)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, idx, probs


def moe_groups(n_tokens: int, cfg: ModelConfig, rt: RuntimeConfig
               ) -> Tuple[int, int, int]:
    """(G, g, C): the number of groups, tokens a group and the capacity of
    each expert in a group, exactly as the reference counts them."""
    g = min(rt.moe_group_size, n_tokens)
    while n_tokens % g:          # the largest divisor of T <= the group size
        g -= 1
    C = max(1, int(-(-g * cfg.experts_per_token * cfg.capacity_factor
                     // cfg.n_experts)))                       # ceil
    return n_tokens // g, g, C


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Capacity-based dispatch."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    G, g, C = moe_groups(B * S, cfg, rt)
    xg = x.reshape(G, g, D)
    gate, idx, probs = _route(p, xg, cfg)                      # (G, g, K)

    # Load-balancing auxiliary loss (Switch-style).
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # Dispatch/combine one-hots with per-expert positions.  A position past
    # the capacity matches no slot (jax.nn.one_hot's zero row: the drop).
    slots = torch.arange(C, device=x.device)
    counts = torch.zeros((G, 1, E), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((G, g, E, C), dtype=torch.float32, device=x.device)
    combine = torch.zeros((G, g, E, C), dtype=torch.float32, device=x.device)
    for k_i in range(K):
        oh = F.one_hot(idx[..., k_i], E).float()               # (G, g, E)
        pos = torch.cumsum(oh, dim=1) - oh + counts            # (G, g, E)
        keep = (pos < C).float() * oh
        slot = (pos.long()[..., None] == slots).float()        # (G, g, E, C)
        disp_k = keep[..., None] * slot
        dispatch = dispatch + disp_k
        combine = combine + disp_k * gate[..., k_i][..., None, None]
        counts = counts + oh.sum(dim=1, keepdim=True)

    cd = x.dtype
    xd = torch.einsum("gtec,gtd->gecd", dispatch.to(cd), xg)   # (G, E, C, D)
    h = torch.einsum("gecd,edf->gecf", xd, p["wi"].to(cd))
    gt = torch.einsum("gecd,edf->gecf", xd, p["wg"].to(cd))
    h = h * F.silu(gt)
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"].to(cd))
    y = torch.einsum("gtec,gecd->gtd", combine.to(cd), ye)
    return y.reshape(B, S, D), aux


def moe_decode(p, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig
               ) -> torch.Tensor:
    """x: (B, 1, D).  Dense all-expert compute, top-k combine."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    gate, idx, _ = _route(p, x, cfg)                           # (B, 1, K)
    cd = x.dtype
    h = torch.einsum("btd,edf->btef", x, p["wi"].to(cd))
    g = torch.einsum("btd,edf->btef", x, p["wg"].to(cd))
    ye = torch.einsum("btef,efd->bted", h * F.silu(g), p["wo"].to(cd))  # (B,1,E,D)
    w = torch.zeros((B, S, E), dtype=torch.float32, device=x.device)
    for k_i in range(K):
        w = w + F.one_hot(idx[..., k_i], E).float() * gate[..., k_i][..., None]
    return torch.einsum("bte,bted->btd", w.to(cd), ye)

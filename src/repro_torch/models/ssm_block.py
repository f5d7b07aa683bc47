"""Mamba-2 block: in_proj -> depthwise conv -> SSD -> gated norm -> out_proj.

Port of ``repro.models.ssm_block``.  The input projection emits
[z (gate, Din), x (Din), B (N), C (N), dt (H)]; a short depthwise causal conv
smooths (x, B, C); the SSD scan runs per head with scalar decay
a = exp(-dt * exp(A_log)); output is RMS-norm(y * silu(z)) -> out_proj.

The mixer's parameters are an ``nn.ParameterDict`` with the reference's key
names; ``ssm_apply`` and ``ssm_decode`` are plain functions over it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels._local import move_split, regroup, rows_split, split_dim
from ..kernels.ssd import ssd, ssd_step
from .common import Initializer, RuntimeConfig, keep_layout, linear, rmsnorm

__all__ = ["ssm_init", "ssm_apply", "ssm_decode", "init_ssm_cache"]


def ssm_init(ini: Initializer, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    D, Din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = Din + 2 * N
    return nn.ParameterDict({
        "in_proj": ini.normal((D, 2 * Din + 2 * N + H), D ** -0.5, dtype),
        "conv_w": ini.normal((cfg.ssm_conv_width, conv_dim), 0.2, dtype),
        "conv_b": ini.zeros((conv_dim,), dtype),
        "A_log": ini.normal((H,), 0.5, torch.float32),
        "dt_bias": ini.zeros((H,), torch.float32),
        "D_skip": ini.ones((H,), torch.float32),
        "norm_scale": ini.zeros((Din,), dtype),
        "out_proj": ini.normal((Din, D), Din ** -0.5, dtype),
    })


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    Din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xbc, dt = regroup(proj, [Din, Din + 2 * N, H])
    return z, xbc, dt                        # (.., Din) (.., Din+2N) (.., H)


def _conv_scan(conv_w, conv_b, xbc, conv_state=None):
    """Depthwise causal conv along S.  xbc: (B, S, Cdim).

    conv_state: (B, W-1, Cdim) trailing context (decode);
    returns (out, new_conv_state)."""
    W = conv_w.shape[0]
    S = xbc.shape[1]
    pad = (conv_state if conv_state is not None
           else xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[-1])))
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+W-1, Cdim)
    out = sum(full[:, i:i + S, :] * conv_w[i][None, None, :] for i in range(W))
    out = F.silu(out + conv_b[None, None, :])
    new_state = full[:, -(W - 1):, :] if W > 1 else pad[:, :0]
    return out, new_state


def _gates(params, dt_raw):
    """dt in fp32; decay a = exp(-dt * exp(A_log))."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    a = torch.exp(-dt * torch.exp(params["A_log"])[None, None, :])
    return dt, a


def ssm_apply(params, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig,
              initial: Optional[Dict] = None, return_state: bool = False):
    """Full-sequence Mamba-2 mixer.  x: (B, S, D)."""
    B, S, D = x.shape
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    # (a sequence-parallel x: the conv and the scan run along the sequence,
    # so the projection takes the channels' split: an all-to-all)
    proj = move_split(linear(x, params["in_proj"]), 1, 2, rows_split(x))
    # z, xbc and dt (and then x, B and C) do not fall on the shards of a
    # tensor-parallel last dim: each piece is regrouped onto shards of its
    # own (one all-to-all), or the dim gathered where they do not divide
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_in_state = initial["conv"] if initial is not None else None
    xbc, conv_state = _conv_scan(params["conv_w"].to(x.dtype),
                                 params["conv_b"].to(x.dtype),
                                 xbc, conv_in_state)
    xs, Bm, Cm = regroup(xbc, [Din, N, N])
    xs = split_dim(xs, -1, H)
    dt, a = _gates(params, dt_raw)                        # (B,S,H)

    xh = xs.reshape(B, S, H, P) * dt[..., None].to(xs.dtype)
    s0 = initial["ssd"] if initial is not None else None
    y, final = ssd(xh, a, Bm, Cm, s0, chunk=cfg.ssm_chunk, impl=rt.ssd_impl)
    y = y + params["D_skip"].float()[None, None, :, None] \
        * xs.reshape(B, S, H, P).float()
    # the gradient of the merged heads must arrive sharded only where the
    # heads are (as attention's output projection)
    y = split_dim(y.reshape(B, S, Din), -1, H).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"])
    out = linear(y, params["out_proj"])
    if return_state:
        return out, {"ssd": final, "conv": conv_state}
    return out


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``rmsnorm(y * silu(z), scale)``, the gated norm over d_inner, with
    the gated product pinned to y's layout, its gradient too (as the norm's
    own steps, ``common.keep_layout``)."""
    return rmsnorm(keep_layout(y, y * F.silu(keep_layout(y, z))), scale)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device: torch.device) -> Dict:
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "ssd": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, Din + 2 * N),
                            dtype=dtype, device=device),
    }


def ssm_decode(params, x_t: torch.Tensor, cache: Dict, cfg: ModelConfig,
               rt: RuntimeConfig):
    """One-token step.  x_t: (B, 1, D); cache: {"ssd", "conv"}."""
    B = x_t.shape[0]
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = linear(x_t, params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _conv_scan(params["conv_w"].to(x_t.dtype),
                                 params["conv_b"].to(x_t.dtype),
                                 xbc, cache["conv"])
    xs, Bm, Cm = regroup(xbc, [Din, N, N])
    xs = split_dim(xs, -1, H)
    dt, a = _gates(params, dt_raw)                        # (B,1,H)
    xh = (xs.reshape(B, 1, H, P) * dt[..., None].to(xs.dtype))[:, 0]
    y, new_state = ssd_step(cache["ssd"], xh, a[:, 0], Bm[:, 0], Cm[:, 0])
    y = y[:, None] + params["D_skip"].float()[None, None, :, None] \
        * xs.reshape(B, 1, H, P).float()
    y = y.reshape(B, 1, Din).to(x_t.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_scale"])
    out = linear(y, params["out_proj"])
    return out, {"ssd": new_state, "conv": conv_state}

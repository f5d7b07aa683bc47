"""RecurrentGemma (Griffin) recurrent block.

Port of ``repro.models.recurrent_block``.  Two branches from the input:
  a) linear -> short depthwise causal conv -> RG-LRU
  b) linear -> GeLU (tanh form, as ``jax.nn.gelu``)
merged as out_proj(a * b).  The RG-LRU gates (r, i) are linear functions of
the post-conv branch input.

The block's parameters are an ``nn.ParameterDict`` with the reference's key
names; ``rec_apply`` and ``rec_decode`` are plain functions over it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels._local import move_split, rows_split
from ..kernels.rglru import rglru, rglru_step
from .common import Initializer, RuntimeConfig, linear

__all__ = ["rec_init", "rec_apply", "rec_decode", "init_rec_cache"]


def rec_init(ini: Initializer, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    D = cfg.d_model
    W = cfg.lru_width or D
    return nn.ParameterDict({
        "in_x": ini.normal((D, W), D ** -0.5, dtype),      # recurrent branch
        "in_y": ini.normal((D, W), D ** -0.5, dtype),      # gate branch
        "conv_w": ini.normal((cfg.ssm_conv_width, W), 0.2, dtype),
        "conv_b": ini.zeros((W,), dtype),
        "gate_r": ini.normal((W, W), W ** -0.5, dtype),
        "gate_i": ini.normal((W, W), W ** -0.5, dtype),
        "lam": nn.Parameter(ini.normal((W,), 0.5, torch.float32).data + 1.0),
        "out": ini.normal((W, D), W ** -0.5, dtype),
    })


def _conv(conv_w, conv_b, x, conv_state=None):
    """Depthwise causal conv along S (no activation).  x: (B, S, W).

    conv_state: (B, Wd-1, W) trailing context (decode); returns
    (out, new_conv_state)."""
    Wd = conv_w.shape[0]
    S = x.shape[1]
    pad = (conv_state if conv_state is not None
           else x.new_zeros((x.shape[0], Wd - 1, x.shape[-1])))
    full = torch.cat([pad, x], dim=1)
    out = sum(full[:, i:i + S, :] * conv_w[i][None, None, :] for i in range(Wd))
    return out + conv_b[None, None, :], full[:, -(Wd - 1):, :]


def rec_apply(params, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig,
              initial: Optional[Dict] = None, return_state: bool = False):
    """Full-sequence recurrent block.  x: (B, S, D).  Where x is split on
    its sequence (sequence parallelism), the conv and the scan, which run
    along the sequence, take the width's split instead (an all-to-all each
    way), and the matmuls run on a rank's rows."""
    rows = rows_split(x)
    bx = linear(x, params["in_x"])
    by = F.gelu(linear(x, params["in_y"]), approximate="tanh")
    conv_in = initial["conv"] if initial is not None else None
    bx, conv_state = _conv(params["conv_w"].to(x.dtype),
                           params["conv_b"].to(x.dtype), move_split(bx, 1, 2, rows),
                           conv_in)
    gx = move_split(bx, 2, 1, rows)
    r = move_split(linear(gx, params["gate_r"]), 1, 2, rows)
    i = move_split(linear(gx, params["gate_i"]), 1, 2, rows)
    h0 = initial["h"] if initial is not None else None
    y, h = rglru(bx, r, i, params["lam"], h0, impl=rt.rglru_impl)
    out = linear(move_split(y, 2, 1, rows) * by, params["out"])
    if return_state:
        return out, {"h": h, "conv": conv_state}
    return out


def init_rec_cache(cfg: ModelConfig, batch: int, dtype,
                   device: torch.device) -> Dict:
    W = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, W), dtype=dtype,
                            device=device),
    }


def rec_decode(params, x_t: torch.Tensor, cache: Dict, cfg: ModelConfig,
               rt: RuntimeConfig):
    """One-token step.  x_t: (B, 1, D); cache: {"h", "conv"}."""
    bx = linear(x_t, params["in_x"])
    by = F.gelu(linear(x_t, params["in_y"]), approximate="tanh")
    bx, conv_state = _conv(params["conv_w"].to(x_t.dtype),
                           params["conv_b"].to(x_t.dtype), bx, cache["conv"])
    r = linear(bx, params["gate_r"])
    i = linear(bx, params["gate_i"])
    y, h = rglru_step(cache["h"], bx[:, 0], r[:, 0], i[:, 0], params["lam"])
    out = linear(y[:, None] * by, params["out"])
    return out, {"h": h, "conv": conv_state}

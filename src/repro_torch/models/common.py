"""Shared model building blocks: runtime knobs, init helpers, norms.

Port of ``repro.models.common``.  Parameters are ``nn.Parameter``s held in
``nn.ParameterDict``s with the JAX package's key names and ``(d_in, d_out)``
orientation; the apply functions are plain functions on tensors, as in the
reference.  A model built on the ``meta`` device holds shapes and dtypes
only (the counterpart of the reference's ``init_abstract``): the sharding
rules read full-size shapes from it without memory.

A model whose parameters :func:`repro_torch.train.sharding.shard_model` made
DTensors runs sharded: each layer takes its parameters through
:func:`on_use`, which gathers their FSDP shards.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["RuntimeConfig", "Initializer", "resolve_device", "rmsnorm",
           "layernorm", "norm_init", "norm_apply", "dense_init", "dense_apply",
           "mlp_init", "mlp_apply", "apply_rope", "softcap", "on_use"]


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs orthogonal to the architecture."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"              # auto | cuda | chunked | ref
    ssd_impl: str = "auto"               # auto | cuda | chunked | ref
    rglru_impl: str = "auto"             # auto | cuda | scan | ref
    remat: str = "none"                  # none | full | dots (training)
    # Accepted for the reference's signature: the port always runs a Python
    # loop over its per-layer modules, and both values compute the same.
    scan_layers: bool = True
    attn_block_q: int = 512
    attn_block_k: int = 1024
    moe_group_size: int = 512            # MoE capacity groups (tokens)
    max_cache_len: int = 0               # serve: KV cache allocation length
    # ActivationSharding (train/sharding.py) or None; the models call
    # .hidden()/.logits() at the reference's constraint points when set.
    act_sharding: Any = None
    # Pin q/k/v head sharding explicitly (heads over tp, or seq in "seq" mode).
    constrain_attn_heads: bool = False
    # MoE execution path: "gspmd" (the capacity einsums, moe_apply) or
    # "shard_map" (explicit all-to-all expert parallelism, moe_apply_shardmap).
    moe_impl: str = "gspmd"

    def with_(self, **kw) -> "RuntimeConfig":
        return dataclasses.replace(self, **kw)

    def hidden(self, x):
        return self.act_sharding.hidden(x) if self.act_sharding else x

    def logits_constraint(self, x):
        return self.act_sharding.logits(x) if self.act_sharding else x

    def heads_constraint(self, x):
        if self.act_sharding and self.constrain_attn_heads:
            return self.act_sharding.heads(x)
        return x

    def moe_constraint(self, x):
        return (self.act_sharding.moe_expert_major(x)
                if self.act_sharding else x)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; raises if it is CUDA and no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return device


class Initializer:
    """Deterministic param init (truncated normal on [-2, 2] x scale).  On
    the ``meta`` device it draws nothing: the parameters are shapes and
    dtypes only."""

    def __init__(self, seed: int, device: Union[str, torch.device]):
        self.device = resolve_device(device)
        self.generator = (None if self.device.type == "meta" else
                          torch.Generator(device=self.device).manual_seed(seed))

    def normal(self, shape, scale: float, dtype: torch.dtype) -> nn.Parameter:
        if self.generator is None:
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=self.device))
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.generator)
        return nn.Parameter((t * scale).to(dtype))

    def zeros(self, shape, dtype: torch.dtype) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=dtype, device=self.device))

    def ones(self, shape, dtype: torch.dtype) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, dtype=dtype, device=self.device))


def on_use(p):
    """Parameters as a layer's matmuls use them.  A sharded parameter (a
    DTensor that ``shard_model`` gave an ``on_use`` layout: its spec with
    the FSDP axes dropped) is redistributed to that layout, so its FSDP
    shards are gathered on use and its gradient is reduce-scattered back; a
    module of such parameters comes back as nested dicts of them.  Plain
    parameters and modules come back as they are."""
    if isinstance(p, torch.Tensor):
        layout = getattr(p, "on_use", None)
        return p if layout is None else p.redistribute(p.device_mesh, layout)
    first = next(p.parameters(), None)
    if getattr(first, "on_use", None) is None:
        return p
    return {k: on_use(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(ini: Initializer, d: int, kind: str, dtype) -> nn.ParameterDict:
    if kind == "rmsnorm":
        return nn.ParameterDict({"scale": ini.zeros((d,), dtype)})  # (1+scale)
    return nn.ParameterDict({"scale": ini.ones((d,), dtype),
                             "bias": ini.zeros((d,), dtype)})


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
              ) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + 1e-6)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_apply(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------


def dense_init(ini: Initializer, d_in: int, d_out: int, dtype,
               bias: bool = False) -> nn.ParameterDict:
    p = nn.ParameterDict({"w": ini.normal((d_in, d_out), d_in ** -0.5, dtype)})
    if bias:
        p["b"] = ini.zeros((d_out,), dtype)
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mlp_init(ini: Initializer, d: int, f: int, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({
        "wi": ini.normal((d, f), d ** -0.5, dtype),
        "wg": ini.normal((d, f), d ** -0.5, dtype),
        "wo": ini.normal((f, d), f ** -0.5, dtype),
    })


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated MLP: SwiGLU (silu) or GeGLU (gelu, tanh form as ``jax.nn.gelu``)."""
    h = x @ p["wi"].to(x.dtype)
    g = x @ p["wg"].to(x.dtype)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (h * g) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    freq = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=positions.device) / dim)
    ang = positions.to(torch.float32)[..., None] * freq       # (..., dim/2)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Half-split, in fp32."""
    D = x.shape[-1]
    sin, cos = _rope_angles(positions, D, theta)      # (B, S, D/2)
    if sin.dim() == 2:                                 # (S, D/2) -> batch dim
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)

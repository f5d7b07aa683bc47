"""Shared model building blocks: runtime knobs, init helpers, norms.

Port of ``repro.models.common`` for the serving slice.  Parameters are
``nn.Parameter``s held in ``nn.ParameterDict``s with the JAX package's key
names and ``(d_in, d_out)`` orientation; the apply functions are plain
functions on tensors, as in the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

__all__ = ["RuntimeConfig", "Initializer", "resolve_device", "rmsnorm",
           "layernorm", "norm_init", "norm_apply", "softcap"]


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs orthogonal to the architecture."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    ssd_impl: str = "auto"               # auto | cuda | chunked | ref

    def with_(self, **kw) -> "RuntimeConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; raises if it is CUDA and no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return device


class Initializer:
    """Deterministic param init (truncated normal on [-2, 2] x scale)."""

    def __init__(self, seed: int, device: Union[str, torch.device]):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, scale: float, dtype: torch.dtype) -> nn.Parameter:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.generator)
        return nn.Parameter((t * scale).to(dtype))

    def zeros(self, shape, dtype: torch.dtype) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=dtype, device=self.device))

    def ones(self, shape, dtype: torch.dtype) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, dtype=dtype, device=self.device))


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

"""Weights made from the seed, one parameter at a time, by name.

Each parameter has a generator of its own, seeded from ``(seed, name)``, so
any one of them can be drawn again alone: the harness fills the program's
parameters with :func:`draw`, and the reference draws the same values again
layer by layer after the program is gone.  Values are drawn on the device,
in the dtype they are served in, in one call a parameter.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

__all__ = ["param_seed", "draw"]


def param_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def _mean_std(name: str, shape: Tuple[int, ...], norm: str) -> Tuple[float, float]:
    """Weights of fan-in d: N(0, 1/d); the embedding N(0, 1); norm scales
    about their identity (a layernorm's scale about 1, an rmsnorm's, used as
    1 + scale, about 0) and biases N(0, 0.1^2), so that each does work."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        return (1.0 if leaf == "scale" and norm == "layernorm" else 0.0), 0.1
    if name == "embed":
        return 0.0, 1.0
    return 0.0, shape[-2] ** -0.5


def draw(seed: int, name: str, shape, dtype: torch.dtype, device, norm: str,
         out: torch.Tensor = None) -> torch.Tensor:
    """Parameter ``name`` of ``shape`` and ``dtype``, drawn on ``device``
    (into ``out`` when given)."""
    shape = tuple(shape)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if tuple(out.shape) != shape or out.dtype != dtype:
        raise ValueError(f"{name}: the program holds {tuple(out.shape)} {out.dtype}, "
                         f"the benchmark draws {shape} {dtype}")
    gen = torch.Generator(device=out.device).manual_seed(param_seed(seed, name))
    mean, std = _mean_std(name, shape, norm)
    return out.normal_(mean, std, generator=gen)

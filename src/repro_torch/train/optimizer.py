"""Optimizers, port of ``repro.train.optimizer``: AdamW (no ``torch.optim``).

The reference's optimizers are pure pytree -> pytree functions.  Here the
trees are dicts of tensors keyed like the model's state dict, and the update
runs under ``torch.no_grad()`` and writes the parameters and moments in place
(the state of a 1.3 B-parameter model would otherwise be held twice), in the
reference's arithmetic order, and returns them.  The state keeps the
reference's layout, ``{"m", "v", "step"}`` with ``step`` an int32 scalar
tensor, so a checkpoint carries the same names in either package.

- **adamw**: fp32 moments, decoupled weight decay on the leaves the
  reference decays, with the warmup-cosine (or linear, or constant) schedule
  of :func:`lr_at`.
- **adafactor** and **adamw8bit** are not ported yet (ROADMAP Queue 1
  item 9); :func:`make_optimizer` refuses them.

The reference decays every leaf of two or more dims of *its* tree, where a
scanned superblock's layers are stacked on a leading dim: so the vectors of
those layers (norm scales, ``A_log``, ``dt_bias``, ``D_skip``, ``conv_b``,
``lam``) are decayed, and those of the unscanned tail layers and the final
norm are not.  :func:`reference_decay` names the same leaves in a port state
dict, and the train step passes them to the update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import (Any, Callable, Container, Dict, FrozenSet, Mapping,
                    Optional, Tuple)

import torch

from ..weights import jax_layout

__all__ = ["OptimizerConfig", "make_optimizer", "global_norm", "clip_by_norm",
           "lr_at", "reference_decay"]

Tree = Dict[str, Any]


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | adafactor | adamw8bit
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    factored_min_dim: int = 128
    # schedules
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_ratio: float = 0.1
    # 8-bit
    quant_block: int = 256


def _f32(value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``, an fp32 scalar computed in fp32 on the
    host, as the reference computes it in fp32 on its device."""
    step = step.detach().to("cpu", torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = _f32(1.0)
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * t))
        else:
            decay = 1.0 - (1 - cfg.min_lr_ratio) * t
    return cfg.lr * warm * decay


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in fp32."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree.values()))


@torch.no_grad()
def clip_by_norm(tree: Dict[str, torch.Tensor], max_norm: float
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm), in place; returns
    (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree.values():
        g.copy_(g.float() * scale)
    return tree, norm


def reference_decay(params: Mapping[str, torch.Tensor], period: int) -> FrozenSet[str]:
    """The names of the leaves that the reference decays: those stacked on
    its repeat dim (``period`` is ``len(cfg.pattern)``) and those of two or
    more dims."""
    out = set()
    for names in jax_layout(params, period).values():
        if isinstance(names, list):
            out.update(names)
        elif params[names].dim() >= 2:
            out.add(names)
    return frozenset(out)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw_init(params: Mapping[str, torch.Tensor]) -> Tree:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(params.values())).device if params else "cpu"
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def _adamw_update(cfg: OptimizerConfig, grads: Mapping[str, torch.Tensor],
                  state: Tree, params: Dict[str, torch.Tensor],
                  decay: Optional[Container[str]] = None):
    """One step, in place.  ``decay`` names the leaves that get weight decay
    (:func:`reference_decay`); by default those of two or more dims."""
    step = state["step"] + 1
    lr = lr_at(cfg, step).item()
    # fp32 scalars, as the reference's: exact in the kernels' fp32 arithmetic
    step_f = step.to("cpu", torch.float32)
    bc1 = (1 - cfg.b1 ** step_f).item()
    bc2 = (1 - cfg.b2 ** step_f).item()
    for k, p in params.items():
        gf = grads[k].float()
        m, v = state["m"][k], state["v"][k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * gf * gf)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if (p.dim() >= 2) if decay is None else (k in decay):  # decoupled
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


@dataclass
class Optimizer:
    cfg: OptimizerConfig
    init: Callable[[Mapping[str, torch.Tensor]], Tree]
    update: Callable[[Mapping, Tree, Dict], Tuple[Dict, Tree]]


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return Optimizer(cfg, _adamw_init, partial(_adamw_update, cfg))
    if cfg.name in ("adafactor", "adamw8bit"):
        raise NotImplementedError(
            f"optimizer {cfg.name!r} is not ported yet: ROADMAP Queue 1 item 9 "
            "(remaining optimizers)")
    raise ValueError(f"unknown optimizer {cfg.name!r}")

"""Optimizers, port of ``repro.train.optimizer``: AdamW, Adafactor and
8-bit-state AdamW (no ``torch.optim``).

The reference's optimizers are pure pytree -> pytree functions.  Here the
trees are dicts of tensors keyed like the model's state dict, and the update
runs under ``torch.no_grad()`` and writes the parameters and the state in
place (the state of a 9 B-parameter model would otherwise be held twice), in
the reference's arithmetic order, and returns them.

- **adamw**: fp32 moments, decoupled weight decay on the leaves the
  reference decays, with the warmup-cosine (or linear, or constant) schedule
  of :func:`lr_at`.  State ``{"m", "v", "step"}``, ``m`` and ``v`` keyed like
  the params.
- **adafactor**: factored second moment (row and column statistics), no
  momentum, the update clipped to RMS 1.  State ``{"v": {path: {"vr", "vc"}
  or {"v"}}, "step"}``.
- **adamw8bit**: moments quantized to int8 in blocks of ``quant_block`` with
  an fp32 absmax scale a block.  State ``{"m": {path: {"q", "scale"}},
  "v": {...}, "step"}``, ``q`` (n_blocks, quant_block) int8 and ``scale``
  (n_blocks, 1) fp32.

The reference's tree stacks a scanned superblock's layers on a leading
repeat dim, and three of its rules read the stacked leaf, not the layer:

- weight decay goes to leaves of two or more dims, so every vector of a
  scanned layer is decayed and the same vector of a tail layer is not
  (:func:`reference_decay` names them; every optimizer here follows it);
- Adafactor's update clip ``rms = sqrt(mean(delta**2))`` is taken over the
  whole stacked leaf, all its layers together, and ``_factored`` decides on
  the stacked shape's last two dims;
- 8-bit AdamW flattens the stacked leaf and cuts it into blocks, so where a
  layer's size is not a multiple of the block, blocks span layers.

So Adafactor's and 8-bit AdamW's state is kept per reference leaf, keyed by
the reference's path (:func:`repro_torch.weights.jax_layout`, ``period`` is
``len(cfg.pattern)``) and shaped as the reference's (the layers stacked, or
quantized over the layers concatenated in the reference's order): the
moments then equal the reference's, and a checkpoint carries the reference's
record names (``opt/v/<path>/vr``, ``opt/m/<path>/q``, ...) in either package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import (Any, Callable, Container, Dict, FrozenSet, List, Mapping,
                    Optional, Sequence, Tuple)

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
    """sqrt of the sum over leaves of the sum of squares, in fp32.  DTensor
    leaves sum their local squares per layout (one partial sum for the
    leaves laid out alike, all-reduced once over the mesh dims that split
    them), so that no reduction is left to DTensor's choice."""
    from ..kernels._local import is_dtensor

    plain = [x for x in tree.values() if not is_dtensor(x)]
    total = sum(torch.sum(x.float() ** 2) for x in plain)
    groups: Dict = {}
    for x in tree.values():
        if is_dtensor(x):
            key = (x.device_mesh, tuple(pl.is_shard() for pl in x.placements))
            local = torch.sum(x.to_local().float() ** 2)
            groups[key] = groups[key] + local if key in groups else local
    if groups:
        from torch.distributed.tensor import DTensor, Partial, Replicate
    for (mesh, split), local in groups.items():
        part = DTensor.from_local(local, mesh, [Partial() if s else Replicate()
                                                for s in split], run_check=False)
        total = total + part.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    return torch.sqrt(total)


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
# The reference's leaves
# ---------------------------------------------------------------------------


def _ref_leaves(params: Mapping[str, torch.Tensor], period: int
                ) -> List[Tuple[str, List[str], Tuple[int, ...]]]:
    """(reference path, the port names it stacks in order, its shape in the
    reference's tree) for every leaf; an unstacked leaf has one name and its
    own shape."""
    out = []
    for path, names in jax_layout(params, period).items():
        if isinstance(names, list):
            out.append((path, names, (len(names),) + tuple(params[names[0]].shape)))
        else:
            out.append((path, [names], tuple(params[names].shape)))
    return out


def _decayed(names: Sequence[str], shape: Tuple[int, ...],
             decay: Optional[Container[str]]) -> bool:
    return len(shape) >= 2 if decay is None else names[0] in decay


def _step_scalars(cfg: OptimizerConfig, state: Tree):
    """(step + 1, its learning rate, the bias corrections 1 - b^step), fp32
    on the host as the reference's."""
    step = state["step"] + 1
    step_f = step.to("cpu", torch.float32)
    return (step, lr_at(cfg, step).item(), (1 - cfg.b1 ** step_f).item(),
            (1 - cfg.b2 ** step_f).item())


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, momentum-free)
# ---------------------------------------------------------------------------


def _factored(shape: Tuple[int, ...], min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _adafactor_factored(shape: Tuple[int, ...], layer_shape: Tuple[int, ...],
                        path: str, min_dim: int) -> bool:
    """The reference decides on its (stacked) shape; the port computes per
    layer, which is the same only where the layer's shape decides alike."""
    factored = _factored(shape, min_dim)
    if factored != _factored(layer_shape, min_dim):
        raise ValueError(
            f"{path}: Adafactor factors the stacked leaf {shape} but not one "
            f"layer of it {layer_shape} (a repeat count >= factored_min_dim "
            f"{min_dim}); the port's per-layer update cannot follow it")
    return factored


def _adafactor_init(params: Mapping[str, torch.Tensor], cfg: OptimizerConfig,
                    period: int = 1) -> Tree:
    v: Tree = {}
    for path, names, shape in _ref_leaves(params, period):
        device = params[names[0]].device
        if _adafactor_factored(shape, tuple(params[names[0]].shape), path,
                               cfg.factored_min_dim):
            v[path] = {"vr": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                         device=device)}
        else:
            v[path] = {"v": torch.zeros(shape, dtype=torch.float32, device=device)}
    device = next(iter(params.values())).device if params else "cpu"
    return {"v": v, "step": torch.zeros((), dtype=torch.int32, device=device)}


def _adafactor_delta(gf: torch.Tensor, v: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The preconditioned update of one layer from its (updated) state."""
    if "vr" in v:
        r = v["vr"] / torch.clamp(v["vr"].mean(dim=-1, keepdim=True), min=1e-30)
        precond = r[..., None] * v["vc"][..., None, :]
        return gf * torch.rsqrt(precond + 1e-30)
    return gf * torch.rsqrt(v["v"] + 1e-30)


@torch.no_grad()
def _adafactor_update(cfg: OptimizerConfig, period: int,
                      grads: Mapping[str, torch.Tensor], state: Tree,
                      params: Dict[str, torch.Tensor],
                      decay: Optional[Container[str]] = None):
    """One step, in place.  The clip's RMS runs over every layer of a
    reference leaf, so each layer's update is computed twice: once to update
    the state and sum its squares, once more, from the updated state, to
    apply it (holding them all would cost a stacked fp32 leaf)."""
    step, lr, _, _ = _step_scalars(cfg, state)
    rho_t = 1.0 - (step.to("cpu", torch.float32) + 1.0) ** -0.8
    rho, one_minus = rho_t.item(), (1 - rho_t).item()
    for path, names, shape in _ref_leaves(params, period):
        v = state["v"][path]
        stacked = len(names) > 1 or shape != tuple(params[names[0]].shape)

        def layer_state(i):
            return {k: (t[i] if stacked else t) for k, t in v.items()}

        sq = 0.0
        for i, name in enumerate(names):
            gf = grads[name].float()
            g2 = gf * gf + 1e-30
            s = layer_state(i)
            if "vr" in s:
                s["vr"].copy_(rho * s["vr"] + one_minus * g2.mean(dim=-1))
                s["vc"].copy_(rho * s["vc"] + one_minus * g2.mean(dim=-2))
            else:
                s["v"].copy_(rho * s["v"] + one_minus * g2)
            delta = _adafactor_delta(gf, s)
            sq = sq + torch.sum(delta * delta)
            del gf, g2, delta
        n = math.prod(shape)
        rms = torch.sqrt(sq / n + 1e-30)
        clip = torch.clamp(rms, min=1.0)
        decayed = _decayed(names, shape, decay)
        for i, name in enumerate(names):
            p = params[name]
            delta = _adafactor_delta(grads[name].float(), layer_state(i)) / clip
            if decayed:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return params, {"v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# AdamW with int8 block-quantized moments
# ---------------------------------------------------------------------------


def _quant(x: torch.Tensor, block: int) -> Dict[str, torch.Tensor]:
    """The reference's ``_quant``: x flattened, padded once to a whole
    block, an absmax scale a block, rounded half to even into [-127, 127]."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequant(d: Mapping[str, torch.Tensor], n: int) -> torch.Tensor:
    """The first ``n`` values of a quantized tensor, flat, in fp32."""
    return (d["q"].float() * d["scale"]).reshape(-1)[:n]


def _adamw8_init(params: Mapping[str, torch.Tensor], cfg: OptimizerConfig,
                 period: int = 1) -> Tree:
    """Zero moments, as the reference's ``_quant`` of zeros gives them: q 0
    and every scale the 1e-12 floor (built directly, without the stacked
    fp32 zeros)."""
    def zeros(shape, device):
        n_blocks = -(-math.prod(shape) // cfg.quant_block)
        return {"q": torch.zeros((n_blocks, cfg.quant_block), dtype=torch.int8,
                                 device=device),
                "scale": torch.full((n_blocks, 1), 1e-12, dtype=torch.float32,
                                    device=device)}

    m: Tree = {}
    v: Tree = {}
    for path, names, shape in _ref_leaves(params, period):
        device = params[names[0]].device
        m[path], v[path] = zeros(shape, device), zeros(shape, device)
    device = next(iter(params.values())).device if params else "cpu"
    return {"m": m, "v": v, "step": torch.zeros((), dtype=torch.int32, device=device)}


def _quant_groups(names: Sequence[str], layer_numel: int, block: int
                  ) -> List[Tuple[List[str], slice]]:
    """The layers of a reference leaf that are quantized together, each
    group with its rows of blocks: one layer a group where a layer fills
    whole blocks, else the whole leaf (its blocks span layers)."""
    if layer_numel % block == 0:
        nb = layer_numel // block
        return [([n], slice(i * nb, (i + 1) * nb)) for i, n in enumerate(names)]
    return [(list(names), slice(None))]


# A layer's update runs over at most this many blocks at a time (64 MiB of
# fp32 a temporary at blocks of 256): blocks are independent, and a whole
# 0.9 G-element embedding at once would need ~20 GB of temporaries.
_CHUNK_BLOCKS = 1 << 16


def _adamw8_apply(cfg: OptimizerConfig, lr: float, bc1: float, bc2: float,
                  decayed: bool, gf: torch.Tensor, pf: torch.Tensor,
                  mq: Dict[str, torch.Tensor], vq: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """The update of the flat fp32 params ``pf`` (grads ``gf``) whose
    moments are the blocks ``mq``/``vq``; quantizes the new moments into
    them and returns the new params, in fp32."""
    n = gf.numel()
    m = cfg.b1 * _dequant(mq, n) + (1 - cfg.b1) * gf
    v = cfg.b2 * _dequant(vq, n) + (1 - cfg.b2) * gf * gf
    v = torch.clamp(v, min=0.0)
    delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    if decayed:
        delta = delta + cfg.weight_decay * pf
    for dst, x in ((mq, m), (vq, v)):
        new = _quant(x, cfg.quant_block)
        dst["q"].copy_(new["q"])
        dst["scale"].copy_(new["scale"])
    return pf - lr * delta


@torch.no_grad()
def _adamw8_update(cfg: OptimizerConfig, period: int,
                   grads: Mapping[str, torch.Tensor], state: Tree,
                   params: Dict[str, torch.Tensor],
                   decay: Optional[Container[str]] = None):
    """One step, in place: the moments are dequantized, updated in fp32 and
    quantized again over the reference's blocks."""
    step, lr, bc1, bc2 = _step_scalars(cfg, state)
    block = cfg.quant_block
    for path, names, shape in _ref_leaves(params, period):
        decayed = _decayed(names, shape, decay)
        layer_numel = params[names[0]].numel()
        for group, rows in _quant_groups(names, layer_numel, block):
            mq = {k: t[rows] for k, t in state["m"][path].items()}
            vq = {k: t[rows] for k, t in state["v"][path].items()}
            if len(group) > 1:            # blocks span layers: the whole leaf
                gf = torch.cat([grads[k].float().reshape(-1) for k in group])
                pf = torch.cat([params[k].float().reshape(-1) for k in group])
                new = _adamw8_apply(cfg, lr, bc1, bc2, decayed, gf, pf, mq, vq)
                for j, k in enumerate(group):
                    params[k].copy_(new[j * layer_numel:(j + 1) * layer_numel]
                                    .reshape(params[k].shape))
                continue
            p, g = params[group[0]].view(-1), grads[group[0]].reshape(-1)
            for b0 in range(0, mq["q"].shape[0], _CHUNK_BLOCKS):
                b1 = min(b0 + _CHUNK_BLOCKS, mq["q"].shape[0])
                lo, hi = b0 * block, min(b1 * block, layer_numel)
                chunk = slice(b0, b1)
                p[lo:hi].copy_(_adamw8_apply(
                    cfg, lr, bc1, bc2, decayed, g[lo:hi].float(), p[lo:hi].float(),
                    {k: t[chunk] for k, t in mq.items()},
                    {k: t[chunk] for k, t in vq.items()}))
    return params, {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


@dataclass
class Optimizer:
    cfg: OptimizerConfig
    init: Callable[[Mapping[str, torch.Tensor]], Tree]
    update: Callable[[Mapping, Tree, Dict], Tuple[Dict, Tree]]


def make_optimizer(cfg: OptimizerConfig, period: int = 1) -> Optimizer:
    """``period`` is the model's superblock length, ``len(cfg.pattern)``:
    Adafactor and 8-bit AdamW keep their state per leaf of the reference's
    stacked tree (AdamW's does not depend on it)."""
    if cfg.name == "adamw":
        return Optimizer(cfg, _adamw_init, partial(_adamw_update, cfg))
    if cfg.name == "adafactor":
        return Optimizer(cfg, partial(_adafactor_init, cfg=cfg, period=period),
                         partial(_adafactor_update, cfg, period))
    if cfg.name == "adamw8bit":
        return Optimizer(cfg, partial(_adamw8_init, cfg=cfg, period=period),
                         partial(_adamw8_update, cfg, period))
    raise ValueError(f"unknown optimizer {cfg.name!r}")

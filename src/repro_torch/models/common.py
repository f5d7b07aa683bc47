"""Shared model building blocks: runtime knobs, init helpers, norms.

Port of ``repro.models.common``.  Parameters are ``nn.Parameter``s held in
``nn.ParameterDict``s with the JAX package's key names and ``(d_in, d_out)``
orientation; the apply functions are plain functions on tensors, as in the
reference.  A model built on the ``meta`` device holds shapes and dtypes
only (the counterpart of the reference's ``init_abstract``): the sharding
rules read full-size shapes from it without memory.

A model whose parameters :func:`repro_torch.train.sharding.shard_model` made
DTensors runs sharded: each layer takes its parameters through
:func:`on_use`, which gathers their FSDP shards where the layer's input
splits its batch over the FSDP mesh dims, and keeps them where it does not
(one row, say: a :class:`Kept` weight); its matmuls go through
:func:`linear`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._local import is_dtensor, one_row, rows_split

__all__ = ["RuntimeConfig", "Initializer", "resolve_device", "rmsnorm",
           "layernorm", "norm_init", "norm_apply", "dense_init", "dense_apply",
           "mlp_init", "mlp_apply", "apply_rope", "softcap", "on_use", "Kept", "weight",
           "keep_layout",
           "linear", "sharded_matmul", "gather"]


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

    def residual(self, x, y):
        """x + y on the residual stream: both laid out as :meth:`hidden`
        lays it out first (a partial sum reduced before the add, which
        torch versions plan differently), and the sum too."""
        return self.hidden(self.hidden(x) + self.hidden(y))

    def logits_constraint(self, x):
        return self.act_sharding.logits(x) if self.act_sharding else x

    def heads_constraint(self, x):
        if self.act_sharding and self.constrain_attn_heads:
            return self.act_sharding.heads(x)
        return x

    def seq_constraint(self, x):
        if self.act_sharding and self.constrain_attn_heads:
            return self.act_sharding.attn_seq(x)
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


# A parameter of more elements is drawn a slice of its first dim at a time,
# so that the draw's fp32 transients (the draw, and torch's trunc_normal_'s
# own temporaries of its size) stay near 4 GiB: arctic-480b's bf16 expert
# stack (4.46e9 elements, 8.9 GB) drawn whole needs several 17.8 GB of them.
DRAW_ELEMENTS = 1 << 30


class Initializer:
    """Deterministic param init (truncated normal on [-2, 2] x scale).  On
    the ``meta`` device it draws nothing: the parameters are shapes and
    dtypes only.  A parameter over ``DRAW_ELEMENTS`` is drawn in slices of
    its first dim, in order."""

    def __init__(self, seed: int, device: Union[str, torch.device]):
        self.device = resolve_device(device)
        self.generator = (None if self.device.type == "meta" else
                          torch.Generator(device=self.device).manual_seed(seed))

    def normal(self, shape, scale: float, dtype: torch.dtype) -> nn.Parameter:
        if self.generator is None:
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=self.device))
        shape = tuple(shape)
        per_row = math.prod(shape[1:])
        if per_row * shape[0] <= DRAW_ELEMENTS:
            return nn.Parameter(self._draw(shape, scale).to(dtype))
        out = torch.empty(shape, dtype=dtype, device=self.device)
        step = max(1, DRAW_ELEMENTS // per_row)
        for r0 in range(0, shape[0], step):
            out[r0:r0 + step] = self._draw((min(step, shape[0] - r0),) + shape[1:], scale)
        return nn.Parameter(out)

    def _draw(self, shape, scale: float) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.generator)
        return t.mul_(scale)

    def zeros(self, shape, dtype: torch.dtype) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=dtype, device=self.device))

    def ones(self, shape, dtype: torch.dtype) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, dtype=dtype, device=self.device))


class Kept(NamedTuple):
    """A 2-d weight that :func:`on_use` left sharded on the FSDP mesh dims
    ``dims``, where the layer's input is whole: :func:`linear` moves the
    activation instead of the weight.  ``.T`` is the weight transposed (a
    tied embedding's logits), kept on the same mesh dims."""
    w: torch.Tensor
    dims: Tuple[int, ...]

    @property
    def T(self) -> "Kept":
        return Kept(self.w.T, self.dims)


def on_use(p, x=None):
    """Parameters as a layer's matmuls use them.  A sharded parameter (a
    DTensor that ``shard_model`` gave an ``on_use`` layout: its spec with
    the FSDP axes dropped) is redistributed to that layout, so its FSDP
    shards are gathered on use and its gradient is reduce-scattered back; a
    module of such parameters comes back as nested dicts of them.  Plain
    parameters and modules come back as they are.

    ``x`` is the activation the layer takes.  On a mesh dim where ``x`` is
    whole (its batch is not split there: a step of one row), every rank
    would run the same whole product of a gathered weight; a 2-d weight
    keeps its FSDP shard on such a dim instead, as the reference's GSPMD
    keeps it, and at one token a row wherever the activation is the smaller
    (:func:`_fsdp_kept`).  It comes back as a :class:`Kept` for
    :func:`linear`, which moves the activation (:func:`weight` gives its
    tensor to other ops)."""
    if isinstance(p, torch.Tensor):
        layout = getattr(p, "on_use", None)
        if layout is None:
            return p
        kept = _fsdp_kept(p, layout, x)
        if kept:
            layout = [p.placements[i] if i in kept else pl for i, pl in enumerate(layout)]
        if torch.is_inference_mode_enabled():
            # (prefill and decode) a redistribute of a parameter that requires
            # grad detaches its result in place there, and torch 2.11's
            # DTensor has no sharding strategy for aten.detach_
            with torch.inference_mode(False):
                p = p.detach()
        w = gather(p, layout)
        return Kept(w, kept) if kept else w
    first = next(p.parameters(), None)
    if getattr(first, "on_use", None) is None:
        return p
    return {k: on_use(v, x) for k, v in p.items()}


def gather(p, layout):
    """The DTensor ``p`` redistributed to ``layout``, its gradient
    reduce-scattered onto p's shards first where it comes as a partial sum
    on the mesh dims that ``layout`` gathers (:class:`_ShardGradFirst`); a
    ``p`` that requires grad and is laid out so, itself (a redistribute to
    its own layout would make such a gradient whole, all-reduced, before
    that reduce-scatter)."""
    if p.requires_grad and tuple(p.placements) == tuple(layout):
        return p
    w = p.redistribute(p.device_mesh, layout)
    if not w.requires_grad:
        return w
    return _ShardGradFirst.apply(w, {i: pl for i, (pl, use) in
                                     enumerate(zip(p.placements, layout))
                                     if pl.is_shard() and not use.is_shard()})


class _ShardGradFirst(torch.autograd.Function):
    """The identity on a gathered weight, whose gradient is reduce-scattered
    onto the weight's FSDP shards (``shards``: mesh dim -> placement) where
    it comes as a partial sum there, before the gather's own backward
    reduces the rest: a partial sum over a mesh dim the weight is whole on
    (the multi-pod mesh's "pod") is then all-reduced on the shard, not on
    the whole gradient, whose order DTensor's planner would otherwise
    choose."""

    @staticmethod
    def forward(ctx, w, shards):
        ctx.shards = shards
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        pl = [ctx.shards.get(i, q) if q.is_partial() else q
              for i, q in enumerate(g.placements)]
        return g.redistribute(g.device_mesh, pl), None


def _fsdp_kept(p, layout, x) -> tuple:
    """The mesh dims on which the parameter ``p`` is sharded, its use layout
    is not (an FSDP dim) and the shard is kept rather than gathered.  A 2-d
    weight keeps it where ``x`` is whole, and at one token a row
    (:func:`~repro_torch.kernels._local.one_row`, decode) where the
    activations that move instead (the batch's rows by p's two dims, in
    and out) hold fewer elements than p.  An expert stack (3-d) keeps it
    at one token a row under the same count (one expert's dims): split on
    its experts, always (expert-parallel decode, ``models/moe.py``), and
    split on d_model where x's batch is not split (the one-row residual
    stream, :meth:`~repro_torch.train.sharding.ActivationSharding.hidden`)."""
    if p.dim() not in (2, 3) or not is_dtensor(x):
        return ()
    d_in, d_out = p.shape[-2:]
    small = one_row(x) and x.shape[0] * (d_in + d_out) < d_in * d_out

    def keep(pl, xpl):
        if p.dim() == 2:
            return small or xpl.is_replicate()
        return small and (pl.is_shard(0) or not xpl.is_shard(0))

    return tuple(i for i, (pl, use, xpl) in enumerate(zip(p.placements, layout,
                                                          x.placements))
                 if pl.is_shard() and not use.is_shard() and keep(pl, xpl))


def weight(w) -> torch.Tensor:
    """The tensor of a weight as :func:`on_use` gave it (a :class:`Kept`
    one's still sharded on its kept mesh dims)."""
    return w.w if isinstance(w, Kept) else w


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` in x's dtype; a :class:`Kept` weight through
    :func:`sharded_matmul`.  Where ``x`` is split on its sequence
    (sequence parallelism, ``kernels/_local.py::rows_split``), each rank
    multiplies its own rows by ``w`` gathered on those mesh dims (cast to
    x's dtype first under no grad), rather than moving the activation to
    the weight's split and summing partial products."""
    if isinstance(w, Kept):
        return sharded_matmul(x, w.w.to(x.dtype), w.dims)
    rows = rows_split(x) if is_dtensor(w) else ()
    if not rows:
        return x @ w.to(x.dtype)
    if any(w.placements[i].is_shard() for i in rows):
        from torch.distributed.tensor import Replicate

        if not torch.is_grad_enabled():
            w = w.to(x.dtype)
        w = w.redistribute(w.device_mesh, [Replicate() if i in rows else pl
                                           for i, pl in enumerate(w.placements)])
    return sharded_matmul(x, w.to(x.dtype))


def sharded_matmul(x: torch.Tensor, w: torch.Tensor, kept: Tuple[int, ...] = ()
                   ) -> torch.Tensor:
    """``x @ w`` for DTensors, run per shard with every layout pinned, so
    that none is left to DTensor's choice (whose matmul flattens the batch
    and sequence dims, and so moves an x split on its sequence): x's last
    dim laid out as w's first (a slice where x is whole and w's first dim is
    sharded, an all-to-all where x is split on its batch there, a gather
    where x's last dim is sharded and w's first is not), x whole where w's
    second dim is sharded, w as it is; the product a partial sum where w's
    first dim is sharded, split on its last dim where w's second is, else
    laid out as x.  On the mesh dims ``kept`` (a weight that kept its FSDP
    shard, :func:`on_use`) the product comes back in x's layout where x was
    split on its batch (a reduce-scatter or an all-to-all), whole where it
    is a partial sum, and split on its last dim where it is (the one-row
    residual stream's layout).  The gradients come back in the inputs'
    layouts: x's a partial sum where w's second dim is sharded, w's where x
    is split on a dim the product keeps (its batch or rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..train.sharding import pin

    last = x.dim() - 1
    given = x.placements
    x = pin(x, [Shard(last) if wp.is_shard(0) else
                (Replicate() if wp.is_shard(1) or xp.is_shard(last) else xp)
                for xp, wp in zip(x.placements, w.placements)])
    y_pl, x_grad, w_grad = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        y_pl.append(Partial() if wp.is_shard(0) else (Shard(last) if wp.is_shard(1) else xp))
        x_grad.append(Partial() if wp.is_shard(1) else xp)
        w_grad.append(wp if wp.is_shard() else (Partial() if xp.is_shard() else Replicate()))
    y = local_map(torch.matmul, out_placements=y_pl,
                  in_placements=(list(x.placements), list(w.placements)),
                  in_grad_placements=(x_grad, w_grad), device_mesh=x.device_mesh,
                  redistribute_inputs=True)(x, w)
    if not kept:
        return y
    return pin(y, [pl if i not in kept else given[i] if given[i].is_shard(0) else
                   Replicate() if pl.is_partial() else pl
                   for i, pl in enumerate(y.placements)])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(ini: Initializer, d: int, kind: str, dtype) -> nn.ParameterDict:
    if kind == "rmsnorm":
        return nn.ParameterDict({"scale": ini.zeros((d,), dtype)})  # (1+scale)
    return nn.ParameterDict({"scale": ini.ones((d,), dtype),
                             "bias": ini.zeros((d,), dtype)})


def keep_layout(x: torch.Tensor, t: torch.Tensor, stat: bool = False) -> torch.Tensor:
    """``t`` pinned to the DTensor ``x``'s layout, its gradient too (a
    statistic over x's last dim without that dim's split, and whole where x
    is a partial sum): a norm's layouts, forward and backward, are not left
    to DTensor's choice, which differs between torch versions.  Plain
    tensors pass as they are."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import Replicate

    from ..train.sharding import pin

    last = x.dim() - 1
    return pin(t, [Replicate() if (stat and pl.is_shard(last)) or pl.is_partial() else pl
                   for pl in x.placements])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = keep_layout(x, torch.mean(xf * xf, dim=-1, keepdim=True), stat=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return keep_layout(x, (y * (1.0 + scale.float())).to(x.dtype))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
              ) -> torch.Tensor:
    xf = x.float()
    mean = keep_layout(x, torch.mean(xf, dim=-1, keepdim=True), stat=True)
    var = keep_layout(x, torch.var(xf, dim=-1, keepdim=True, correction=0), stat=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-6)
    return keep_layout(x, (y * scale.float() + bias.float()).to(x.dtype))


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
    y = linear(x, p["w"])
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
    h = linear(x, p["wi"])
    g = linear(x, p["wg"])
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return linear(h * g, p["wo"])


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

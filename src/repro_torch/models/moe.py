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

``moe_apply_shardmap`` is expert parallelism with explicit collectives on
the "data"/"model" sub-meshes of ``rt.act_sharding.rules.mesh``, the
reference's ``shard_map`` version, as ``torch.distributed`` all-to-alls.

Sharded (DTensor) runs: ``moe_apply`` and ``moe_decode`` run per shard
(:func:`repro_torch.kernels._local.per_shard`), tokens on the batch's mesh
dims and the experts' d_ff over the others where it divides, each rank's
output a partial sum there (tensor-parallel experts); ``moe_apply`` raises
where a shard's token groups would not be the global batch's.
``moe_apply_shardmap`` takes each rank's rows and its experts' weights (the
expert axis of their ``on_use`` layout) as local tensors and gives their
gradients back as partial sums over the mesh dims that split the tokens.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels._local import is_dtensor, per_shard, shard_layout
from .common import Initializer, RuntimeConfig

__all__ = ["moe_init", "moe_apply", "moe_apply_shardmap", "moe_decode",
           "moe_groups"]


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


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balancing loss over the groups routed here."""
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    return E * torch.sum(me * ce)


def _dispatch_combine(gate: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """(dispatch, combine), each (G, g, E, C) fp32: one-hots with
    per-expert positions.  A position past the capacity matches no slot
    (jax.nn.one_hot's zero row: the drop)."""
    G, g, K = idx.shape
    slots = torch.arange(C, device=idx.device)
    counts = torch.zeros((G, 1, E), dtype=torch.float32, device=idx.device)
    dispatch = torch.zeros((G, g, E, C), dtype=torch.float32, device=idx.device)
    combine = torch.zeros((G, g, E, C), dtype=torch.float32, device=idx.device)
    for k_i in range(K):
        oh = F.one_hot(idx[..., k_i], E).float()               # (G, g, E)
        pos = torch.cumsum(oh, dim=1) - oh + counts            # (G, g, E)
        keep = (pos < C).float() * oh
        slot = (pos.long()[..., None] == slots).float()        # (G, g, E, C)
        disp_k = keep[..., None] * slot
        dispatch = dispatch + disp_k
        combine = combine + disp_k * gate[..., k_i][..., None, None]
        counts = counts + oh.sum(dim=1, keepdim=True)
    return dispatch, combine


_TOKENS = ("batch", None, None)                  # x, y: (B, S, D)
_W_IN = (None, None, "heads")                   # wi, wg: (E, D, F)
_W_OUT = (None, "heads", None)                  # wo: (E, F, D)


def _moe_per_shard(fn, p, x: torch.Tensor, cfg: ModelConfig, with_aux: bool):
    """``fn(p, x)`` per shard (see the module docstring); the aux loss, the
    mean over each shard's groups, becomes the mean over the shards."""
    _, layout = shard_layout(x, _TOKENS, (cfg.moe_d_ff,))
    n = 1
    for i, role in enumerate(layout):
        n *= x.device_mesh.size(i) if role == "batch" else 1

    def local(x, router, wi, wg, wo):
        out = fn({"router": router, "wi": wi, "wg": wg, "wo": wo}, x)
        return (out[0], out[1] / n) if with_aux else out

    args = (x, p["router"], p["wi"], p["wg"], p["wo"])
    roles = (_TOKENS, (None, None), _W_IN, _W_IN, _W_OUT)
    if with_aux:
        return per_shard(local, args, roles, [_TOKENS, ()], heads=(cfg.moe_d_ff,),
                         partial_over=[("heads",), ("batch",)])
    return per_shard(local, args, roles, _TOKENS, heads=(cfg.moe_d_ff,),
                     partial_over=[("heads",)])


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Capacity-based dispatch."""
    if is_dtensor(x):
        n_local = x.shape[0] * x.shape[1]
        for i, pl in enumerate(x.placements):
            n_local //= x.device_mesh.size(i) if pl.is_shard(0) else 1
        if moe_groups(n_local, cfg, rt)[1] != moe_groups(x.shape[0] * x.shape[1], cfg, rt)[1]:
            raise ValueError(
                f"a shard's {n_local} tokens group otherwise than the batch's "
                f"{x.shape[0] * x.shape[1]} (moe_group_size {rt.moe_group_size})")
        return _moe_per_shard(lambda q, y: moe_apply(q, y, cfg, rt), p, x, cfg, True)
    B, S, D = x.shape
    E = cfg.n_experts
    G, g, C = moe_groups(B * S, cfg, rt)
    xg = x.reshape(G, g, D)
    gate, idx, probs = _route(p, xg, cfg)                      # (G, g, K)
    aux = _aux_loss(probs, idx, E)
    dispatch, combine = _dispatch_combine(gate, idx, E, C)

    cd = x.dtype
    xd = torch.einsum("gtec,gtd->gecd", dispatch.to(cd), xg)   # (G, E, C, D)
    xd = rt.moe_constraint(xd)          # -> expert-major (all-to-all under EP)
    h = torch.einsum("gecd,edf->gecf", xd, p["wi"].to(cd))
    gt = torch.einsum("gecd,edf->gecf", xd, p["wg"].to(cd))
    h = h * F.silu(gt)
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"].to(cd))
    ye = rt.moe_constraint(ye)          # stay expert-major until combine
    y = torch.einsum("gtec,gecd->gtd", combine.to(cd), ye)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Expert parallelism with explicit collectives
# ---------------------------------------------------------------------------


class _SplitOver(torch.autograd.Function):
    """x, the same on every rank of ``group``, -> this rank's ``1/n`` of its
    dim 0.  Backward all-gathers the pieces' gradients, so that each rank
    holds the gradient of the whole replicated x."""

    @staticmethod
    def forward(ctx, x, group, n: int, i: int):
        ctx.group, ctx.n = group, n
        return torch.chunk(x, n, dim=0)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(ctx.n)]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, dim=0), None, None, None


class _GatherOver(torch.autograd.Function):
    """This rank's piece -> the pieces of every rank of ``group`` along dim
    0, the same on each rank.  Each rank goes on with the same result (and
    gets the same gradient of it), so backward keeps its own piece's
    gradient."""

    @staticmethod
    def forward(ctx, x, group, n: int, i: int):
        ctx.n, ctx.i = n, i
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        return torch.chunk(g, ctx.n, dim=0)[ctx.i].contiguous(), None, None, None


class _MeanOver(torch.autograd.Function):
    """The mean of ``x`` over the ranks of ``group`` (the reference's
    ``pmean``); each rank's value contributes 1/n of the replicated result."""

    @staticmethod
    def forward(ctx, x, group, n: int):
        ctx.n = n
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _AllToAll(torch.autograd.Function):
    """Chunk j of dim 0 to rank j of ``group``; chunk i of the result from
    rank i.  With equal chunks the exchange is its own inverse, so backward
    sends each gradient chunk back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, group=group)
    return out


def _shardmap_dtensor(p, x, cfg: ModelConfig, rt: RuntimeConfig):
    """``moe_apply_shardmap`` on DTensors: x's rows on the batch axes and
    the experts on the expert axis, as local tensors (see the module
    docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    rules = rt.act_sharding.rules
    mesh = rules.mesh
    names = mesh.mesh_dim_names
    b_axes = rules.batch_spec_axes(x.shape[0]) or ()
    x_pl = tuple(Shard(0) if a in b_axes else Replicate() for a in names)
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=x_pl)
    tp = rules.tp_axis
    n_tp = rules.size(tp) if tp else 1
    G = moe_groups(xl.shape[0] * xl.shape[1], cfg, rt)[0]
    splits = set(b_axes) | ({tp} if tp and n_tp > 1 and G % n_tp == 0 else set())

    def local(w, keep):
        w = w.redistribute(mesh, tuple(Shard(0) if a == keep else Replicate()
                                       for a in names))
        grad = tuple(pl if pl.is_shard() else (Partial() if a in splits else Replicate())
                     for a, pl in zip(names, w.placements))
        return w.to_local(grad_placements=grad)

    ea = rules.expert_axis or "data"
    lp = {"router": local(p["router"], None),
          **{k: local(p[k], ea) for k in ("wi", "wg", "wo")}}
    y, aux = moe_apply_shardmap(lp, xl, cfg, rt, local_experts=True)
    y = DTensor.from_local(y, mesh, x_pl, run_check=False, shape=x.shape,
                           stride=x.stride())
    aux = DTensor.from_local(aux, mesh, (Replicate(),) * len(names), run_check=False)
    return y, aux


def moe_apply_shardmap(p, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig,
                       *, local_experts: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with explicit collectives.

    ``x`` (B_local, S, D) is this rank's rows of a batch split over the
    rules' batch axes, as the data-parallel feed hands them out; the params
    are whole on every rank, and each rank runs the experts of its place on
    the expert axis.  As the reference's code (not its docstring):

      route per rank over its local token groups, the groups split further
      over tp -> capacity dispatch -> (E, G*C, D)
      all-to-all over the expert axis   (tokens travel to their experts)
      the E/n_ep local experts
      all-to-all back -> combine -> all-gather over tp

    and the aux loss is the mean over the expert and tp axes.  d_ff is not
    split over tp (the reference's ``wi_spec`` is ``P(ea, None, None)``), so
    no partial sums cross tp.  Gradients flow through every collective; the
    experts' and router's gradients are this rank's share, which the
    data-parallel reduction sums.  A batch that is not split over the
    expert axis raises (the reference routes each token once per expert
    rank there, and its docstring's fallback does not exist).  With
    ``local_experts`` the expert weights are already this rank's E / n_ep.
    DTensor inputs take :func:`_shardmap_dtensor`.
    """
    if is_dtensor(x):
        return _shardmap_dtensor(p, x, cfg, rt)
    rules = rt.act_sharding.rules
    mesh = rules.mesh
    ea = rules.expert_axis or "data"
    tp = rules.tp_axis
    if isinstance(ea, tuple) or isinstance(tp, tuple):
        raise ValueError(f"moe_apply_shardmap takes one mesh axis for experts and "
                         f"one for tp, not {ea!r} and {tp!r}")
    Bl, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    n_ep = rules.size(ea)
    n_tp = rules.size(tp) if tp else 1
    n_batch = 1
    for a in rules.batch_axes:
        n_batch *= rules.size(a)
    if ea not in (rules.batch_spec_axes(Bl * n_batch) or ()) or E % n_ep:
        raise ValueError(
            f"moe_apply_shardmap needs the batch split over the expert axis "
            f"{ea!r} ({n_ep} ranks; batch axes {rules.batch_axes}) and the "
            f"{E} experts divided by it")
    ep_group = mesh.get_group(ea)
    E_local = E // n_ep
    e0 = mesh.get_local_rank(ea) * E_local
    wi, wg, wo = (p[k] if local_experts else p[k][e0:e0 + E_local]
                  for k in ("wi", "wg", "wo"))

    G, gg, C = moe_groups(Bl * S, cfg, rt)
    xg = x.reshape(G, gg, D)
    split = bool(tp) and n_tp > 1 and G % n_tp == 0
    if split:
        tp_group, tp_rank = mesh.get_group(tp), mesh.get_local_rank(tp)
        xg = _SplitOver.apply(xg, tp_group, n_tp, tp_rank)
        G //= n_tp
    gate, idx, probs = _route(p, xg, cfg)
    aux = _MeanOver.apply(_aux_loss(probs, idx, E), ep_group, n_ep)
    if tp:
        aux = _MeanOver.apply(aux, mesh.get_group(tp), n_tp)
    dispatch, combine = _dispatch_combine(gate, idx, E, C)

    cd = x.dtype
    xd = torch.einsum("gtec,gtd->gecd", dispatch.to(cd), xg)
    xd = xd.permute(1, 0, 2, 3).reshape(E, G * C, D)
    # tokens -> their experts' ranks: (E, GC, D) -> (E_local, n_ep * GC, D)
    xd = _AllToAll.apply(xd, ep_group)
    xd = xd.reshape(n_ep, E_local, G * C, D).transpose(0, 1).reshape(
        E_local, n_ep * G * C, D)
    h = torch.einsum("ecd,edf->ecf", xd, wi.to(cd))
    gt = torch.einsum("ecd,edf->ecf", xd, wg.to(cd))
    ye = torch.einsum("ecf,efd->ecd", h * F.silu(gt), wo.to(cd))
    ye = ye.reshape(E_local, n_ep, G * C, D).transpose(0, 1).reshape(E, G * C, D)
    ye = _AllToAll.apply(ye, ep_group)           # each expert's rows of my tokens
    ye = ye.reshape(E, G, C, D).permute(1, 0, 2, 3)
    y = torch.einsum("gtec,gecd->gtd", combine.to(cd), ye)
    if split:
        y = _GatherOver.apply(y, tp_group, n_tp, tp_rank)
    return y.reshape(Bl, S, D), aux


def moe_decode(p, x: torch.Tensor, cfg: ModelConfig, rt: RuntimeConfig
               ) -> torch.Tensor:
    """x: (B, 1, D).  Dense all-expert compute, top-k combine."""
    if is_dtensor(x):
        return _moe_per_shard(lambda q, y: moe_decode(q, y, cfg, rt), p, x, cfg, False)
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

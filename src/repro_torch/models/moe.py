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

Decode: all experts are computed densely for the new token, as products
batched over the experts on the stacks as stored (``_expert_in``,
``_combine``), and combined with the top-k gate weights; nothing is
dropped, so prefill and decode agree with
``forward`` only where no token drops (``capacity_factor = n_experts``).

``moe_apply_shardmap`` is expert parallelism with explicit collectives on
the "data"/"model" sub-meshes of ``rt.act_sharding.rules.mesh``, the
reference's ``shard_map`` version, as ``torch.distributed`` all-to-alls.

Sharded (DTensor) runs: ``moe_apply`` and ``moe_decode`` run per shard
(:func:`repro_torch.kernels._local.per_shard`), tokens on the batch's mesh
dims and the experts' d_ff over the others where it divides, each rank's
output a partial sum there (tensor-parallel experts); ``moe_apply`` raises
where a shard's token groups would not be the global batch's.  At one row
a rank split on its sequence, ``moe_apply`` routes each rank's own groups
(``_moe_rows``); at one token a row, ``moe_decode`` runs expert stacks
split on their experts where they lie (``_moe_decode_ep``) and stacks split
on d_model on that split (``_moe_decode_kept``).
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
from ..kernels._local import block_index, is_dtensor, per_shard, rows_split, shard_layout
from ..spans import count
from .common import Initializer, Kept, RuntimeConfig, gather, linear, weight

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
    return _top_k(linear(x.float(), p["router"]), cfg)


def _top_k(logits: torch.Tensor, cfg: ModelConfig):
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

    args = (x, weight(p["router"]), p["wi"], p["wg"], p["wo"])
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
        if _groups_on_rows(p, x, cfg, rt):
            return _moe_rows(p, x, cfg, rt)
        return _moe_per_shard(lambda q, y: moe_apply(q, y, cfg, rt), p, x, cfg, True)
    B, S, D = x.shape
    G, g, C = moe_groups(B * S, cfg, rt)
    xd, combine, aux = _dispatch_groups(p, x.reshape(G, g, D), cfg, C)
    xd = rt.moe_constraint(xd)          # -> expert-major (all-to-all under EP)
    ye = rt.moe_constraint(_experts(p, xd))     # stay expert-major until combine
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), ye)
    return y.reshape(B, S, D), aux


def _dispatch_groups(p, xg: torch.Tensor, cfg: ModelConfig, C: int):
    """Route the token groups ``xg`` (G, g, D) and dispatch them: the
    experts' slots (G, E, C, D), the combine weights (G, g, E, C) and the
    aux loss of these groups.  Under the profiler it counts the slots
    (``moe.slots``) and the token-expert pairs kept in them (``moe.kept``)."""
    E = cfg.n_experts
    gate, idx, probs = _route(p, xg, cfg)                      # (G, g, K)
    dispatch, combine = _dispatch_combine(gate, idx, E, C)
    count("moe.slots", xg.shape[0] * E * C)
    # a float32 sum of ones is exact below 2**24; sum(dtype=int64) would
    # first copy the whole one-hot tensor to int64
    count("moe.kept", lambda: dispatch.sum().long())
    xd = torch.einsum("gtec,gtd->gecd", dispatch.to(xg.dtype), xg)   # (G, E, C, D)
    return xd, combine, _aux_loss(probs, idx, E)


def _experts(p, xd: torch.Tensor) -> torch.Tensor:
    """The experts' gated MLP on their slots (G, E, C, D)."""
    cd = xd.dtype
    h = torch.einsum("gecd,edf->gecf", xd, p["wi"].to(cd))
    gt = torch.einsum("gecd,edf->gecf", xd, p["wg"].to(cd))
    return torch.einsum("gecf,efd->gecd", h * F.silu(gt), p["wo"].to(cd))


def _groups_on_rows(p, x, cfg: ModelConfig, rt: RuntimeConfig) -> bool:
    """Whether :func:`_moe_rows` runs ``x``: split on its sequence (a rows
    split) at one row a rank, its ranks' rows made of whole token groups,
    and the experts' d_ff split on every mesh dim that splits the rows."""
    rows = rows_split(x)
    wi = p["wi"]
    if not rows or not is_dtensor(wi):
        return False
    mesh = x.device_mesh
    b_loc, s_loc = x.shape[0], x.shape[1]
    for i, pl in enumerate(x.placements):
        b_loc //= mesh.size(i) if pl.is_shard(0) else 1
        s_loc //= mesh.size(i) if pl.is_shard(1) else 1
    g = moe_groups(x.shape[0] * x.shape[1], cfg, rt)[1]
    return (b_loc == 1 and s_loc % g == 0
            and all(wi.placements[i].is_shard(2) for i in rows))


def _moe_rows(p, x, cfg: ModelConfig, rt: RuntimeConfig):
    """:func:`moe_apply` on ``x`` split on its sequence at one row a rank
    (``_groups_on_rows``): each rank routes and dispatches its own token
    groups (the batch's groups: its rows hold whole ones), the slots are
    gathered on the mesh dims that split the experts' d_ff, each rank runs
    its d_ff slice of the experts on them, and the partial outputs are
    reduce-scattered back to the groups' ranks, which combine their own.
    The router and the dispatch and combine einsums run once a token, not
    once a rank of the rows' split, for slots gathered in place of x.  At
    more rows a rank, x is gathered instead (``_moe_per_shard``), which
    moves less; the aux loss is the mean over the shards' groups, as there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, D = x.device_mesh, x.shape[-1]
    _, g, C = moe_groups(x.shape[0] * x.shape[1], cfg, rt)
    x_pl = list(x.placements)
    tok = [Shard(0) if pl.is_shard() else Replicate() for pl in x_pl]
    n_tok = 1
    for i, pl in enumerate(x_pl):
        n_tok *= mesh.size(i) if pl.is_shard() else 1
    whole = [Replicate()] * mesh.ndim

    def route(xl, router):
        xd, combine, aux = _dispatch_groups({"router": router}, xl.reshape(-1, g, D),
                                            cfg, C)
        return xd, combine, aux / n_tok

    router = weight(p["router"])
    part = [Partial() if pl.is_shard() else Replicate() for pl in x_pl]
    xd, combine, aux = local_map(
        route, out_placements=(tok, tok, part), in_placements=(x_pl, whole),
        in_grad_placements=(x_pl, part), device_mesh=mesh,
        redistribute_inputs=True)(x, router)
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    f_dims = [i for i, pl in enumerate(wi.placements) if pl.is_shard(2)]
    xd_pl = [Replicate() if i in f_dims else pl for i, pl in enumerate(tok)]
    xd = xd.redistribute(mesh, xd_pl)

    def w_grad(w):
        return [pl if pl.is_shard() else (Partial() if xd_pl[i].is_shard() else Replicate())
                for i, pl in enumerate(w.placements)]

    ye = local_map(
        lambda xd, wi, wg, wo: _experts({"wi": wi, "wg": wg, "wo": wo}, xd),
        out_placements=[Partial() if i in f_dims else pl for i, pl in enumerate(xd_pl)],
        in_placements=(xd_pl, list(wi.placements), list(wg.placements),
                       list(wo.placements)),
        in_grad_placements=([Partial() if i in f_dims else pl for i, pl in enumerate(xd_pl)],
                            w_grad(wi), w_grad(wg), w_grad(wo)),
        device_mesh=mesh, redistribute_inputs=True)(xd, wi, wg, wo)
    ye = ye.redistribute(mesh, tok)

    def combine_fn(ye, combine):                # a rank's one row
        return torch.einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye).reshape(1, -1, D)

    y = local_map(combine_fn, out_placements=x_pl, in_placements=(tok, tok),
                  device_mesh=mesh, redistribute_inputs=True)(ye, combine)
    return y, aux


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
    tp = _group_axis(rules)
    n_tp = rules.size(tp) if tp else 1
    G = moe_groups(xl.shape[0] * xl.shape[1], cfg, rt)[0]
    splits = set(b_axes) | ({tp} if tp and n_tp > 1 and G % n_tp == 0 else set())

    def local(w, keep):
        w = gather(w, tuple(Shard(0) if a == keep else Replicate() for a in names))
        grad = tuple(pl if pl.is_shard() else (Partial() if a in splits else Replicate())
                     for a, pl in zip(names, w.placements))
        return w.to_local(grad_placements=grad)

    ea = rules.expert_axis or "data"
    lp = {"router": local(weight(p["router"]), None),
          **{k: local(p[k], ea) for k in ("wi", "wg", "wo")}}
    y, aux = moe_apply_shardmap(lp, xl, cfg, rt, local_experts=True)
    y = DTensor.from_local(y, mesh, x_pl, run_check=False, shape=x.shape,
                           stride=x.stride())
    aux = DTensor.from_local(aux, mesh, (Replicate(),) * len(names), run_check=False)
    return y, aux


def _group_axis(rules):
    """The mesh axis over which :func:`moe_apply_shardmap` splits each
    rank's token groups: tp, as the reference's, or where the layout has no
    tp, the axis that splits the sequence (ZeRO-3 with sequence
    parallelism, where the reference runs every group on each of its ranks)."""
    return rules.tp_axis if rules.tp_axis else rules.seq_axis


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
    tp = _group_axis(rules)
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
    if isinstance(p["wi"], Kept):
        wi = p["wi"]
        if all(wi.w.placements[i].is_shard(0) for i in wi.dims):
            return _moe_decode_ep(p, x, cfg)
        return _moe_decode_kept(p, x, cfg)
    if is_dtensor(x):
        return _moe_per_shard(lambda q, y: moe_decode(q, y, cfg, rt), p, x, cfg, False)
    gate, idx, _ = _route(p, x, cfg)                           # (B, 1, K)
    cd = x.dtype
    h, g = _expert_in(x, p["wi"].to(cd), p["wg"].to(cd))
    return _combine(h * F.silu(g), p["wo"].to(cd), gate, idx, cfg)


def _expert_in(x, wi, wg):
    """Every expert's h and g (E, N, F) on the N token rows of ``x`` (...,
    D): products batched over the experts, on the stacks ``wi``, ``wg`` (E,
    D, F) as they lie, the rows broadcast over E.  (``einsum("btd,edf->
    btef")`` shares no batch dim with a stack, so it multiplies x by a (D,
    E*F) copy of each stack: two stacks' copies a call.)"""
    xe = x.reshape(1, -1, x.shape[-1]).expand(wi.shape[0], -1, -1)
    return torch.bmm(xe, wi), torch.bmm(xe, wg)


def _combine(a, wo, gate, idx, cfg: ModelConfig, e0: int = 0):
    """The top-k gates' sum of the experts' outputs ``a`` @ ``wo``, (...,
    D) for the gates' (..., K); ``a`` (E, N, F) and ``wo`` (E, F, D) may
    hold the experts from ``e0`` on only (a rank's share of them: the
    result is then its partial sum)."""
    E, lead = cfg.n_experts, gate.shape[:-1]
    ye = torch.bmm(a, wo)                                      # (E, N, D)
    gate, idx = gate.reshape(-1, gate.shape[-1]), idx.reshape(-1, idx.shape[-1])
    w = torch.zeros((gate.shape[0], E), dtype=torch.float32, device=a.device)
    for k_i in range(cfg.experts_per_token):
        w = w + F.one_hot(idx[:, k_i], E).float() * gate[:, k_i][:, None]
    w = w[:, e0:e0 + a.shape[0]]
    y = torch.einsum("ne,end->nd", w.to(a.dtype), ye)
    return y.reshape(*lead, ye.shape[-1])


def _moe_decode_ep(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`moe_decode` whose expert stacks kept their split of the
    experts (``on_use`` at one token a row; arctic-480b's 128 experts on
    "data"): the experts stay where they lie and the tokens come to them.
    x and the router's logits are gathered on the mesh dims that split the
    experts (the batch's rows there: a few tokens), each rank runs its
    experts (its d_ff slice, where d_ff is split) on every gathered row and
    gives its share of the gated sum, and the partial sums are
    reduce-scattered back to the rows' ranks (all-reduced over d_ff's
    split)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    ep = p["wi"].dims
    wi, wg, wo = (weight(p[k]) for k in ("wi", "wg", "wo"))
    mesh, cd = x.device_mesh, x.dtype
    logits = linear(x.float(), p["router"])
    rows = [Replicate() if i in ep or pl.is_partial() else pl
            for i, pl in enumerate(x.placements)]
    x_all, logits = x.redistribute(mesh, rows), logits.redistribute(mesh, rows)
    index = block_index(mesh, ep)[0]           # this rank's block of experts

    def local(x, logits, wi, wg, wo):
        gate, idx, _ = _top_k(logits, cfg)
        h, g = _expert_in(x, wi.to(cd), wg.to(cd))
        return _combine(h * F.silu(g), wo.to(cd), gate, idx, cfg, index * wi.shape[0])

    out_pl = [Partial() if i in ep or wi.placements[i].is_shard(2) else pl
              for i, pl in enumerate(rows)]
    y = local_map(local, out_placements=out_pl, device_mesh=mesh,
                  in_placements=(rows, rows, list(wi.placements), list(wg.placements),
                                 list(wo.placements)),
                  redistribute_inputs=True)(x_all, logits, wi, wg, wo)
    return y.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                 for pl in x.placements])


def _moe_decode_kept(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`moe_decode` whose expert stacks kept their FSDP shard of
    d_model (``on_use`` at one row): each rank contracts its slice of x's
    d_model (x split there, the one-row residual stream) into partial sums
    of h and g, all-reduced at (E, B, d_ff's tensor-parallel shard), and
    gives its d_model slice of the gated sum of the experts' outputs: the
    output is split on d_model there and a partial sum over d_ff's split.
    The router's logits come whole (``linear`` of a kept weight)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..train.sharding import pin

    kept = p["wi"].dims
    wi, wg, wo = (weight(p[k]) for k in ("wi", "wg", "wo"))
    mesh, cd = x.device_mesh, x.dtype
    logits = linear(x.float(), p["router"])
    logits = logits.redistribute(mesh, [Replicate()] * mesh.ndim)
    x = pin(x, [Shard(2) if i in kept else Replicate() for i in range(mesh.ndim)])

    def split(w, d_dim, d_out, f_out):
        """The product's placement on each mesh dim: ``d_out`` where w
        splits d_model (its dim ``d_dim``), ``f_out`` where it splits d_ff
        (a kept stack is split on no expert), whole elsewhere."""
        return [d_out if pl.is_shard(d_dim) else f_out if pl.is_shard() else Replicate()
                for pl in w.placements]

    hg_pl = split(wi, 1, Partial(), Shard(2))
    h, g = local_map(
        lambda x, wi, wg: _expert_in(x, wi.to(cd), wg.to(cd)),
        out_placements=(hg_pl, hg_pl), device_mesh=mesh,
        in_placements=(list(x.placements), list(wi.placements), list(wg.placements)),
        redistribute_inputs=True)(x, wi, wg)
    whole = [Replicate() if pl.is_partial() else pl for pl in hg_pl]
    h, g = h.redistribute(mesh, whole), g.redistribute(mesh, whole)

    def combine(h, g, wo, logits):
        gate, idx, _ = _top_k(logits, cfg)
        return _combine(h * F.silu(g), wo.to(cd), gate, idx, cfg)

    return local_map(combine, out_placements=split(wo, 2, Shard(2), Partial()),
                     in_placements=(whole, whole, list(wo.placements),
                                    [Replicate()] * mesh.ndim),
                     device_mesh=mesh, redistribute_inputs=True)(h, g, wo, logits)

"""Decoder-only LM for the dense, moe, ssm, hybrid and vlm families: every
block kind (``ssm``, ``rec``, ``local``, ``attn``, ``global``), the MoE
feed-forward (mixtral) with arctic's dense residual MLP beside it, gemma's
post-sublayer norms and the VLM's frontend-embeds prefix.

Port of ``repro.models.decoder.DecoderLM``.  The reference stacks each
superblock's params on a leading repeat dim and scans over it
(``_scan_or_unroll``), with the ``n_layers % len(pattern)`` remainder layers
in an unscanned ``tail``; here every layer, tail included, is one entry of an
``nn.ModuleList`` (layer ``l`` has kind ``pattern[l % len(pattern)]``) and
the scan is a Python loop over it.  MoE layers run ``moe_apply``'s capacity
dispatch in forward and prefill and the dense ``moe_decode`` in decode; their
load-balancing loss is computed and dropped, as in the reference.

Modality frontends are stubs, as in the reference: a VLM's patch embeddings
arrive precomputed as ``frontend_embeds`` (B, P, d_model) and occupy the
sequence prefix; ``loss`` supervises only the text positions.

Training: ``loss`` is the reference's masked next-token cross entropy.
``RuntimeConfig.remat`` recomputes each layer in the backward pass:
``"full"`` saves nothing inside it (the reference's ``jax.checkpoint`` with
``nothing_saveable`` around each superblock), ``"dots"`` saves the outputs
of matrix products without batch dims, ``aten.mm`` and ``aten.addmm``, and
recomputes everything else, ``aten.bmm`` included (the reference's
``checkpoint_dots_with_no_batch_dims``), as selective activation
checkpointing; recomputing per layer keeps the same values.  MoE layers run
``moe_apply`` or, with ``RuntimeConfig.moe_impl="shard_map"``,
``moe_apply_shardmap``; ``RuntimeConfig.act_sharding`` is called at the
reference's constraint points.  Gradients come from autograd through the
plain versions of the kernels (``ssd_impl="chunked"``, ``rglru_impl="scan"``,
``attn_impl="ref"``): the Hopper kernels are forward-only and their wrappers
refuse inputs that require grad.

The serving methods keep the reference's signatures minus ``params`` (the
module holds them).  The decode cache is a list with one dict per layer:
``{"ssd", "conv"}`` for ``ssm``, ``{"h", "conv"}`` for ``rec`` and
``{"k", "v"}`` for the attention kinds: for ``local`` (and ``attn`` or
``global`` under a ``sliding_window``) a ring buffer of the window, rounded
up to 128, or of ``RuntimeConfig.max_cache_len`` when that is shorter; for
unwindowed ``attn`` and ``global`` layers a linear cache of
``max_cache_len`` slots.  Left-padded serving waves pass ``segments`` (0
for pads) to ``prefill`` and ``context_start`` to ``decode_step``, which
keeps decode from attending the pads' K/V in either cache.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..kernels._local import block_index, is_dtensor, last_row
from ..spans import span
from .attention import attn_apply, attn_decode, attn_init, init_kv_cache
from .common import (Initializer, Kept, RuntimeConfig, linear, mlp_apply, mlp_init,
                     norm_apply, norm_init, on_use, resolve_device, softcap)
from .moe import moe_apply, moe_apply_shardmap, moe_decode, moe_init
from .recurrent_block import init_rec_cache, rec_apply, rec_decode, rec_init
from .ssm_block import init_ssm_cache, ssm_apply, ssm_decode, ssm_init

__all__ = ["DecoderLM", "xent_loss", "remat_call"]

_REMAT = ("none", "full", "dots")
# Matrix products without batch dims: what remat="dots" keeps.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_remat(rt: RuntimeConfig) -> None:
    if rt.remat not in _REMAT:
        raise ValueError(f"unknown remat mode {rt.remat!r}; choose from {_REMAT}")


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(mode: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the backward
    pass per ``mode`` when grad mode is on (see the module docstring)."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if mode == "full":
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, **kwargs,
                      context_fn=partial(create_selective_checkpoint_contexts,
                                         _dots_policy))


def _block_window(kind: str, cfg: ModelConfig) -> Optional[int]:
    if kind == "local":
        return cfg.local_window
    if kind in ("attn", "global"):
        return cfg.sliding_window     # mixtral SWA; None for full attention
    return None


def _cache_round(n: int, m: int = 128) -> int:
    return ((n + m - 1) // m) * m


def _roll_seq(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=1)`` as two slices (torch 2.11's DTensor
    has no sharding strategy for ``aten.roll``)."""
    if shift == 0:
        return x
    return torch.cat([x[:, -shift:], x[:, :-shift]], dim=1)


def _write_ring(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write prompt K/V into the (possibly window-sized ring) cache."""
    L = cache["k"].shape[1]
    S = k.shape[1]
    if S >= L:
        # keep the last L positions; ring phase = S % L so that absolute
        # position p lands at slot p % L.
        shift = S % L
        return {"k": _roll_seq(k[:, S - L:], shift).to(cache["k"].dtype),
                "v": _roll_seq(v[:, S - L:], shift).to(cache["v"].dtype)}
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return cache


class DecoderLM(nn.Module):
    """Decoder-only LM on ``device`` (CUDA unless the caller asks for CPU)."""

    def __init__(self, cfg: ModelConfig, rt: RuntimeConfig = RuntimeConfig(),
                 *, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        check_remat(rt)
        self.cfg, self.rt = cfg, rt
        self.pattern = cfg.pattern
        self.kinds = [cfg.pattern[l % len(cfg.pattern)] for l in range(cfg.n_layers)]
        self.device = resolve_device(device)
        ini = Initializer(seed, self.device)
        dtype = rt.param_dtype
        self.embed = ini.normal((cfg.padded_vocab, cfg.d_model), 1.0, dtype)
        self.final_norm = norm_init(ini, cfg.d_model, cfg.norm, dtype)
        self.blocks = nn.ModuleList(self._init_block(ini, kind) for kind in self.kinds)
        if not cfg.tie_embeddings:
            self.lm_head = ini.normal((cfg.d_model, cfg.padded_vocab),
                                      cfg.d_model ** -0.5, dtype)

    def _init_block(self, ini: Initializer, kind: str) -> nn.ModuleDict:
        cfg, dtype = self.cfg, self.rt.param_dtype
        D = cfg.d_model
        p = nn.ModuleDict({"norm1": norm_init(ini, D, cfg.norm, dtype)})
        if kind == "ssm":
            p["ssm"] = ssm_init(ini, cfg, dtype)
            return p
        if kind == "rec":
            p["rec"] = rec_init(ini, cfg, dtype)
        else:
            p["attn"] = attn_init(ini, cfg, dtype)
        if cfg.post_norms:
            p["post_norm1"] = norm_init(ini, D, cfg.norm, dtype)
        p["norm2"] = norm_init(ini, D, cfg.norm, dtype)
        if cfg.n_experts:
            p["moe"] = moe_init(ini, cfg, dtype)
        if not cfg.n_experts or cfg.dense_residual:
            p["mlp"] = mlp_init(ini, D, cfg.d_ff, dtype)
        if cfg.post_norms:
            p["post_norm2"] = norm_init(ini, D, cfg.norm, dtype)
        return p

    def load_jax_params(self, np_tree: Dict) -> None:
        """Load the JAX package's parameter pytree (nested dicts of numpy)."""
        from ..weights import params_from_jax
        self.load_state_dict(params_from_jax(np_tree))

    # ------------------------------------------------------------------ fwd

    def _embed(self, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = embed_lookup(self.embed, tokens).to(self.rt.compute_dtype)
        if self.cfg.scale_embed:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
        return self.rt.hidden(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self._norm(on_use(self.final_norm), x)
        head = (on_use(self.embed, x).T if cfg.tie_embeddings
                else on_use(self.lm_head, x))
        logits = softcap(linear(x, head).float(), cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            iota = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return self.rt.logits_constraint(logits)

    def _norm(self, p, x: torch.Tensor) -> torch.Tensor:
        """A norm of ``x`` by params ``p``, in a timed span of its own."""
        with span("model.norm", timed=True):
            return norm_apply(p, x, self.cfg.norm, self.cfg.norm_eps)

    def _mlp_sublayer(self, p, x: torch.Tensor, mix: torch.Tensor,
                      decode: bool = False) -> torch.Tensor:
        """x + mix, then the MLP sublayer (the MoE, plus arctic's dense
        residual MLP, in MoE layers; dense experts in ``decode``); gemma's
        post-norms wrap both sublayers' outputs."""
        cfg, rt = self.cfg, self.rt
        if cfg.post_norms:
            mix = self._norm(p["post_norm1"], rt.hidden(mix))
        x = rt.residual(x, mix)
        h = rt.hidden(self._norm(p["norm2"], x))
        with span("model.moe" if cfg.n_experts else "model.mlp", timed=True):
            if cfg.n_experts:
                if decode:
                    y = moe_decode(p["moe"], h, cfg, self.rt)
                else:
                    moe_fn = (moe_apply_shardmap if self.rt.moe_impl == "shard_map"
                              else moe_apply)
                    y, _aux = moe_fn(p["moe"], h, cfg, self.rt)
                if cfg.dense_residual:
                    y = y + mlp_apply(p["mlp"], h, cfg.act)
            else:
                y = mlp_apply(p["mlp"], h, cfg.act)
        if cfg.post_norms:
            y = self._norm(p["post_norm2"], rt.hidden(y))
        return rt.residual(x, y)

    def _apply_block(self, kind: str, p, x, *, positions, segments):
        cfg, rt = self.cfg, self.rt
        p = on_use(p, x)
        h = rt.hidden(self._norm(p["norm1"], x))
        if kind == "ssm":
            return rt.residual(x, ssm_apply(p["ssm"], h, cfg, rt))
        if kind == "rec":
            mix = rec_apply(p["rec"], h, cfg, rt)
        else:
            mix = attn_apply(p["attn"], h, cfg, rt, positions=positions,
                             causal=True, window=_block_window(kind, cfg),
                             segments=segments)
        return rt.hidden(self._mlp_sublayer(p, x, mix))

    def _positions(self, x: torch.Tensor, positions):
        if positions is None:
            B, S = x.shape[:2]
            positions = torch.arange(S, device=x.device).expand(B, S)
        return positions

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Training/eval forward -> fp32 logits (B, S_total, V_pad), where
        S_total counts the ``frontend_embeds`` prefix when the batch has one."""
        x = self._embed(batch["tokens"], batch.get("frontend_embeds"))
        positions = self._positions(x, batch.get("positions"))
        segments = batch.get("segments")
        for kind, p in zip(self.kinds, self.blocks):
            x = remat_call(self.rt.remat, self._apply_block, kind, p, x,
                           positions=positions, segments=segments)
        return self._logits(x)

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token cross entropy; labels < 0 are masked.  Returns
        (loss, {"loss", "n_tokens"}).  The frontend prefix's logits are not
        supervised."""
        labels = batch["labels"]
        return xent_loss(self.forward(batch)[:, -labels.shape[1]:], labels)

    # ------------------------------------------------------------------ serve

    def _init_block_cache(self, kind: str, batch: int) -> Dict:
        cfg, rt = self.cfg, self.rt
        dtype = rt.compute_dtype
        if kind == "ssm":
            return init_ssm_cache(cfg, batch, dtype, self.device)
        if kind == "rec":
            return init_rec_cache(cfg, batch, dtype, self.device)
        length = rt.max_cache_len
        window = _block_window(kind, cfg)
        if window is not None:
            length = min(length, _cache_round(window))
        if length <= 0:
            raise ValueError("attention layers need a KV cache: set "
                             "RuntimeConfig.max_cache_len > 0")
        return init_kv_cache(cfg, batch, length, dtype, self.device)

    def init_cache(self, batch: int) -> List[Dict]:
        """Allocate the decode cache, one dict per layer (window-bounded
        layers allocate only the window); sharded per ``cache_specs`` when
        the params are."""
        cache = [self._init_block_cache(kind, batch) for kind in self.kinds]
        return shard_cache(self, cache, batch)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                segments: Optional[torch.Tensor] = None):
        """Run the full prompt, return (last-position logits, cache, length).

        ``frontend_embeds`` (B, P, d_model) precede the tokens; the length
        counts them.  ``positions`` default to ``arange(S)`` per row;
        ``segments`` (B, S) mask attention across packed or padded sequences
        (the serving engine marks left pads 0 and content 1).
        """
        with span("model.step", timed=True):
            x = self._embed(tokens, frontend_embeds)
            positions = self._positions(x, positions)
            cache = self.init_cache(x.shape[0])
            filled = []
            for kind, p, layer_cache in zip(self.kinds, self.blocks, cache):
                x, state = self._prefill_block(kind, p, x, layer_cache, positions,
                                               segments)
                filled.append(state)
            return self._logits(last_row(x)), filled, x.shape[1]

    def _prefill_block(self, kind: str, p, x, cache, positions, segments=None):
        cfg, rt = self.cfg, self.rt
        p = on_use(p, x)
        h = rt.hidden(self._norm(p["norm1"], x))
        if kind == "ssm":
            y, state = ssm_apply(p["ssm"], h, cfg, rt, return_state=True)
            state["conv"] = state["conv"].to(cache["conv"].dtype)
            return rt.residual(x, y), state
        if kind == "rec":
            mix, state = rec_apply(p["rec"], h, cfg, rt, return_state=True)
            state["conv"] = state["conv"].to(cache["conv"].dtype)
        else:
            with span("model.attn", timed=True):
                mix, (k, v) = attn_apply(
                    p["attn"], h, cfg, rt, positions=positions, causal=True,
                    window=_block_window(kind, cfg), segments=segments,
                    return_kv=True)
                state = _write_ring(cache, k, v)
        return rt.hidden(self._mlp_sublayer(p, x, mix)), state

    @torch.inference_mode()
    def decode_step(self, cache: List[Dict], token: torch.Tensor, pos: int,
                    context_start: Optional[torch.Tensor] = None):
        """token: (B, 1) int; pos: absolute position (RoPE and the caches
        use it); ``context_start``: optional (B,) first valid position of each
        row, on the model's device (a left-padded wave's S - len(prompt)).

        Returns (logits (B, 1, V_pad), new cache).
        """
        with span("model.step", timed=True):
            x = self._embed(token)
            new_cache = []
            for kind, p, layer_cache in zip(self.kinds, self.blocks, cache):
                x, state = self._decode_block(kind, p, x, layer_cache, pos,
                                              context_start)
                new_cache.append(state)
            return self._logits(x), new_cache

    def _decode_block(self, kind: str, p, x_t, cache, pos, context_start=None):
        cfg, rt = self.cfg, self.rt
        p = on_use(p, x_t)
        h = rt.hidden(self._norm(p["norm1"], x_t))
        if kind == "ssm":
            y, state = ssm_decode(p["ssm"], h, cache, cfg, rt)
            return rt.residual(x_t, y), state
        if kind == "rec":
            mix, state = rec_decode(p["rec"], h, cache, cfg, rt)
        else:
            with span("model.attn", timed=True):
                mix, state = attn_decode(p["attn"], h, cache, pos, cfg, rt,
                                         window=_block_window(kind, cfg),
                                         context_start=context_start)
        return rt.hidden(self._mlp_sublayer(p, x_t, mix, decode=True)), state


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` for ``tokens``.  A sharded table is gathered on
    use, but at one token a row (decode) it keeps its FSDP shard of d_model
    (:func:`on_use`), and each rank's rows come out split there; where its
    vocab stays sharded, each rank looks up the tokens that fall in its rows
    (zeros for the rest) and the result is a partial sum over those mesh
    dims.  The tokens are whole on the mesh dims the table is split on."""
    embed = on_use(embed, tokens)
    kept = ()
    if isinstance(embed, Kept):
        embed, kept = embed
    if not is_dtensor(embed):
        return embed[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = embed.device_mesh
    vocab = [i for i, pl in enumerate(embed.placements) if pl.is_shard(0)]
    if not vocab and not kept:
        return torch.nn.functional.embedding(tokens, embed)
    index, n = block_index(mesh, vocab)        # this rank's block of rows
    rows = embed.shape[0] // n
    lo = index * rows

    def lookup(table, tok):
        hit = (tok >= lo) & (tok < lo + rows)
        out = table[torch.where(hit, tok - lo, 0)]
        return torch.where(hit[..., None], out, torch.zeros((), dtype=out.dtype))

    split = vocab + list(kept)
    tok_pl = [Replicate() if i in split else pl for i, pl in enumerate(tokens.placements)]
    out_pl = [Partial() if i in vocab else Shard(2) if i in kept else pl
              for i, pl in enumerate(tok_pl)]
    grad_pl = [pl if i in split else (Partial() if tok_pl[i].is_shard() else Replicate())
               for i, pl in enumerate(embed.placements)]
    return local_map(lookup, out_placements=out_pl, in_placements=(
        list(embed.placements), tok_pl), in_grad_placements=(grad_pl, tok_pl),
        device_mesh=mesh, redistribute_inputs=True)(embed, tokens)


def shard_cache(model, cache, batch: int):
    """``cache`` as DTensors per ``cache_specs`` when ``model``'s params are
    sharded (the rules of its ``act_sharding``), else as it is."""
    if not is_dtensor(next(model.parameters())):
        return cache
    from ..train.sharding import cache_specs, shard_tree
    rules = model.rt.act_sharding.rules
    return shard_tree(cache, cache_specs(cache, rules, batch), rules.mesh)


def xent_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Masked cross entropy, the mean over positions whose label is >= 0.

    The reference extracts the label logit with a one-hot reduction (it
    keeps a vocab-sharded axis sharded); on one device a gather computes the
    same value, and logits with a sharded vocab take
    :func:`_vocab_parallel_terms`.
    """
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    if is_dtensor(logits) and any(pl.is_shard(logits.dim() - 1)
                                  for pl in logits.placements):
        lse, label_logit = _vocab_parallel_terms(logits, safe)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - label_logit
    denom = torch.clamp(mask.sum(), min=1)
    loss = torch.where(mask, nll, 0.0).sum() / denom
    return loss, {"loss": loss, "n_tokens": denom}


def _vocab_parallel_terms(logits, labels):
    """(logsumexp, label logit) of DTensor logits whose vocab dim may be
    sharded, without gathering it: each rank reduces its own vocab block
    (the max, the sum of exponentials and the one-hot label term) and the
    (B, S) partial results are all-reduced.  Every layout is pinned (per
    shard, by ``local_map``), the gradient's too: the logits' gradient stays
    in their layout, each rank's block from its own terms."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab = [i for i, pl in enumerate(logits.placements) if pl.is_shard(last)]
    index, n = block_index(mesh, vocab)        # this rank's vocab block
    lo = index * (logits.shape[-1] // n)
    l_pl = list(logits.placements)
    rows = [Replicate() if i in vocab else pl for i, pl in enumerate(l_pl)]
    m = local_map(lambda l: l.amax(dim=-1),
                  out_placements=[Partial("max") if i in vocab else pl
                                  for i, pl in enumerate(rows)],
                  in_placements=(l_pl,), device_mesh=mesh,
                  redistribute_inputs=True)(logits.detach())
    m = m.redistribute(mesh, rows)

    def terms(l, m, lab):
        iota = lo + torch.arange(l.shape[-1], device=l.device)
        return (torch.exp(l - m[..., None]).sum(dim=-1),
                torch.where(lab[..., None] == iota, l, 0.0).sum(dim=-1))

    part = [Partial() if i in vocab else pl for i, pl in enumerate(rows)]
    s, label_logit = local_map(terms, out_placements=(part, part),
                               in_placements=(l_pl, rows, rows),
                               in_grad_placements=(l_pl, rows, rows), device_mesh=mesh,
                               redistribute_inputs=True)(logits, m, labels)
    lse = torch.log(s.redistribute(mesh, rows)) + m
    return lse, label_logit.redistribute(mesh, rows)

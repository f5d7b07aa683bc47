"""Logical-axis sharding rules -> partition specs for params, optimizer
state, batch and cache; port of ``repro.train.sharding``.

MaxText-style: parameters are matched by their path in the reference's tree
(names are stable across the model zoo) and given specs built from a rule
table.  Rules adapt to the mesh (axis sizes must divide the dim) and to the
shape kind (train / prefill / decode / long-decode).

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry a
dim: a mesh axis name, a tuple of names, or ``None``.  The rules read the
reference's stacked shapes: a port leaf that is one layer of a stacked
reference leaf (:func:`repro_torch.weights.jax_layout`) takes the spec of
that leaf without its leading repeat dim, which is never sharded.

Baseline layout:
- batch        -> ("pod", "data")     (replicated when batch==1, long_500k)
- d_ff / heads -> "model"             (tensor parallel)
- d_model rows of big matrices -> "data"  (FSDP; gathered on use)
- vocab        -> "model"
- MoE experts  -> "data" when divisible (arctic 128/16), else d_ff/"model"

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or any object
with ``axis_names`` and a name -> size ``shape`` (enough to evaluate the
rules for a production mesh no process group holds).  :func:`named` turns a
spec into DTensor placements on a DeviceMesh; :func:`constrain` and
:class:`ActivationSharding` redistribute DTensors and hand plain tensors
back as they are.

Sharded execution: :func:`shard_model` makes every parameter a DTensor with
its spec's placements (each rank keeps its own piece; a ``meta`` model gets
``meta`` pieces, shapes without memory, as the dry-run wants) and gives it
an ``on_use`` layout, the spec with the FSDP axes dropped, which
:func:`repro_torch.models.common.on_use` redistributes it to where a layer
uses it ("gathered on use"); under ``moe_impl="shard_map"`` the experts'
weights keep the expert axis (the reference's ``wi_spec = P(ea, None,
None)``).  :func:`shard_tree` does the same for optimizer state, batches and
caches.  The train step then runs on DTensors, and the mesh's placements
do the data-parallel reduction (``train/step.py``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels._local import one_row
from ..weights import jax_layout

__all__ = ["ShardingRules", "param_specs", "batch_specs", "cache_specs",
           "opt_state_specs", "named", "constrain", "local_shard",
           "from_local", "from_global", "shard_model", "shard_tree", "pin",
           "local_shape", "use_spec",
           "ActivationSharding", "Sharding", "mesh_axis_names", "mesh_shape"]

Spec = Tuple[Any, ...]


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for a DeviceMesh (whose ``shape`` is a tuple) or a
    mesh-like object whose ``shape`` already maps names to sizes."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh_axis_names(mesh), shape))


class ShardingRules:
    """Maps logical roles to mesh axes; override per experiment."""

    def __init__(
        self,
        mesh,
        *,
        batch_axes: Tuple[str, ...] = ("pod", "data"),
        fsdp_axis: Optional[str] = "data",
        tp_axis: Optional[str] = "model",
        expert_axis: Optional[str] = "data",
        shard_activations_embed: bool = False,
        attn_shard_mode: str = "heads",      # heads | seq
        moe_layout: str = "none",            # none | expert_major | grid
        seq_axis=None,                       # activation seq-dim sharding
    ):
        self.mesh = mesh
        names = mesh_axis_names(mesh)
        self._sizes = mesh_shape(mesh)

        def _valid(axis):
            if isinstance(axis, tuple):
                axis = tuple(a for a in axis if a in names)
                return axis or None
            return axis if axis in names else None

        self.batch_axes = tuple(a for a in batch_axes if a in names)
        self.fsdp_axis = _valid(fsdp_axis)
        self.tp_axis = _valid(tp_axis)
        self.expert_axis = _valid(expert_axis)
        self.shard_activations_embed = shard_activations_embed
        self.attn_shard_mode = attn_shard_mode
        self.moe_layout = moe_layout
        self.seq_axis = _valid(seq_axis)

    def size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self._sizes[a]
            return n
        return self._sizes[axis]

    def axis_if_divides(self, axis, dim: int):
        """axis may be a name or a tuple of names (multi-axis sharding)."""
        if axis is not None and dim > 0 and dim % self.size(axis) == 0:
            return axis
        return None

    def batch_spec_axes(self, batch: int):
        """Largest prefix of batch_axes whose product divides batch."""
        out = []
        prod = 1
        for a in self.batch_axes:
            if batch % (prod * self.size(a)) == 0:
                out.append(a)
                prod *= self.size(a)
        return tuple(out) if out else None


# ---------------------------------------------------------------------------
# Param rules (path-regex -> spec builder)
# ---------------------------------------------------------------------------


def _param_rule(path: str, shape: Tuple[int, ...], r: ShardingRules) -> Spec:
    """Assign a spec given the reference's param path and (stacked) shape.

    Paths look like: "embed", "blocks/pos0/attn/wq/w", "tail/tail0/mlp/wi",
    "blocks/pos0/moe/wi", "decoder/self_attn/wo/w", "lm_head", ...
    Leading stacked dims (scan repeats) are never sharded.
    """
    stacked = path.startswith(("blocks/", "decoder/", "encoder/"))
    lead: Spec = (None,) if stacked else ()
    body = shape[1:] if stacked else shape
    nb = len(body)

    def spec(*axes):
        return lead + axes

    fsdp, tp = r.fsdp_axis, r.tp_axis

    # ---- embeddings / heads -------------------------------------------------
    if re.fullmatch(r".*embed", path):
        return (r.axis_if_divides(tp, shape[0]), r.axis_if_divides(fsdp, shape[1]))
    if re.fullmatch(r".*lm_head", path):
        return (r.axis_if_divides(fsdp, shape[0]), r.axis_if_divides(tp, shape[1]))

    # ---- MoE ------------------------------------------------------------------
    if "/moe/" in path:
        if path.endswith("router"):
            return spec(r.axis_if_divides(fsdp, body[0]), None)
        # wi/wg/wo: (E, D, F) or (E, F, D)
        E = body[0]
        ea = r.axis_if_divides(r.expert_axis, E)

        def minus(axis, used):
            """axis with names already used removed (no duplicate axes)."""
            if axis is None:
                return None
            used_names = set(used if isinstance(used, tuple)
                             else ([] if used is None else [used]))
            names = axis if isinstance(axis, tuple) else (axis,)
            left = tuple(a for a in names if a not in used_names)
            return left if len(left) > 1 else (left[0] if left else None)

        if path.endswith(("wi", "wg")):
            d_axis = r.axis_if_divides(minus(fsdp, ea), body[1])
            return spec(ea, d_axis, r.axis_if_divides(tp, body[2]))
        d_axis = r.axis_if_divides(minus(fsdp, ea), body[2])
        return spec(ea, r.axis_if_divides(tp, body[1]), d_axis)

    # ---- biases / norms / vectors ------------------------------------------------
    if nb <= 1:
        return spec(*([None] * nb))

    # ---- attention projections ------------------------------------------------
    if re.search(r"(attn|self_attn|cross_attn)/w[qkv]/w$", path):
        return spec(r.axis_if_divides(fsdp, body[0]), r.axis_if_divides(tp, body[1]))
    if re.search(r"(attn|self_attn|cross_attn)/wo/w$", path):
        return spec(r.axis_if_divides(tp, body[0]), r.axis_if_divides(fsdp, body[1]))

    # ---- MLP ----------------------------------------------------------------------
    if re.search(r"mlp/(wi|wg)$", path):
        return spec(r.axis_if_divides(fsdp, body[0]), r.axis_if_divides(tp, body[1]))
    if re.search(r"mlp/wo$", path):
        return spec(r.axis_if_divides(tp, body[0]), r.axis_if_divides(fsdp, body[1]))

    # ---- SSM / recurrent ------------------------------------------------------------
    if re.search(r"ssm/in_proj$", path) or re.search(r"rec/(in_x|in_y)$", path):
        return spec(r.axis_if_divides(fsdp, body[0]), r.axis_if_divides(tp, body[1]))
    if re.search(r"ssm/out_proj$", path) or re.search(r"rec/out$", path):
        return spec(r.axis_if_divides(tp, body[0]), r.axis_if_divides(fsdp, body[1]))
    if re.search(r"rec/gate_[ri]$", path):
        return spec(r.axis_if_divides(fsdp, body[0]), r.axis_if_divides(tp, body[1]))
    if re.search(r"(ssm|rec)/conv_w$", path):
        return spec(None, r.axis_if_divides(tp, body[1]))

    # ---- fallback: shard the biggest dim on tp if divisible ----------------------------
    axes = [None] * nb
    order = sorted(range(nb), key=lambda i: -body[i])
    for i in order:
        a = r.axis_if_divides(tp, body[i])
        if a:
            axes[i] = a
            break
    return spec(*axes)


def _reference_leaves(params: Mapping[str, Any], period: int):
    """(reference path, stacked?, port names, reference shape) per leaf."""
    for path, names in jax_layout(params, period).items():
        if isinstance(names, list):
            yield path, True, names, (len(names),) + tuple(params[names[0]].shape)
        else:
            yield path, False, [names], tuple(params[names].shape)


def param_specs(params: Mapping[str, Any], rules: ShardingRules, period: int
                ) -> Dict[str, Spec]:
    """Spec per port param name (works on meta tensors: build the model
    with ``device="meta"``).  ``period`` is ``len(cfg.pattern)``."""
    out: Dict[str, Spec] = {}
    for path, stacked, names, shape in _reference_leaves(params, period):
        spec = _param_rule(path, shape, rules)
        for n in names:
            out[n] = spec[1:] if stacked else spec
    return out


def opt_state_specs(opt_state: Mapping[str, Any], params: Mapping[str, Any],
                    pspecs: Mapping[str, Spec], rules: ShardingRules,
                    period: int) -> Dict[str, Any]:
    """Optimizer-state specs, as a tree shaped like ``opt_state``.

    AdamW's ``m``/``v`` (keyed like the params) take their param's spec;
    Adafactor's ``vr``/``vc`` (keyed by the reference's path, stacked) take
    the matching prefix of the stacked param's spec, its unfactored ``v``
    the whole spec; 8-bit AdamW's ``q``/``scale`` blocks are replicated (the
    flattening breaks alignment with named dims), and so is the step.  The
    reference matches a state leaf to the first param of the same shape;
    here each leaf takes its own param's spec.
    """
    stacked_spec: Dict[str, Spec] = {}
    for path, stacked, names, _ in _reference_leaves(params, period):
        s = pspecs[names[0]]
        stacked_spec[path] = ((None,) + tuple(s)) if stacked else tuple(s)

    def leaf(key: str, sub: Any):
        if isinstance(sub, torch.Tensor):
            return tuple([None] * sub.dim())
        if all(isinstance(t, torch.Tensor) for t in sub.values()):   # adamw
            return {k: tuple(pspecs[k]) for k in sub}
        out = {}
        for path, st in sub.items():
            s = stacked_spec[path]
            if "vr" in st:
                out[path] = {"vr": s[:-1], "vc": s[:-2] + s[-1:]}
            elif "v" in st and isinstance(st["v"], torch.Tensor):
                out[path] = {"v": s}
            else:                                                # int8 blocks
                out[path] = {k: tuple([None] * t.dim()) for k, t in st.items()}
        return out

    return {k: leaf(k, v) for k, v in opt_state.items()}


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch: Mapping[str, Any], rules: ShardingRules) -> Dict[str, Spec]:
    """Inputs: batch dim over batch_axes; model-dim embeds optionally on tp."""
    out: Dict[str, Spec] = {}
    for name, leaf in batch.items():
        shape = tuple(leaf.shape)
        rest = [None] * (len(shape) - 1)
        if "frontend_embeds" in name and len(shape) == 3:
            rest[-1] = rules.axis_if_divides(rules.tp_axis, shape[-1])
        out[name] = (rules.batch_spec_axes(shape[0]), *rest)
    return out


def cache_specs(cache, rules: ShardingRules, batch: int):
    """Decode caches (the port's per-layer lists of dicts, or the
    encoder-decoder's ``{"self": [...], "cross": [...]}``): batch over
    batch_axes; the last dim that tp divides (heads, width) over tp, but a
    KV cache's heads (``"k"``/``"v"``, (B, L, H, dh)) where tp divides them
    (the reference splits its head dim): decode attention then reads the
    cache where it lies, and a head dim split where the heads do not divide
    leaves only partial scores to sum (``models/attention.py``)."""
    b_axes = rules.batch_spec_axes(batch)

    def assign(leaf, key=None):
        if isinstance(leaf, Mapping):
            return {k: assign(v, k) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [assign(v) for v in leaf]
        body = tuple(leaf.shape)
        axes = [None] * len(body)
        if body:
            axes[0] = b_axes if body[0] == batch else None
        order = list(range(len(body) - 1, 0, -1))
        if key in ("k", "v") and len(body) == 4:
            order.insert(0, 2)
        for i in order:
            a = rules.axis_if_divides(rules.tp_axis, body[i])
            if a:
                axes[i] = a
                break
        return tuple(axes)

    return assign(cache)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------


class Sharding(NamedTuple):
    """A spec laid on a DeviceMesh: the mesh and one DTensor placement per
    mesh dim (the counterpart of the reference's ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]


def _placements(mesh, spec: Sequence) -> Tuple[Any, ...]:
    """One placement a mesh dim; a dim of one rank replicates (the same
    layout, and DTensor will not reshape a dim sharded over it)."""
    from torch.distributed.tensor import Replicate, Shard

    where: Dict[str, int] = {}
    for dim, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                where[a] = dim
    sizes = mesh_shape(mesh)
    return tuple(Shard(where[a]) if a in where and sizes[a] > 1 else Replicate()
                 for a in mesh_axis_names(mesh))


def named(mesh, spec_tree):
    """A spec (or a dict tree of specs) as :class:`Sharding` on ``mesh``."""
    if isinstance(spec_tree, Mapping):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return Sharding(mesh, _placements(mesh, spec_tree))


def local_shard(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's piece of the global tensor ``x`` under ``sharding``
    (``torch.chunk`` along each sharded dim, in mesh-dim order, as DTensor
    splits)."""
    coord = sharding.mesh.get_coordinate()
    for mdim, pl in enumerate(sharding.placements):
        if pl.is_shard():
            n = sharding.mesh.size(mdim)
            if x.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does not "
                                 f"divide over {n} ranks")
            x = torch.chunk(x, n, dim=pl.dim)[coord[mdim]]
    return x


def from_local(local: torch.Tensor, sharding: Sharding, global_shape) -> Any:
    """This rank's piece as a DTensor of ``global_shape`` (contiguous) on
    the sharding's mesh; no communication."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(tuple(global_shape), device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(global_shape),
                              stride=stride)


def from_global(x: torch.Tensor, sharding: Sharding, device=None) -> Any:
    """``x``, the same global tensor on every rank, as a DTensor on the
    sharding's mesh, each rank keeping its own piece on ``device`` (the
    mesh's device type by default); no communication."""
    local = local_shard(x, sharding).to(device or sharding.mesh.device_type)
    return from_local(local, sharding, x.shape)


def local_shape(shape, sharding: Sharding) -> Tuple[int, ...]:
    """The shape of each rank's piece of a tensor of ``shape`` (the specs
    shard a dim only where its mesh axes divide it)."""
    out = list(shape)
    for mdim, pl in enumerate(sharding.placements):
        if pl.is_shard():
            out[pl.dim] //= sharding.mesh.size(mdim)
    return tuple(out)


def shard_tensor(x: torch.Tensor, sharding: Sharding) -> Any:
    """``x`` (the global tensor, the same on every rank) as a DTensor under
    ``sharding``; a ``meta`` tensor gets a ``meta`` piece of the local
    shape, any other keeps its device."""
    if x.is_meta:
        local = torch.empty(local_shape(x.shape, sharding), dtype=x.dtype,
                            device="meta")
    else:
        local = local_shard(x, sharding).contiguous()
    return from_local(local, sharding, x.shape)


def shard_tree(tree, spec_tree, mesh):
    """Every tensor of ``tree`` (dicts and lists of tensors) as a DTensor
    with its spec in ``spec_tree``; 0-dim tensors (the optimizer's step, a
    host scalar) stay as they are."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0:
            return tree
        return shard_tensor(tree, named(mesh, spec_tree))
    if isinstance(tree, Mapping):
        return {k: shard_tree(v, spec_tree[k], mesh) for k, v in tree.items()}
    return [shard_tree(v, s, mesh) for v, s in zip(tree, spec_tree)]


def use_spec(name: str, spec: Spec, rules: ShardingRules, moe_shard_map: bool) -> Spec:
    """The layout a parameter is used in: ``spec`` with the FSDP axes
    dropped (its TP axes kept); MoE expert weights under ``shard_map`` keep
    only the expert axis on their expert dim."""
    if moe_shard_map and re.search(r"moe\.(wi|wg|wo)$", name):
        ea = rules.expert_axis
        return (spec[0] if spec[0] == ea else None,) + (None,) * (len(spec) - 1)
    fsdp = rules.fsdp_axis
    drop = set(fsdp if isinstance(fsdp, tuple) else (fsdp,)) - {None}

    def keep(axis):
        names = tuple(a for a in (axis if isinstance(axis, tuple) else (axis,))
                      if a is not None and a not in drop)
        return names if len(names) > 1 else (names[0] if names else None)

    return tuple(keep(a) for a in spec)


def shard_model(model, rules: ShardingRules) -> Dict[str, Spec]:
    """Make every parameter of ``model`` a DTensor on the rules' mesh with
    its :func:`param_specs` placements, each rank keeping its piece (see the
    module docstring); returns the specs.  ``model.rt.act_sharding`` should
    hold the same rules, so that the activations follow them."""
    from torch import nn

    params = dict(model.named_parameters())
    specs = param_specs(params, rules, len(model.pattern))
    shard_map = getattr(model.rt, "moe_impl", None) == "shard_map"
    for name, p in params.items():
        new = nn.Parameter(shard_tensor(p.detach(), named(rules.mesh, specs[name])),
                           requires_grad=p.requires_grad)
        new.on_use = _placements(rules.mesh,
                                 use_spec(name, specs[name], rules, shard_map))
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner).register_parameter(leaf, new)
    return specs


def constrain(x, rules: ShardingRules, spec: Sequence):
    """A DTensor redistributed to ``spec`` on the rules' mesh, and its
    gradient redistributed to the same layout in the backward pass, as the
    reference's ``with_sharding_constraint`` constrains the cotangent too (a
    gradient left a partial sum would otherwise let the next matmul's
    backward gather its weight and run the whole product on every rank); a
    plain tensor is returned as it is (one process holds the whole of it)."""
    return pin(x, _placements(rules.mesh, spec))


def pin(x, placements: Sequence):
    """:func:`constrain` in DTensor placements: ``x`` redistributed to
    ``placements`` on its own mesh, its gradient to the same layout; a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, placements = x.device_mesh, tuple(placements)
    y = x.redistribute(mesh, placements)
    if not y.requires_grad:
        return y
    return DTensor.from_local(y.to_local(grad_placements=placements), mesh,
                              placements, run_check=False, shape=y.shape,
                              stride=y.stride())


class ActivationSharding:
    """Constraint points the models call (via RuntimeConfig.act_sharding).

    Batch over the data axes, vocab (logits) over tp, and optionally the
    embed dim over tp.  Each method redistributes a DTensor and returns a
    plain tensor as it is (the reference's "no-op when unset").
    """

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def _spec(self, x, last_axis) -> Spec:
        b_axes = self.rules.batch_spec_axes(x.shape[0])
        return (b_axes, *([None] * (x.dim() - 2)), last_axis)

    def hidden(self, x):
        """(B, S, D) residual-stream activations; with ``seq_axis`` set the
        seq dim is sharded too.

        Two layouts here are the port's own, not the reference's rule
        (``src/repro/train/sharding.py``, which constrains the stream to
        (batch, None, tp) in both cases); the dry-run's grid compares these
        cells' traffic with the reference's other layout.  In
        ``attn_shard_mode="seq"`` with no ``seq_axis`` the stream stays split
        on its sequence over tp between the sequence-parallel attention
        layers (Megatron's sequence parallelism), each layer's matmuls run
        on a rank's rows by weights gathered on tp
        (``models/common.py::linear``); the reference gathers the sequence.
        At one token a row (decode), D is split over the FSDP axes that the
        batch leaves whole, as the weights that keep their FSDP shard there
        take and give it (``models/common.py::on_use``), so the stream is
        never gathered; the reference leaves D whole there."""
        r = self.rules
        tp = (r.axis_if_divides(r.tp_axis, x.shape[-1])
              if r.shard_activations_embed else None)
        seq = r.seq_axis if r.seq_axis is not None else (
            r.tp_axis if r.attn_shard_mode == "seq" and tp is None else None)
        if (seq is not None and x.dim() == 3 and x.shape[1] > 1
                and x.shape[1] % r.size(seq) == 0):
            return constrain(x, r, (r.batch_spec_axes(x.shape[0]), seq, tp))
        if tp is None and x.dim() == 3 and one_row(x) and r.fsdp_axis:
            b_axes = r.batch_spec_axes(x.shape[0]) or ()
            free = tuple(a for a in (r.fsdp_axis if isinstance(r.fsdp_axis, tuple)
                                     else (r.fsdp_axis,)) if a not in b_axes)
            tp = r.axis_if_divides(free[0] if len(free) == 1 else (free or None),
                                   x.shape[-1])
        return constrain(x, r, self._spec(x, tp))

    def logits(self, x):
        """(B, S, V_pad): vocab over tp."""
        r = self.rules
        return constrain(x, r, self._spec(x, r.axis_if_divides(r.tp_axis, x.shape[-1])))

    def moe_expert_major(self, x):
        """(G, E, C, D/F) dispatched MoE activations: expert-major (E over
        the expert axis) under ``moe_layout="expert_major"``, token groups
        over tp and experts over the expert axis under ``"grid"``, else
        left alone."""
        r = self.rules
        if r.moe_layout == "grid":
            ga = r.axis_if_divides(r.tp_axis, x.shape[0])
            ea = r.axis_if_divides(r.expert_axis, x.shape[1])
            return constrain(x, r, (ga, ea, None, None))
        if r.moe_layout != "expert_major":
            return x
        ea = r.axis_if_divides(r.expert_axis, x.shape[1])
        return constrain(x, r, (None, ea, None, None))

    def _seq_attn_axis(self):
        """The mesh axis that splits q/k/v's sequence in mode "seq": tp, or
        ``seq_axis`` where the layout has no tp (ZeRO-3 with sequence
        parallelism, the multi-pod mesh's ``zero3`` and ``moe_ep``)."""
        r = self.rules
        return r.tp_axis if r.tp_axis is not None else r.seq_axis

    def _seq_mode(self, x) -> bool:
        r = self.rules
        axis = self._seq_attn_axis()
        return (r.attn_shard_mode == "seq" and axis is not None and x.shape[1] > 1
                and x.shape[1] % r.size(axis) == 0)

    def heads(self, x):
        """(B, S, H, dh) q/k/v: heads over tp when divisible (else
        replicated), or the sequence over tp (``seq_axis`` where there is no
        tp) in mode "seq" (context parallelism: the attention then splits the
        query rows there and gathers K/V, ``kernels/_local.py``, and its
        output stays sharded on the sequence).  Without tp the reference's
        rule constrains q/k/v to P(batch, None, None, None), whole on
        ``seq_axis``, and leaves the attention's split to GSPMD; here the
        sequence stays split where the residual stream splits it (a layout
        of the port's own, as :meth:`hidden`'s)."""
        r = self.rules
        b_axes = r.batch_spec_axes(x.shape[0])
        if self._seq_mode(x):
            return constrain(x, r, (b_axes, self._seq_attn_axis(), None, None))
        return constrain(x, r, (b_axes, None, r.axis_if_divides(r.tp_axis, x.shape[2]),
                                None))

    def attn_seq(self, x):
        """(B, S, H * dh) q/k/v projections in mode "seq": the sequence
        split as :meth:`heads` lays it out, before the heads' view (an
        all-to-all of the projection's shards; heads that do not divide tp
        would otherwise be gathered whole first); else left alone."""
        r = self.rules
        if not self._seq_mode(x):
            return x
        return constrain(x, r, (r.batch_spec_axes(x.shape[0]), self._seq_attn_axis(), None))

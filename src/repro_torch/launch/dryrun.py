"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell on
one rank of a fake production mesh; port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell with ``jax.jit(step,
in_shardings=..., out_shardings=...)`` on 256 or 512 fake host devices and
reads XLA's cost and memory analyses and the compiled HLO's collectives.
Here one process holds a fake process group (``torch.distributed`` backend
``"fake"``: every collective returns at once) of 256 ranks, as the
production mesh (16, 16) over ("data", "model") wants, or 512 for
(2, 16, 16) over ("pod", "data", "model"), and is its rank 0.  The model is
built on the ``meta`` device and its parameters, the optimizer state and the
inputs are made DTensors with their specs' placements whose local shards
are ``meta`` tensors (shapes without memory); the cell's real step (loss,
backward, clip and optimizer update; ``prefill``; or ``decode_step``) then
runs on them under :class:`~repro_torch.launch.hlo_analysis.CostCounter` and
:class:`~repro_torch.launch.hlo_analysis.CollectiveCounter`, which read the
ops rank 0 runs.  The mesh claims ``cuda`` (``--device cpu`` for the tests;
without it and without a CUDA runtime the run raises).  The dry-run runs
the plain paths (``runtime_for`` pins ``chunked``/``scan``): no kernel is
launched.

A build returns a :class:`Lowered`, the prepared callable and its inputs,
in place of JAX's lowered computation: ``lower_s`` is the time to build it
and ``compile_s`` the time of the traced step.  The records keep the
reference's keys, so ``benchmarks/roofline.py`` renders them.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch gemma2-9b --shape train_4k --mesh both --roofline
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, cell_runnable, get_config
from ..models import build_model
from ..train.optimizer import make_optimizer
from ..train.sharding import (ActivationSharding, ShardingRules, batch_specs,
                              mesh_axis_names, opt_state_specs, param_specs,
                              shard_model, shard_tree)
from ..train.step import make_train_step
from .hlo_analysis import (CARD, HW, CollectiveCounter, CostCounter,
                           roofline_terms)
from .mesh import make_production_mesh
from .specs import input_specs, runtime_for, serve_token_specs, train_config_for

__all__ = ["Lowered", "fake_process_group", "build_train_lowering",
           "build_prefill_lowering", "build_decode_lowering", "run_cell",
           "run_cell_roofline", "model_flops_for", "model_memory_bytes", "main"]


@contextmanager
def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit (the run leaves no group behind)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry-run "
                           "makes its own fake one")
    for name in ("torch.distributed.tensor._collective_utils",
                 "torch.distributed.tensor._redistribute"):
        logging.getLogger(name).setLevel(logging.ERROR)   # the CPU all-to-all note
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


def _data_parallel(mesh) -> int:
    n = 1
    for a, size in zip(mesh_axis_names(mesh), mesh.mesh.shape):
        if a in ("pod", "data"):
            n *= size
    return n


def _locals(tree) -> List[torch.Tensor]:
    """The local tensors of every (D)Tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Compiled:
    """What a traced step gives: the counterparts of ``cost_analysis()``,
    ``memory_analysis()`` and the collective inventory."""
    flops: float
    bytes: float
    memory: Dict[str, int]
    collectives: Any


@dataclasses.dataclass
class Lowered:
    """A cell's step, prepared: ``fn(*args)`` runs it on ``args``, the
    DTensors (and host scalars) it takes."""
    fn: Callable
    args: tuple

    def compile(self) -> Compiled:
        """Run the step once under the cost and collective counters."""
        from torch.distributed.tensor.experimental import implicit_replication

        cost, colls = CostCounter(), CollectiveCounter()
        cost.add_arguments(_locals(self.args))
        with implicit_replication(), cost, colls:
            out = self.fn(*self.args)
        seen, out_bytes, alias = set(), 0, 0
        for t in _locals(out):
            s = t.untyped_storage()
            if id(s) in seen:
                continue
            seen.add(id(s))
            out_bytes += s.nbytes()
            alias += s.nbytes() if cost.is_argument(t) else 0
        temp = max(0, cost.peak - (out_bytes - alias))
        memory = {"argument_bytes": cost.argument_bytes, "output_bytes": out_bytes,
                  "temp_bytes": temp, "alias_bytes": alias,
                  "peak_estimate_bytes": cost.argument_bytes + out_bytes + temp - alias}
        return Compiled(float(cost.flops), float(cost.bytes), memory, colls.stats)


def _sharded_model(cfg, rt, rules):
    model = build_model(cfg, rt, device="meta")
    shard_model(model, rules)
    return model


def build_train_lowering(cfg, shape, mesh, rules, rt_overrides=None,
                         tc_overrides=None):
    rt = runtime_for(cfg, shape, act_sharding=ActivationSharding(rules),
                     **(rt_overrides or {}))
    model = build_model(cfg, rt, device="meta")
    period = len(cfg.pattern)
    tc = train_config_for(cfg, shape, _data_parallel(mesh))
    if tc_overrides:
        tc = dataclasses.replace(tc, **tc_overrides)
    opt = make_optimizer(tc.optimizer, period=period)
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    ospecs = opt_state_specs(opt_state, params, param_specs(params, rules, period),
                             rules, period)
    shard_model(model, rules)
    params = dict(model.named_parameters())
    opt_state = shard_tree(opt_state, ospecs, mesh)
    opt_state["step"] = torch.zeros((), dtype=torch.int32)    # a host scalar
    batch = input_specs(cfg, shape)
    batch = shard_tree(batch, batch_specs(batch, rules), mesh)
    step = make_train_step(model, tc)
    return Lowered(step, (params, opt_state, batch)), {
        "microbatches": tc.microbatches, "optimizer": tc.optimizer.name,
        "step_kind": "train_step"}


def _meta_input(shape, dtype, spec, mesh):
    return shard_tree(torch.empty(shape, dtype=dtype, device="meta"), spec, mesh)


def build_prefill_lowering(cfg, shape, mesh, rules, rt_overrides=None):
    rt = runtime_for(cfg, shape, max_cache_len=shape.seq_len,
                     act_sharding=ActivationSharding(rules), **(rt_overrides or {}))
    model = _sharded_model(cfg, rt, rules)
    B, S = shape.global_batch, shape.seq_len
    b_axes = rules.batch_spec_axes(B)
    emb, i32 = torch.bfloat16, torch.int32
    if cfg.is_encoder_decoder:
        args = (_meta_input((B, S, cfg.d_model), emb, (b_axes, None, None), mesh),
                _meta_input((B, S), i32, (b_axes, None), mesh))
    elif cfg.frontend == "vision":
        Pf = cfg.frontend_tokens
        args = (_meta_input((B, S - Pf), i32, (b_axes, None), mesh),
                _meta_input((B, Pf, cfg.d_model), emb, (b_axes, None, None), mesh))
    else:
        args = (_meta_input((B, S), i32, (b_axes, None), mesh), None)
    return Lowered(model.prefill, args), {"step_kind": "prefill"}


def build_decode_lowering(cfg, shape, mesh, rules, rt_overrides=None):
    from torch.distributed.tensor.experimental import implicit_replication

    rt = runtime_for(cfg, shape, max_cache_len=shape.seq_len,
                     act_sharding=ActivationSharding(rules), **(rt_overrides or {}))
    model = _sharded_model(cfg, rt, rules)
    B, S = shape.global_batch, shape.seq_len
    b_axes = rules.batch_spec_axes(B)
    token, _ = serve_token_specs(cfg, shape)
    token = shard_tree(token, (b_axes, None), mesh)
    with implicit_replication(), torch.inference_mode():    # as decode_step's
        if cfg.is_encoder_decoder:
            enc = _meta_input((B, S, cfg.d_model), torch.bfloat16, (b_axes, None, None),
                              mesh)
            cache = model.init_cache(B, enc)
        else:
            cache = model.init_cache(B)
    # The last position: every cache is full (a ring has wrapped).
    return Lowered(model.decode_step, (cache, token, S - 1)), {"step_kind": "decode_step"}


def _build(cfg, shape, mesh, rules, rt_overrides, tc_overrides=None):
    if shape.kind == "train":
        return build_train_lowering(cfg, shape, mesh, rules, rt_overrides, tc_overrides)
    if shape.kind == "prefill":
        return build_prefill_lowering(cfg, shape, mesh, rules, rt_overrides)
    return build_decode_lowering(cfg, shape, mesh, rules, rt_overrides)


def _error(rec: Dict[str, Any], e: Exception) -> None:
    rec["status"] = "error"
    rec["error"] = f"{type(e).__name__}: {e}"
    rec["traceback"] = traceback.format_exc(limit=8)


def run_cell(arch: str, shape_name: str, mesh, rules=None,
             rt_overrides=None, tc_overrides=None,
             hw: HW = HW(), shape=None) -> Dict[str, Any]:
    """Build and trace one cell; return the §Dry-run / §Roofline record.
    ``shape`` replaces ``SHAPES[shape_name]`` (a cut batch, say)."""
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    cell = cell_runnable(arch, shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_tag(mesh),
        "runnable": cell.runnable, "skip_reason": cell.skip_reason,
    }
    if not cell.runnable:
        rec["status"] = "skipped"
        return rec
    rules = rules or ShardingRules(mesh)
    t0 = time.time()
    try:
        lowered, meta = _build(cfg, shape, mesh, rules, rt_overrides, tc_overrides)
        rec.update(meta)
        rec["lower_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        compiled = lowered.compile()
        rec["compile_s"] = round(time.time() - t1, 2)
        rec["hlo_flops"] = compiled.flops
        rec["hlo_bytes"] = compiled.bytes
        rec["memory"] = compiled.memory
        rec["collectives"] = compiled.collectives.to_json()
        rec["roofline"] = roofline_terms(
            rec["hlo_flops"], rec["hlo_bytes"],
            compiled.collectives.total_wire_bytes, hw)
        _add_model_terms(rec, cfg, shape, mesh.size(), hw)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - record, keep sweeping
        _error(rec, e)
    return rec


def _reduced_cfg(cfg, n_superblocks: int):
    """cfg with n_superblocks repeats of the layer pattern (no tail)."""
    k = len(cfg.pattern)
    kw = {"n_layers": k * n_superblocks}
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = n_superblocks
        kw["n_layers"] = n_superblocks
    return dataclasses.replace(cfg, **kw)


def run_cell_roofline(arch: str, shape_name: str, mesh, rules=None,
                      rt_overrides=None, hw: HW = HW()) -> Dict[str, Any]:
    """Roofline terms by the reference's 2-point layer extrapolation.

    The reference needs it because ``cost_analysis()`` counts a scan body
    once: it compiles unrolled graphs of 1 and 2 superblocks (microbatches
    1, single-block attention), takes the difference as the per-superblock
    cost and extrapolates linearly to the full depth:

        est(X) = X(1) + (X(2) - X(1)) * (n_layers/k - 1)

    A dispatch trace counts every op it runs, loops included, so here the
    extrapolation equals the full-depth trace of the same settings exactly
    where every superblock does the same work (mamba2-1.3b, internvl2-2b and
    seamless-m4t-medium at train_4k on 16 x 16: FLOPs, bytes and wire bytes
    to the last digit); it is kept for the reference's records and for its
    cost, two shallow traces.  It does not hold exactly, as in the
    reference, (1) where the depth is no whole number of superblocks
    (recurrentgemma-9b's 38 layers are 12 2/3 of its three-layer pattern,
    and its two tail layers count as 2/3 of one: FLOPs -0.11 %), and (2)
    where the full model takes another optimizer than the shallow ones
    (``train_config_for`` gives Adafactor above 1e11 parameters, so
    mixtral-8x22b and arctic-480b trace AdamW at one and two superblocks:
    the FLOPs agree, the optimizer's bytes and wire bytes do not).
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cell = cell_runnable(arch, shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_tag(mesh),
        "runnable": cell.runnable, "skip_reason": cell.skip_reason,
        "method": "2-point layer extrapolation (unrolled, micro=1)",
    }
    if not cell.runnable:
        rec["status"] = "skipped"
        return rec
    rules = rules or ShardingRules(mesh)
    rt_o = dict(rt_overrides or {})
    rt_o["scan_layers"] = False
    # Single-block attention, as the reference's (its chunked path hides
    # loops from cost_analysis; here it only matches the reference's terms).
    rt_o.setdefault("attn_block_q", shape.seq_len)
    rt_o.setdefault("attn_block_k", shape.seq_len)
    k = len(cfg.pattern)
    reps = cfg.n_layers / k if not cfg.is_encoder_decoder else cfg.n_layers
    try:
        points = []
        for n_sb in (1, 2):
            sub = _reduced_cfg(cfg, n_sb)
            lowered, _ = _build(sub, shape, mesh, rules, rt_o, {"microbatches": 1})
            t0 = time.time()
            compiled = lowered.compile()
            points.append({
                "flops": compiled.flops,
                "bytes": compiled.bytes,
                "wire": compiled.collectives.total_wire_bytes,
                "coll_counts": compiled.collectives.counts,
                "compile_s": round(time.time() - t0, 2),
            })
        p1, p2 = points

        def extrap(key):
            return p1[key] + (p2[key] - p1[key]) * (reps - 1)

        rec["per_superblock"] = {
            "flops": p2["flops"] - p1["flops"],
            "bytes": p2["bytes"] - p1["bytes"],
            "wire": p2["wire"] - p1["wire"],
        }
        rec["points"] = points
        rec["hlo_flops"] = extrap("flops")
        rec["hlo_bytes"] = extrap("bytes")
        rec["wire_bytes"] = extrap("wire")
        rec["roofline"] = roofline_terms(
            rec["hlo_flops"], rec["hlo_bytes"], rec["wire_bytes"], hw)
        _add_model_terms(rec, cfg, shape, mesh.size(), hw)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        _error(rec, e)
    return rec


def _add_model_terms(rec, cfg, shape, n_dev, hw):
    """Model-side accounting: useful flops, analytic memory bound, and
    roofline fractions against both the traced and analytic bounds."""
    model_flops = model_flops_for(cfg, shape)
    rec["model_flops_global"] = model_flops
    rec["model_flops_per_device"] = model_flops / n_dev
    mem_model = model_memory_bytes(cfg, shape, n_dev)
    r = rec["roofline"]
    r["memory_model_s"] = mem_model / hw.hbm_bw
    r["bound_model_s"] = max(r["compute_s"], r["memory_model_s"],
                             r["collective_s"])
    r["dominant_model"] = max(
        ("compute", r["compute_s"]), ("memory", r["memory_model_s"]),
        ("collective", r["collective_s"]), key=lambda kv: kv[1])[0]
    if rec["hlo_flops"] > 0:
        rec["useful_flops_ratio"] = (
            rec["model_flops_per_device"] / rec["hlo_flops"])
        ideal_s = rec["model_flops_per_device"] / hw.peak_flops
        rec["roofline_fraction"] = ideal_s / max(r["bound_s"], 1e-12)
        rec["roofline_fraction_model"] = ideal_s / max(
            r["bound_model_s"], 1e-12)


def model_memory_bytes(cfg, shape, n_dev: int) -> float:
    """Analytic per-device memory traffic (bytes/step), the reference's
    fusion-ideal LOWER bound beside the traced bytes' UPPER bound.

    Inventory (the reference's):
    - weights: fully sharded; train reads them 3x (fwd, remat fwd, bwd) +
      grad write/read + optimizer state read/write; prefill/decode 1x.
    - activations: residual stream + mlp/attn intermediates,
      ~(8*d_model + 3*d_ff_eff + heads) per token per layer, x4 train
      (fwd+remat+bwd write/read), x1.5 inference.
    - logits: tokens x padded_vocab x 4B x 3 / tp (sharded over tp=16).
    - decode adds the KV/state cache read+write.
    """
    pb = 2 if cfg.n_params() > 5e9 else 4
    P_tot, P_act = cfg.n_params(), cfg.n_active_params()
    B, S = shape.global_batch, shape.seq_len
    tp = 16
    opt_b = 6 if P_tot > 1e11 else 20
    if shape.kind == "train":
        tokens_loc = B * S / max(n_dev // tp, 1)
        weights = P_tot * (3 * pb + 8 + opt_b) / n_dev
    elif shape.kind == "prefill":
        tokens_loc = B * S / max(n_dev // tp, 1)
        weights = P_tot * pb / n_dev
    else:
        tokens_loc = max(B / max(n_dev // tp, 1), 1)
        weights = P_act * pb / n_dev
    d_ff_eff = cfg.d_ff + (cfg.experts_per_token * cfg.moe_d_ff
                           if cfg.n_experts else 0)
    attn_dim = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    per_tok_layer = (8 * cfg.d_model + 3 * d_ff_eff + attn_dim) * 2
    act_factor = 4.0 if shape.kind == "train" else 1.5
    n_layers = cfg.n_layers + (cfg.n_encoder_layers or 0)
    acts = tokens_loc * per_tok_layer * n_layers * act_factor / tp
    logits = tokens_loc * cfg.padded_vocab * 4 * 3 / tp
    cache = 0.0
    if shape.kind == "decode":
        ctx = min(S, cfg.sliding_window or S)
        if cfg.local_window:
            ctx = min(ctx, max(cfg.local_window,
                               S if "global" in cfg.pattern else 0)) or ctx
        kv_per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 2
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.pattern[i % len(cfg.pattern)]
                     in ("attn", "local", "global"))
        cache = (B / max(n_dev // tp, 1)) * ctx * kv_per_tok * n_attn / tp
        if cfg.family == "ssm":
            cache = (B / max(n_dev // tp, 1)) * cfg.n_layers * \
                cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 * 2 / tp
    return weights + acts + logits + cache


def _layer_window(cfg, kind: str):
    if kind == "local":
        return cfg.local_window
    if kind in ("attn", "global"):
        return cfg.sliding_window
    return None


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active per train token, 2*N_active per inference
    token, plus the attention term 4*H*dh*avg_ctx per token per attention
    layer (avg_ctx respects each layer kind's window)."""
    n_active = cfg.n_active_params()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        base = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = B * S
        base = 2.0 * n_active * tokens
    else:
        tokens = B  # one new token per sequence
        base = 2.0 * n_active * tokens
    if cfg.n_heads:
        dh, Hq = cfg.head_dim, cfg.n_heads
        bwd = 3.0 if shape.kind == "train" else 1.0
        for i in range(cfg.n_layers):
            kind = cfg.pattern[i % len(cfg.pattern)]
            if kind not in ("attn", "local", "global"):
                continue
            w = _layer_window(cfg, kind)
            if shape.kind == "decode":
                ctx = min(S, w) if w else S
                base += 4.0 * Hq * dh * ctx * B
            else:
                weff = min(w, S) if w else S
                avg_ctx = weff * (S - weff / 2.0) / S  # ->S/2 full, ->w long
                base += bwd * 4.0 * Hq * dh * avg_ctx * B * S
    return base


def _summary(rec: Dict[str, Any]) -> str:
    status = rec["status"]
    if status == "error":
        return f"    -> error {rec['error'][:200]}"
    if status != "ok":
        return f"    -> {status}"
    r = rec["roofline"]
    extra = (f" dominant={r['dominant']} compute={r['compute_s']:.4f}s"
             f" memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s")
    mem = rec.get("memory", {})
    if mem:
        extra += f" peak={mem.get('peak_estimate_bytes', 0) / 2**30:.2f}GiB"
    if "roofline_fraction" in rec:
        extra += f" roofline_frac={rec['roofline_fraction']:.3f}"
    if "compile_s" in rec:
        extra += f" trace={rec['compile_s']}s"
    return f"    -> ok{extra}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="2-point extrapolated roofline instead of the "
                         "full-depth cell")
    ap.add_argument("--layout", default="baseline",
                    help="baseline | seqpar | zero3 | moe_ep | auto "
                         "(presets, see launch/presets.py)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device type the mesh claims (cpu for tests)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA runtime; "
                           "pass --device cpu to trace on a cpu mesh")

    os.makedirs(args.out, exist_ok=True)
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    kind = "roofline" if args.roofline else "dryrun"
    hw = HW()
    print(f"hardware model: {CARD}: {hw}", flush=True)
    failed = 0
    for multi_pod in pods:
        with fake_process_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=args.device)
            tag = _mesh_tag(mesh)
            for arch in archs:
                for shape_name in shapes:
                    path = os.path.join(
                        args.out, f"{arch}__{shape_name}__{tag}"
                        + ("__roofline" if args.roofline else "") + ".json")
                    if args.skip_existing and os.path.exists(path):
                        print(f"[skip existing] {path}")
                        continue
                    print(f"=== [{kind}] {arch} x {shape_name} on {tag} ===",
                          flush=True)
                    rules = rt_o = tc_o = None
                    if args.layout != "baseline":
                        from .presets import resolve_layout

                        rules, rt_o, tc_o = resolve_layout(
                            get_config(arch), SHAPES[shape_name], mesh, args.layout)
                    rec = (run_cell_roofline(arch, shape_name, mesh, rules=rules,
                                             rt_overrides=rt_o, hw=hw)
                           if args.roofline else
                           run_cell(arch, shape_name, mesh, rules=rules,
                                    rt_overrides=rt_o, tc_overrides=tc_o, hw=hw))
                    rec["layout"] = args.layout
                    rec["device"] = args.device
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=2)
                    failed += rec["status"] == "error"
                    print(_summary(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

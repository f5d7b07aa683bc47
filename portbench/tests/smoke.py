"""Smoke-size cells for the CPU tests: the program's smoke configs in the
configuration file's keys, and cells of the real benchmark's metrics and
mixes at a few clients and short prompts."""

from __future__ import annotations

import dataclasses
import json

from portbench import harness

# smoke shapes: short prompts, a few clients, the dtypes of the real cells
MIXES = {
    "eval_score": {"kind": "closed_loop",
                   "prompt_tokens": {"dist": "log_uniform", "lo": 8, "hi": 40},
                   "output_tokens": {"dist": "uniform", "lo": 1, "hi": 1},
                   "cycle_waves": 4},
    "gen_long": {"kind": "closed_loop",
                 "prompt_tokens": {"dist": "log_uniform", "lo": 6, "hi": 24},
                 "output_tokens": {"dist": "uniform", "lo": 3, "hi": 9},
                 "cycle_waves": 1},
}


def dense_smoke_config() -> dict:
    """A dense configuration at the program's stablelm smoke sizes (no cell
    runs one yet): LayerNorm, a SwiGLU MLP, no experts."""
    cfg = smoke_config("mixtral-8x22b-d8", "stablelm-1.6b")
    cfg.pop("rms_norm_eps")
    cfg.update(norm="layernorm", layer_norm_eps=1e-6, rope_theta=10000.0,
               param_dtype="float32", runtime={})
    return cfg


def smoke_config(name: str, arch: str = "") -> dict:
    """The configuration file of ``name`` at the program's smoke sizes (of
    ``arch``, where given)."""
    from repro_torch.configs import get_smoke_config
    real = json.loads((harness.ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    mc = get_smoke_config(arch or real["arch"])
    cfg = dict(real, arch=mc.name)
    cfg.update(num_hidden_layers=mc.n_layers, hidden_size=mc.d_model,
               num_attention_heads=mc.n_heads, num_key_value_heads=mc.n_kv_heads,
               head_dim=mc.head_dim, vocab_size=mc.vocab_size,
               intermediate_size=mc.moe_d_ff if mc.n_experts else mc.d_ff,
               num_local_experts=mc.n_experts, num_experts_per_tok=mc.experts_per_token,
               cache_len=64)
    if mc.n_experts:
        cfg["runtime"] = dict(real["runtime"], capacity_factor=mc.n_experts / mc.experts_per_token)
    return cfg


# limits at the smoke sizes, between the program's readings there and the
# float8 control's, over 14 seeds a cell at the control test's sizes (one
# cycle; eval 16 clients on 8 rows, gen 32 on 32) and the cells' routing
# margins: clear logit error 0.0233 against 0.0913, widest clear gap 0.0717
# against 0.1092, mean gap 0.0041 against 0.0085
SMOKE_LIMITS = {"max_logit_gap_clear": 0.09, "mean_logit_gap": 0.006,
                "logit_error_max_clear": 0.06, "served_not_best_of_own_logits": 0}


def smoke_cell(workload: str, clients: int = 4, judge: int = 8, max_batch: int = 0,
               **spec) -> harness.Cell:
    """``workload`` at the smoke sizes: its numbers compared, at the smoke
    limits; the engine's ``max_batch`` half the clients where the cell's
    own is, else all of them."""
    real = harness.load_cell(workload)
    mix = workload.rsplit(".", 1)[-1]
    limits = {k: SMOKE_LIMITS[k] for k in real.spec["limits"]}
    if not max_batch:
        max_batch = clients * real.spec["max_batch"] // real.spec["clients"]
    return dataclasses.replace(
        real, config=smoke_config(workload[: -len(mix) - 1]), mix=MIXES[mix],
        spec=dict({"clients": clients, "max_batch": max_batch, "judge_requests": judge,
                   "routing_margin": real.spec["routing_margin"], "limits": limits}, **spec))

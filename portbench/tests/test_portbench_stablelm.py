"""StableLM 2 1.6B's configuration and cells (``configs/stablelm-1.6b.json``,
``reference/stablelm.py``, ``cells/stablelm-1.6b.*``) and the readers of the
dense model's spans: the harness loads the cells, refuses a program whose
rotary fraction or norm eps is not the file's, counts the program's
parameter bytes, and judges a smoke run as the decoder's cells are judged."""

import dataclasses

import pytest
import torch

from portbench import counts, harness, reference
from portbench.tests.smoke import smoke_cell, smoke_config

CELLS = ["stablelm-1.6b.eval_score", "stablelm-1.6b.gen_long"]
READERS = ["model.attn_us_per_prompt_token.eval", "model.mlp_us_per_prompt_token.eval",
           "model.mlp_ms_per_step.gen", "model.norm_us_per_prompt_token.eval"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_cells_load(workload):
    cell = harness.load_cell(workload)
    assert cell.chips == 1 and cell.config["arch"] == "stablelm-1.6b"
    assert reference.module(cell.config).__name__ == "portbench.reference.stablelm"
    assert cell.config["reduced"] == []
    assert cell.spec["max_batch"] == 32
    assert cell.spec["clients"] == (64 if workload.endswith("eval_score") else 32)
    names = {m["name"] for m in cell.end_to_end} | {m["name"] for m in cell.per_layer}
    assert "setup_s" in names
    assert ({"ttft_p95_ms", "prompt_tokens_per_s", "prefill_mfu", "flash_fwd_wgmma_roofline",
             "model.attn_us_per_prompt_token.eval", "model.mlp_us_per_prompt_token.eval",
             "model.norm_us_per_prompt_token.eval"}
            if workload.endswith("eval_score") else
            {"output_tokens_per_s", "decode_step_roofline_share", "model.attn_ms_per_step.gen",
             "model.mlp_ms_per_step.gen"}) <= names
    assert not any("moe" in n for n in names)


def test_the_program_is_the_files():
    from repro_torch.configs import get_config
    mc = harness.program_config(harness.load_cell(CELLS[0]).config, get_config)
    assert (mc.rotary_fraction, mc.norm_eps, mc.qkv_bias, mc.tie_embeddings) == (
        0.25, 1e-5, True, False)
    assert (mc.n_layers, mc.d_model, mc.n_heads, mc.n_kv_heads, mc.head_dim, mc.d_ff,
            mc.vocab_size, mc.norm) == (24, 2048, 32, 32, 64, 5632, 100352, "layernorm")


@pytest.mark.parametrize("key, value, file_key", [
    ("rotary_fraction", 1.0, "partial_rotary_factor"),
    ("norm_eps", 1e-6, "layer_norm_eps"),
    ("qkv_bias", False, "use_qkv_bias")])
def test_a_program_that_differs_is_refused(key, value, file_key):
    from repro_torch.configs import get_config
    cfg = harness.load_cell(CELLS[0]).config
    cfg = dict(cfg, runtime=dict(cfg["runtime"], **{key: value}))
    with pytest.raises(ValueError, match=file_key):
        harness.program_config(cfg, get_config)


def test_the_reference_refuses_a_fraction_it_cannot_rotate():
    cfg = dict(smoke_config("stablelm-1.6b"), partial_rotary_factor=3 / 16)
    with pytest.raises(ValueError, match="rotates 3 of 16"):
        reference.module(cfg).Reference(cfg, 0, "cpu")


def test_weight_bytes_are_the_programs():
    """The program at the published sizes, built on the meta device (no
    memory, no draw): its parameters but the embedding, in its dtypes."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = harness.load_cell(CELLS[0]).config
    model = build_model(harness.program_config(cfg, get_config),
                        harness.runtime_config(cfg), device="meta", seed=0)
    served = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                 if n != "embed")
    assert counts.weight_bytes(cfg) == served
    assert served == pytest.approx(2.878e9, rel=1e-3)       # 1.44 B in bf16


def _fp32(cell):
    return dataclasses.replace(cell, config=dict(cell.config, param_dtype="float32",
                                                  compute_dtype="float32"))


@pytest.mark.parametrize("workload", CELLS)
def test_a_smoke_run_is_judged_correct(workload):
    """At the smoke sizes in float32 the served tokens are the reference's
    best and the prefill's logits its own; in bfloat16, the cell passes its
    smoke limits."""
    from repro_torch.configs import get_smoke_config
    for cell, tight in ((_fp32(smoke_cell(workload, clients=4, judge=4)), True),
                        (smoke_cell(workload, clients=4, judge=4), False)):
        model = harness.build_program(cell.config, 7, "cpu", get_smoke_config)
        run = harness.Run(cell, model, 7)
        run.window(0.0)
        verdict, _ = harness.judge(cell, run.requests, run.model.prefills, 7, "cpu")
        assert verdict["judged_requests"] == 4
        assert verdict["clear_share"] == 1.0                 # no router: every position
        if tight:
            assert verdict["max_logit_gap"] < 1e-4 and verdict["logit_error_max"] < 1e-4
        assert harness.passes(harness.checks(cell, 0, verdict))


# ------------------------------------------------------------ readers

WAVES = [
    {"prompt_lens": [4, 1], "decode_steps": 2,
     "prefill_device_s": {"model.step": 0.45, "model.attn": 0.1, "model.mlp": 0.3,
                          "model.norm": 0.02},
     "decode_device_s": {"model.step": 0.18, "model.attn": 0.04, "model.mlp": 0.12}},
    {"prompt_lens": [2, 3], "decode_steps": 0,
     "prefill_device_s": {"model.step": 0.2, "model.attn": 0.05, "model.mlp": 0.1,
                          "model.norm": 0.03},
     "decode_device_s": {}},
]


def _read(name, waves):
    rec = {"waves": waves, "requests": [], "window_s": 1.0}
    return harness.read_metrics([{"name": name, "unit": "x"}], rec).get(name, {}).get("value")


def test_the_readers():
    # 10 prompt tokens: attention 0.15 s, MLP 0.4 s, norms 0.05 s; decode 2
    # steps, MLP 0.12 s
    assert _read(READERS[0], WAVES) == pytest.approx(1e6 * 0.15 / 10)
    assert _read(READERS[1], WAVES) == pytest.approx(1e6 * 0.4 / 10)
    assert _read(READERS[2], WAVES) == pytest.approx(1e3 * 0.12 / 2)
    assert _read(READERS[3], WAVES) == pytest.approx(1e6 * 0.05 / 10)


@pytest.mark.parametrize("name", READERS)
def test_a_run_without_the_span_reads_nothing(name):
    span = "model." + name.split(".")[1].split("_")[0]       # model.attn, .mlp, .norm
    bare = [{k: v for k, v in w.items() if not k.endswith("_device_s")} for w in WAVES]
    assert _read(name, bare) is None                         # an unprofiled run
    moe = [dict(w, **{k: {("model.moe" if s == span else s): t for s, t in w[k].items()}
                      for k in ("prefill_device_s", "decode_device_s")}) for w in WAVES]
    assert _read(name, moe) is None                          # no such span
    assert _read(name, []) is None


def test_the_readers_on_the_programs_own_waves():
    """The spans the smoke program fills under the profiler are the ones
    the readers read."""
    from repro_torch.configs import get_smoke_config
    cell = smoke_cell(CELLS[1], clients=2)
    model = harness.build_program(cell.config, 3, "cpu", get_smoke_config)
    run = harness.Run(cell, model, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rec = run.window(0.0, traced=True)
    for name in READERS:
        value = _read(name, rec["waves"])
        assert value is not None and value > 0, name

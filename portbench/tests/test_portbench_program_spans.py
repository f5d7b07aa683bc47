"""The readers of the program's own spans and counters (the engine's
``wave_stats`` keys that ``repro_torch.spans`` and the engine fill) on
synthetic waves worked out by hand, and ``None`` where a wave lacks the keys:
a program without them, as in a run of an older commit."""

import pytest

from portbench import harness

# two waves; the first decodes 2 steps, the second none (an eval wave)
WAVES = [
    {"batch": 2, "prompt_len": 4, "prompt_lens": [4, 1], "req_ids": [0, 1],
     "queue_s": [0.25, 0.5], "prefill_s": 0.5, "decode_s": 0.2, "decode_steps": 2,
     "decode_wait_s": 0.15, "decode_tokens": 2,
     "prefill_device_s": {"model.step": 0.45, "model.attn": 0.1, "model.moe": 0.3},
     "decode_device_s": {"model.step": 0.18, "model.attn": 0.04, "model.moe": 0.12},
     "moe_slots": 64, "moe_kept": 16},
    {"batch": 2, "prompt_len": 3, "prompt_lens": [2, 3], "req_ids": [2, 3],
     "queue_s": [1.0, 1.5], "prefill_s": 0.25, "decode_s": 0.01, "decode_steps": 0,
     "decode_wait_s": 0.0, "decode_tokens": 0,
     "prefill_device_s": {"model.step": 0.2, "model.attn": 0.05, "model.moe": 0.1},
     "decode_device_s": {}, "moe_slots": 48, "moe_kept": 12},
]
PROFILED = ("prefill_device_s", "decode_device_s", "moe_slots", "moe_kept")
NEW_KEYS = ("req_ids", "queue_s", "decode_wait_s") + PROFILED
METRICS = ["engine.queue_ms_p95.eval", "model.moe_ms_per_step.gen", "model.attn_ms_per_step.gen",
           "model.moe_us_per_prompt_token.eval", "moe.slot_use.eval"]


def read(name, waves):
    rec = {"waves": waves, "requests": [], "window_s": 1.0}
    return harness.read_metrics([{"name": name, "unit": "x"}], rec).get(name, {}).get("value")


def _without(*keys):
    return [{k: v for k, v in w.items() if k not in keys} for w in WAVES]


def test_queue_p95():
    # 0.25, 0.5, 1.0, 1.5 s: the inclusive method's 95th percentile lies at
    # 0.95 x 3 = 2.85 of the sorted rows, 1.0 + 0.85 x 0.5 = 1.425 s
    assert read("engine.queue_ms_p95.eval", WAVES) == pytest.approx(1425.0)


def test_decode_device_per_step():
    # the wave without decode steps is left out: 0.12 s and 0.04 s over 2 steps
    assert read("model.moe_ms_per_step.gen", WAVES) == pytest.approx(60.0)
    assert read("model.attn_ms_per_step.gen", WAVES) == pytest.approx(20.0)


def test_prefill_moe_per_prompt_token():
    # 0.3 + 0.1 s over 4 + 1 + 2 + 3 unpadded prompt tokens
    assert read("model.moe_us_per_prompt_token.eval", WAVES) == pytest.approx(4e4)


def test_slot_use():
    assert read("moe.slot_use.eval", WAVES) == pytest.approx(100 * 28 / 112)


@pytest.mark.parametrize("name", METRICS)
def test_none_without_the_programs_keys(name):
    assert read(name, _without(*NEW_KEYS)) is None
    assert read(name, []) is None


@pytest.mark.parametrize("name", ["model.moe_ms_per_step.gen", "model.attn_ms_per_step.gen",
                                  "model.moe_us_per_prompt_token.eval", "moe.slot_use.eval"])
def test_none_without_the_profilers_keys(name):
    """A wave served with the profiler off has the host keys only."""
    assert read(name, _without(*PROFILED)) is None


def test_slot_use_none_without_either_counter():
    assert read("moe.slot_use.eval", _without("moe_kept")) is None
    assert read("moe.slot_use.eval", _without("moe_slots")) is None


def test_none_where_nothing_decoded():
    eval_waves = [dict(w, decode_steps=0, decode_device_s={}) for w in WAVES]
    for name in ("model.moe_ms_per_step.gen", "model.attn_ms_per_step.gen"):
        assert read(name, eval_waves) is None

"""Each metric's reader on synthetic records and a synthetic trace."""

import math

import pytest

from portbench import counts, harness
from portbench.tests.test_portbench_counts import TINY

WAVES = [
    {"batch": 2, "prompt_len": 4, "prompt_lens": [4, 1], "output_lens": [3, 1],
     "prefill_s": 0.5, "decode_s": 0.2, "decode_steps": 2, "decode_tokens": 2},
    {"batch": 2, "prompt_len": 4, "prompt_lens": [2, 4], "output_lens": [1, 2],
     "prefill_s": 0.25, "decode_s": 0.1, "decode_steps": 1, "decode_tokens": 1},
]
REQUESTS = [{"prompt": [0] * n, "output": [1] * m, "ttft_s": t}
            for n, m, t in ((4, 3, 0.5), (1, 1, 0.5), (2, 1, 1.0), (4, 2, 1.0))]
TRACE = {"kernels": {"flash_fwd_wgmma_kernel<64>": [4, 2e-9], "gemm": [9, 1.0]},
         "busy_s": 0.75, "window_s": 1.0}


def rec(trace=None):
    return {"waves": WAVES, "requests": REQUESTS, "window_s": 2.0, "setup_s": 7.5,
            "config": TINY, "trace": trace}


def read(name, r):
    return harness.read_metrics([{"name": name, "unit": "x"}], r).get(name, {}).get("value")


def test_end_to_end():
    assert read("prompt_tokens_per_s", rec()) == 11 / 2.0
    assert read("output_tokens_per_s", rec()) == 7 / 2.0
    assert read("setup_s", rec()) == 7.5
    # the 95th percentile of 0.5, 0.5, 1.0, 1.0 (inclusive method): 1.0
    assert read("ttft_p95_ms", rec()) == pytest.approx(1000.0)


def test_engine():
    assert read("engine.pad_share.eval", rec()) == pytest.approx(100 * (16 - 11) / 16)
    assert read("engine.decode_ms_per_step.gen", rec()) == pytest.approx(1000 * 0.3 / 3)
    assert read("engine.active_row_share.gen", rec()) == pytest.approx(100 * 3 / 6)


def test_prefill_mfu():
    flops = counts.prefill_flops(TINY, [4, 1]) + counts.prefill_flops(TINY, [2, 4])
    assert read("prefill_mfu", rec()) == pytest.approx(
        100 * flops / (0.75 * counts.PEAK_BF16_FLOPS))


def test_decode_step_roofline_share():
    weights = counts.weight_bytes(TINY)
    # wave 1: step 0 serves row 0 (output 3) at context 4 + 1; step 1 row 0
    # at 6; wave 2: step 0 serves row 1 (output 2) at 4 + 1
    bound = sum(counts.decode_step(TINY, [c], weights)["seconds"] for c in (5, 6, 5))
    assert read("decode_step_roofline_share", rec()) == pytest.approx(100 * bound / 0.3)


def test_trace_readers():
    assert read("flash_fwd_wgmma_roofline", rec()) is None       # no trace
    bound = 2 * (counts.flash_call(TINY, [4, 1])["seconds"]
                 + counts.flash_call(TINY, [2, 4])["seconds"])
    assert read("flash_fwd_wgmma_roofline", rec(TRACE)) == pytest.approx(100 * bound / 2e-9)
    for name in ("device_idle_share.eval", "device_idle_share.gen"):
        assert read(name, rec()) is None
        assert read(name, rec(TRACE)) == pytest.approx(25.0)


def test_every_metric_has_a_reader():
    import json
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        value = read(m["name"], rec(TRACE))
        assert value is None or math.isfinite(value)

"""The timed spans on the card: CUDA timing events in place of the CPU's
host clock.  The file imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_spans_cuda.py

A smoke mixtral-8x22b wave served under ``torch.profiler`` on the card gets
device seconds for its timed spans, each within the host time of the phase
that holds it, and the same tokens as the wave served with the profiler off.
``chip_smoke.py --profile``'s table of a profiled prefill counts the kernels
alone, not the spans' ranges that the trace draws beside them.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' marks and the profiled kernels are the card's")


def _serve(model, traced):
    engine = ServeEngine(model, max_batch=3)
    rng = np.random.default_rng(2)
    for n in (7, 40, 13):
        engine.submit(rng.integers(3, model.cfg.vocab_size, size=n), max_new_tokens=8)
    if not traced:
        return engine, engine.run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        return engine, engine.run()


def _model():
    rt = RuntimeConfig(compute_dtype=torch.float32, moe_group_size=16, max_cache_len=64)
    return build_model(get_smoke_config("mixtral-8x22b"), rt, device="cuda", seed=3)


def test_timed_spans_read_cuda_events(card):
    model = _model()
    _, off = _serve(model, traced=False)
    engine, on = _serve(model, traced=True)
    assert [r.output for r in on] == [r.output for r in off]
    [stats] = engine.wave_stats
    for phase, host_s in (("prefill", stats["prefill_s"]), ("decode", stats["decode_s"])):
        secs = stats[f"{phase}_device_s"]
        assert set(secs) == {"model.step", "model.norm", "model.attn", "model.moe"}, phase
        assert 0 < secs["model.norm"] + secs["model.attn"] + secs["model.moe"] <= secs[
            "model.step"] <= host_s
    assert 0 < stats["moe_kept"] < stats["moe_slots"]


def test_profile_table_sums_kernels_alone(card):
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = _model()
    tokens = torch.randint(3, model.cfg.vocab_size, (2, 40), device="cuda")
    model.prefill(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name for e in device if e.is_user_annotation}
    assert {"model.step", "model.norm", "model.attn", "model.moe"} <= spans   # on the device
    kernels = [e for e in device if not e.is_user_annotation]
    busy_ms, idle, launches, top = chip_smoke.profile_table(torch, prof, window_us, top=50)
    assert launches == len(kernels)
    assert busy_ms == pytest.approx(sum(e.time_range.elapsed_us() for e in kernels) / 1e3)
    assert 0 < idle < 1
    assert not spans & {k["name"] for k in top}

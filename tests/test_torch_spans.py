"""The port's spans and counters (``repro_torch.spans``) in the serving engine,
on the CPU at the smoke sizes.

With the profiler off a wave enters no ``record_function`` and its
``wave_stats`` hold only the host-clock keys; under ``torch.profiler`` the
engine's and the model's ranges nest by time, the wave's entry gains the
timed spans' seconds and the MoE capacity counters, and what is served does
not change by a bit.
"""

import dataclasses
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.autograd.profiler_util import FunctionEvent  # noqa: E402
from torch.profiler import profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

LENGTHS = (7, 20, 13)            # one left-padded wave: S = 20, T = 60
NEW = 5
HOST_KEYS = {"batch", "prompt_len", "prompt_lens", "req_ids", "queue_s", "prefill_s",
             "decode_s", "decode_steps", "decode_wait_s", "decode_tokens"}
DEVICE_KEYS = {"prefill_device_s", "decode_device_s", "moe_slots", "moe_kept"}

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


def _model(**cfg_changes):
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"), **cfg_changes)
    rt = RuntimeConfig(compute_dtype=torch.float32, moe_group_size=16, max_cache_len=64)
    return build_model(cfg, rt, device="cpu", seed=1)


@pytest.fixture(scope="module")
def mixtral():
    return _model()


@pytest.fixture(scope="module")
def stablelm():
    """The published StableLM 2 block at the smoke sizes: q/k/v bias, RoPE on
    a quarter of each head, LayerNorm at eps 1e-5, a dense MLP."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), qkv_bias=True,
                              rotary_fraction=0.25, norm_eps=1e-5)
    rt = RuntimeConfig(compute_dtype=torch.float32, max_cache_len=64)
    return build_model(cfg, rt, device="cpu", seed=1)


class _Logits:
    """The model as the engine sees it, keeping every step's last logits."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        out = self.model.prefill(*args, **kw)
        self.logits.append(out[0][:, -1].clone())
        return out

    def decode_step(self, *args, **kw):
        out = self.model.decode_step(*args, **kw)
        self.logits.append(out[0][:, -1].clone())
        return out


def _serve(model, traced: bool, lengths=LENGTHS, gap_s: float = 0.0):
    """One wave of ``lengths`` through a fresh engine; (engine, requests,
    the model's logits, the profiler or None)."""
    seen = _Logits(model)
    engine = ServeEngine(seen, max_batch=len(lengths))
    rng = np.random.default_rng(5)
    for n in lengths:
        engine.submit(rng.integers(3, model.cfg.vocab_size, size=n), max_new_tokens=NEW)
        time.sleep(gap_s)
    if not traced:
        return engine, engine.run(), seen.logits, None
    with profile() as prof:
        done = engine.run()
    return engine, done, seen.logits, prof


def _ranges(prof):
    """{name: [(start_ns, end_ns)]} of the spans' profiler ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("engine.", "model.")):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(inner, outer):
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def test_profiler_off_enters_no_range(mixtral, monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert spans.span("a") is spans.span("b", timed=True)     # one shared null context
    engine, done, _, _ = _serve(mixtral, traced=False)
    assert entered == []
    [stats] = engine.wave_stats
    assert set(stats) == HOST_KEYS
    assert stats["decode_steps"] == NEW - 1
    assert 0 < stats["decode_wait_s"] < stats["decode_s"]
    _serve(mixtral, traced=True)
    assert {"engine.wave", "model.step", "model.moe"} <= set(entered)


def test_ranges_nest_by_time(mixtral):
    engine, _, _, prof = _serve(mixtral, traced=True)
    r = _ranges(prof)
    [stats] = engine.wave_stats
    layers = mixtral.cfg.n_layers
    assert len(r["engine.wave"]) == len(r["engine.prefill"]) == 1
    assert _inside(r["engine.prefill"], r["engine.wave"])
    prefill_step = [s for s in r["model.step"] if _inside([s], r["engine.prefill"])]
    assert len(prefill_step) == 1
    norms = 2 * layers + 1                                 # two a layer, the final norm
    in_prefill = [s for s in r["model.norm"] if _inside([s], r["engine.prefill"])]
    assert len(in_prefill) == norms and _inside(in_prefill, prefill_step)
    assert len(r["model.norm"]) == norms * (1 + stats["decode_steps"])
    for name in ("model.attn", "model.moe"):
        in_prefill = [s for s in r[name] if _inside([s], r["engine.prefill"])]
        assert len(in_prefill) == layers and _inside(in_prefill, prefill_step)
        assert len(r[name]) == layers * (1 + stats["decode_steps"])
        assert _inside(r[name], r["model.step"])
    steps = stats["decode_steps"]
    assert len(r["engine.decode_step"]) == steps + 1       # the last one only ends rows
    assert len(r["engine.decode.rows"]) == steps + 1
    assert len(r["engine.decode.launch"]) == len(r["engine.decode.wait"]) == steps
    for name in ("engine.decode.rows", "engine.decode.launch", "engine.decode.wait"):
        assert _inside(r[name], r["engine.decode_step"])
    assert _inside(r["engine.decode_step"], r["engine.wave"])
    decode_step = [s for s in r["model.step"] if _inside([s], r["engine.decode.launch"])]
    assert len(decode_step) == steps
    for key in ("prefill_device_s", "decode_device_s"):
        secs = stats[key]
        assert set(secs) == {"model.step", "model.norm", "model.attn", "model.moe"}
        assert 0 < secs["model.norm"] + secs["model.attn"] + secs["model.moe"] <= secs[
            "model.step"]


def test_profiler_on_serves_the_same_bits(mixtral):
    _, done_off, logits_off, _ = _serve(mixtral, traced=False)
    _, done_on, logits_on, _ = _serve(mixtral, traced=True)
    assert [r.output for r in done_on] == [r.output for r in done_off]
    assert len(logits_on) == len(logits_off) == NEW
    for on, off in zip(logits_on, logits_off):
        assert torch.equal(on, off)


def test_dense_spans_time_attention_and_mlp(stablelm):
    """A dense model's wave times ``model.norm``, ``model.attn`` and
    ``model.mlp`` (no MoE span or counter) in its prefill and its decode,
    each inside the step."""
    engine, _, _, prof = _serve(stablelm, traced=True)
    [stats] = engine.wave_stats
    assert set(stats) == HOST_KEYS | {"prefill_device_s", "decode_device_s"}
    for key in ("prefill_device_s", "decode_device_s"):
        secs = stats[key]
        assert set(secs) == {"model.step", "model.norm", "model.attn", "model.mlp"}
        assert 0 < secs["model.norm"] + secs["model.attn"] + secs["model.mlp"] <= secs[
            "model.step"]
    r = _ranges(prof)
    layers = stablelm.cfg.n_layers
    for name, n in (("model.norm", 2 * layers + 1), ("model.attn", layers),
                    ("model.mlp", layers)):
        assert len(r[name]) == n * (1 + stats["decode_steps"])
        assert _inside(r[name], r["model.step"])


def test_dense_profiler_on_serves_the_same_bits(stablelm):
    _, done_off, logits_off, _ = _serve(stablelm, traced=False)
    _, done_on, logits_on, _ = _serve(stablelm, traced=True)
    assert [r.output for r in done_on] == [r.output for r in done_off]
    assert len(logits_on) == len(logits_off) == NEW
    for on, off in zip(logits_on, logits_off):
        assert torch.equal(on, off)


@pytest.mark.parametrize("capacity_factor", [2.0, 1.25])
def test_moe_counters(capacity_factor, monkeypatch):
    model = _model(capacity_factor=capacity_factor)
    cfg = model.cfg
    routed = []
    route = moe._route

    def recording_route(p, x, cfg):
        out = route(p, x, cfg)
        routed.append(out[1].numpy())
        return out

    monkeypatch.setattr(moe, "_route", recording_route)
    engine, _, _, _ = _serve(model, traced=True)
    [stats] = engine.wave_stats
    T = len(LENGTHS) * max(LENGTHS)
    G, g, C = moe.moe_groups(T, cfg, model.rt)
    assert stats["moe_slots"] == cfg.n_layers * G * cfg.n_experts * C
    prefill = [idx for idx in routed if idx.shape[:2] == (G, g)]   # decode routes (B, 1)
    assert len(prefill) == cfg.n_layers
    if capacity_factor == cfg.n_experts / cfg.experts_per_token:
        assert C == g and stats["moe_kept"] == cfg.n_layers * T * cfg.experts_per_token
        return
    kept = 0
    for idx in prefill:                                    # (G, g, K) expert ids
        load = np.stack([np.bincount(group.ravel(), minlength=cfg.n_experts)
                         for group in idx])                # (G, E)
        kept += int(np.minimum(load, C).sum())
    assert kept < cfg.n_layers * T * cfg.experts_per_token   # some pairs dropped
    assert stats["moe_kept"] == kept


def test_queue_time_is_row_aligned(mixtral):
    engine, done, _, _ = _serve(mixtral, traced=False, gap_s=0.02)
    [stats] = engine.wave_stats
    assert stats["req_ids"] == [r.req_id for r in done]
    queue = stats["queue_s"]
    assert len(queue) == len(stats["prompt_lens"]) == len(LENGTHS)
    assert all(q >= 0 for q in queue)
    assert queue[0] > queue[1] > queue[2]                  # submitted in this order
    assert queue[0] - queue[2] >= 0.04


def test_decode_reads_each_steps_marks_during_the_next(mixtral, monkeypatch):
    """The engine reads a decode step's marks while the device runs the next
    step, so the wave's end reads only the last step's spans."""
    left = []
    totals = spans.Recorder.totals

    def counting_totals(self):
        left.append(self.marked())
        return totals(self)

    monkeypatch.setattr(spans.Recorder, "totals", counting_totals)
    engine, _, _, _ = _serve(mixtral, traced=True)
    [stats] = engine.wave_stats
    # two norms, attn and moe a layer; the final norm and the step
    assert left == [4 * mixtral.cfg.n_layers + 2]
    assert 0 < stats["decode_device_s"]["model.moe"] < stats["decode_device_s"]["model.step"]


def test_profile_table_counts_kernels_not_spans():
    """``chip_smoke.py --profile`` sums the device's kernels: a span's range,
    drawn on the device's timeline as a user annotation, is not one."""
    def event(i, name, start, end, annotation=False):
        return FunctionEvent(i, name, thread=0, start_us=start, end_us=end,
                             device_type=DeviceType.CUDA, is_user_annotation=annotation)

    class Prof:
        def events(self):
            return [event(0, "model.step", 0, 90, annotation=True),
                    event(1, "model.attn", 5, 40, annotation=True),
                    event(2, "gemm", 5, 35), event(3, "gemm", 45, 75),
                    event(4, "softmax", 35, 40),
                    FunctionEvent(5, "aten::mm", thread=0, start_us=0, end_us=100)]

    busy_ms, idle, launches, top = chip_smoke.profile_table(torch, Prof(), window_us=100.0)
    assert busy_ms == pytest.approx(0.065) and idle == pytest.approx(0.35)
    assert launches == 3
    assert [(k["name"], k["launches"]) for k in top] == [("gemm", 2), ("softmax", 1)]

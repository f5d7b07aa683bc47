"""``chip_smoke.py``'s hold of every kernel call of a pass to its plain
version (``held_calls``, ``hold_calls``), on the CPU with a stand-in
launcher.

On the card ``flash_cuda`` launches the Hopper kernel; here it is replaced
(monkeypatched) by a launcher that runs the kernel's plain version,
``_flash_chunked``, on the bf16 inputs and counts its launches as the real
wrapper does.  The smoke gemma3-12b (5 local layers with a 32-token window,
then a global one) serves one padded wave through ``ServeEngine`` with
``attn_impl="cuda"``, so that every attention layer's prefill goes through
the wrapper, as on the card.  The hold must see one call a layer, each with
its layer kind's window, pass the plain launcher, and refuse a launcher whose
output is 4 bf16 ulps off in one (row, head) and one that drops the window.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import _flash_chunked  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

LENGTHS = (20, 33, 45)       # straddling the smoke local window (32); row 2 unpadded
CFG = get_smoke_config("gemma3-12b")
KINDS = [CFG.pattern[i % len(CFG.pattern)] for i in range(CFG.n_layers)]
EXPECT = {"ssd_fwd": 0, "ssd_fwd_wgmma": 0, "rglru_fwd": 0,
          "flash_fwd": CFG.n_layers, "flash_fwd_wgmma": 0}   # head_dim 16: flash_fwd's


def _launcher(perturb=None, drop_window=False):
    """A stand-in for ``flash_cuda``: the plain version in the inputs' bf16,
    its output optionally perturbed, its launches counted as the real
    wrapper counts them."""
    def launch(q, k, v, *, causal=True, window=None, softcap=None, q_segments=None,
               kv_segments=None, q_offset=0, scale=None):
        out = _flash_chunked(q, k, v, causal=causal, window=None if drop_window else window,
                             softcap=softcap, q_segments=q_segments,
                             kv_segments=kv_segments, q_offset=q_offset, scale=scale,
                             block_q=16, block_k=16)
        # as the real wrapper counts: on its module's attribute of its name
        flash_kernel.flash_cuda.launches += 1
        return out if perturb is None else perturb(out)

    launch.launches = launch.wgmma_launches = 0
    return launch


def _four_ulps_off(out):
    """Row 2's first query (which attends its first key alone) in q head 0,
    moved up by 4 bf16 ulps."""
    out = out.clone()
    x = out[2, 0, 0].float()
    ulp = torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)
    out[2, 0, 0] = (x + 4 * ulp).to(out.dtype)
    return out


def _serve(monkeypatch, launcher):
    """The wave's run (to pass to the hold) after ``flash_cuda`` became
    ``launcher``."""
    monkeypatch.setattr(flash_kernel, "flash_cuda", launcher)
    model = build_model(CFG, RuntimeConfig(compute_dtype=torch.bfloat16, attn_impl="cuda",
                                           max_cache_len=64), device="cpu", seed=0)
    engine = ServeEngine(model, max_batch=len(LENGTHS))
    rng = np.random.default_rng(5)
    for n in LENGTHS:
        engine.submit(rng.integers(3, CFG.vocab_size, size=n), max_new_tokens=2)
    return engine.run


def test_the_hold_checks_every_layer_of_a_gemma3_wave(monkeypatch):
    run = _serve(monkeypatch, _launcher())
    with chip_smoke.held_calls(torch) as records:
        run()
    assert len(records) == CFG.n_layers
    assert [r["window"] for r in records] == [
        CFG.local_window if kind == "local" else None for kind in KINDS]
    assert KINDS.count("local") == 5 and KINDS.count("global") == 1
    assert all(r["kernel"] == "flash_fwd" and r["causal"] and r["segments"]
               and r["q"] == [len(LENGTHS), max(LENGTHS), CFG.n_heads, CFG.head_dim]
               for r in records)
    assert all(r["share"] <= 1.0 for r in records), [r["share"] for r in records]
    # the wrapper is the stand-in again after the block, with the launches
    # counted in it
    assert flash_kernel.flash_cuda.__name__ == "launch"
    assert flash_kernel.flash_cuda.launches == CFG.n_layers


def test_hold_calls_passes_the_plain_launcher_and_counts_its_launches(monkeypatch):
    run = _serve(monkeypatch, _launcher())
    summary = chip_smoke.hold_calls(torch, run, EXPECT, "smoke gemma3 wave")
    assert summary["flash_fwd"]["calls"] == CFG.n_layers
    assert 0.0 <= summary["flash_fwd"]["max_share_of_limit"] <= 1.0


def test_hold_calls_refuses_a_count_other_than_expected(monkeypatch):
    run = _serve(monkeypatch, _launcher())
    with pytest.raises(SystemExit):
        chip_smoke.hold_calls(torch, run, dict(EXPECT, flash_fwd=CFG.n_layers + 1),
                              "smoke gemma3 wave")


def test_the_hold_refuses_four_ulps_in_one_row_and_head(monkeypatch):
    run = _serve(monkeypatch, _launcher(perturb=_four_ulps_off))
    with chip_smoke.held_calls(torch) as records:
        run()
    assert len(records) == CFG.n_layers
    assert all(r["share"] > 1.0 for r in records), [r["share"] for r in records]


def test_the_hold_refuses_a_launcher_that_drops_the_window(monkeypatch):
    run = _serve(monkeypatch, _launcher(drop_window=True))
    with chip_smoke.held_calls(torch) as records:
        run()
    # the local layers' calls lie outside the limit, the global one's within
    assert [r["share"] > 1.0 for r in records] == [kind == "local" for kind in KINDS]
    run = _serve(monkeypatch, _launcher(drop_window=True))
    with pytest.raises(SystemExit):
        chip_smoke.hold_calls(torch, run, EXPECT, "smoke gemma3 wave")

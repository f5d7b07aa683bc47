"""The MoE family on the card against the same model on the CPU.

These tests need an NVIDIA GPU with ``nvcc`` (the attention kernels have no
CPU mode) and skip elsewhere.  The file imports no JAX, so it also runs on a
card machine that has none:

    python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Smoke mixtral-8x22b (a sliding window on every layer) and arctic-480b (the
dense residual MLP beside the experts) in fp32, with the same weights on
both devices: on the card prefill launches the flash-attention kernel and
the MoE runs its one-hot dispatch there; on the CPU everything runs the
plain versions.  Prefill under capacity drops (groups of 16) and 8 decode
steps, and one left-padded wave through ``ServeEngine``, are held to the CPU
within 3e-4 (tests/test_kernels.py::_tol, fp32).

One MoE decode layer at mixtral-8x22b's full width (8 experts, d_model
6144, d_ff 16384, bf16, 24 rows) against its plain einsum version: the
same values within the bf16 tolerance, and the call's memory rise under one
expert stack (1.61 GB), which the plain version's copies of wi and wg pass.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model, moe  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(atol=3e-4, rtol=3e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _both(arch, **cfg_changes):
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_changes)
    rt = RuntimeConfig(compute_dtype=torch.float32, moe_group_size=16, max_cache_len=96)
    cpu = build_model(cfg, rt, device="cpu", seed=3)
    gpu = build_model(cfg, rt, device="cuda", seed=3)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_prefill_and_decode_on_the_card_match_the_cpu(card, arch):
    cpu, gpu = _both(arch)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        3, cpu.cfg.vocab_size, size=(2, 70)))
    before = launch_counts()["flash_fwd"]
    runs = []
    for model in (cpu, gpu):
        logits, cache, pos = model.prefill(tokens.to(model.device))
        out = [logits]
        for i in range(8):
            tok = out[-1][:, -1].argmax(-1)[:, None]
            logits, cache = model.decode_step(cache, tok, pos + i)
            out.append(logits)
        runs.append(out)
    assert launch_counts()["flash_fwd"] == before + gpu.cfg.n_layers
    for want, got in zip(*runs):
        _close(got, want)


def test_padded_wave_on_the_card_matches_the_cpu(card):
    cpu, gpu = _both("mixtral-8x22b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 512, size=n) for n in (7, 20, 13, 45)]
    outs = []
    for model in (cpu, gpu):
        engine = ServeEngine(model, max_batch=4)
        for p in prompts:
            engine.submit(p, max_new_tokens=8)
        outs.append([r.output for r in engine.run()])
    assert outs[0] == outs[1]


def _einsum_decode(p, x, cfg):
    """The plain version of ``moe_decode``: einsums over the expert axis,
    whose first two multiply x by a (D, E * F) copy of wi and of wg."""
    gate, idx, _ = moe._route(p, x, cfg)
    h = torch.einsum("btd,edf->btef", x, p["wi"])
    g = torch.einsum("btd,edf->btef", x, p["wg"])
    ye = torch.einsum("btef,efd->bted", h * F.silu(g), p["wo"])
    w = sum(F.one_hot(idx[..., k], cfg.n_experts).float() * gate[..., k][..., None]
            for k in range(cfg.experts_per_token))
    return torch.einsum("bte,bted->btd", w.to(x.dtype), ye)


def _rise(fn):
    """fn's result and the most device memory allocated during it above
    what was allocated before."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def test_moe_decode_at_mixtral_width_runs_on_the_stacks_as_stored(card):
    cfg = get_config("mixtral-8x22b")
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device="cuda").manual_seed(29)

    def draw(shape, scale, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * scale

    p = {"router": draw((D, E), D ** -0.5, torch.float32),
         "wi": draw((E, D, Fd), D ** -0.5), "wg": draw((E, D, Fd), D ** -0.5),
         "wo": draw((E, Fd, D), Fd ** -0.5)}
    x = draw((24, 1, D), 1.0)
    stack = E * D * Fd * 2
    plain, plain_rise = _rise(lambda: _einsum_decode(p, x, cfg))
    y, rise = _rise(lambda: moe.moe_decode(p, x, cfg, RuntimeConfig()))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert plain_rise >= stack > rise, (plain_rise, rise)
    got, want = y.float(), plain.float()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=5e-2, rtol=5e-2)
    assert ((got - want).norm() / want.norm()).item() < 1e-2

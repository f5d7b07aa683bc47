"""The encoder-decoder on the card against the same model on the CPU, and
the flash-attention kernels on its shapes: non-causal, and Sq != Sk.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU mode)
and skip elsewhere.  The file imports no JAX, so it also runs on a card
machine that has none:

    python -m pytest -q -m cuda tests/test_torch_encdec_cuda.py

Smoke seamless-m4t-medium in fp32 with the same weights on both devices:
``forward`` (flash attention in the encoder, the decoder's self-attention
and its cross-attention at Sq != Sk), ``prefill`` and 8 ``decode_step``s
within 3e-4 (tests/test_kernels.py::_tol, fp32).  The kernels alone at
seamless's head_dim 64 in bf16 (``flash_fwd_wgmma``) are held to
``bf16_flash_limit`` against ``_flash_chunked`` in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import bf16_flash_limit  # noqa: E402
from repro_torch.kernels.flash_attention.ops import _flash_chunked  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(atol=3e-4, rtol=3e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def test_seamless_on_the_card_matches_the_cpu(card):
    cfg = get_smoke_config("seamless-m4t-medium")
    rt = RuntimeConfig(compute_dtype=torch.float32, max_cache_len=48)
    cpu = build_model(cfg, rt, device="cpu", seed=4)
    gpu = build_model(cfg, rt, device="cuda", seed=4)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    frames = torch.from_numpy((rng.standard_normal((2, 40, cfg.d_model)) * 0.1
                               ).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, 24)))
    before = launch_counts()["flash_fwd"]
    with torch.no_grad():
        full = [m({"frontend_embeds": frames.to(m.device), "tokens": tokens.to(m.device)})
                for m in (cpu, gpu)]
    assert launch_counts()["flash_fwd"] == before + cfg.n_encoder_layers + 2 * cfg.n_layers
    _close(full[1], full[0])
    runs = []
    for model in (cpu, gpu):
        logits, cache, pos = model.prefill(frames.to(model.device),
                                           tokens[:, :12].to(model.device))
        out = [logits]
        for i in range(8):
            tok = out[-1][:, -1].argmax(-1)[:, None]
            logits, cache = model.decode_step(cache, tok, pos + i)
            out.append(logits)
        runs.append(out)
    for want, got in zip(*runs):
        _close(got, want)


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv", [
    (256, 1024, 16, 16),     # seamless's cross-attention in forward
    (1024, 1024, 16, 16),    # its encoder
    (70, 333, 8, 2),         # ragged both ways, GQA
    (333, 70, 4, 4),         # more queries than keys
])
def test_flash_wgmma_non_causal_and_sq_ne_sk(card, Sq, Sk, Hq, Hkv):
    from repro_torch.kernels.flash_attention.kernel import flash_cuda
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda().bfloat16()
               for s in ((2, Sq, Hq, 64), (2, Sk, Hkv, 64), (2, Sk, Hkv, 64)))
    wgmma = flash_cuda.wgmma_launches
    out = flash_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_cuda.wgmma_launches == wgmma + 1
    opts = dict(causal=False, window=None, softcap=None, q_segments=None,
                kv_segments=None, q_offset=0, scale=None, block_q=128, block_k=128)
    want = _flash_chunked(q.double(), k.double(), v.double(), **opts)
    want_absv = _flash_chunked(q.double(), k.double(), v.double().abs(), **opts)
    err = (out.double() - want).abs()
    limit = bf16_flash_limit(want, want_absv)
    assert torch.isfinite(out).all()
    assert (err <= limit).all(), f"worst at {(err / limit).max().item():.3g} of the limit"

"""The hand-written flash-attention kernels (``flash_fwd_wgmma.cu`` for bf16
at head_dim 64/128/256, ``flash_fwd.cu`` for the rest) against their plain
version.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU mode)
and skip elsewhere.  The file imports no JAX, so it also runs on a card
machine that has none:

    python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

The yardstick is ``attention_reference`` in float64 on the card.  fp32 is held
to the reference's tolerance (tests/test_kernels.py::_tol, 3e-4).  bf16 is
held to ``bf16_flash_limit``: one bf16 ulp of the float64 result (2^-7
relative) plus fp32 slack, plus 2^-8 of the float64 result on |v|, the most
that rounding P to bf16 for the tensor cores can move the output.  That is
well inside ``_tol``'s 5e-2, which is larger than a typical attention output
here (tests/test_torch_flash_bound.py shows the limit refuses wrong masks).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (attention_reference,  # noqa: E402
                                                 bf16_flash_limit, flash_attention)

pytestmark = pytest.mark.cuda
TOL = {"float32": dict(atol=3e-4, rtol=3e-4)}


@pytest.fixture
def flash_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU mode")
    from repro_torch.kernels.flash_attention.kernel import flash_cuda
    return flash_cuda


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(tdt).cuda()
            for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _packed(B, Sq, Sk, q_offset=0, split=None):
    """Two packed sequences per row, split at key ``split``; the first three q
    rows carry a segment id that no key has, so they are fully masked."""
    split = Sk // 2 if split is None else split
    ks = torch.ones((B, Sk), dtype=torch.int32)
    ks[:, split:] = 2
    qs = torch.ones((B, Sq), dtype=torch.int32)
    qs[:, max(split - q_offset, 0):] = 2
    qs[:, :3] = 9
    return qs, ks


def _check(flash_cuda, seed, shape, dtype="float32", segments=None, **opts):
    q, k, v = _qkv(seed, *shape, dtype=dtype)
    seg = {}
    if segments is not None:
        seg = dict(q_segments=segments[0].cuda(), kv_segments=segments[1].cuda())
    out = flash_cuda(q, k, v, **opts, **seg)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    want = attention_reference(q.double(), k.double(), v.double(), **opts, **seg)
    if dtype == "float32":
        np.testing.assert_allclose(out.double().cpu().numpy(), want.cpu().numpy(),
                                   **TOL[dtype])
        return out
    want_absv = attention_reference(q.double(), k.double(), v.double().abs(), **opts, **seg)
    err = (out.double() - want).abs()
    limit = bf16_flash_limit(want, want_absv)
    assert torch.isfinite(out).all()
    ratio = (err / limit).max().item()
    assert ratio <= 1.0, (f"{int((err > limit).sum())} outputs beyond the bf16 limit, "
                          f"worst at {ratio:.3g} of it (max |err| {err.max().item():.3g})")
    return out


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cuda_head_dims(flash_cuda, D, dtype):
    _check(flash_cuda, D, (2, 130, 130, 4, 2, D), dtype, window=70)   # ragged


OPTIONS = [
    dict(causal=False),
    dict(softcap=50.0),
    dict(window=1),
    dict(causal=False, window=33, softcap=20.0),
]


@pytest.mark.parametrize("opts", OPTIONS)
def test_flash_cuda_options(flash_cuda, opts):
    _check(flash_cuda, 1, (1, 96, 96, 8, 2, 64), **opts)


def test_flash_cuda_q_offset_and_segments(flash_cuda):
    B, Sq, Sk = 2, 40, 150
    qs = torch.ones((B, Sq), dtype=torch.int32)
    ks = torch.ones((B, Sk), dtype=torch.int32)
    ks[:, 120:] = 2
    qs[:, 10:] = 2
    qs[:, :3] = 9                         # no key has segment 9: rows are zero
    out = _check(flash_cuda, 2, (B, Sq, Sk, 4, 1, 64), segments=(qs, ks),
                 q_offset=110, window=64)
    assert (out[:, :3] == 0).all()


# ---- the tensor-core route (bf16, head_dim 64/128/256) ------------------------

@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("case", [
    # Sq, Sk, q_offset, window: ragged lengths (not multiples of 128 or 64),
    # then q_offset with Sq < Sk, then a long MQA run over many KV tiles.
    (200, 200, 0, None),
    (70, 333, 263, 100),
    (1000, 1000, 0, 300),
])
def test_flash_wgmma_ragged_and_q_offset(flash_cuda, D, case):
    Sq, Sk, q_offset, window = case
    _check(flash_cuda, D + Sq, (2, Sq, Sk, 4, 1, D), "bfloat16", q_offset=q_offset,
           window=window)


@pytest.mark.parametrize("window", [
    100,    # the window's edge falls inside a KV tile of 64 keys
    128,    # the window's edge falls on tile boundaries
    2048,   # wider than the sequence: every tile below the diagonal is interior
])
def test_flash_wgmma_window_edges(flash_cuda, window):
    _check(flash_cuda, window, (2, 512, 512, 4, 1, 128), "bfloat16", window=window)


@pytest.mark.parametrize("opts", OPTIONS)
def test_flash_wgmma_options(flash_cuda, opts):
    _check(flash_cuda, 1, (1, 96, 96, 8, 2, 64), "bfloat16", **opts)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_softcap_gqa(flash_cuda, causal):
    _check(flash_cuda, 7, (2, 384, 384, 8, 4, 128), "bfloat16", softcap=50.0,
           causal=causal)


@pytest.mark.parametrize("D", [64, 256])
def test_flash_wgmma_masked_rows_are_zero(flash_cuda, D):
    B, S = 2, 300
    out = _check(flash_cuda, 11, (B, S, S, 4, 1, D), "bfloat16",
                 segments=_packed(B, S, S, split=130), window=200)
    assert (out[:, :3] == 0).all()


def test_flash_wgmma_launch_counts(flash_cuda):
    """bf16 at head_dim 256 takes the tensor-core route; fp32 and bf16 at
    head_dim 32 do not.  ``launches`` counts both routes."""
    routes = [("bfloat16", 256, 1), ("float32", 256, 0), ("bfloat16", 32, 0)]
    for dtype, D, wgmma in routes:
        q, k, v = _qkv(5, 1, 64, 64, 2, 1, D, dtype)
        launches, wgmma_launches = flash_cuda.launches, flash_cuda.wgmma_launches
        flash_cuda(q, k, v)
        torch.cuda.synchronize()
        assert flash_cuda.launches == launches + 1, (dtype, D)
        assert flash_cuda.wgmma_launches == wgmma_launches + wgmma, (dtype, D)


def test_flash_auto_launches_kernel(flash_cuda):
    """``flash_attention(impl="auto")`` on CUDA tensors goes through the
    kernel, once, and agrees with the chunked plain version."""
    q, k, v = _qkv(3, 2, 128, 128, 4, 1, 32)
    before = flash_cuda.launches
    out = flash_attention(q, k, v, window=48, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 1
    want = flash_attention(q.double(), k.double(), v.double(), window=48,
                           impl="chunked", block_q=64, block_k=64)
    np.testing.assert_allclose(out.double().cpu().numpy(), want.cpu().numpy(),
                               **TOL["float32"])


def test_flash_cuda_refuses_what_it_cannot_take(flash_cuda):
    q, k, v = _qkv(4, 1, 32, 32, 4, 2, 64)
    launches = flash_cuda.launches
    with pytest.raises(TypeError, match="takes q in"):
        flash_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k is"):
        flash_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_cuda(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="head_dim"):
        qb, kb, vb = (t[..., :48].bfloat16() for t in (q, k, v))
        flash_cuda(qb, kb, vb)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_cuda(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="both q_segments"):
        flash_cuda(q, k, v, q_segments=torch.ones((1, 32), device="cuda"))
    with pytest.raises(ValueError, match="different devices"):
        flash_cuda(q, k.cpu(), v)
    assert flash_cuda.launches == launches


def test_flash_cuda_refuses_inputs_that_require_grad(flash_cuda):
    """The kernel is forward-only: under grad mode, an input that requires
    grad is refused; under inference_mode, as serving runs, it launches."""
    q, k, v = _qkv(5, 1, 64, 64, 4, 1, 32)
    launches = flash_cuda.launches
    with pytest.raises(RuntimeError, match='forward-only.*impl="ref"'):
        flash_attention(q, k.requires_grad_(), v, block_q=64, block_k=64)
    assert flash_cuda.launches == launches
    with torch.inference_mode():
        out = flash_attention(q, k, v, block_q=64, block_k=64)
    assert flash_cuda.launches == launches + 1
    want = flash_attention(q.double(), k.detach().double(), v.double(),
                           impl="chunked", block_q=64, block_k=64)
    np.testing.assert_allclose(out.double().cpu().numpy(), want.cpu().numpy(),
                               **TOL["float32"])


# ---- padded serving waves (gemma2's regime: GQA 2, head_dim 256, softcap) ----

def _left_padded(lengths, S):
    seg = torch.zeros((len(lengths), S), dtype=torch.int32)
    for b, n in enumerate(lengths):
        seg[b, S - n:] = 1
    return seg, seg


@pytest.mark.parametrize("opts", [
    dict(causal=True),                     # a global layer
    dict(causal=True, window=300),         # a local layer
    # Non-causal, so that pad rows (segment 0) reach the keys past Sk, which
    # the kernel's last tile holds with segment 0 too: only its bounds test
    # keeps them out.
    dict(causal=False),
])
def test_flash_wgmma_padded_wave_gqa_softcap(flash_cuda, opts):
    """bf16 at head_dim 256, 4 q heads on 2 KV heads, softcap 50, rows
    LEFT-padded as the serving engine pads them, and Sk = 1000 = 15 x 64 + 40
    (the last KV tile is ragged)."""
    S = 1000
    _check(flash_cuda, 17, (3, S, S, 4, 2, 256), "bfloat16",
           segments=_left_padded((1000, 611, 37), S), softcap=50.0, **opts)


def test_padded_wave_launches_the_kernel_in_every_attention_layer(flash_cuda):
    """A smoke gemma2 (2 local and 2 global layers) served on the card in one
    padded wave: each attention layer's prefill launches flash attention once,
    on the tensor-core route in bf16 (head_dim 64 here) and on flash_fwd in
    fp32; every request gets its tokens."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"), head_dim=64)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
               for n in (70, 33, 129)]
    for dtype, wgmma in ((torch.bfloat16, cfg.n_layers), (torch.float32, 0)):
        model = build_model(cfg, RuntimeConfig(compute_dtype=dtype, max_cache_len=160),
                            device="cuda", seed=0)
        engine = ServeEngine(model, max_batch=3)
        ids = [engine.submit(p, max_new_tokens=5) for p in prompts]
        launches, wgmma_launches = flash_cuda.launches, flash_cuda.wgmma_launches
        engine.run()
        assert flash_cuda.launches - launches == cfg.n_layers, dtype
        assert flash_cuda.wgmma_launches - wgmma_launches == wgmma, dtype
        assert engine.wave_stats[-1]["prompt_lens"] == [70, 33, 129]
        assert all(len(engine.result(i).output) == 5 for i in ids)

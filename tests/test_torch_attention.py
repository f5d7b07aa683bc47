"""The port's attention module against ``repro.models.attention`` on the same
weights (made by the JAX initializer, carried across as numpy).

``attn_apply`` over a sliding window with packed segments, and
``attn_decode`` over a window-sized ring buffer that wraps (the decoder's
``_write_ring`` fills it from the prompt).  fp32 compute, tolerance 3e-4
(tests/test_kernels.py::_tol).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.common import RuntimeConfig, apply_rope  # noqa: E402
from repro_torch.weights import to_torch  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(atol=3e-4, rtol=3e-4)


def _setup(seed=0, **cfg_changes):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **cfg_changes)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **cfg_changes)
    jparams = jattn.attn_init(jcommon.Initializer(jax.random.PRNGKey(seed)),
                              jcfg, jnp.float32)
    if cfg.qkv_bias:      # the initializer zeroes biases: give them values
        rng = np.random.default_rng(seed + 100)
        for name in ("wq", "wk", "wv"):
            b = jparams[name]["b"]
            jparams[name]["b"] = jnp.asarray(
                rng.standard_normal(b.shape, dtype=np.float32) * 0.1)
    tparams = nn.ModuleDict({
        name: nn.ParameterDict({k: nn.Parameter(to_torch(np.asarray(v)),
                                                requires_grad=False)
                                for k, v in sub.items()})
        for name, sub in jparams.items()})
    return jcfg, cfg, jparams, tparams


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("jax_impl,impl", [("pallas_interpret", "chunked"),
                                           ("naive", "ref"), ("xla", "chunked")])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attn_apply_matches_jax(jax_impl, impl, qkv_bias):
    jcfg, cfg, jparams, tparams = _setup(qkv_bias=qkv_bias)
    B, S = 2, 48
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32) + 5, (B, S))
    segments = np.ones((B, S), np.int32)
    segments[1, :10] = 0                       # a left pad in row 1
    jrt = jcommon.RuntimeConfig(compute_dtype=jnp.float32, attn_impl=jax_impl,
                                attn_block_q=16, attn_block_k=16)
    trt = RuntimeConfig(compute_dtype=torch.float32, attn_impl=impl,
                        attn_block_q=16, attn_block_k=16)
    jy, (jk, jv) = jattn.attn_apply(
        jparams, jnp.asarray(x), jcfg, jrt, positions=jnp.asarray(positions),
        window=cfg.local_window, segments=jnp.asarray(segments), return_kv=True)
    ty, (tk, tv) = tattn.attn_apply(
        tparams, torch.from_numpy(x), cfg, trt,
        positions=torch.from_numpy(np.ascontiguousarray(positions)),
        window=cfg.local_window, segments=torch.from_numpy(segments),
        return_kv=True)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("prompt_len", [40, 70])
def test_attn_decode_over_wrapping_ring_matches_jax(prompt_len):
    """Ring of 64 slots, window 32: a 70-token prompt already wraps the ring
    at prefill (phase 70 % 64 = 6); a 40-token prompt wraps during decode."""
    jcfg, cfg, jparams, tparams = _setup(seed=2)
    B, L, window, steps = 2, 64, cfg.local_window, 30
    rng = np.random.default_rng(prompt_len)
    x = rng.standard_normal((B, prompt_len + steps, cfg.d_model), dtype=np.float32)
    jrt = jcommon.RuntimeConfig(compute_dtype=jnp.float32, attn_impl="naive")
    trt = RuntimeConfig(compute_dtype=torch.float32, attn_impl="ref")
    _, (jk, jv) = jattn.attn_apply(jparams, jnp.asarray(x[:, :prompt_len]), jcfg,
                                   jrt, window=window, return_kv=True)
    _, (tk, tv) = tattn.attn_apply(tparams, torch.from_numpy(x[:, :prompt_len]),
                                   cfg, trt, window=window, return_kv=True)
    jcache = jdec._write_ring(jattn.init_kv_cache(jcfg, B, L, jnp.float32), jk, jv)
    tcache = tdec._write_ring(tattn.init_kv_cache(cfg, B, L, torch.float32,
                                                  torch.device("cpu")), tk, tv)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    ctx = np.array([0, 3], np.int32)           # row 1 starts at position 3
    for step in range(steps):
        pos = prompt_len + step
        xt = x[:, pos:pos + 1]
        jy, jcache = jattn.attn_decode(jparams, jnp.asarray(xt), jcache,
                                       jnp.asarray(pos, jnp.int32), jcfg, jrt,
                                       window=window,
                                       context_start=jnp.asarray(ctx))
        ty, tcache = tattn.attn_decode(tparams, torch.from_numpy(xt), tcache, pos,
                                       cfg, trt, window=window,
                                       context_start=torch.from_numpy(ctx))
        _close(ty, jy)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_attn_decode_linear_cache_matches_jax():
    """No window: slot = pos, valid = slot <= pos."""
    jcfg, cfg, jparams, tparams = _setup(seed=3)
    B, L = 2, 24
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, L, cfg.d_model), dtype=np.float32)
    jrt = jcommon.RuntimeConfig(compute_dtype=jnp.float32)
    trt = RuntimeConfig(compute_dtype=torch.float32)
    jcache = jattn.init_kv_cache(jcfg, B, L, jnp.float32)
    tcache = tattn.init_kv_cache(cfg, B, L, torch.float32, torch.device("cpu"))
    for pos in range(L):
        xt = x[:, pos:pos + 1]
        jy, jcache = jattn.attn_decode(jparams, jnp.asarray(xt), jcache,
                                       jnp.asarray(pos, jnp.int32), jcfg, jrt)
        ty, tcache = tattn.attn_decode(tparams, torch.from_numpy(xt), tcache, pos,
                                       cfg, trt)
        _close(ty, jy)


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 3, 16), dtype=np.float32)
    pos = rng.integers(0, 5000, size=(2, 10)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0), want)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.arange(10), 10000.0)
    _close(apply_rope(torch.from_numpy(x), torch.arange(10), 10000.0), want)

"""The port's attention op (repro_torch.kernels.flash_attention) against the
JAX package's Pallas kernel in interpret mode.

The same numpy inputs go through ``flash_attention(impl="pallas_interpret")``
and through the port's chunked online-softmax path (the CUDA kernel's plain
version) and its naive reference.  Cases cover causal, sliding window,
softcap, GQA and MQA, bidirectional, packed segments that leave rows fully
masked, ``q_offset`` and bf16.  Tolerances are the reference's own
(tests/test_kernels.py::_tol): fp32 3e-4, bf16 5e-2.  The CUDA kernel itself
runs only on the card: tests/test_torch_flash_cuda.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_reference,  # noqa: E402
                                                 flash_attention)

TOL = {"float32": dict(atol=3e-4, rtol=3e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
PORT_IMPLS = ["chunked", "ref"]


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32))


def _segments(B, Sq, Sk, q_offset=0):
    """Two packed sequences per row; the first q rows carry a segment id that
    no key has, so they are fully masked."""
    qs = np.ones((B, Sq), np.int32)
    ks = np.ones((B, Sk), np.int32)
    ks[:, Sk // 2:] = 2
    qs[:, max(Sk // 2 - q_offset, 0):] = 2
    qs[:, :4] = 7
    return qs, ks


@functools.lru_cache(maxsize=None)
def _jax_out(seed, shape, dtype, opts, block):
    q, k, v = _qkv(seed, *shape)
    kw = dict(opts)
    if kw.pop("segments", False):
        qs, ks = _segments(shape[0], shape[1], shape[2], kw.get("q_offset", 0))
        kw.update(q_segments=jnp.asarray(qs), kv_segments=jnp.asarray(ks))
    jdt = getattr(jnp, dtype)
    out = jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                    impl="pallas_interpret", block_q=block, block_k=block, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port_out(seed, shape, dtype, opts, impl, block):
    q, k, v = _qkv(seed, *shape)
    kw = dict(opts)
    if kw.pop("segments", False):
        qs, ks = _segments(shape[0], shape[1], shape[2], kw.get("q_offset", 0))
        kw.update(q_segments=torch.from_numpy(qs), kv_segments=torch.from_numpy(ks))
    tdt = getattr(torch, dtype)
    out = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          impl=impl, block_q=block, block_k=block, **kw)
    assert out.dtype == tdt
    return out.float().numpy()


CASES = [
    # (B, Sq, Sk, Hq, Hkv, D), options
    ((1, 64, 64, 4, 4, 16), (("causal", True),)),                      # MHA
    ((2, 64, 64, 8, 2, 16), (("causal", True),)),                      # GQA
    ((1, 64, 64, 4, 1, 32), (("causal", True),)),                      # MQA
    ((2, 64, 64, 4, 2, 16), (("causal", True), ("window", 24))),       # window
    ((1, 64, 64, 4, 2, 16), (("causal", True), ("softcap", 30.0))),    # softcap
    ((1, 64, 64, 4, 2, 16), (("causal", False),)),                     # encoder
    ((2, 64, 64, 4, 2, 16), (("causal", True), ("window", 16), ("softcap", 50.0))),
    ((2, 64, 64, 4, 1, 16), (("causal", True), ("segments", True))),   # packed
    ((1, 16, 64, 4, 2, 16), (("causal", True), ("q_offset", 48))),     # decode chunk
    ((1, 32, 64, 4, 1, 16), (("causal", True), ("window", 20), ("q_offset", 32),
                             ("segments", True))),
]


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("shape,opts", CASES)
def test_flash_matches_jax_pallas(impl, shape, opts):
    want = _jax_out(0, shape, "float32", opts, 16)
    got = _port_out(0, shape, "float32", opts, impl, 16)
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_flash_bf16_matches_jax_pallas(impl):
    shape, opts = (2, 64, 64, 4, 1, 32), (("causal", True), ("window", 24))
    want = _jax_out(1, shape, "bfloat16", opts, 32)
    got = _port_out(1, shape, "bfloat16", opts, impl, 32)
    np.testing.assert_allclose(got, want, **TOL["bfloat16"])


def test_fully_masked_rows_are_zero():
    shape, opts = (2, 64, 64, 4, 1, 16), (("causal", True), ("segments", True))
    got = _port_out(0, shape, "float32", opts, "chunked", 16)
    assert np.all(got[:, :4] == 0.0)          # segment 7 has no keys
    assert np.abs(got[:, 4:]).max() > 0


def test_chunked_single_block_is_the_reference():
    """One block each way: the chunked path is the reference, as _flash_xla."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 32, 32, 4, 2, 16))
    got = flash_attention(q, k, v, window=8, impl="chunked", block_q=64, block_k=64)
    torch.testing.assert_close(got, attention_reference(q, k, v, window=8))


def test_flash_dispatch_refuses_what_it_cannot_do():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 48, 48, 4, 2, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, k, v, impl="cuda", block_q=16, block_k=16)
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, k, v, impl="pallas")
    # The reference asserts that the blocks divide Sq and Sk (48 is not a
    # multiple of 32); the port's routes take any length: the kernel route
    # raises its device error, the plain version masks its short last blocks.
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, k, v, impl="cuda", block_q=32, block_k=32)
    np.testing.assert_allclose(
        flash_attention(q, k, v, impl="chunked", block_q=32, block_k=32).numpy(),
        attention_reference(q, k, v).numpy(), atol=3e-4, rtol=3e-4)
    with pytest.raises(AssertionError):
        jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                  impl="pallas_interpret", block_q=32, block_k=32)

"""The port's RG-LRU op (repro_torch.kernels.rglru) against the JAX package's.

The same numpy inputs go through the JAX reference and its Pallas kernel
(interpret mode), and through the port's sequential reference, its
log-depth scan (the CUDA kernel's plain version) and its decode step.
Tolerances are the reference's own (tests/test_kernels.py::_tol): fp32
3e-4, bf16 5e-2.  The CUDA kernel itself runs only on the card:
tests/test_torch_rglru_cuda.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru import rglru as jax_rglru  # noqa: E402
from repro.kernels.rglru import rglru_reference as jax_rglru_reference  # noqa: E402
from repro_torch.kernels.rglru import (rglru, rglru_reference,  # noqa: E402
                                       rglru_step)

TOL = {"float32": dict(atol=3e-4, rtol=3e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _inputs(seed, B, S, W):
    """numpy counterpart of tests/test_kernels.py::_rglru_inputs (fp32)."""
    rng = np.random.default_rng(seed)
    x, r, i = (rng.standard_normal((B, S, W), dtype=np.float32) for _ in range(3))
    lam = rng.standard_normal((W,), dtype=np.float32)
    h0 = rng.standard_normal((B, W), dtype=np.float32) * 0.2
    return x, r, i, lam, h0


def _close(got, want, dtype="float32"):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


@functools.lru_cache(maxsize=None)
def _jax_out(seed, shape, impl, dtype, with_h0):
    x, r, i, lam, h0 = _inputs(seed, *shape)
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(a).astype(jdt) for a in (x, r, i)] + [jnp.asarray(lam)]
    h0 = jnp.asarray(h0) if with_h0 else None
    if impl == "ref":
        y, hf = jax_rglru_reference(*args, h0)
    else:
        y, hf = jax_rglru(*args, h0, chunk=16, impl=impl)
    return np.asarray(y.astype(jnp.float32)), np.asarray(hf)


def _port_args(seed, shape, dtype):
    x, r, i, lam, h0 = _inputs(seed, *shape)
    tdt = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in (x, r, i)]
            + [torch.from_numpy(lam)], torch.from_numpy(h0))


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("impl", ["scan", "ref", "auto"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_matches_jax(jax_impl, impl, with_h0):
    shape = (2, 48, 64)
    args, h0 = _port_args(0, shape, "float32")
    y, hf = rglru(*args, h0 if with_h0 else None, impl=impl)
    y_want, hf_want = _jax_out(0, shape, jax_impl, "float32", with_h0)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    _close(y, y_want)
    _close(hf, hf_want)


@pytest.mark.parametrize("S", [1, 5, 37, 128])
def test_rglru_scan_ragged_lengths_match_jax_reference(S):
    """The log-depth scan at lengths that are not powers of two."""
    shape = (2, S, 32)
    args, h0 = _port_args(S, shape, "float32")
    y, hf = rglru(*args, h0, impl="scan")
    y_want, hf_want = _jax_out(S, shape, "ref", "float32", True)
    _close(y, y_want)
    _close(hf, hf_want)


@pytest.mark.parametrize("impl", ["scan", "ref"])
def test_rglru_bf16_matches_jax(impl):
    shape = (2, 64, 64)
    args, h0 = _port_args(1, shape, "bfloat16")
    y, hf = rglru(*args, h0, impl=impl)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    y_want, hf_want = _jax_out(1, shape, "pallas_interpret", "bfloat16", True)
    _close(y, y_want, "bfloat16")
    _close(hf, hf_want, "bfloat16")


def test_rglru_decode_chain_equals_scan():
    """tests/test_kernels.py::test_rglru_decode_chain, on the port."""
    args, h0 = _port_args(2, (2, 16, 32), "float32")
    x, r, i, lam = args
    h = h0
    ys = []
    for t in range(16):
        y_t, h = rglru_step(h, x[:, t], r[:, t], i[:, t], lam)
        assert y_t.dtype == x.dtype and h.dtype == torch.float32
        ys.append(y_t)
    y_want, hf_want = _jax_out(2, (2, 16, 32), "ref", "float32", True)
    _close(torch.stack(ys, dim=1), y_want)
    _close(h, hf_want)


def test_rglru_step_returns_x_dtype_and_fp32_state():
    args, h0 = _port_args(3, (2, 1, 16), "bfloat16")
    x, r, i, lam = args
    y, h = rglru_step(h0, x[:, 0], r[:, 0], i[:, 0], lam)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_ref, h_ref = rglru_reference(x, r, i, lam, h0)
    torch.testing.assert_close(h, h_ref)
    torch.testing.assert_close(y, y_ref[:, 0])


def test_rglru_dispatch_refuses_what_it_cannot_do():
    args, h0 = _port_args(4, (1, 8, 16), "float32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rglru(*args, h0, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        rglru(*args, h0, impl="pallas")
    # The reference's kernel route asserts S % chunk == 0; the port's takes
    # any S (its kernel scans in chunks of its own), so at S = 300 it raises
    # its device error, as at any length.
    args, h0 = _port_args(4, (1, 300, 16), "float32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rglru(*args, h0, impl="cuda")
    with pytest.raises(AssertionError):
        jax_rglru(*[jnp.asarray(a.numpy()) for a in args], jnp.asarray(h0.numpy()),
                  impl="pallas_interpret")

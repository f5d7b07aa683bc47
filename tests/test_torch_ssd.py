"""The port's SSD op (repro_torch.kernels.ssd) against the JAX package's.

The same numpy inputs go through the JAX reference, its chunked XLA path and
its Pallas kernel (interpret mode), and through the port's sequential
reference, its chunked plain-torch path and its decode step.  Tolerances are
the reference's own (tests/test_kernels.py::_tol): fp32 3e-4, bf16 5e-2.
The CUDA kernel itself runs only on the card: tests/test_torch_ssd_cuda.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd import ssd_reference as jax_ssd_reference  # noqa: E402
from repro_torch.kernels.ssd import ssd, ssd_reference, ssd_step  # noqa: E402
from repro_torch.kernels.ssd.ops import _ssd_chunked  # noqa: E402

PORT_IMPLS = ["chunked", "ref"]
JAX_IMPLS = ["ref", "xla", "pallas_interpret"]
TOL = {"float32": dict(atol=3e-4, rtol=3e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _ssd_inputs(seed, B, S, H, P, N):
    """numpy counterpart of tests/test_kernels.py::_ssd_inputs (fp32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H)))) * 0.5 + 0.5
    Bm = rng.standard_normal((B, S, N), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((B, S, N), dtype=np.float32) * 0.3
    s0 = rng.standard_normal((B, H, P, N), dtype=np.float32) * 0.1
    return x, a.astype(np.float32), Bm, Cm, s0


def _t(*arrs, dtype=None):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    return [t.to(dtype) for t in out] if dtype is not None else out


def _close(got, want, dtype="float32"):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


@functools.lru_cache(maxsize=None)
def _jax_out(seed, shape, chunk, impl, zero_s0=False):
    x, a, Bm, Cm, s0 = _ssd_inputs(seed, *shape)
    s0 = None if zero_s0 else jnp.asarray(s0)
    args = (jnp.asarray(x), jnp.asarray(a), jnp.asarray(Bm), jnp.asarray(Cm))
    if impl == "ref":
        y, sf = jax_ssd_reference(*args, s0)
    else:
        y, sf = jax_ssd(*args, s0, chunk=chunk, impl=impl)
    return np.asarray(y), np.asarray(sf)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_ssd_matches_jax(chunk, impl, jax_impl):
    shape = (2, 128, 4, 16, 32)
    x, a, Bm, Cm, s0 = _ssd_inputs(0, *shape)
    y, sf = ssd(*_t(x, a, Bm, Cm, s0), chunk=chunk, impl=impl)
    y_want, sf_want = _jax_out(0, shape, chunk, jax_impl)
    _close(y, y_want)
    _close(sf, sf_want)
    assert y.dtype == torch.float32 and sf.dtype == torch.float32


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_ssd_zero_initial_state(impl):
    shape = (1, 64, 2, 16, 16)
    x, a, Bm, Cm, _ = _ssd_inputs(1, *shape)
    y, sf = ssd(*_t(x, a, Bm, Cm), chunk=16, impl=impl)
    y_want, sf_want = _jax_out(1, shape, 16, "pallas_interpret", zero_s0=True)
    _close(y, y_want)
    _close(sf, sf_want)


def test_ssd_decode_chain_equals_scan():
    shape = (2, 16, 4, 16, 32)
    x, a, Bm, Cm, s0 = _ssd_inputs(2, *shape)
    tx, ta, tB, tC, state = _t(x, a, Bm, Cm, s0)
    ys = []
    for t in range(16):
        y_t, state = ssd_step(state, tx[:, t], ta[:, t], tB[:, t], tC[:, t])
        ys.append(y_t)
    y_want, sf_want = _jax_out(2, shape, 16, "ref")
    _close(torch.stack(ys, 1), y_want)
    _close(state, sf_want)


def test_ssd_prefill_then_decode_continuity():
    """State from chunked prefill continues correctly into decode."""
    shape = (1, 96, 2, 16, 16)
    x, a, Bm, Cm, _ = _ssd_inputs(3, *shape)
    tx, ta, tB, tC = _t(x, a, Bm, Cm)
    _, state = ssd(tx[:, :64], ta[:, :64], tB[:, :64], tC[:, :64],
                   chunk=32, impl="chunked")
    for t in range(64, 96):
        _, state = ssd_step(state, tx[:, t], ta[:, t], tB[:, t], tC[:, t])
    _, sf_want = _jax_out(3, shape, 96, "ref", zero_s0=True)
    _close(state, sf_want)


@pytest.mark.parametrize("b,nc,chunk,h,p,n", [
    (1, 1, 8, 1, 8, 8),
    (2, 4, 8, 2, 16, 32),
    (1, 3, 16, 4, 8, 16),
    (2, 2, 32, 1, 16, 8),
    (1, 4, 32, 2, 8, 32),
    (2, 1, 16, 4, 16, 16),
])
def test_ssd_shape_sweep(b, nc, chunk, h, p, n):
    shape = (b, nc * chunk, h, p, n)
    x, a, Bm, Cm, s0 = _ssd_inputs(6, *shape)
    y_want, sf_want = _jax_out(6, shape, chunk, "ref")
    for impl in PORT_IMPLS:
        y, sf = ssd(*_t(x, a, Bm, Cm, s0), chunk=chunk, impl=impl)
        assert y.shape == x.shape
        _close(y, y_want)
        _close(sf, sf_want)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_ssd_bf16(impl):
    x, a, Bm, Cm, s0 = _ssd_inputs(4, 2, 64, 4, 16, 32)
    jy, jsf = jax_ssd(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(a),
                      jnp.asarray(Bm).astype(jnp.bfloat16),
                      jnp.asarray(Cm).astype(jnp.bfloat16), jnp.asarray(s0),
                      chunk=16, impl="xla")
    tx, tB, tC = _t(x, Bm, Cm, dtype=torch.bfloat16)
    ta, ts0 = _t(a, s0)
    y, sf = ssd(tx, ta, tB, tC, ts0, chunk=16, impl=impl)
    assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
    _close(y, np.asarray(jy.astype(jnp.float32)), "bfloat16")
    _close(sf, np.asarray(jsf), "bfloat16")


def test_ssd_chunked_float64_is_a_reference():
    """fp64 inputs keep fp64 through the plain version (the card's yardstick)."""
    x, a, Bm, Cm, s0 = _ssd_inputs(5, 1, 32, 2, 16, 16)
    y, sf = _ssd_chunked(*_t(x, a, Bm, Cm, s0, dtype=torch.float64), chunk=16)
    assert y.dtype == torch.float64 and sf.dtype == torch.float64
    y_ref, sf_ref = ssd_reference(*_t(x, a, Bm, Cm, s0))
    _close(y, y_ref.numpy())
    _close(sf, sf_ref.numpy())


def test_ssd_dispatch_on_cpu():
    x, a, Bm, Cm, s0 = _t(*_ssd_inputs(7, 1, 32, 2, 16, 16))
    y_auto, _ = ssd(x, a, Bm, Cm, s0, chunk=16)
    y_chunked, _ = ssd(x, a, Bm, Cm, s0, chunk=16, impl="chunked")
    assert torch.equal(y_auto, y_chunked)
    with pytest.raises(ValueError, match="CUDA"):
        ssd(x, a, Bm, Cm, s0, chunk=16, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ssd(x, a, Bm, Cm, s0, impl="pallas")
    with pytest.raises(AssertionError):
        ssd(x, a, Bm, Cm, s0, chunk=24, impl="chunked")

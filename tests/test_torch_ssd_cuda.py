"""The hand-written SSD kernels (``ssd_fwd_wgmma.cu`` for bf16 at P 64, N 128;
``ssd_fwd.cu`` for the rest) against their plain version.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU mode)
and skip elsewhere.  The file imports no JAX, so it also runs on a card
machine that has none:

    python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

The yardstick is ``_ssd_chunked`` in float64 on the card.  fp32 is held to
the reference's tolerance (tests/test_kernels.py::_tol, 3e-4).  bf16 is held
to ``bf16_ssd_limit``: one bf16 ulp of the float64 result plus fp32 slack,
plus 2^-8 of what each operand the tensor-core kernel rounds to bf16 (the
decayed scores, w_t x_t, the entering state) can move a term by; the final
state, fp32, gets 2^-8 of what the w_t x_t roundings can move it by.  _tol's
5e-2 was looser than the errors it had to catch
(tests/test_torch_ssd_bound.py shows this limit refuses wrong masks, decays,
state passing and fp8 scores).  Decays are drawn from (0.5, 1), as the JAX
package's tests draw them, and from (0.99, 1) ("slow"), where the terms that
cross chunks weigh as much as those inside one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import bf16_ssd_limit, ssd  # noqa: E402
from repro_torch.kernels.ssd.kernel import kernel_chunk  # noqa: E402
from repro_torch.kernels.ssd.ops import _ssd_chunked  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {"float32": dict(atol=3e-4, rtol=3e-4)}


@pytest.fixture
def ssd_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the SSD kernels have no CPU mode")
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    return ssd_cuda


def _inputs(seed, B, S, H, P, N, dtype="float32", with_s0=True, decay="fast"):
    """tests/test_kernels.py::_ssd_inputs drawn with numpy, on the card; with
    ``decay="slow"``, a in (0.99, 1)."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P), dtype=np.float32))
    if decay == "slow":
        a = torch.from_numpy(rng.uniform(0.99, 1.0, (B, S, H)).astype(np.float32))
    else:
        a = torch.from_numpy((1 / (1 + np.exp(-rng.standard_normal((B, S, H))))
                              * 0.5 + 0.5).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32) * 0.3)
    Cm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32) * 0.3)
    s0 = torch.from_numpy(rng.standard_normal((B, H, P, N), dtype=np.float32) * 0.1)
    return (x.to(tdt).cuda(), a.cuda(), Bm.to(tdt).cuda(), Cm.to(tdt).cuda(),
            s0.cuda() if with_s0 else None)


def _d(t):
    return None if t is None else t.double()


def _check(y, sf, x, a, Bm, Cm, s0, chunk=256):
    """y and the final state against the float64 plain version: fp32 within
    3e-4, bf16 within ``bf16_ssd_limit`` at the kernel's chunk."""
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape and sf.dtype == torch.float32
    S = x.shape[1]
    y_want, s_want = _ssd_chunked(_d(x), _d(a), _d(Bm), _d(Cm), _d(s0), chunk=S)
    if x.dtype == torch.float32:
        for got, want in ((y, y_want), (sf, s_want)):
            np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(),
                                       **TOL["float32"])
        return
    y_lim, s_lim = bf16_ssd_limit(y_want, x, a, Bm, Cm, s0, chunk=kernel_chunk(chunk, S))
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    for name, got, want, lim in (("y", y, y_want, y_lim), ("state", sf, s_want, s_lim)):
        err = (got.double() - want).abs()
        ratio = (err / lim).max().item()
        assert ratio <= 1.0, (f"{int((err > lim).sum())} {name} values beyond the bf16 limit, "
                              f"worst at {ratio:.3g} of it (max |err| {err.max().item():.3g})")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_cuda_kernel_matches_plain(ssd_cuda, dtype):
    x, a, Bm, Cm, s0 = _inputs(8, 2, 200, 8, 64, 128, dtype)  # ragged last chunk
    y, sf = ssd_cuda(x, a, Bm, Cm, s0)
    _check(y, sf, x, a, Bm, Cm, s0)


@pytest.mark.parametrize("B,S,H,chunk,with_s0", [
    (4, 512, 64, 256, False),     # mamba2-1.3b prefill wave 1
    (2, 1024, 8, 256, True),      # 4 chunks with an initial state
    (2, 1024, 8, 128, True),      # 8 chunks of 128
    (1, 512, 4, 16, True),        # a chunk below the tile: rounded up to 64
    (2, 400, 8, 192, True),       # a chunk of 192: three 64-row tiles, the last ragged
])
def test_ssd_wgmma_serving_shapes(ssd_cuda, B, S, H, chunk, with_s0):
    x, a, Bm, Cm, s0 = _inputs(11, B, S, H, 64, 128, "bfloat16", with_s0)
    y, sf = ssd_cuda(x, a, Bm, Cm, s0, chunk=chunk)
    _check(y, sf, x, a, Bm, Cm, s0, chunk)


@pytest.mark.parametrize("B,S,H,chunk,with_s0", [
    (4, 512, 64, 256, False),     # mamba2-1.3b prefill wave 1
    (2, 1024, 8, 256, True),      # 4 chunks with an initial state
    (2, 1000, 8, 256, True),      # 4 chunks, the last ragged
    (2, 1024, 8, 128, True),      # 8 chunks of 128
])
def test_ssd_wgmma_slow_decay(ssd_cuda, B, S, H, chunk, with_s0):
    """a in (0.99, 1): the carry between chunks, the r tiles far below the
    diagonal and the initial state weigh on every row."""
    x, a, Bm, Cm, s0 = _inputs(16, B, S, H, 64, 128, "bfloat16", with_s0, "slow")
    y, sf = ssd_cuda(x, a, Bm, Cm, s0, chunk=chunk)
    _check(y, sf, x, a, Bm, Cm, s0, chunk)


@pytest.mark.parametrize("S", [200, 300, 40, 1])
def test_ssd_wgmma_ragged(ssd_cuda, S):
    """S not a multiple of the tile or the chunk, and S below one tile."""
    x, a, Bm, Cm, s0 = _inputs(12, 2, S, 4, 64, 128, "bfloat16")
    y, sf = ssd_cuda(x, a, Bm, Cm, s0, chunk=256)
    _check(y, sf, x, a, Bm, Cm, s0)


def test_ssd_wgmma_strided_inputs(ssd_cuda):
    """B and C as the model passes them: views into a wider projection."""
    x, a, _, _, s0 = _inputs(13, 2, 320, 4, 64, 128, "bfloat16")
    xbc = torch.randn(2, 320, 4 * 64 + 256, device="cuda").bfloat16()
    Bm, Cm = xbc[..., 256:384], xbc[..., 384:]
    y, sf = ssd_cuda(x, a, Bm, Cm, s0)
    _check(y, sf, x, a, Bm.contiguous(), Cm.contiguous(), s0)


@pytest.mark.parametrize("dtype,P,N,wgmma", [
    ("bfloat16", 64, 128, True), ("float32", 64, 128, False),
    ("bfloat16", 16, 128, False), ("bfloat16", 64, 96, False)])
def test_ssd_cuda_route(ssd_cuda, dtype, P, N, wgmma):
    """bf16 at (P, N) = (64, 128) takes ssd_fwd_wgmma, everything else
    ssd_fwd; each call counts once."""
    x, a, Bm, Cm, s0 = _inputs(14, 2, 192, 4, P, N, dtype)
    launches, wg = ssd_cuda.launches, ssd_cuda.wgmma_launches
    y, sf = ssd_cuda(x, a, Bm, Cm, s0)
    assert ssd_cuda.launches == launches + 1
    assert ssd_cuda.wgmma_launches == wg + int(wgmma)
    _check(y, sf, x, a, Bm, Cm, s0)


@pytest.mark.parametrize("S,P,N", [(48, 16, 16), (256, 64, 128), (64, 32, 96)])
def test_ssd_auto_launches_kernel(ssd_cuda, S, P, N):
    """``ssd(impl="auto")`` on CUDA tensors goes through the kernel, once."""
    x, a, Bm, Cm, _ = _inputs(9, 2, S, 4, P, N, with_s0=False)
    before = ssd_cuda.launches
    y, sf = ssd(x, a, Bm, Cm, chunk=16)
    assert ssd_cuda.launches == before + 1
    _check(y, sf, x, a, Bm, Cm, None, chunk=16)


def test_ssd_auto_bf16_launches_wgmma_once(ssd_cuda):
    """The serving call: ``ssd(impl="auto")`` with chunk 256 launches the
    tensor-core route once per call."""
    x, a, Bm, Cm, s0 = _inputs(15, 2, 512, 8, 64, 128, "bfloat16")
    launches, wg = ssd_cuda.launches, ssd_cuda.wgmma_launches
    for _ in range(2):
        y, sf = ssd(x, a, Bm, Cm, s0, chunk=256)
    assert (ssd_cuda.launches, ssd_cuda.wgmma_launches) == (launches + 2, wg + 2)
    _check(y, sf, x, a, Bm, Cm, s0)


def test_ssd_cuda_refuses_what_it_cannot_take(ssd_cuda):
    x, a, Bm, Cm, s0 = _inputs(10, 1, 32, 2, 16, 16)
    xb, ab, Bb, Cb, sb = _inputs(10, 1, 32, 2, 64, 128, "bfloat16")
    launches, wg = ssd_cuda.launches, ssd_cuda.wgmma_launches
    with pytest.raises(TypeError, match="takes x in"):
        ssd_cuda(x.half(), a, Bm.half(), Cm.half(), s0)
    with pytest.raises(TypeError, match="B_mat"):
        ssd_cuda(x, a, Bm.bfloat16(), Cm, s0)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_cuda(x[..., :8], a, Bm, Cm, s0[..., :8, :])
    with pytest.raises(ValueError, match="initial_state"):
        ssd_cuda(x, a, Bm, Cm, s0[:, :1])
    with pytest.raises(ValueError, match="different devices"):
        ssd_cuda(x, a.cpu(), Bm, Cm, s0)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_cuda(xb, ab, Bb, Cb, sb[:, :, :32])
    with pytest.raises(ValueError, match="chunk must be positive"):
        ssd_cuda(xb, ab, Bb, Cb, sb, chunk=0)
    with pytest.raises(ValueError, match="a has shape"):
        ssd_cuda(xb, ab[:, :16], Bb, Cb, sb)
    assert (ssd_cuda.launches, ssd_cuda.wgmma_launches) == (launches, wg)


def test_ssd_cuda_refuses_inputs_that_require_grad(ssd_cuda):
    """The kernel is forward-only: under grad mode, an input that requires
    grad is refused (a model trained through it would lose its gradients);
    under inference_mode, as serving runs, the same call launches."""
    x, a, Bm, Cm, s0 = _inputs(16, 1, 64, 2, 16, 16)
    launches = ssd_cuda.launches
    with pytest.raises(RuntimeError, match='forward-only.*impl="chunked"'):
        ssd(x.requires_grad_(), a, Bm, Cm, s0, chunk=32)
    assert ssd_cuda.launches == launches
    with torch.inference_mode():
        y, sf = ssd(x, a, Bm, Cm, s0, chunk=32)
    assert ssd_cuda.launches == launches + 1
    _check(y, sf, x.detach(), a, Bm, Cm, s0, chunk=32)

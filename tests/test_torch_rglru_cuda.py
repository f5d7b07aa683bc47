"""The hand-written RG-LRU kernel (``rglru_fwd.cu``) against its plain version.

These tests need an NVIDIA GPU with ``nvcc`` (the kernel has no CPU mode) and
skip elsewhere.  The file imports no JAX, so it also runs on a card machine
that has none:

    python -m pytest -q -m cuda tests/test_torch_rglru_cuda.py

The yardstick is ``_rglru_scan`` in float64 on the card.  fp32 results,
including the final h in every case, are held to the reference's tolerance
(tests/test_kernels.py::_tol, 3e-4).  The kernel computes in fp32 and rounds a
bf16 y once, so bf16 y is held to one bf16 ulp of the float64 result (2^-7
relative) plus fp32 slack, well inside ``_tol``'s 5e-2.

The kernel scans chunks of ``kernel_chunk()`` steps in parallel and carries
h between them by a look-back.  Decays drawn from N(0, 1) make a chunk's
product of a underflow, so the carry weighs nothing there; the slow-decay
cases (lam ~ U(-12, -7), a in (0.99, 1)) give it its weight, at the serving
shapes, in fp32 with h0, and at S on a chunk boundary and one step either
side of one (tests/test_torch_rglru_bound.py shows that the limit refuses a
wrong carry there and not at fast decays).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru import rglru  # noqa: E402
from repro_torch.kernels.rglru.ops import _rglru_scan  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {"float32": dict(atol=3e-4, rtol=3e-4),
       "bfloat16": dict(atol=1e-4, rtol=2 ** -7)}


@pytest.fixture
def rglru_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the RG-LRU kernel has no CPU mode")
    from repro_torch.kernels.rglru.kernel import rglru_cuda
    return rglru_cuda


def _inputs(seed, B, S, W, dtype="float32", decay="fast"):
    """tests/test_kernels.py::_rglru_inputs drawn with numpy, on the card;
    ``decay="slow"`` draws lam from U(-12, -7) instead of N(0, 1)."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    x, r, i = (torch.from_numpy(rng.standard_normal((B, S, W), dtype=np.float32))
               .to(tdt).cuda() for _ in range(3))
    lam = (rng.uniform(-12.0, -7.0, W).astype(np.float32) if decay == "slow"
           else rng.standard_normal((W,), dtype=np.float32))
    lam = torch.from_numpy(lam).cuda()
    h0 = torch.from_numpy(rng.standard_normal((B, W), dtype=np.float32) * 0.2).cuda()
    return x, r, i, lam, h0


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,W,with_h0", [(203, 200, True), (64, 4096, False),
                                         (1, 96, True)])
def test_rglru_cuda_kernel_matches_plain(rglru_cuda, dtype, S, W, with_h0):
    x, r, i, lam, h0 = _inputs(S, 3, S, W, dtype)     # ragged S and W included
    h0 = h0 if with_h0 else None
    y, h = rglru_cuda(x, r, i, lam, h0)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and h.dtype == torch.float32
    y_want, h_want = _rglru_scan(x.double(), r.double(), i.double(), lam.double(),
                                 h0.double() if h0 is not None else None)
    _close(y, y_want, dtype)
    _close(h, h_want, "float32")


def _check(rglru_cuda, x, r, i, lam, h0):
    y, h = rglru_cuda(x, r, i, lam, h0)
    torch.cuda.synchronize()
    dtype = str(x.dtype).removeprefix("torch.")
    assert y.dtype == x.dtype and h.dtype == torch.float32
    y_want, h_want = _rglru_scan(x.double(), r.double(), i.double(), lam.double(),
                                 h0.double() if h0 is not None else None)
    _close(y, y_want, dtype)
    _close(h, h_want, "float32")


@pytest.mark.parametrize("B,S,W,dtype,with_h0", [
    (4, 3072, 4096, "bfloat16", False),      # serve wave A
    (4, 1024, 4096, "bfloat16", False),      # serve wave B
    (2, 1024, 4096, "float32", True),
])
def test_rglru_cuda_slow_decay(rglru_cuda, B, S, W, dtype, with_h0):
    x, r, i, lam, h0 = _inputs(S + W, B, S, W, dtype, decay="slow")
    _check(rglru_cuda, x, r, i, lam, h0 if with_h0 else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks,extra", [(4, 0), (1, -1), (1, 1)])
def test_rglru_cuda_chunk_boundaries_slow_decay(rglru_cuda, dtype, chunks, extra):
    """S on a chunk boundary (4 chunks) and one step short of and past one,
    with h0, ragged W."""
    from repro_torch.kernels.rglru.kernel import kernel_chunk
    S = chunks * kernel_chunk() + extra
    x, r, i, lam, h0 = _inputs(S, 3, S, 1000, dtype, decay="slow")
    _check(rglru_cuda, x, r, i, lam, h0)


def test_rglru_cuda_scratch_across_calls_and_streams(rglru_cuda):
    """The look-back's scratch is kept between calls (a new epoch each) and
    grows: a large call, a small one, the large one again, and a call on a
    second stream all stay right."""
    big = _inputs(21, 2, 700, 520, "bfloat16", decay="slow")
    small = _inputs(22, 1, 40, 96, "float32", decay="slow")
    for args in (small, big, small, big, big):
        _check(rglru_cuda, *args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _check(rglru_cuda, *big)


def test_rglru_cuda_is_deterministic(rglru_cuda):
    """Each tile folds its predecessor's h in one fixed order, so repeated
    calls at the serving shape, at slow decay and on a second stream (its
    own scratch), give the same bits."""
    args = _inputs(23, 4, 3072, 4096, "bfloat16", decay="slow")
    y, h = rglru_cuda(*args)
    for _ in range(3):
        y2, h2 = rglru_cuda(*args)
        assert torch.equal(y, y2) and torch.equal(h, h2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y2, h2 = rglru_cuda(*args)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_rglru_auto_launches_kernel(rglru_cuda):
    """``rglru(impl="auto")`` on CUDA tensors goes through the kernel, once."""
    x, r, i, lam, h0 = _inputs(9, 2, 48, 64)
    before = rglru_cuda.launches
    y, h = rglru(x, r, i, lam, h0)
    torch.cuda.synchronize()
    assert rglru_cuda.launches == before + 1
    y_want, h_want = _rglru_scan(x.double(), r.double(), i.double(), lam.double(),
                                 h0.double())
    _close(y, y_want, "float32")
    _close(h, h_want, "float32")


def test_rglru_cuda_refuses_what_it_cannot_take(rglru_cuda):
    x, r, i, lam, h0 = _inputs(10, 1, 32, 16)
    launches = rglru_cuda.launches
    with pytest.raises(TypeError, match="takes x in"):
        rglru_cuda(x.half(), r.half(), i.half(), lam, h0)
    with pytest.raises(TypeError, match="r is"):
        rglru_cuda(x, r.bfloat16(), i, lam, h0)
    with pytest.raises(ValueError, match="lam has shape"):
        rglru_cuda(x, r, i, lam[:8], h0)
    with pytest.raises(ValueError, match="initial_h"):
        rglru_cuda(x, r, i, lam, h0[:, :8])
    with pytest.raises(ValueError, match="different devices"):
        rglru_cuda(x, r, i, lam.cpu(), h0)
    assert rglru_cuda.launches == launches


def test_rglru_cuda_refuses_inputs_that_require_grad(rglru_cuda):
    """The kernel is forward-only: under grad mode, an input that requires
    grad is refused; under inference_mode, as serving runs, it launches."""
    x, r, i, lam, h0 = _inputs(11, 1, 32, 16)
    launches = rglru_cuda.launches
    with pytest.raises(RuntimeError, match='forward-only.*impl="scan"'):
        rglru(x, r, i, lam.requires_grad_(), h0)
    assert rglru_cuda.launches == launches
    with torch.inference_mode():
        y, h = rglru(x, r, i, lam, h0)
    assert rglru_cuda.launches == launches + 1
    y_want, h_want = _rglru_scan(x.double(), r.double(), i.double(),
                                 lam.detach().double(), h0.double())
    _close(y, y_want, "float32")
    _close(h, h_want, "float32")

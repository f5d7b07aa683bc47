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


def _inputs(seed, B, S, W, dtype="float32"):
    """tests/test_kernels.py::_rglru_inputs drawn with numpy, on the card."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    x, r, i = (torch.from_numpy(rng.standard_normal((B, S, W), dtype=np.float32))
               .to(tdt).cuda() for _ in range(3))
    lam = torch.from_numpy(rng.standard_normal((W,), dtype=np.float32)).cuda()
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

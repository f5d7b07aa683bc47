"""The hand-written SSD kernel (``ssd_fwd.cu``) against its plain version.

These tests need an NVIDIA GPU with ``nvcc`` (the kernel has no CPU mode) and
skip elsewhere.  The file imports no JAX, so it also runs on a card machine
that has none:

    python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py

The yardstick is ``_ssd_chunked`` in float64 on the card; tolerances are the
reference's (tests/test_kernels.py::_tol): fp32 3e-4, bf16 5e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.kernels.ssd.ops import _ssd_chunked  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {"float32": dict(atol=3e-4, rtol=3e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


@pytest.fixture
def ssd_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the SSD kernel has no CPU mode")
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    return ssd_cuda


def _inputs(seed, B, S, H, P, N, dtype="float32", with_s0=True):
    """tests/test_kernels.py::_ssd_inputs drawn with numpy, on the card."""
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P), dtype=np.float32))
    a = torch.from_numpy((1 / (1 + np.exp(-rng.standard_normal((B, S, H))))
                          * 0.5 + 0.5).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32) * 0.3)
    Cm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32) * 0.3)
    s0 = torch.from_numpy(rng.standard_normal((B, H, P, N), dtype=np.float32) * 0.1)
    return (x.to(tdt).cuda(), a.cuda(), Bm.to(tdt).cuda(), Cm.to(tdt).cuda(),
            s0.cuda() if with_s0 else None)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_cuda_kernel_matches_plain(ssd_cuda, dtype):
    x, a, Bm, Cm, s0 = _inputs(8, 2, 200, 8, 64, 128, dtype)  # ragged last chunk
    y, sf = ssd_cuda(x, a, Bm, Cm, s0)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and sf.dtype == torch.float32
    y_want, sf_want = _ssd_chunked(x.double(), a.double(), Bm.double(),
                                   Cm.double(), s0.double(), chunk=200)
    _close(y, y_want, dtype)
    _close(sf, sf_want, dtype)


@pytest.mark.parametrize("S,P,N", [(48, 16, 16), (256, 64, 128), (64, 32, 96)])
def test_ssd_auto_launches_kernel(ssd_cuda, S, P, N):
    """``ssd(impl="auto")`` on CUDA tensors goes through the kernel, once."""
    x, a, Bm, Cm, _ = _inputs(9, 2, S, 4, P, N, with_s0=False)
    before = ssd_cuda.launches
    y, sf = ssd(x, a, Bm, Cm, chunk=16)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    y_want, sf_want = _ssd_chunked(x.double(), a.double(), Bm.double(),
                                   Cm.double(), chunk=16)
    _close(y, y_want, "float32")
    _close(sf, sf_want, "float32")


def test_ssd_cuda_refuses_what_it_cannot_take(ssd_cuda):
    x, a, Bm, Cm, s0 = _inputs(10, 1, 32, 2, 16, 16)
    launches = ssd_cuda.launches
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
    assert ssd_cuda.launches == launches

"""The hand-written flash-attention kernel (``flash_fwd.cu``) against its
plain version.

These tests need an NVIDIA GPU with ``nvcc`` (the kernel has no CPU mode) and
skip elsewhere.  The file imports no JAX, so it also runs on a card machine
that has none:

    python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

The yardstick is ``attention_reference`` in float64 on the card.  fp32 is held
to the reference's tolerance (tests/test_kernels.py::_tol, 3e-4).  The kernel
computes in fp32 and rounds a bf16 output once, so bf16 is held to one bf16
ulp of the float64 result (2^-7 relative) plus fp32 slack, well inside
``_tol``'s 5e-2, which is larger than a typical attention output here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (attention_reference,  # noqa: E402
                                                 flash_attention)

pytestmark = pytest.mark.cuda
TOL = {"float32": dict(atol=3e-4, rtol=3e-4),
       "bfloat16": dict(atol=1e-4, rtol=2 ** -7)}


@pytest.fixture
def flash_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel has no CPU mode")
    from repro_torch.kernels.flash_attention.kernel import flash_cuda
    return flash_cuda


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(tdt).cuda()
            for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _check(flash_cuda, seed, shape, dtype="float32", segments=None, **opts):
    q, k, v = _qkv(seed, *shape, dtype=dtype)
    seg = {}
    if segments is not None:
        seg = dict(q_segments=segments[0].cuda(), kv_segments=segments[1].cuda())
    out = flash_cuda(q, k, v, **opts, **seg)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    want = attention_reference(q.double(), k.double(), v.double(), **opts, **seg)
    np.testing.assert_allclose(out.double().cpu().numpy(), want.cpu().numpy(),
                               **TOL[dtype])
    return out


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cuda_head_dims(flash_cuda, D, dtype):
    _check(flash_cuda, D, (2, 130, 130, 4, 2, D), dtype, window=70)   # ragged


@pytest.mark.parametrize("opts", [
    dict(causal=False),
    dict(softcap=50.0),
    dict(window=1),
    dict(causal=False, window=33, softcap=20.0),
])
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
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_cuda(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="both q_segments"):
        flash_cuda(q, k, v, q_segments=torch.ones((1, 32), device="cuda"))
    with pytest.raises(ValueError, match="different devices"):
        flash_cuda(q, k.cpu(), v)
    assert flash_cuda.launches == launches

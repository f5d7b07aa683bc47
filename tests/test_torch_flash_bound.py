"""The bf16 flash-attention limit (``bf16_flash_limit``) against an emulation
of the tensor-core kernel's roundings, on the CPU.

``flash_fwd_wgmma.cu`` computes scores in fp32, rounds the probabilities P to
bf16 for the PV product, sums l from the fp32 P and rounds the output to bf16
once.  ``_emulate`` repeats that arithmetic in plain torch, with the kernel's
tiling: 128-row q tiles, the 64-key KV tiles in the causal/window range, and
the per-warpgroup test that lets interior tiles skip the causal and window
mask.  The emulation must lie within the limit of the float64 reference; the
same emulation with the window off by one, the segment mask dropped, or the
rescale of O and l by alpha skipped must exceed it more than tenfold.  The
card tests (tests/test_torch_flash_cuda.py) and chip_smoke.py hold the kernel
itself to the same limit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (attention_reference,  # noqa: E402
                                                 bf16_flash_limit)

BQ, BK, NEG_INF = 128, 64, -1e30


def _emulate(q, k, v, *, window, q_segments=None, kv_segments=None, causal=True,
             skip_alpha=False):
    """flash_fwd_wgmma's arithmetic in plain torch on bf16 (B, S, H, D) inputs."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=2)
    scale = D ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, Sq, BQ):
        rows = min(BQ, Sq - q0)
        qa = torch.arange(q0, q0 + rows)
        k_lo = max(0, q0 - window + 1) if window is not None else 0
        k_hi = min(Sk, q0 + rows) if causal else Sk
        m = torch.full((B, Hq, rows), NEG_INF)
        l = torch.zeros((B, Hq, rows))
        acc = torch.zeros((B, Hq, rows, D))
        for k0 in range(k_lo // BK * BK, k_hi, BK):
            cols = torch.arange(k0, min(k0 + BK, Sk))
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + rows].float(),
                             kf[:, k0:k0 + len(cols)]) * scale
            mask = torch.ones((rows, len(cols)), dtype=torch.bool)
            for w_lo in range(0, rows, 64):          # the two consumer warpgroups
                a_lo, a_hi = q0 + w_lo, q0 + w_lo + 63
                interior = (k0 + BK <= Sk and (not causal or k0 + BK - 1 <= a_lo)
                            and (window is None or a_hi - k0 < window))
                if not interior:
                    part = torch.ones((min(64, rows - w_lo), len(cols)), dtype=torch.bool)
                    d = qa[w_lo:w_lo + 64, None] - cols[None, :]
                    if causal:
                        part &= d >= 0
                    if window is not None:
                        part &= d < window
                    mask[w_lo:w_lo + 64] = part
            mask = mask[None, None]
            if q_segments is not None:
                mask = mask & (q_segments[:, None, q0:q0 + rows, None]
                               == kv_segments[:, None, None, cols])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])          # exactly 0 where masked
            alpha = torch.where(m <= NEG_INF * 0.5, 0.0, torch.exp(m - m_safe))
            if skip_alpha:
                alpha = torch.ones_like(alpha)
            l = alpha * l + p.sum(-1)                      # fp32 P
            acc = alpha[..., None] * acc + torch.einsum(
                "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, k0:k0 + len(cols)])
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[:, q0:q0 + rows] = (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)
    return out


def _inputs(D, B=2, S=320, Hq=4, Hkv=1, seed=0):
    rng = np.random.default_rng(seed + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    ks = torch.ones((B, S), dtype=torch.int32)
    ks[:, 130:] = 2
    qs = ks.clone()
    qs[:, :3] = 9                      # no key has segment 9: rows fully masked
    return q, k, v, qs, ks


def _worst_ratio(out, q, k, v, window, qs, ks):
    """max |out - want| / limit against the float64 reference."""
    opts = dict(window=window, q_segments=qs, kv_segments=ks)
    want = attention_reference(q.double(), k.double(), v.double(), **opts)
    want_absv = attention_reference(q.double(), k.double(), v.double().abs(), **opts)
    err = (out.double() - want).abs()
    return (err / bf16_flash_limit(want, want_absv)).max().item()


@pytest.mark.parametrize("D", [64, 256])
def test_emulated_kernel_lies_within_the_limit(D):
    q, k, v, qs, ks = _inputs(D)
    out = _emulate(q, k, v, window=100, q_segments=qs, kv_segments=ks)
    assert (out[:, :3] == 0).all()
    assert _worst_ratio(out, q, k, v, 100, qs, ks) <= 1.0


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("fault", ["window off by one", "segments dropped", "alpha skipped"])
def test_the_limit_refuses_a_wrong_kernel(D, fault):
    q, k, v, qs, ks = _inputs(D)
    kw = dict(window=100, q_segments=qs, kv_segments=ks)
    if fault == "window off by one":
        kw["window"] = 101
    elif fault == "segments dropped":
        kw.update(q_segments=None, kv_segments=None)
    else:
        kw["skip_alpha"] = True
    out = _emulate(q, k, v, **kw)
    assert _worst_ratio(out, q, k, v, 100, qs, ks) > 10.0


def test_the_limit_is_what_rounding_p_and_the_output_can_reach():
    """The limit's terms, on a hand-made case: one bf16 ulp of the output,
    2^-8 of the |v|-weighted average, and the fp32 slack."""
    want = torch.tensor([0.0, 1.0, -2.0], dtype=torch.float64)
    want_absv = torch.tensor([0.0, 3.0, 4.0], dtype=torch.float64)
    limit = bf16_flash_limit(want, want_absv)
    assert torch.allclose(limit, torch.tensor([1e-4, 1e-4 + 2 ** -7 + 3 * 2 ** -8,
                                               1e-4 + 2 * 2 ** -7 + 4 * 2 ** -8],
                                              dtype=torch.float64))

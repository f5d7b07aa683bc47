"""The bf16 SSD limit (``bf16_ssd_limit``) against an emulation of the
tensor-core kernel's tiling and roundings, on the CPU.

``ssd_fwd_wgmma.cu`` works at the caller's chunk rounded up to a multiple of
64 (``kernel_chunk``), pads the ragged end with zero inputs and decay 1, and
rounds three operands to bf16 on the way: w_t x_t for each chunk's state
(w_t = exp(la_end - la_t)), the state entering each chunk (fp32 state
passing, rounded for the scan's product), and the decayed scores
(C B^T ⊙ M) before the product with x; y is rounded to bf16 once.
``_emulate`` repeats that arithmetic in plain torch.  The emulation must lie
within the limit of the float64 plain result; the same emulation with the
causal diagonal off by one, the entering state of the wrong chunk, the decay
mask dropped, or exp(la) missing on the inter-chunk term must exceed it more
than tenfold somewhere.

Decays drawn from (0.5, 1), as the JAX package's tests draw them, leave a
term 64 steps away a weight of about 1e-8, so they cannot show faults in the
long-range terms.  Slow decays, a in (0.99, 1) (mamba2 heads with a small
dt·exp(A_log) decay as slowly), must also lie within the limit, and there
the same faults, the carry exp(total) s dropped from the state passing, and
the r tiles below the one next to the diagonal skipped, must each exceed it
more than tenfold.  Decayed scores rounded to fp8 (e4m3) instead of bf16
must exceed it too.  The card tests (tests/test_torch_ssd_cuda.py) and
chip_smoke.py hold the kernel itself to the same limit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import bf16_ssd_limit  # noqa: E402
from repro_torch.kernels.ssd.kernel import kernel_chunk  # noqa: E402
from repro_torch.kernels.ssd.ops import _ssd_chunked  # noqa: E402

FAULTS = ["diagonal off by one", "stale entering state", "decay dropped",
          "exp(la) missing on inter"]
LONG_RANGE_FAULTS = ["carry dropped", "far r tiles skipped"]
TILE = 64


def _emulate(x, a, Bm, Cm, s0, *, chunk, fault=None, scores_dtype=torch.bfloat16):
    """ssd_fwd_wgmma's arithmetic in plain torch: x, B, C bf16, a and s0 fp32;
    the decayed scores rounded to ``scores_dtype``.  Returns (y bf16, final
    state fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = kernel_chunk(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    loga = torch.nn.functional.pad(torch.log(a.float()), (0, 0, 0, pad))  # decay 1 past S
    la = torch.cumsum(loga.reshape(Bsz, nc, Q, H), dim=2)               # (B, nc, Q, H)

    # 1. each chunk's state contribution, from bf16(w_t x_t)
    w = torch.exp(la[:, :, -1:, :] - la)
    xw = (xf * w[..., None]).bfloat16().float()
    dstate = torch.einsum("bgthp,bgtn->bghpn", xw, Bf)
    # 2. state passing in fp32
    state = (torch.zeros((Bsz, H, P, N)) if s0 is None else s0.float())
    entering = []
    for g in range(nc):
        entering.append(state)
        carry = torch.exp(la[:, g, -1])[:, :, None, None] * state
        state = dstate[:, g] + (0.0 if fault == "carry dropped" else carry)
    if fault == "stale entering state":
        entering = entering[:1] + entering[:-1]
    ent = torch.stack(entering, dim=1).bfloat16().float()              # (B, nc, H, P, N)
    # 3. the scan: exp(la_t) C_t s^T + bf16(C B^T ⊙ M) x
    inter = torch.einsum("bgtn,bghpn->bgthp", Cf, ent)
    if fault != "exp(la) missing on inter":
        inter = inter * torch.exp(la)[..., None]
    scores = torch.einsum("bgtn,bgrn->bgtr", Cf, Bf)
    t_idx = torch.arange(Q)
    causal = (t_idx[:, None] > t_idx[None, :] if fault == "diagonal off by one"
              else t_idx[:, None] >= t_idx[None, :])
    if fault == "far r tiles skipped":
        causal &= t_idx[None, :] // TILE >= t_idx[:, None] // TILE - 1
    decay = torch.exp(la[:, :, :, None, :] - la[:, :, None, :, :])    # (B, nc, t, r, H)
    if fault == "decay dropped":
        decay = torch.ones_like(decay)
    m = torch.where(causal[None, None, :, :, None], scores[..., None] * decay, 0.0)
    intra = torch.einsum("bgtrh,bgrhp->bgthp", m.to(scores_dtype).float(), xf)
    y = (inter + intra).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y.bfloat16(), state


def _decays(rng, shape, decay):
    """a in (0.5, 1) ("fast", tests/test_kernels.py::_ssd_inputs) or in
    (0.99, 1) ("slow")."""
    if decay == "slow":
        return torch.from_numpy(rng.uniform(0.99, 1.0, shape).astype(np.float32))
    return torch.from_numpy((1 / (1 + np.exp(-rng.standard_normal(shape)))
                             * 0.5 + 0.5).astype(np.float32))


def _inputs(seed, B, S, H, with_s0, P=64, N=128, decay="fast"):
    """tests/test_torch_ssd_cuda.py::_inputs, on the CPU."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P), dtype=np.float32)).bfloat16()
    a = _decays(rng, (B, S, H), decay)
    Bm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32) * 0.3).bfloat16()
    Cm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32) * 0.3).bfloat16()
    s0 = (torch.from_numpy(rng.standard_normal((B, H, P, N), dtype=np.float32) * 0.1)
          if with_s0 else None)
    return x, a, Bm, Cm, s0


def _worst_ratios(y, final, x, a, Bm, Cm, s0, ref_chunk, chunk):
    """max |err| / limit of y and of the final state, against float64."""
    d = lambda t: None if t is None else t.double()          # noqa: E731
    y_want, s_want = _ssd_chunked(d(x), d(a), d(Bm), d(Cm), d(s0), chunk=ref_chunk)
    y_lim, s_lim = bf16_ssd_limit(y_want, x, a, Bm, Cm, s0,
                                  chunk=kernel_chunk(chunk, x.shape[1]))
    return (((y.double() - y_want).abs() / y_lim).max().item(),
            ((final.double() - s_want).abs() / s_lim).max().item())


# (S, caller's chunk, s0, float64 reference chunk dividing S)
CASES = [(600, 256, True, 200),     # 3 chunks of 256, the last ragged (88 steps)
         (600, 256, False, 200),
         (130, 256, True, 130),     # one chunk of 192, ragged
         (300, 64, True, 100)]      # 5 chunks of 64


@pytest.mark.parametrize("S,chunk,with_s0,ref_chunk", CASES)
def test_emulated_kernel_lies_within_the_limit(S, chunk, with_s0, ref_chunk):
    x, a, Bm, Cm, s0 = _inputs(S + chunk, 1, S, 2, with_s0)
    y, final = _emulate(x, a, Bm, Cm, s0, chunk=chunk)
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    ry, rs = _worst_ratios(y, final, x, a, Bm, Cm, s0, ref_chunk, chunk)
    assert ry <= 1.0 and rs <= 1.0, (ry, rs)


@pytest.mark.parametrize("S,chunk,with_s0,ref_chunk", CASES)
def test_emulated_kernel_lies_within_the_limit_at_slow_decay(S, chunk, with_s0, ref_chunk):
    x, a, Bm, Cm, s0 = _inputs(S + chunk + 1, 1, S, 2, with_s0, decay="slow")
    y, final = _emulate(x, a, Bm, Cm, s0, chunk=chunk)
    ry, rs = _worst_ratios(y, final, x, a, Bm, Cm, s0, ref_chunk, chunk)
    assert ry <= 1.0 and rs <= 1.0, (ry, rs)


@pytest.mark.parametrize("fault", FAULTS)
def test_the_limit_refuses_a_wrong_kernel(fault):
    S, chunk, with_s0, ref_chunk = CASES[0]
    x, a, Bm, Cm, s0 = _inputs(S + chunk, 1, S, 2, with_s0)
    y, final = _emulate(x, a, Bm, Cm, s0, chunk=chunk, fault=fault)
    ry, _ = _worst_ratios(y, final, x, a, Bm, Cm, s0, ref_chunk, chunk)
    assert ry > 10.0, ry


@pytest.mark.parametrize("fault", FAULTS + LONG_RANGE_FAULTS)
def test_the_limit_refuses_a_wrong_kernel_at_slow_decay(fault):
    """Every fault, long-range ones included, at 3 chunks of 256 with s0; the
    limit refuses a kernel whose y or final state exceeds it."""
    S, chunk, with_s0, ref_chunk = CASES[0]
    x, a, Bm, Cm, s0 = _inputs(S + chunk + 1, 1, S, 2, with_s0, decay="slow")
    y, final = _emulate(x, a, Bm, Cm, s0, chunk=chunk, fault=fault)
    assert max(_worst_ratios(y, final, x, a, Bm, Cm, s0, ref_chunk, chunk)) > 10.0


@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_the_limit_refuses_fp8_scores(decay):
    """The decayed scores rounded to e4m3 (unit roundoff 2^-4) instead of
    bf16 (2^-8): the limit is tight enough to see it."""
    S, chunk, with_s0, ref_chunk = CASES[0]
    x, a, Bm, Cm, s0 = _inputs(S + chunk, 1, S, 2, with_s0, decay=decay)
    y, final = _emulate(x, a, Bm, Cm, s0, chunk=chunk, scores_dtype=torch.float8_e4m3fn)
    ry, _ = _worst_ratios(y, final, x, a, Bm, Cm, s0, ref_chunk, chunk)
    assert ry > 1.0, ry


def test_kernel_chunk_rounds_up_to_the_tile():
    assert [kernel_chunk(c, S) for c, S in
            [(256, 512), (256, 200), (16, 48), (256, 64), (100, 1000), (256, 1)]] == \
        [256, 256, 64, 64, 128, 64]


def test_the_limit_is_what_the_roundings_can_reach():
    """The limit's terms, on a case worked by hand: S 2, P 1, N 2, chunks of
    one step, no initial state.  y = (2, 2.25); the causal form on |C_t . B_r|
    gives (2, 0.25 + 2), the entering state (3, 1) of the second chunk adds
    0.25 · |C_1| . (3, 1) = 1.25; the final state's limit is 2^-8 of
    0.25 · 1 · |B_0| + 2 |B_1| = (2.75, 2.25)."""
    x = torch.tensor([1.0, -2.0], dtype=torch.float64).reshape(1, 2, 1, 1)
    a = torch.tensor([0.5, 0.25], dtype=torch.float64).reshape(1, 2, 1)
    Bm = torch.tensor([[3.0, 1.0], [1.0, 1.0]], dtype=torch.float64)[None]
    Cm = torch.tensor([[1.0, -1.0], [1.0, -2.0]], dtype=torch.float64)[None]
    y_want, s_want = _ssd_chunked(x, a, Bm, Cm, chunk=1)
    assert torch.allclose(y_want.flatten(), torch.tensor([2.0, 2.25], dtype=torch.float64))
    y_lim, s_lim = bf16_ssd_limit(y_want, x, a, Bm, Cm, chunk=1)
    assert torch.allclose(y_lim.flatten(), torch.tensor(
        [1e-4 + 2 * 2 ** -7 + 2 * 2 ** -8, 1e-4 + 2.25 * 2 ** -7 + 3.5 * 2 ** -8],
        dtype=torch.float64))
    assert torch.allclose(s_lim.flatten(), torch.tensor(
        [1e-4 + 2.75 * 2 ** -8, 1e-4 + 2.25 * 2 ** -8], dtype=torch.float64))

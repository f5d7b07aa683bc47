"""The RG-LRU kernel's blocking, in plain torch, against the JAX package and
against the checks' limit, on the CPU.

``rglru_fwd.cu`` scans chunks of steps in parallel: each chunk scans from
zero to its aggregate (A_c = prod a, H_c), takes the h at the end of the
chunk before it, h_in(c) = H_{c-1} + A_{c-1} h_in(c-1), and re-walks its
steps from h_in.  ``_rglru_chunked`` repeats that in plain torch, and takes
the look-back as an argument, so that the tests below can inject faults
into it.  It must agree with the JAX package (``rglru_pallas`` in
interpret mode and ``_rglru_xla``) on the same numpy inputs within the
reference's fp32 tolerance, 3e-4, and in bf16 lie within ``ROUNDED_TOL``
(one bf16 ulp, 2^-7 relative, plus 1e-4; chip_smoke.py) of the float64
plain result, as the kernel must on the card.

Decays drawn as the JAX package's tests draw them (lam ~ N(0, 1), so a in
about (1e-8, 0.93)) make the product of a over a chunk underflow, so the
carry between chunks weighs nothing and faults in it cannot show.  Slow
decays, lam ~ U(-12, -7) so a in (0.99, 1) (trained RecurrentGemma
initialises its gates so that a^c lies in (0.9, 0.999); Griffin,
arXiv:2402.19427), give the carry its weight: there each injected fault
must exceed the limit more than tenfold.  The first two faults pass at fast
decays, which is why the slow draws exist.  The card tests
(tests/test_torch_rglru_cuda.py) and chip_smoke.py hold the kernel itself
to the same limit at both decays.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels.rglru import rglru as jax_rglru  # noqa: E402
from repro.kernels.rglru.ops import _rglru_xla  # noqa: E402
from repro_torch.kernels.rglru.ops import (_look_back, _rglru_chunked,  # noqa: E402
                                           _rglru_scan)

FP32_TOL = dict(atol=3e-4, rtol=3e-4)
ROUNDED_TOL = {"float32": (3e-4, 3e-4), "bfloat16": (1e-4, 2 ** -7)}
CARRY_FAULTS = ["carry sees only the previous chunk",
                "aggregates composed out of order"]
FAULTS = CARRY_FAULTS + ["A of one intermediate chunk dropped", "h0 dropped",
                         "padded step in an aggregate"]


def _inputs(seed, B, S, W, decay):
    rng = np.random.default_rng(seed)
    x, r, i = (rng.standard_normal((B, S, W), dtype=np.float32) for _ in range(3))
    if decay == "slow":
        lam = rng.uniform(-12.0, -7.0, W).astype(np.float32)
    else:
        lam = rng.standard_normal(W, dtype=np.float32)
    h0 = rng.standard_normal((B, W), dtype=np.float32) * 0.2
    return x, r, i, lam, h0


@functools.lru_cache(maxsize=None)
def _jax_out(seed, shape, decay, impl, with_h0):
    x, r, i, lam, h0 = _inputs(seed, *shape, decay)
    args = [jnp.asarray(a) for a in (x, r, i, lam)]
    h0 = jnp.asarray(h0) if with_h0 else jnp.zeros(h0.shape, jnp.float32)
    if impl == "xla":
        y, h = jax.jit(_rglru_xla)(*args, h0)
    else:      # the Pallas kernel in interpret mode, one block of all S steps
        y, h = jax_rglru(*args, h0, chunk=shape[1], impl="pallas_interpret")
    return np.asarray(y), np.asarray(h)


def _torch_args(seed, shape, decay, dtype="float32", with_h0=True):
    x, r, i, lam, h0 = _inputs(seed, *shape, decay)
    tdt = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in (x, r, i)] + [torch.from_numpy(lam)],
            torch.from_numpy(h0) if with_h0 else None)


def _plain64(args, h0):
    return _rglru_scan(*(a.double() for a in args), h0.double() if h0 is not None else None)


def _over_limit(got, want, dtype):
    """max |got - want| / (atol + rtol |want|) under ROUNDED_TOL[dtype]."""
    atol, rtol = ROUNDED_TOL[dtype]
    return ((got.double() - want).abs() / (atol + rtol * want.abs())).max().item()


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("S,chunk,with_h0", [(160, 32, True), (100, 32, False),
                                             (129, 64, True), (64, 64, False)])
def test_chunked_matches_jax(jax_impl, decay, S, chunk, with_h0):
    shape = (2, S, 64)
    args, h0 = _torch_args(S, shape, decay, with_h0=with_h0)
    y, h = _rglru_chunked(*args, h0, chunk=chunk)
    y_want, h_want = _jax_out(S, shape, decay, jax_impl, with_h0)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_want, **FP32_TOL)
    np.testing.assert_allclose(h.numpy(), h_want, **FP32_TOL)


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("S,chunk", [(512, 32), (333, 64), (31, 32)])
def test_chunked_bf16_within_rounded_tol(decay, S, chunk):
    """bf16 inputs, fp32 arithmetic, y rounded once: within ROUNDED_TOL of the
    float64 plain result, as the kernel is held on the card."""
    args, h0 = _torch_args(7, (2, S, 128), decay, "bfloat16")
    y, h = _rglru_chunked(*args, h0, chunk=chunk)
    y_want, h_want = _plain64(args, h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert _over_limit(y, y_want, "bfloat16") <= 1.0
    assert _over_limit(h, h_want, "float32") <= 1.0


def _faulty_look_back(A, H, h0, fault):
    """A look-back with one fault: the carry from the previous chunk's local
    scan alone, or a walk back over the chunks before each chunk, h_in(c) =
    H_{c-1} + A_{c-1} (H_{c-2} + ... + A_0 h0), with chunks c-2 and c-3
    composed in swapped order or chunk c-2's A left out."""
    if fault == "h0 dropped":
        return _look_back(A, H, torch.zeros_like(h0))
    h_in = [h0]
    for c in range(1, A.shape[1]):
        if fault == "carry sees only the previous chunk":
            h_in.append(H[:, c - 1])
            continue
        order = list(range(c - 1, -1, -1))
        if fault == "aggregates composed out of order" and c >= 3:
            order[1], order[2] = order[2], order[1]
        acc_a, acc_h = torch.ones_like(h0), torch.zeros_like(h0)
        for j in order:
            acc_h = acc_h + acc_a * H[:, j]
            if not (fault == "A of one intermediate chunk dropped" and j == c - 2):
                acc_a = acc_a * A[:, j]
        h_in.append(acc_h + acc_a * h0)
    return torch.stack(h_in, dim=1)


def _with_fault(x, r, i, lam, h0, chunk, fault=None):
    """``_rglru_chunked`` with ``fault`` injected: into its look-back, or, for
    a padded step in an aggregate, by padding x, r and i with zeros to whole
    chunks, so that the padded steps' gates enter the last aggregate."""
    S = x.shape[1]
    if fault == "padded step in an aggregate":
        x, r, i = (F.pad(t, (0, 0, 0, -S % chunk)) for t in (x, r, i))
    look_back = (_look_back if fault in (None, "padded step in an aggregate")
                 else functools.partial(_faulty_look_back, fault=fault))
    y, h = _rglru_chunked(x, r, i, lam, h0, chunk=chunk, look_back=look_back)
    return y[:, :S], h


def _fault_ratio(decay, fault, chunk=64, shape=(2, 500, 256)):
    """The worst of y's and the final h's error over their ROUNDED_TOL limit
    (bf16 y, fp32 h), with ``fault`` injected, by default at S 500: 8 chunks
    of 64 (16 of 32) and a ragged last chunk."""
    args, h0 = _torch_args(11, shape, decay, "bfloat16")
    y, h = _with_fault(*args, h0, chunk, fault)
    y_want, h_want = _plain64(args, h0)
    return max(_over_limit(y, y_want, "bfloat16"), _over_limit(h, h_want, "float32"))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_emulation_is_the_chunked_scan_and_lies_within_the_limit(decay, chunk):
    """In float64 the chunked scan is the sequential scan to rounding; with
    bf16 inputs in fp32 it lies within the limit."""
    args, h0 = _torch_args(11, (2, 500, 256), decay, "bfloat16")
    y64, h64 = _rglru_chunked(*(a.double() for a in args), h0.double(), chunk=chunk)
    y_want, h_want = _plain64(args, h0)
    torch.testing.assert_close(y64, y_want, atol=1e-10, rtol=1e-8)
    torch.testing.assert_close(h64, h_want, atol=1e-10, rtol=1e-8)
    assert _fault_ratio(decay, None, chunk) <= 1.0


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("fault", FAULTS)
def test_the_limit_refuses_each_fault_at_slow_decay(fault, chunk):
    assert _fault_ratio("slow", fault, chunk) > 10.0


@pytest.mark.parametrize("fault", CARRY_FAULTS)
def test_carry_faults_pass_at_fast_decay(fault):
    """Why the slow draws exist: at the JAX tests' decays a chunk's product of
    a underflows, and a wrong carry stays within the limit."""
    assert _fault_ratio("fast", fault) <= 1.0


def test_one_minus_a_squared_keeps_its_digits_at_slow_decay():
    """1 - a*a with a rounded to fp32 (the reference's evaluation, which
    ``_rglru_scan`` keeps) loses up to a third of itself when a is within
    1e-7 of 1, and at wave A's length puts some y over one bf16 ulp of the
    float64 result; the kernel's -(a - 1)(a + 1), which ``_rglru_chunked``
    evaluates as -expm1(2 log a), does not."""
    args, h0 = _torch_args(11, (2, 3072, 256), "slow", "bfloat16")
    y_want, _ = _plain64(args, h0)
    y_ref, _ = _rglru_scan(*args, h0)
    assert _over_limit(y_ref, y_want, "bfloat16") > 1.0
    assert _fault_ratio("slow", None, 32, (2, 3072, 256)) <= 1.0

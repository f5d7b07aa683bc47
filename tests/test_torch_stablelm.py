"""The port serves the published StableLM 2 block: RoPE on the first quarter
of each head (``ModelConfig.rotary_fraction`` 0.25), LayerNorm with bias at
eps 1e-5 (``ModelConfig.norm_eps``), q/k/v bias and multi-head attention.

At a smoke size, in float32 on the benchmark's seeded weights, ``DecoderLM``
agrees with the plain reference ``portbench/reference/stablelm.py`` within
3e-4 (the repository's float32 tolerance): its full forward, a prefill then
8 decode steps through the cache, and ``ServeEngine`` on a left-padded wave.
A whole-head program leaves that reference by far more, and so does the old
eps 1e-6 where the first norm's input has a variance near the eps (an
embedding of std 1e-3).  At their defaults, ``apply_rope``, ``rmsnorm`` and
``layernorm`` give today's bits.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, weights  # noqa: E402
from portbench.reference.stablelm import Reference  # noqa: E402
from portbench.tests.smoke import smoke_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.common import apply_rope, layernorm, rmsnorm  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = dict(atol=3e-4, rtol=3e-4)
SEED = 2 ** 33 + 17
PROMPT, DECODE = 12, 8
LENGTHS = (7, 20, 13)             # one left-padded wave
NEW = 5


def _config(**keys) -> dict:
    """The benchmark's stablelm-1.6b file at the program's smoke sizes
    (2 layers, 4 heads of 16: 4 dims rotate), in float32."""
    return dict(smoke_config("stablelm-1.6b"), param_dtype="float32",
                compute_dtype="float32", **keys)


def _program(cfg: dict, **fields):
    """The program of ``cfg`` with the seed's weights, its ModelConfig's
    ``fields`` changed after the file's check."""
    model = harness.build_program(cfg, SEED, "cpu", get_smoke_config)
    if fields:
        model.cfg = dataclasses.replace(model.cfg, **fields)
    return model


def _tokens(n: int, vocab: int, seed: int = 0) -> torch.Tensor:
    return torch.randint(0, vocab, (n,), generator=torch.Generator().manual_seed(seed))


def _reference(cfg, tokens, positions):
    return Reference(cfg, SEED, "cpu").logits([tokens], [positions])[0]


def test_the_program_is_the_published_block():
    cfg = _config()
    mc = _program(cfg).cfg
    assert (mc.rotary_fraction, mc.norm_eps, mc.qkv_bias) == (0.25, 1e-5, True)
    assert (mc.norm, mc.n_heads, mc.n_kv_heads, mc.n_experts) == ("layernorm", 4, 4, 0)
    assert int(mc.rotary_fraction * mc.head_dim) == 4


def test_forward_matches_the_reference():
    cfg = _config()
    tokens = _tokens(PROMPT + DECODE, cfg["vocab_size"])
    with torch.no_grad():
        got = _program(cfg)({"tokens": tokens[None]})[0, :, : cfg["vocab_size"]]
    want = _reference(cfg, tokens, torch.arange(len(tokens)))
    torch.testing.assert_close(got, want, **TOL)


def test_prefill_and_decode_through_the_cache_match_the_reference():
    cfg = _config()
    model = _program(cfg)
    tokens = _tokens(PROMPT + DECODE, cfg["vocab_size"], seed=1)
    with torch.inference_mode():
        logits, cache, n = model.prefill(tokens[None, :PROMPT])
        got = [logits[0, -1]]
        for i in range(PROMPT, PROMPT + DECODE):
            logits, cache = model.decode_step(cache, tokens[None, i:i + 1], i)
            got.append(logits[0, -1])
    assert n == PROMPT
    got = torch.stack(got)[:, : cfg["vocab_size"]]
    want = _reference(cfg, tokens, torch.arange(PROMPT - 1, PROMPT + DECODE))
    torch.testing.assert_close(got, want, **TOL)


class _Logits:
    """The model as the engine sees it, keeping each step's last logits."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        out = self.model.prefill(*args, **kw)
        self.logits.append(out[0][:, -1].clone())
        return out

    def decode_step(self, *args, **kw):
        out = self.model.decode_step(*args, **kw)
        self.logits.append(out[0][:, -1].clone())
        return out


def test_a_left_padded_wave_matches_the_reference():
    cfg = _config()
    seen = _Logits(_program(cfg))
    engine = ServeEngine(seen, max_batch=len(LENGTHS))
    prompts = [_tokens(n, cfg["vocab_size"], seed=10 + n) for n in LENGTHS]
    for p in prompts:
        engine.submit(p.numpy(), max_new_tokens=NEW)
    done = engine.run()
    [stats] = engine.wave_stats
    assert stats["prompt_lens"] == list(LENGTHS) and len(seen.logits) == NEW
    ref = Reference(cfg, SEED, "cpu")
    for row, (prompt, r) in enumerate(zip(prompts, done)):
        assert len(r.output) == NEW
        seq = torch.cat([prompt, torch.as_tensor(r.output[:-1])])
        n = len(prompt)
        want = ref.logits([seq], [torch.arange(n - 1, n - 1 + NEW)])[0]
        got = torch.stack([lg[row] for lg in seen.logits])[:, : cfg["vocab_size"]]
        torch.testing.assert_close(got, want, **TOL, msg=f"row {row}")
        assert r.output == want.argmax(-1).tolist()


def _far(got, want) -> float:
    """The largest difference, in units of the tolerance at ``want``."""
    return float(((got - want).abs() / (TOL["atol"] + TOL["rtol"] * want.abs())).max())


def test_a_whole_head_program_leaves_the_reference():
    cfg = _config()
    tokens = _tokens(PROMPT + DECODE, cfg["vocab_size"], seed=2)
    want = _reference(cfg, tokens, torch.arange(len(tokens)))
    with torch.no_grad():
        got = _program(cfg, rotary_fraction=1.0)({"tokens": tokens[None]})
    assert _far(got[0, :, : cfg["vocab_size"]], want) > 100


@pytest.fixture
def small_embedding(monkeypatch):
    """The embedding drawn at std 1e-3, so that the first norm's input has a
    variance near the eps (both sides draw through ``weights.draw``)."""
    mean_std = weights._mean_std

    def small(name, shape, norm):
        return (0.0, 1e-3) if name == "embed" else mean_std(name, shape, norm)

    monkeypatch.setattr(weights, "_mean_std", small)


@pytest.mark.parametrize("eps, far", [(1e-5, False), (1e-6, True)], ids=["1e-5", "1e-6"])
def test_the_norm_eps_shows_at_a_small_variance(small_embedding, eps, far):
    """At the benchmark's embedding (std 1) a norm's input has a variance near
    1, where 1e-5 and 1e-6 differ by ~5e-6 relative: under the tolerance.
    At std 1e-3 the published eps matches and the old one is far off."""
    cfg = _config()
    tokens = _tokens(PROMPT, cfg["vocab_size"], seed=3)
    want = _reference(cfg, tokens, torch.arange(PROMPT))
    with torch.no_grad():
        got = _program(cfg, norm_eps=eps)({"tokens": tokens[None]})[0, :, : cfg["vocab_size"]]
    if far:
        assert _far(got, want) > 100
    else:
        torch.testing.assert_close(got, want, **TOL)


# ------------------------------------------------------------ the defaults


def _rope_before(x, positions, theta):
    """``apply_rope`` before the rotary fraction, verbatim."""
    D = x.shape[-1]
    freq = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                   device=positions.device) / D)
    ang = positions.to(torch.float32)[..., None] * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def _rmsnorm_before(x, scale):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _layernorm_before(x, scale, bias):
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + 1e-6)
    return (y * scale.float() + bias.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_defaults_give_todays_bits(dtype):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 9, 3, 64, generator=gen).to(dtype)
    for positions in (torch.arange(9), torch.arange(18).reshape(2, 9) + 5):
        assert torch.equal(apply_rope(x, positions, 1e4), _rope_before(x, positions, 1e4))
    h = (3 * torch.randn(4, 7, 48, generator=gen)).to(dtype)
    scale, bias = torch.randn(48, generator=gen), torch.randn(48, generator=gen)
    assert torch.equal(rmsnorm(h, scale), _rmsnorm_before(h, scale))
    assert torch.equal(layernorm(h, scale, bias), _layernorm_before(h, scale, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_fraction_rotates_the_first_dims_alone(dtype):
    """Dims [0, r) are a whole-head rotation of that slice (frequencies over
    r); dims [r, D) come back with their bits, in x's dtype."""
    x = torch.randn(2, 9, 3, 64, generator=torch.Generator().manual_seed(5)).to(dtype)
    positions = torch.arange(9) + 100
    y = apply_rope(x, positions, 1e4, 0.25)
    assert y.dtype == dtype
    assert torch.equal(y[..., :16], _rope_before(x[..., :16], positions, 1e4))
    assert torch.equal(y[..., 16:], x[..., 16:])
    for fraction in (3 / 64, 0.0):                 # 3 dims (odd), none
        with pytest.raises(ValueError, match="even"):
            apply_rope(x, positions, 1e4, fraction)


"""The encoder-decoder (seamless-m4t-medium) in the port against the JAX
package.

At the smoke config, on weights initialised in JAX and carried across by
``params_from_jax``: the parameter tree both ways, ``encode``, ``forward``
(its cross-attention through flash attention at Sq != Sk), ``loss`` and every
gradient against ``jax.grad``, ``prefill`` (its cross-attention through the
plain ``_cross_apply``) with every cache, and 8 ``decode_step``s.  Then
the attention module's cross paths alone: ``attn_apply(kv_x=...)`` at
Sq != Sk through the plain chunked flash attention in blocks that divide
neither length, and ``attn_decode(cross_kv=..., cross_len=...)``.  The
reference's ``init_cache(batch, enc_out)`` raises; the port's builds the
cross K/V.  The reference runs ``attn_impl="naive"``; fp32, tolerance 3e-4
(tests/test_kernels.py::_tol).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import EncDecLM, RuntimeConfig, build_model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.weights import (jax_layout, params_from_jax,  # noqa: E402
                                 params_to_jax, to_torch)

ARCH = "seamless-m4t-medium"
TOL = dict(atol=3e-4, rtol=3e-4)
CACHE_LEN = 48
JRT = dict(compute_dtype=jnp.float32, attn_impl="naive", max_cache_len=CACHE_LEN)
B, S_ENC, S_DEC = 2, 24, 12


def _pair(**cfg_changes):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **cfg_changes)
    jmodel = jax_build_model(jcfg, JaxRuntimeConfig(**JRT))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(dataclasses.replace(get_smoke_config(ARCH), **cfg_changes),
                         RuntimeConfig(compute_dtype=torch.float32, max_cache_len=CACHE_LEN),
                         device="cpu", seed=1)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def models():
    return _pair()


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **TOL)


def _inputs(cfg, seed, S_dec=S_DEC):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((B, S_ENC, cfg.d_model)) * 0.1).astype(np.float32)
    tokens = rng.integers(3, cfg.vocab_size, size=(B, S_dec + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.1] = -1
    return {"frontend_embeds": frames, "tokens": tokens[:, :S_dec], "labels": labels}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _walk(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_builds_with_the_reference_parameter_tree(models):
    _, jparams, tmodel = models
    cfg = tmodel.cfg
    assert isinstance(tmodel, EncDecLM)
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    own = tmodel.state_dict()
    assert set(state) == set(own)
    assert all(state[k].shape == own[k].shape for k in own)
    assert len(tmodel.encoder) == cfg.n_encoder_layers and len(tmodel.decoder) == cfg.n_layers
    layout = jax_layout(own, len(cfg.pattern))
    assert layout["decoder/cross_attn/wq/w"] == [f"decoder.{l}.cross_attn.wq.w"
                                                 for l in range(cfg.n_layers)]
    assert layout["enc_final_norm/bias"] == "enc_final_norm.bias"
    back = params_to_jax(own, len(cfg.pattern))
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in want:
        np.testing.assert_array_equal(_walk(back, path), np.asarray(leaf))
    assert len(want) == len(jax.tree.leaves(back))


def test_encode_matches_jax(models):
    jmodel, jparams, tmodel = models
    batch = _inputs(tmodel.cfg, 1)
    want = jmodel.encode(jparams, jnp.asarray(batch["frontend_embeds"]))
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(batch["frontend_embeds"]))
    _close(got, want)


@pytest.mark.parametrize("vocab", [None, 462])
def test_forward_matches_jax(models, vocab):
    """At the smoke vocab, and at one padded to 512 (as 256206 pads to
    256256), whose padded logits read -1e30."""
    jmodel, jparams, tmodel = models if vocab is None else _pair(vocab_size=vocab)
    cfg = tmodel.cfg
    batch = _inputs(cfg, 2)
    want = jmodel.forward(jparams, _j(batch))
    with torch.no_grad():
        got = tmodel(_t(batch))
    assert tuple(got.shape) == want.shape == (B, S_DEC, cfg.padded_vocab)
    _close(got, want)
    assert (cfg.padded_vocab != cfg.vocab_size) == (vocab is not None)
    assert (got[..., cfg.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_jax(models, remat):
    jmodel, jparams, _ = models
    tmodel = build_model(get_smoke_config(ARCH),
                         RuntimeConfig(compute_dtype=torch.float32, attn_impl="ref",
                                       remat=remat), device="cpu")
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    batch = _inputs(tmodel.cfg, 3)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, _j(batch))
    params = dict(tmodel.named_parameters())
    loss, aux = tmodel.loss(_t(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert int(aux["n_tokens"]) == int(jaux["n_tokens"])
    got = params_to_jax(grads, len(tmodel.pattern))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, leaf in want:
        np.testing.assert_allclose(_walk(got, path), np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(want) == len(jax.tree.leaves(got))


def test_prefill_and_decode_match_jax(models):
    """Prefill's logits, self-attention caches and cross K/V, then 8 decode
    steps against the reference's (its caches are stacked over layers)."""
    jmodel, jparams, tmodel = models
    batch = _inputs(tmodel.cfg, 4)
    frames, tokens = batch["frontend_embeds"], batch["tokens"]
    jlogits, jcache, jpos = jmodel.prefill(jparams, jnp.asarray(frames), jnp.asarray(tokens))
    tlogits, tcache, tpos = tmodel.prefill(torch.from_numpy(frames), torch.from_numpy(tokens))
    assert tpos == jpos == S_DEC
    _close(tlogits, jlogits)
    for layer in range(tmodel.cfg.n_layers):
        for side in ("self", "cross"):
            for key in ("k", "v"):
                _close(tcache[side][layer][key], jcache[side][key][layer])
    tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)
    decode = jax.jit(jmodel.decode_step)
    for step in range(8):
        jlogits, jcache = decode(jparams, jcache, jnp.asarray(tok),
                                 jnp.asarray(jpos + step, jnp.int32))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok), tpos + step)
        _close(tlogits, jlogits)
        tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)


def test_prefill_decode_match_forward(models):
    """As tests/test_arch_smoke.py::test_prefill_decode_matches_forward, in
    the port: prefill(tokens[:, :-1]) and one decode step give the forward's
    last two positions (flash cross-attention against the plain one)."""
    _, _, tmodel = models
    batch = _t(_inputs(tmodel.cfg, 5))
    with torch.no_grad():
        full = tmodel(batch)
    lp, cache, pos = tmodel.prefill(batch["frontend_embeds"], batch["tokens"][:, :-1])
    lg, _ = tmodel.decode_step(cache, batch["tokens"][:, -1:], pos)
    _close(lp[:, 0], full[:, -2].numpy())
    _close(lg[:, 0], full[:, -1].numpy())


def test_init_cache_builds_the_cross_kv_where_the_reference_raises(models):
    """The reference's ``init_cache(batch, enc_out)`` calls ``_cross_kv(None,
    enc_out)``, and ``jax.vmap`` of None raises; the port's module holds its
    params, so it builds each layer's cross K/V, equal to prefill's."""
    jmodel, jparams, tmodel = models
    batch = _inputs(tmodel.cfg, 6)
    enc = jmodel.encode(jparams, jnp.asarray(batch["frontend_embeds"]))
    with pytest.raises(ValueError, match="vmap"):
        jmodel.init_cache(B, enc)
    frames = torch.from_numpy(batch["frontend_embeds"])
    with torch.no_grad():
        cache = tmodel.init_cache(B, tmodel.encode(frames))
    _, filled, _ = tmodel.prefill(frames, torch.from_numpy(batch["tokens"]))
    assert len(cache["self"]) == len(cache["cross"]) == tmodel.cfg.n_layers
    assert tuple(cache["self"][0]["k"].shape) == (B, CACHE_LEN, 4, 16)
    for got, want in zip(cache["cross"], filled["cross"]):
        torch.testing.assert_close(got["k"], want["k"])
        torch.testing.assert_close(got["v"], want["v"])
    assert "cross" not in tmodel.init_cache(B)


# ---- the attention module's cross paths ------------------------------------------

def _attn_pair(seed):
    cfg = jax_smoke_config(ARCH)
    from repro.models.common import Initializer
    jp = jax_attention.attn_init(Initializer(jax.random.PRNGKey(seed)), cfg, jnp.float32)
    tp = {k: {n: to_torch(np.asarray(a)) for n, a in d.items()} for k, d in jp.items()}
    return cfg, jp, tp


@pytest.mark.parametrize("Sq,Sk,block", [(12, 40, (8, 16)), (33, 17, (16, 8)), (5, 5, (128, 128))])
def test_attn_apply_cross_matches_jax(Sq, Sk, block):
    """K/V from ``kv_x``, no RoPE, non-causal: the port's chunked flash
    attention in blocks that divide neither length, against the reference's
    naive attention; q segments are ignored, as the reference's masking
    ignores them without kv segments."""
    cfg, jp, tp = _attn_pair(Sq + Sk)
    rng = np.random.default_rng(Sq * Sk)
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((B, Sk, cfg.d_model)).astype(np.float32)
    seg = np.ones((B, Sq), np.int32)
    seg[0, :3] = 2
    want = jax_attention.attn_apply(
        jp, jnp.asarray(x), cfg, JaxRuntimeConfig(compute_dtype=jnp.float32, attn_impl="naive"),
        kv_x=jnp.asarray(kv_x), segments=jnp.asarray(seg))
    rt = RuntimeConfig(compute_dtype=torch.float32, attn_impl="chunked",
                       attn_block_q=block[0], attn_block_k=block[1])
    got = attention.attn_apply(tp, torch.from_numpy(x), cfg, rt, kv_x=torch.from_numpy(kv_x),
                               segments=torch.from_numpy(seg))
    assert tuple(got.shape) == (B, Sq, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("cross_len", [None, 13])
def test_attn_decode_cross_matches_jax(cross_len):
    """One token against precomputed encoder K/V, the first ``cross_len``
    valid; the cache passes through untouched."""
    cfg, jp, tp = _attn_pair(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, 20, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    jrt = JaxRuntimeConfig(compute_dtype=jnp.float32)
    want, _ = jax_attention.attn_decode(
        jp, jnp.asarray(x), {}, jnp.asarray(0, jnp.int32), cfg, jrt,
        cross_kv=(jnp.asarray(k), jnp.asarray(v)),
        cross_len=None if cross_len is None else jnp.asarray(cross_len))
    sentinel = {"k": torch.zeros(1)}
    got, cache = attention.attn_decode(
        tp, torch.from_numpy(x), sentinel, 0, cfg, RuntimeConfig(compute_dtype=torch.float32),
        cross_kv=(torch.from_numpy(k), torch.from_numpy(v)), cross_len=cross_len)
    assert cache is sentinel
    _close(got, want)


def test_serve_engine_refuses_an_encoder_decoder(models):
    """The reference's engine cannot serve one either (its requests carry
    no frames); the port's says so when it is built."""
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServeEngine(models[2])

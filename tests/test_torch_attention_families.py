"""The attention-only families in the port against the JAX package.

stablelm-1.6b (layernorm, MHA, untied head), qwen2.5-32b (QKV bias, GQA),
gemma2-9b (local/global layers, both softcaps, post-norms, scaled embedding),
gemma3-12b (5 local : 1 global) and internvl2-2b (a frontend-embeds prefix),
each at its smoke config, on weights initialised by JAX and carried across by
``params_from_jax``: the forward, prefill and decode (prompts shorter and
longer than the 128-slot ring of the local layers, so the ring's wrap and
shift run), and the loss with every gradient against ``jax.grad``.  The
reference runs ``attn_impl="naive"``; the port runs its chunked plain
version for serving and ``"ref"`` for training.  fp32, tolerance 3e-4
(tests/test_kernels.py::_tol).

Also the plain flash attention at ragged lengths, and the kernel routes
refusing CPU tensors with their device error at any length.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_reference,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.rglru import rglru  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402

TOL = dict(atol=3e-4, rtol=3e-4)
ARCHS = ["stablelm-1.6b", "qwen2.5-32b", "gemma2-9b", "gemma3-12b", "internvl2-2b"]
WINDOWED = ["gemma2-9b", "gemma3-12b"]
CACHE_LEN = 176        # global layers hold the longest prompt; local rings 128
JRT = dict(compute_dtype=jnp.float32, attn_impl="naive")


def _pair(arch, jax_rt=None, torch_rt=None, **cfg_changes):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **cfg_changes)
    jmodel = jax_build_model(jcfg, JaxRuntimeConfig(**(jax_rt or JRT)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke_config(arch), **cfg_changes)
    trt = torch_rt or RuntimeConfig(compute_dtype=torch.float32)
    tmodel = build_model(tcfg, trt, device="cpu", seed=1)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **TOL)


def _frontend(cfg, B, seed):
    """The VLM's stub input: precomputed patch embeddings, or None."""
    if cfg.frontend != "vision":
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)) * 0.1
            ).astype(np.float32)


def _layer_cache(jcache, layer, period, n_repeats):
    """The reference's cache of one layer (stacked superblocks, then tail)."""
    if layer < n_repeats * period:
        return jax.tree.map(lambda a: a[layer // period],
                            jcache["blocks"][f"pos{layer % period}"])
    return jcache[f"tail{layer - n_repeats * period}"]


@pytest.mark.parametrize("arch", ARCHS)
def test_builds_with_the_reference_parameter_tree(arch):
    jmodel, jparams, tmodel = _pair(arch)
    cfg = tmodel.cfg
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    own = tmodel.state_dict()
    assert set(state) == set(own)
    assert all(state[k].shape == own[k].shape for k in own)
    assert ("lm_head" in own) == (not cfg.tie_embeddings)
    assert ("blocks.0.post_norm1.scale" in own) == cfg.post_norms
    assert ("blocks.0.post_norm2.scale" in own) == cfg.post_norms
    assert ("blocks.0.attn.wq.b" in own) == cfg.qkv_bias
    # and back: the port's tree is the reference's, leaf for leaf
    back = params_to_jax(own, len(cfg.pattern))
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in want:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert len(want) == len(jax.tree.leaves(back))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jmodel, jparams, tmodel = _pair(arch)
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    batch = {"tokens": tokens}
    fe = _frontend(cfg, 2, 4)
    if fe is not None:
        batch["frontend_embeds"] = fe
    jlogits = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlogits = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(tlogits.shape) == jlogits.shape
    assert tlogits.shape[1] == 40 + cfg.frontend_tokens * (fe is not None)
    _close(tlogits, jlogits)


@pytest.mark.parametrize("prompt_len", [20, 150])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, prompt_len):
    """Prefill logits, every layer's KV cache, then 8 decode steps.  At 150
    tokens a local layer's 128-slot ring wraps: prefill writes it with a
    shift and decode keeps going round it."""
    jmodel, jparams, tmodel = _pair(
        arch, jax_rt=dict(JRT, max_cache_len=CACHE_LEN),
        torch_rt=RuntimeConfig(compute_dtype=torch.float32, max_cache_len=CACHE_LEN))
    cfg = tmodel.cfg
    rng = np.random.default_rng(prompt_len)
    tokens = rng.integers(3, cfg.vocab_size, size=(2, prompt_len)).astype(np.int32)
    fe = _frontend(cfg, 2, prompt_len)
    jlogits, jcache, jpos = jmodel.prefill(
        jparams, jnp.asarray(tokens), None if fe is None else jnp.asarray(fe))
    tlogits, tcache, tpos = tmodel.prefill(
        torch.from_numpy(tokens), None if fe is None else torch.from_numpy(fe))
    assert tpos == jpos == prompt_len + (0 if fe is None else cfg.frontend_tokens)
    _close(tlogits, jlogits)
    period = len(cfg.pattern)
    for layer, kind in enumerate(tmodel.kinds):
        want = _layer_cache(jcache, layer, period, cfg.n_layers // period)
        for key in ("k", "v"):
            assert tuple(tcache[layer][key].shape) == want[key].shape, (layer, kind)
            _close(tcache[layer][key], want[key])
    tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)
    decode = jax.jit(jmodel.decode_step)
    for step in range(8):
        jlogits, jcache = decode(jparams, jcache, jnp.asarray(tok),
                                 jnp.asarray(jpos + step, jnp.int32))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok), tpos + step)
        _close(tlogits, jlogits)
        tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)


def _train_batch(cfg, seed, B=4, S=40):
    """Two documents a row, positions restarting at each, masked labels; the
    VLM's rows carry the patch prefix instead (its logits unsupervised)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[rng.random((B, S)) < 0.1] = -1
    batch = {"tokens": tokens[:, :S], "labels": labels}
    fe = _frontend(cfg, B, seed)
    if fe is not None:
        batch["frontend_embeds"] = fe
        return batch
    cut = rng.integers(S // 4, 3 * S // 4, size=B)
    batch["segments"] = (np.arange(S)[None] >= cut[:, None]).astype(np.int32)
    batch["positions"] = np.where(batch["segments"] == 1,
                                  np.arange(S)[None] - cut[:, None],
                                  np.arange(S)[None]).astype(np.int32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jmodel, jparams, tmodel = _pair(
        arch, torch_rt=RuntimeConfig(compute_dtype=torch.float32, attn_impl="ref"))
    batch = _train_batch(tmodel.cfg, 5)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = dict(tmodel.named_parameters())
    loss, aux = tmodel.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert int(aux["n_tokens"]) == int(jaux["n_tokens"]) == int((batch["labels"] >= 0).sum())
    got = params_to_jax(grads, len(tmodel.pattern))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, leaf in want:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(want) == len(jax.tree.leaves(got))


@pytest.mark.parametrize("arch", WINDOWED)
def test_windowed_decode_ring_cache(arch):
    """As tests/test_arch_smoke.py::test_windowed_decode_ring_cache: a window
    of 8, decode from an empty cache far past it.  Every step's logits match
    the reference's decode (3e-4) and the port's own full forward (the
    reference test's 2e-3)."""
    B, S_long = 2, 24
    jmodel, jparams, tmodel = _pair(
        arch, jax_rt=dict(JRT, max_cache_len=32),
        torch_rt=RuntimeConfig(compute_dtype=torch.float32, max_cache_len=32),
        local_window=8)
    tokens = np.random.default_rng(7).integers(
        0, tmodel.cfg.vocab_size, size=(B, S_long)).astype(np.int32)
    with torch.no_grad():
        full = tmodel({"tokens": torch.from_numpy(tokens)})
    jcache, tcache = jmodel.init_cache(B), tmodel.init_cache(B)
    decode = jax.jit(jmodel.decode_step)
    for t in range(S_long):
        jlg, jcache = decode(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.asarray(t, jnp.int32))
        tlg, tcache = tmodel.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]), t)
        _close(tlg, jlg)
        assert (tlg[:, 0] - full[:, t]).abs().max().item() < 2e-3, t


# ---- the plain flash attention at any length, and the kernel routes ---------

def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _left_pad_segments(lengths, S):
    seg = torch.zeros((len(lengths), S), dtype=torch.int32)
    for b, n in enumerate(lengths):
        seg[b, S - n:] = 1
    return seg


@pytest.mark.parametrize("case", [
    # Sq, Sk, q_offset, window, softcap, left-padded rows
    (300, 300, 0, None, 50.0, (300, 211, 129)),
    (300, 300, 0, 100, 50.0, (300, 37, 1)),
    (300, 300, 0, None, None, None),
    (100, 333, 233, 64, None, None),
    (129, 129, 0, 128, 20.0, (129, 64, 128)),
])
def test_chunked_takes_ragged_blocks(case):
    """Sq and Sk that blocks of 128 do not divide: the short last q and kv
    blocks are masked by position, as the kernels mask ragged tiles."""
    Sq, Sk, q_offset, window, cap, lengths = case
    B = 3 if lengths else 2
    q, k, v = _qkv(Sq + Sk, B, Sq, Sk, 8, 4, 32)
    opts = dict(causal=True, window=window, softcap=cap, q_offset=q_offset)
    if lengths:
        seg = _left_pad_segments(lengths, Sk)
        opts.update(q_segments=seg, kv_segments=seg)
    got = flash_attention(q, k, v, impl="chunked", block_q=128, block_k=128, **opts)
    want = attention_reference(q.double(), k.double(), v.double(), **opts)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # the dispatcher's CPU default is the same plain version
    torch.testing.assert_close(
        flash_attention(q, k, v, block_q=128, block_k=128, **opts), got)


@pytest.mark.parametrize("S", [300, 700, 4500])
def test_kernel_routes_refuse_cpu_tensors_at_any_length(S):
    """The cuda routes take any length: on a CPU tensor they raise their
    device error (no divisibility assert comes first)."""
    q, k, v = _qkv(S, 1, S, S, 2, 1, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, k, v, impl="cuda", block_q=512, block_k=1024)
    x = torch.zeros((1, S, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rglru(x, x, x, torch.zeros(8), impl="cuda")


def test_decode_past_a_linear_cache_raises():
    """A global layer's cache holds ``max_cache_len`` positions; a decode step
    past it raises, where the reference's update clamps to the last slot."""
    model = build_model(get_smoke_config("gemma2-9b"),
                        RuntimeConfig(compute_dtype=torch.float32, max_cache_len=16),
                        device="cpu")
    _, cache, pos = model.prefill(torch.arange(3, 19)[None])
    with pytest.raises(ValueError, match="max_cache_len"):
        model.decode_step(cache, torch.tensor([[5]]), pos)

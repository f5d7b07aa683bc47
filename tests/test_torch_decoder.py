"""The port's DecoderLM against ``repro.models.DecoderLM`` on weights
initialised by JAX and carried across by ``params_from_jax``.

mamba2 (smoke config): prompts of 10, 16 and 48 tokens cover a chunk shorter
than ssm_chunk=16, exactly one chunk, and three chunks.  recurrentgemma
(smoke config with n_layers=5: one scanned (rec, rec, local) superblock and
two unscanned tail layers): prompts of 16, 48 and 80 tokens against a local
window of 32 in a 64-slot ring (max_cache_len=64), so window masking and the
ring's wrap both run.  fp32 compute, tolerance 3e-4
(tests/test_kernels.py::_tol).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

TOL = dict(atol=3e-4, rtol=3e-4)
ARCH = "mamba2-1.3b"


def _pair(ssd_impl, param_dtype=jnp.float32, **cfg_changes):
    jrt = JaxRuntimeConfig(param_dtype=param_dtype, compute_dtype=jnp.float32,
                           ssd_impl=ssd_impl)
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **cfg_changes)
    jmodel = jax_build_model(jcfg, jrt)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tdtype = torch.bfloat16 if param_dtype == jnp.bfloat16 else torch.float32
    trt = RuntimeConfig(param_dtype=tdtype, compute_dtype=torch.float32)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), **cfg_changes)
    tmodel = build_model(tcfg, trt, device="cpu", seed=1)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ssd_impl,prompt_len", [
    ("pallas_interpret", 10), ("pallas_interpret", 16),
    ("pallas_interpret", 48), ("xla", 48)])
def test_prefill_and_decode_logits_match_jax(ssd_impl, prompt_len):
    jmodel, jparams, tmodel = _pair(ssd_impl)
    rng = np.random.default_rng(prompt_len)
    tokens = rng.integers(3, 512, size=(2, prompt_len)).astype(np.int32)
    jlogits, jcache, jpos = jmodel.prefill(jparams, jnp.asarray(tokens))
    tlogits, tcache, tpos = tmodel.prefill(torch.from_numpy(tokens))
    assert tpos == jpos == prompt_len
    assert tuple(tlogits.shape) == jlogits.shape
    _close(tlogits, jlogits)
    for i, layer in enumerate(tcache):       # per-layer view of the stacked cache
        for k in ("ssd", "conv"):
            _close(layer[k], jcache["blocks"]["pos0"][k][i])
    tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)
    for step in range(8):
        jlogits, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                             jnp.asarray(jpos + step, jnp.int32))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok),
                                             tpos + step)
        _close(tlogits, jlogits)
        tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)


def test_forward_matches_jax():
    jmodel, jparams, tmodel = _pair("xla", vocab_size=500)   # padded to 512
    tokens = np.random.default_rng(3).integers(3, 500, size=(2, 32)).astype(np.int32)
    jlogits = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits = tmodel({"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    assert (tlogits[..., 500:] == -1e30).all()   # padded vocab is masked


def test_bf16_params_carry_across():
    jmodel, jparams, tmodel = _pair("xla", param_dtype=jnp.bfloat16)
    assert tmodel.embed.dtype == torch.bfloat16
    np_tree = jax.tree.map(np.asarray, jparams)
    state = params_from_jax(np_tree)
    got = state["blocks.1.ssm.in_proj"].view(torch.uint16).numpy()
    want = np_tree["blocks"]["pos0"]["ssm"]["in_proj"][1].view(np.uint16)
    np.testing.assert_array_equal(got, want)          # bit for bit
    tokens = np.arange(3, 19, dtype=np.int32)[None]
    jlogits, _, _ = jmodel.prefill(jparams, jnp.asarray(tokens))
    tlogits, _, _ = tmodel.prefill(torch.from_numpy(tokens))
    _close(tlogits, jlogits)


def test_state_dict_keys_and_shapes():
    jmodel, jparams, tmodel = _pair("xla")
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    own = tmodel.state_dict()
    assert set(state) == set(own)
    for k, v in state.items():
        assert v.shape == own[k].shape, k


def test_entry_points_refuse_quiet_fallbacks():
    cfg = get_smoke_config(ARCH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)                      # default device is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(get_smoke_config(RG_ARCH))
    # the attention families are ported: stablelm builds
    assert build_model(get_smoke_config("stablelm-1.6b"), device="cpu").kinds == ["attn"] * 2
    # so are the MoE families and the encoder-decoder: every config builds
    from repro_torch.configs import ARCHS
    from repro_torch.models import EncDecLM
    for arch in ARCHS:
        model = build_model(get_smoke_config(arch), device="cpu")
        assert isinstance(model, EncDecLM) == get_smoke_config(arch).is_encoder_decoder
    assert "moe" in build_model(get_smoke_config("arctic-480b"), device="cpu").blocks[0]
    # recurrentgemma is ported: it builds, and its attention layers refuse to
    # serve without a KV cache rather than allocate an empty one.
    model = build_model(get_smoke_config(RG_ARCH), device="cpu")
    with pytest.raises(ValueError, match="max_cache_len"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int64))


def test_full_config_matches_reference_config():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_chunk) == (48, 2048, 64, 64, 128, 256)
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import ARCHS
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        assert get_config(arch).__dict__ == jax_get_config(arch).__dict__, arch


# ---------------------------------------------------------------------------
# recurrentgemma: rec + local attention, with unscanned tail layers
# ---------------------------------------------------------------------------

RG_ARCH = "recurrentgemma-9b"


@functools.lru_cache(maxsize=None)
def _rg_pair(attn_impl, rglru_impl):
    jrt = JaxRuntimeConfig(compute_dtype=jnp.float32, attn_impl=attn_impl,
                           rglru_impl=rglru_impl, max_cache_len=64)
    jcfg = dataclasses.replace(jax_smoke_config(RG_ARCH), n_layers=5)
    jmodel = jax_build_model(jcfg, jrt)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    trt = RuntimeConfig(compute_dtype=torch.float32, max_cache_len=64)
    tcfg = dataclasses.replace(get_smoke_config(RG_ARCH), n_layers=5)
    tmodel = build_model(tcfg, trt, device="cpu", seed=1)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _jax_layer_cache(jcache, layer, k=3, n_repeats=1):
    if layer < n_repeats * k:
        return jax.tree.map(lambda a: a[layer // k],
                            jcache["blocks"][f"pos{layer % k}"])
    return jcache[f"tail{layer - n_repeats * k}"]


@pytest.mark.parametrize("impls,prompt_len", [
    (("pallas_interpret", "pallas_interpret"), 16),
    (("pallas_interpret", "pallas_interpret"), 48),
    (("pallas_interpret", "pallas_interpret"), 80),
    (("naive", "xla"), 80)])
def test_recurrentgemma_prefill_and_decode_match_jax(impls, prompt_len):
    jmodel, jparams, tmodel = _rg_pair(*impls)
    assert tmodel.kinds == ["rec", "rec", "local", "rec", "rec"]
    rng = np.random.default_rng(prompt_len)
    tokens = rng.integers(3, 512, size=(2, prompt_len)).astype(np.int32)
    jprefill = jax.jit(jmodel.prefill)                  # interpret mode is slow
    jdecode = jax.jit(jmodel.decode_step)               # op by op
    jlogits, jcache, jpos = jprefill(jparams, jnp.asarray(tokens))
    jpos = int(jpos)
    tlogits, tcache, tpos = tmodel.prefill(torch.from_numpy(tokens))
    assert tpos == jpos == prompt_len
    _close(tlogits, jlogits)
    for layer, kind in enumerate(tmodel.kinds):
        want = _jax_layer_cache(jcache, layer)
        assert set(tcache[layer]) == set(want)
        for name, t in tcache[layer].items():
            assert tuple(t.shape) == want[name].shape, (layer, name)
            _close(t, want[name])
    tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)
    for step in range(8):
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                                  jnp.asarray(jpos + step, jnp.int32))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok),
                                             tpos + step)
        _close(tlogits, jlogits)
        tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)
    for layer in (2,):                           # the ring after 8 more tokens
        for name in ("k", "v"):
            _close(tcache[layer][name], _jax_layer_cache(jcache, layer)[name])


def test_recurrentgemma_forward_with_segments_matches_jax():
    jmodel, jparams, tmodel = _rg_pair("naive", "xla")
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, 512, size=(2, 40)).astype(np.int32)
    segments = np.ones((2, 40), np.int32)
    segments[:, 20:] = 2                          # two packed sequences per row
    positions = np.concatenate([np.arange(20), np.arange(20)]).astype(np.int32)
    positions = np.broadcast_to(positions, (2, 40))
    batch = {"tokens": tokens, "segments": segments, "positions": positions}
    jlogits = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlogits = tmodel({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in batch.items()})
    _close(tlogits, jlogits)


def test_recurrentgemma_state_dict_keys_cover_tail():
    _, jparams, tmodel = _rg_pair("naive", "xla")
    np_tree = jax.tree.map(np.asarray, jparams)
    assert set(np_tree["tail"]) == {"tail0", "tail1"}
    state = params_from_jax(np_tree)
    own = tmodel.state_dict()
    assert set(state) == set(own)
    for k, v in state.items():
        assert v.shape == own[k].shape, k
    np.testing.assert_array_equal(state["blocks.4.rec.gate_r"].numpy(),
                                  np_tree["tail"]["tail1"]["rec"]["gate_r"])
    np.testing.assert_array_equal(state["blocks.2.attn.wq.w"].numpy(),
                                  np_tree["blocks"]["pos2"]["attn"]["wq"]["w"][0])
    assert state["blocks.0.rec.lam"].dtype == torch.float32


def test_recurrentgemma_full_config_matches_reference():
    cfg = get_config(RG_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.local_window, cfg.d_ff, cfg.lru_width, cfg.pattern) == \
        (38, 4096, 16, 1, 256, 2048, 12288, 4096, ("rec", "rec", "local"))

"""The port's DecoderLM against ``repro.models.DecoderLM`` (mamba2 smoke
config) on weights initialised by JAX and carried across by
``params_from_jax``.

Prompts of 10, 16 and 48 tokens cover a chunk shorter than ssm_chunk=16,
exactly one chunk, and three chunks.  fp32 compute, tolerance 3e-4
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
    with pytest.raises(NotImplementedError, match="attention slice"):
        build_model(get_smoke_config("stablelm-1.6b"), device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent slice"):
        build_model(get_smoke_config("recurrentgemma-9b"), device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_model(get_smoke_config("seamless-m4t-medium"), device="cpu")


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

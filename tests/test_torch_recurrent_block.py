"""The port's RecurrentGemma block against ``repro.models.recurrent_block`` on
the same weights (made by the JAX initializer, carried across as numpy).

Prefill with and without an initial state, then a chain of decode steps that
continues from the prefill's state.  fp32 compute, tolerance 3e-4
(tests/test_kernels.py::_tol).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import recurrent_block as jrec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import recurrent_block as trec  # noqa: E402
from repro_torch.models.common import Initializer, RuntimeConfig  # noqa: E402
from repro_torch.weights import to_torch  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(atol=3e-4, rtol=3e-4)


def _setup(seed=0, B=2, S=24):
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams = jrec.rec_init(jcommon.Initializer(jax.random.PRNGKey(seed)),
                            jcfg, jnp.float32)
    tparams = nn.ParameterDict({
        k: nn.Parameter(to_torch(np.asarray(v)), requires_grad=False)
        for k, v in jparams.items()})
    rng = np.random.default_rng(seed)
    W = cfg.lru_width
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    initial = {"h": rng.standard_normal((B, W), dtype=np.float32) * 0.2,
               "conv": rng.standard_normal((B, cfg.ssm_conv_width - 1, W),
                                           dtype=np.float32)}
    return jcfg, cfg, jparams, tparams, x, initial


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("jax_impl,impl", [("pallas_interpret", "scan"),
                                           ("xla", "scan"), ("xla", "ref")])
@pytest.mark.parametrize("with_initial", [False, True])
def test_rec_apply_matches_jax(jax_impl, impl, with_initial):
    jcfg, cfg, jparams, tparams, x, initial = _setup()
    jrt = jcommon.RuntimeConfig(compute_dtype=jnp.float32, rglru_impl=jax_impl)
    trt = RuntimeConfig(compute_dtype=torch.float32, rglru_impl=impl)
    jinit = ({k: jnp.asarray(v) for k, v in initial.items()}
             if with_initial else None)
    tinit = ({k: torch.from_numpy(v) for k, v in initial.items()}
             if with_initial else None)
    jout, jstate = jrec.rec_apply(jparams, jnp.asarray(x), jcfg, jrt, jinit,
                                  return_state=True)
    tout, tstate = trec.rec_apply(tparams, torch.from_numpy(x), cfg, trt, tinit,
                                  return_state=True)
    _close(tout, jout)
    for k in ("h", "conv"):
        _close(tstate[k], jstate[k])
    assert tstate["h"].dtype == torch.float32


def test_rec_decode_chain_continues_prefill():
    jcfg, cfg, jparams, tparams, x, _ = _setup(seed=1, S=20)
    jrt = jcommon.RuntimeConfig(compute_dtype=jnp.float32, rglru_impl="xla")
    trt = RuntimeConfig(compute_dtype=torch.float32)
    _, jcache = jrec.rec_apply(jparams, jnp.asarray(x[:, :12]), jcfg, jrt,
                               return_state=True)
    _, tcache = trec.rec_apply(tparams, torch.from_numpy(x[:, :12]), cfg, trt,
                               return_state=True)
    for t in range(12, 20):
        jy, jcache = jrec.rec_decode(jparams, jnp.asarray(x[:, t:t + 1]), jcache,
                                     jcfg, jrt)
        ty, tcache = trec.rec_decode(tparams, torch.from_numpy(x[:, t:t + 1]),
                                     tcache, cfg, trt)
        _close(ty, jy)
        _close(tcache["h"], jcache["h"])
        _close(tcache["conv"], jcache["conv"])
    # ... and the chain equals one prefill over all 20 tokens
    tfull, tstate = trec.rec_apply(tparams, torch.from_numpy(x), cfg, trt,
                                   return_state=True)
    _close(ty, tfull[:, -1:].numpy())
    _close(tcache["h"], tstate["h"].numpy())


def test_rec_init_shapes_and_lam_dtype():
    cfg = get_smoke_config(ARCH)
    p = trec.rec_init(Initializer(0, "cpu"), cfg, torch.bfloat16)
    jp = jrec.rec_init(jcommon.Initializer(jax.random.PRNGKey(0)),
                       jax_smoke_config(ARCH), jnp.bfloat16)
    assert set(p) == set(jp)
    for k in p:
        assert tuple(p[k].shape) == jp[k].shape, k
    assert p["lam"].dtype == torch.float32 and p["in_x"].dtype == torch.bfloat16
    cache = trec.init_rec_cache(cfg, 3, torch.bfloat16, torch.device("cpu"))
    assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    assert tuple(cache["conv"].shape) == (3, cfg.ssm_conv_width - 1, cfg.lru_width)

"""The port's Mamba-2 mixer against ``repro.models.ssm_block`` on the same
weights (made by the JAX initializer, carried across as numpy).

fp32 compute, tolerance 3e-4 (tests/test_kernels.py::_tol).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ssm_block as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import ssm_block as tssm  # noqa: E402
from repro_torch.models.common import RuntimeConfig  # noqa: E402
from repro_torch.weights import to_torch  # noqa: E402

TOL = dict(atol=3e-4, rtol=3e-4)
JRT = jcommon.RuntimeConfig(compute_dtype=jnp.float32, ssd_impl="pallas_interpret")
TRT = RuntimeConfig(compute_dtype=torch.float32, ssd_impl="chunked")


def _setup(seed=0, B=2, S=32):
    jcfg = jax_smoke_config("mamba2-1.3b")
    cfg = get_smoke_config("mamba2-1.3b")
    jparams = jssm.ssm_init(jcommon.Initializer(jax.random.PRNGKey(seed)),
                            jcfg, jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = nn.ParameterDict({k: nn.Parameter(to_torch(v), requires_grad=False)
                                for k, v in np_params.items()})
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    initial = {
        "ssd": rng.standard_normal((B, H, P, N), dtype=np.float32) * 0.1,
        "conv": rng.standard_normal((B, cfg.ssm_conv_width - 1, Din + 2 * N),
                                    dtype=np.float32),
    }
    return jcfg, cfg, jparams, tparams, x, initial


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_initial", [False, True])
def test_ssm_apply_matches_jax(with_initial):
    jcfg, cfg, jparams, tparams, x, initial = _setup()
    j_init = jax.tree.map(jnp.asarray, initial) if with_initial else None
    t_init = ({k: torch.from_numpy(v) for k, v in initial.items()}
              if with_initial else None)
    jout, jstate = jssm.ssm_apply(jparams, jnp.asarray(x), jcfg, JRT,
                                  initial=j_init, return_state=True)
    tout, tstate = tssm.ssm_apply(tparams, torch.from_numpy(x), cfg, TRT,
                                  initial=t_init, return_state=True)
    _close(tout, jout)
    assert set(tstate) == {"ssd", "conv"}
    _close(tstate["ssd"], jstate["ssd"])
    _close(tstate["conv"], jstate["conv"])


def test_ssm_decode_matches_jax():
    jcfg, cfg, jparams, tparams, x, initial = _setup(seed=1, S=1)
    jcache = jax.tree.map(jnp.asarray, initial)
    tcache = {k: torch.from_numpy(v) for k, v in initial.items()}
    for _ in range(3):      # a short chain: the returned cache feeds the next step
        jout, jcache = jssm.ssm_decode(jparams, jnp.asarray(x), jcache, jcfg, JRT)
        tout, tcache = tssm.ssm_decode(tparams, torch.from_numpy(x), tcache,
                                       cfg, TRT)
        _close(tout, jout)
        _close(tcache["ssd"], jcache["ssd"])
        _close(tcache["conv"], jcache["conv"])
        x = np.array(jout)


def test_ssm_cache_layout_matches_jax():
    jcfg, cfg = jax_smoke_config("mamba2-1.3b"), get_smoke_config("mamba2-1.3b")
    jcache = jssm.init_ssm_cache(jcfg, 3, jnp.bfloat16)
    tcache = tssm.init_ssm_cache(cfg, 3, torch.bfloat16, torch.device("cpu"))
    for k in ("ssd", "conv"):
        assert tuple(tcache[k].shape) == jcache[k].shape
    assert tcache["ssd"].dtype == torch.float32
    assert tcache["conv"].dtype == torch.bfloat16

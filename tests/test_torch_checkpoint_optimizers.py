"""Adafactor's and 8-bit AdamW's state in platform checkpoints, across
packages: a checkpoint written by the port loads in the JAX package and one
written by the JAX package loads in the port, with the records the
reference names (``opt/v/<path>/vr``, ``opt/m/<path>/q``, ...) and every
leaf bit for bit (the records are raw bytes).  Smoke mamba2 (8-bit blocks
that span its two layers) and gemma2 (a (local, global) superblock),
``factored_min_dim`` 16 so that Adafactor factors their matrices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.platform import Platform as JaxPlatform  # noqa: E402
from repro.train import checkpoint as jax_checkpoint  # noqa: E402
from repro.train import optimizer as jax_optimizer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer  # noqa: E402
from repro_torch.weights import opt_state_to_jax, params_from_jax  # noqa: E402

DATASET = "checkpoints/smoke"
KW = dict(lr=1e-2, warmup_steps=0, factored_min_dim=16)
CASES = [(arch, name) for arch in ("mamba2-1.3b", "gemma2-9b")
         for name in ("adafactor", "adamw8bit")]


def _setup(arch, name):
    jmodel = jax_build_model(jax_smoke_config(arch), JaxRuntimeConfig())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_smoke_config(arch), RuntimeConfig(), device="cpu", seed=1)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    jopt = jax_optimizer.make_optimizer(jax_optimizer.OptimizerConfig(name=name, **KW))
    opt = make_optimizer(OptimizerConfig(name=name, **KW), period=len(tmodel.pattern))
    grads = jax.tree.map(lambda p: np.random.default_rng(p.size).standard_normal(
        p.shape).astype(np.float32), jax.tree.map(np.asarray, jparams))
    return jparams, tmodel, jopt, opt, grads


def _assert_equal(got_np, want):
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert leaves
    for path, leaf in leaves:
        node = got_np
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch,name", CASES)
def test_port_optimizer_state_loads_in_the_reference(tmp_path, arch, name):
    jparams, tmodel, jopt, opt, grads = _setup(arch, name)
    period = len(tmodel.pattern)
    params = {k: v.detach() for k, v in tmodel.named_parameters()}
    state = opt.init(params)
    params, state = opt.update(params_from_jax(grads), state, params)
    plat = Platform.open(str(tmp_path), actor="trainer")
    checkpoint.save_checkpoint(plat.manager, DATASET, 1, params, state, period=period)
    ids = set(plat.manager.checkout(DATASET, "trainer",
                                    register_snapshot=False).iter_record_ids())
    if name == "adafactor":
        assert "opt/v/blocks/pos0/norm1/scale/v" in ids
        assert {"opt/v/embed/vr", "opt/v/embed/vc"} <= ids
    else:
        assert {"opt/m/embed/q", "opt/m/embed/scale", "opt/v/final_norm/scale/q"} <= ids

    jplat = JaxPlatform.open(str(tmp_path), actor="trainer")
    like_p = jax.eval_shape(lambda: jparams)
    like_o = jax.eval_shape(jopt.init, like_p)
    _, jstate, _ = jax_checkpoint.load_checkpoint(jplat.manager, DATASET, like_p, like_o)
    _assert_equal(opt_state_to_jax(state, period), jstate)
    assert int(jstate["step"]) == 1


@pytest.mark.parametrize("arch,name", CASES)
def test_reference_optimizer_state_loads_in_the_port(tmp_path, arch, name):
    jparams, tmodel, jopt, opt, grads = _setup(arch, name)
    period = len(tmodel.pattern)
    jparams, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jopt.init(jparams),
                                  jparams)
    jplat = JaxPlatform.open(str(tmp_path), actor="trainer")
    jax_checkpoint.save_checkpoint(jplat.manager, DATASET, 1, jparams, jstate)

    plat = Platform.open(str(tmp_path), actor="trainer")
    like_p = dict(tmodel.named_parameters())
    like_o = opt.init(like_p)
    _, state, _ = checkpoint.load_checkpoint(plat.manager, DATASET, like_p, like_o,
                                             period=period)
    _assert_equal(opt_state_to_jax(state, period), jstate)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    # and the restored state steps on as the reference's does
    params = {k: v.detach().clone() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jparams)).items()}
    params, state = opt.update(params_from_jax(grads), state, params)
    _, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
    got = opt_state_to_jax(state, period)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        node = got
        for p in path:
            node = node[p.key]
        if path[-1].key == "q":
            np.testing.assert_array_equal(node, np.asarray(leaf))
        else:
            np.testing.assert_allclose(node, np.asarray(leaf), atol=3e-4, rtol=3e-4)

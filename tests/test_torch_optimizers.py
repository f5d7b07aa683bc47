"""The port's Adafactor and 8-bit AdamW against the reference's
(``repro.train.optimizer``), and the checks of ``tests/test_train_stack.py``
for all three optimizers.

Each case starts from one set of JAX-initialised weights of a smoke model
(mamba2, gemma2, arctic), and feeds both packages the same three sets of
gradients, drawn with numpy from a seed in the reference's stacked layout.
After every step the params and the state, restacked with
``params_to_jax``/``opt_state_to_jax``, must match the reference's: fp32 at
3e-4 (tests/test_kernels.py::_tol), bf16 params at 5e-2; 8-bit AdamW's
``q`` exactly and its ``scale`` to fp32 rounding (rtol 1e-6).
``factored_min_dim`` is lowered to 16 so that Adafactor factors the smoke
models' matrices (at the default 128 nothing of a smoke model factors).
Smoke mamba2's ``A_log``, ``D_skip`` and ``dt_bias`` (2 layers x 8 heads)
and every stacked vector of width 64 share quant blocks across layers.
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
from repro.train import optimizer as jax_optimizer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig, _quant_groups,  # noqa: E402
                                         make_optimizer)
from repro_torch.weights import (opt_state_from_jax, opt_state_to_jax,  # noqa: E402
                                 params_from_jax, params_to_jax)

FP32_TOL = dict(atol=3e-4, rtol=3e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
KW = dict(lr=1e-2, warmup_steps=2, total_steps=6, factored_min_dim=16)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_f32(a):
    return a.view(jnp.bfloat16).astype(np.float32) if a.dtype == np.uint16 else \
        np.asarray(a).astype(np.float32)


def _assert_trees(got, want, tol, what):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        quant = k.endswith("['scale']") and k[:-len("['scale']")] + "['q']" in want
        if k.endswith("['q']"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}{k}")
        elif quant:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f"{what}{k}")
        elif k.endswith("['step']"):
            assert int(g) == int(w)
        else:
            np.testing.assert_allclose(_as_f32(g), _as_f32(w), **tol,
                                       err_msg=f"{what}{k}")


def _models(arch, dtype):
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = jax_build_model(jax_smoke_config(arch), JaxRuntimeConfig(param_dtype=jdtype))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_smoke_config(arch), RuntimeConfig(param_dtype=dtype),
                         device="cpu", seed=1)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jparams, tmodel


def _grads(rng, jparams, step):
    """Gradients in the reference's layout, a scale a leaf and a step."""
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-3, 1)
                   * 10.0 ** -step).astype(p.dtype), jax.tree.map(np.asarray, jparams))


def _run_three_steps(arch, name, dtype, tol):
    jparams, tmodel = _models(arch, dtype)
    period = len(tmodel.pattern)
    jopt = jax_optimizer.make_optimizer(jax_optimizer.OptimizerConfig(name=name, **KW))
    opt = make_optimizer(OptimizerConfig(name=name, **KW), period=period)
    params = {k: v.detach() for k, v in tmodel.named_parameters()}
    js, ts = jopt.init(jparams), opt.init(params)
    _assert_trees(opt_state_to_jax(ts, period), js, FP32_TOL, "init ")
    rng = np.random.default_rng(7)
    for step in range(3):
        g = _grads(rng, jparams, step)
        jparams, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jparams)
        params, ts = opt.update(params_from_jax(g), ts, params)
        _assert_trees(params_to_jax(params, period), jparams, tol, f"step {step} params ")
        _assert_trees(opt_state_to_jax(ts, period), js, FP32_TOL, f"step {step} state ")
    return ts, js, params, period


@pytest.mark.parametrize("name", ["adafactor", "adamw8bit"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "gemma2-9b", "arctic-480b"])
def test_three_steps_match_the_reference_in_fp32(arch, name):
    ts, _, _, _ = _run_three_steps(arch, name, torch.float32, FP32_TOL)
    if name == "adafactor":
        assert any("vr" in v for v in ts["v"].values())       # the factored path ran
        assert any("v" in v for v in ts["v"].values())


@pytest.mark.parametrize("name", ["adafactor", "adamw8bit"])
def test_three_steps_match_the_reference_with_bf16_params(name):
    _, _, params, _ = _run_three_steps("gemma2-9b", name, torch.bfloat16, BF16_TOL)
    assert all(p.dtype == torch.bfloat16 for p in params.values())


def test_adamw8bit_in_chunks_of_blocks_matches_the_reference(monkeypatch):
    """A large layer is updated a few blocks at a time (at full width, 2^16
    blocks); with chunks of 3 blocks the smoke models' layers take that path
    and still match the reference exactly."""
    from repro_torch.train import optimizer as port_optimizer
    monkeypatch.setattr(port_optimizer, "_CHUNK_BLOCKS", 3)
    _run_three_steps("gemma2-9b", "adamw8bit", torch.float32, FP32_TOL)


def test_mamba2_vectors_share_quant_blocks_across_layers():
    """The reference quantizes a stacked leaf as one flat array, so the two
    layers' 8 A_log values (16 in all) fill one block of 256: quantizing per
    layer would give each layer its own scale."""
    _, tmodel = _models("mamba2-1.3b", torch.float32)
    names = ["blocks.0.ssm.A_log", "blocks.1.ssm.A_log"]
    groups = _quant_groups(names, tmodel.get_parameter(names[0]).numel(), 256)
    assert groups == [(names, slice(None))]
    w = tmodel.get_parameter("blocks.0.ssm.in_proj")
    assert len(_quant_groups(["a", "b"], w.numel(), 256)) == (2 if w.numel() % 256 == 0 else 1)
    ts, js, _, _ = _run_three_steps("mamba2-1.3b", "adamw8bit", torch.float32, FP32_TOL)
    assert ts["m"]["blocks/pos0/ssm/A_log"]["q"].shape == (1, 256)
    np.testing.assert_array_equal(ts["m"]["blocks/pos0/ssm/A_log"]["q"].numpy(),
                                  np.asarray(js["m"]["blocks"]["pos0"]["ssm"]["A_log"]["q"]))


def test_adafactor_clips_over_the_stacked_leaf():
    """The update's RMS runs over every layer of a stacked leaf: a layer
    whose own update would be clipped is not, where its neighbour's is 0."""
    cfg = OptimizerConfig(name="adafactor", lr=1.0, weight_decay=0.0, warmup_steps=0,
                          schedule="constant", factored_min_dim=1000)
    opt = make_optimizer(cfg, period=1)
    params = {f"blocks.{i}.w": torch.zeros(4) for i in range(2)}
    state = opt.init(params)
    assert set(state["v"]) == {"blocks/pos0/w"}
    assert state["v"]["blocks/pos0/w"]["v"].shape == (2, 4)
    g = {"blocks.0.w": torch.full((4,), 1.0), "blocks.1.w": torch.zeros(4)}
    params, state = opt.update(g, state, params)
    # At step 1, v = 2^-0.8 g^2, so layer 0's delta is 2^0.4 ~ 1.32 and layer
    # 1's is 0: the stacked RMS, 1.32 / sqrt(2), is under 1 and nothing is
    # clipped, where layer 0 alone (RMS 1.32) would be clipped to 1.
    np.testing.assert_allclose(params["blocks.0.w"].numpy(), -2 ** 0.4, rtol=1e-5)
    jopt = jax_optimizer.make_optimizer(jax_optimizer.OptimizerConfig(
        name="adafactor", lr=1.0, weight_decay=0.0, warmup_steps=0, schedule="constant",
        factored_min_dim=1000))
    jp = {"blocks": {"pos0": {"w": jnp.zeros((2, 4))}}}
    jp, _ = jopt.update({"blocks": {"pos0": {"w": jnp.stack([jnp.ones(4), jnp.zeros(4)])}}},
                        jopt.init(jp), jp)
    np.testing.assert_allclose(params["blocks.0.w"].numpy(),
                               np.asarray(jp["blocks"]["pos0"]["w"][0]), rtol=1e-6)


def test_a_factored_stack_of_vectors_is_refused():
    """Where the stacked leaf (R, d) factors and one layer (d,) cannot, the
    per-layer state cannot follow the reference: it raises."""
    opt = make_optimizer(OptimizerConfig(name="adafactor", factored_min_dim=2), period=1)
    with pytest.raises(ValueError, match="factored_min_dim"):
        opt.init({f"blocks.{i}.b": torch.zeros(4) for i in range(3)})


def test_state_crosses_from_the_reference_and_back():
    """The reference's state tree becomes the port's (opt_state_from_jax)
    and back (opt_state_to_jax) unchanged, for all three optimizers."""
    for name in ("adamw", "adafactor", "adamw8bit"):
        jparams, tmodel = _models("gemma2-9b", torch.float32)
        period = len(tmodel.pattern)
        jopt = jax_optimizer.make_optimizer(jax_optimizer.OptimizerConfig(name=name, **KW))
        g = _grads(np.random.default_rng(3), jparams, 0)
        _, js = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(jparams), jparams)
        np_state = jax.tree.map(np.asarray, js)
        ts = opt_state_from_jax(np_state, dict(tmodel.named_parameters()), period)
        back = opt_state_to_jax(ts, period)
        for k, v in _leaves(np_state).items():
            np.testing.assert_array_equal(_leaves(back)[k], v, err_msg=f"{name}{k}")


# ---------------------------------------------------------------------------
# tests/test_train_stack.py:35-69, for the port
# ---------------------------------------------------------------------------


def _quad_loss(p):
    return sum(torch.sum(x.float() ** 2) for x in p.values())


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adamw8bit"])
def test_optimizer_reduces_quadratic(name):
    cfg = OptimizerConfig(name=name, lr=0.05, weight_decay=0.0, warmup_steps=0,
                          total_steps=1000, schedule="constant", factored_min_dim=4)
    opt = make_optimizer(cfg)
    params = {"a": torch.tensor([1.0, -2.0, 3.0]), "b": torch.ones((4, 4)) * 2.0}
    state = opt.init(params)
    loss0 = float(_quad_loss(params))
    for _ in range(60):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(p, torch.autograd.grad(_quad_loss(p), list(p.values()))))
        params, state = opt.update(grads, state, params)
    loss1 = float(_quad_loss(params))
    assert loss1 < loss0 * 0.2, (name, loss0, loss1)
    assert int(state["step"]) == 60


def test_adafactor_state_is_factored():
    opt = make_optimizer(OptimizerConfig(name="adafactor", factored_min_dim=4))
    state = opt.init({"w": torch.ones((8, 16)), "b": torch.ones((8,))})
    assert set(state["v"]["w"]) == {"vr", "vc"}
    assert state["v"]["w"]["vr"].shape == (8,)
    assert state["v"]["w"]["vc"].shape == (16,)
    assert set(state["v"]["b"]) == {"v"}   # too small to factor


def test_adamw8bit_state_is_quantized():
    opt = make_optimizer(OptimizerConfig(name="adamw8bit", quant_block=16))
    state = opt.init({"w": torch.ones((8, 16))})
    assert state["m"]["w"]["q"].dtype == torch.int8
    assert state["m"]["w"]["q"].shape == (8, 16)
    assert state["m"]["w"]["scale"].shape == (8, 1)

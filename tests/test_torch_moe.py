"""The MoE family in the port against the JAX package.

The layer: ``moe_apply`` (GShard capacity dispatch: y and the load-balancing
loss) and ``moe_decode`` (dense experts) on the smoke mixtral-8x22b and
arctic-480b configs, fp32 and bf16, with group sizes that give several
groups and real drops, a token count that the group size does not divide,
and a prime one (groups of 1), and the gradients of ``moe_apply`` against
``jax.grad``.  The models: the parameter tree, forward, prefill and decode
at the default capacity, the forward/prefill/decode consistency where no
token drops (``capacity_factor = n_experts``), the loss and every gradient,
and one unequal-prompt wave through the port's ``ServeEngine`` against the
JAX engine (under drops a row's prefill depends on the other rows of its
wave, so the wave is held to the JAX engine's wave, not to each prompt
decoded alone).  Weights are initialised in JAX and carried across with
``params_from_jax``; the reference runs ``attn_impl="naive"``.  Tolerances
are tests/test_kernels.py::_tol's: fp32 3e-4, bf16 5e-2.
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
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.common import Initializer as JaxInitializer  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax, to_torch  # noqa: E402

ARCHS = ["mixtral-8x22b", "arctic-480b"]
TOL = {"float32": dict(atol=3e-4, rtol=3e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
CACHE_LEN = 64
GROUP = 16            # tests/test_arch_smoke.py's moe_group_size


def _np(t):
    return t.detach().float().numpy()


def _layer(arch, seed):
    """The reference's MoE params (fp32) and the same as port tensors."""
    cfg = jax_smoke_config(arch)
    jp = jax_moe.moe_init(JaxInitializer(jax.random.PRNGKey(seed)), cfg, jnp.float32)
    tp = {k: to_torch(np.asarray(v)) for k, v in jp.items()}
    return cfg, jp, tp


def _x(cfg, shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    return jx, to_torch(np.asarray(jx))


def _dropped(jp, jx, cfg, group):
    """Expert assignments over capacity in ``moe_apply`` (from the
    reference's own routing): per group and expert, max(0, load - C)."""
    T = jx.shape[0] * jx.shape[1]
    G, g, C = moe.moe_groups(T, cfg, RuntimeConfig(moe_group_size=group))
    _, idx, _ = jax_moe._route(jp, jx.reshape(G, g, -1), cfg)
    load = np.asarray(jax.nn.one_hot(idx, cfg.n_experts).sum(axis=(1, 2)))   # (G, E)
    return int(np.maximum(load - C, 0).sum())


# (B, S, moe_group_size): several groups with drops; T = 42 that 16 does not
# divide (g = 14); a prime T = 37 (g = 1, C = 1); groups of 8 with drops.
CASES = [(4, 40, 16), (3, 14, 16), (1, 37, 16), (2, 40, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, case, dtype):
    B, S, group = case
    cfg, jp, tp = _layer(arch, sum(case))
    jx, tx = _x(cfg, (B, S), B * S, dtype)
    jy, jaux = jax_moe.moe_apply(jp, jx, cfg, JaxRuntimeConfig(moe_group_size=group))
    ty, taux = moe.moe_apply(tp, tx, cfg, RuntimeConfig(moe_group_size=group))
    assert ty.dtype == tx.dtype and tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), **TOL[dtype])
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL["float32"])
    G, g, C = moe.moe_groups(B * S, cfg, RuntimeConfig(moe_group_size=group))
    if case == (1, 37, 16):
        assert (G, g, C) == (37, 1, 1)
    if case == (3, 14, 16):
        assert (G, g) == (3, 14)
    if group == GROUP and B * S == 160 or group == 8:
        assert G > 1 and _dropped(jp, jx, cfg, group) > 0


@pytest.mark.parametrize("T,group,cf,want", [
    (160, 16, 1.25, (10, 16, 5)), (42, 16, 1.25, (3, 14, 5)), (37, 16, 1.25, (37, 1, 1)),
    (18000, 512, 1.25, (36, 500, 157)), (4096, 512, 1.0, (8, 512, 128)),
    (7, 512, 4.0, (1, 7, 7)),
])
def test_group_and_capacity_arithmetic(T, group, cf, want):
    """G, g and C as the reference counts them for mixtral-8x22b (8 experts,
    top 2): g the largest divisor of T at most the group size,
    C = max(1, ceil(g K cf / E)) on a float cf."""
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), capacity_factor=cf)
    assert moe.moe_groups(T, cfg, RuntimeConfig(moe_group_size=group)) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_jax(arch, dtype):
    cfg, jp, tp = _layer(arch, 3)
    jx, tx = _x(cfg, (4, 1), 4, dtype)
    jy = jax_moe.moe_decode(jp, jx, cfg, JaxRuntimeConfig())
    ty = moe.moe_decode(tp, tx, cfg, RuntimeConfig())
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_gradients_match_jax(arch):
    """d(sum(y * w) + aux) / d(x, router, wi, wg, wo) under real drops."""
    B, S, group = 4, 40, GROUP
    cfg, jp, tp = _layer(arch, 11)
    jx, tx = _x(cfg, (B, S), 12, "float32")
    assert _dropped(jp, jx, cfg, group) > 0
    w = np.random.default_rng(13).standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def jloss(params, x):
        y, aux = jax_moe.moe_apply(params, x, cfg, JaxRuntimeConfig(moe_group_size=group))
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x = tx.clone().requires_grad_(True)
    y, aux = moe.moe_apply(leaves, x, cfg, RuntimeConfig(moe_group_size=group))
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(_np(x.grad), np.asarray(jgx), **TOL["float32"])
    for k in ("router", "wi", "wg", "wo"):
        np.testing.assert_allclose(_np(leaves[k].grad), np.asarray(jgp[k]),
                                   **TOL["float32"], err_msg=k)


# ---- the models ---------------------------------------------------------------

JRT = dict(compute_dtype=jnp.float32, attn_impl="naive", moe_group_size=GROUP,
           max_cache_len=CACHE_LEN)


def _pair(arch, torch_rt=None, jax_rt=None, **cfg_changes):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **cfg_changes)
    jmodel = jax_build_model(jcfg, JaxRuntimeConfig(**(jax_rt or JRT)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke_config(arch), **cfg_changes)
    trt = torch_rt or RuntimeConfig(compute_dtype=torch.float32, moe_group_size=GROUP,
                                    max_cache_len=CACHE_LEN)
    tmodel = build_model(tcfg, trt, device="cpu", seed=1)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), **(tol or TOL["float32"]))


def _tokens(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_builds_with_the_reference_parameter_tree(arch):
    _, jparams, tmodel = _pair(arch)
    cfg = tmodel.cfg
    state = params_from_jax(jax.tree.map(np.asarray, jparams))
    own = tmodel.state_dict()
    assert set(state) == set(own)
    assert all(state[k].shape == own[k].shape for k in own)
    assert own["blocks.0.moe.wi"].shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert own["blocks.0.moe.router"].dtype == torch.float32
    assert ("blocks.0.mlp.wi" in own) == cfg.dense_residual
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
    tokens = _tokens(tmodel.cfg, 3, 2, 40)
    jlogits = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits = tmodel({"tokens": torch.from_numpy(tokens)})
    assert tuple(tlogits.shape) == jlogits.shape
    _close(tlogits, jlogits)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """At the default capacity (drops in prefill, none in decode), against
    the reference's own prefill and decode: logits, every KV cache (the
    70-token prompt passes mixtral's 32-token window and its 64-slot ring,
    so the ring's shifted write runs), and 8 decode steps."""
    cache_len = 64 if arch == "mixtral-8x22b" else 80     # arctic's is linear
    jmodel, jparams, tmodel = _pair(
        arch, jax_rt=dict(JRT, max_cache_len=cache_len),
        torch_rt=RuntimeConfig(compute_dtype=torch.float32, moe_group_size=GROUP,
                               max_cache_len=cache_len))
    tokens = _tokens(tmodel.cfg, 5, 2, 70)
    jlogits, jcache, jpos = jmodel.prefill(jparams, jnp.asarray(tokens))
    tlogits, tcache, tpos = tmodel.prefill(torch.from_numpy(tokens))
    assert tpos == jpos == 70
    _close(tlogits, jlogits)
    for layer in range(tmodel.cfg.n_layers):
        for key in ("k", "v"):
            _close(tcache[layer][key], jcache["blocks"]["pos0"][key][layer])
    tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)
    decode = jax.jit(jmodel.decode_step)
    for step in range(8):
        jlogits, jcache = decode(jparams, jcache, jnp.asarray(tok),
                                 jnp.asarray(jpos + step, jnp.int32))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(tok), tpos + step)
        _close(tlogits, jlogits)
        tok = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_forward_where_nothing_drops(arch):
    """As tests/test_arch_smoke.py::test_prefill_decode_matches_forward: at
    capacity_factor = n_experts no token drops, so prefill(prompt[:-1]) and
    one decode step give the forward's last two positions."""
    cfg = get_smoke_config(arch)
    _, _, tmodel = _pair(arch, capacity_factor=float(cfg.n_experts))
    tokens = torch.from_numpy(_tokens(cfg, 6, 2, 16))
    with torch.no_grad():
        full = tmodel({"tokens": tokens})
    lp, cache, pos = tmodel.prefill(tokens[:, :-1])
    lg, _ = tmodel.decode_step(cache, tokens[:, -1:], pos)
    _close(lp[:, 0], full[:, -2].numpy())
    _close(lg[:, 0], full[:, -1].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jmodel, jparams, tmodel = _pair(
        arch, torch_rt=RuntimeConfig(compute_dtype=torch.float32, attn_impl="ref",
                                     moe_group_size=GROUP))
    cfg = tmodel.cfg
    rng = np.random.default_rng(8)
    tokens = rng.integers(3, cfg.vocab_size, size=(4, 41)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.1] = -1
    batch = {"tokens": tokens[:, :40], "labels": labels}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = dict(tmodel.named_parameters())
    loss, _ = tmodel.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL["float32"])
    got = params_to_jax(grads, len(tmodel.pattern))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, leaf in want:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL["float32"],
                                   err_msg=jax.tree_util.keystr(path))
    assert len(want) == len(jax.tree.leaves(got))


class _RecordPrefill:
    """Records the last-position logits of every prefill of ``model``."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        out = self.model.prefill(*args, **kw)
        self.logits.append(np.asarray(out[0][:, -1], np.float32))
        return out


def _padded_wave_against_jax(arch):
    """Prompts of 7, 20 and 13 tokens: one wave padded to S = 20, T = 60
    tokens in groups of 15 (the largest divisor of 60 at most 16), which 20
    does not divide, so a group spans two rows and the pads take capacity,
    in both engines alike."""
    jmodel, jparams, tmodel = _pair(arch)
    G, g, C = moe.moe_groups(60, tmodel.cfg, tmodel.rt)
    assert (G, g) == (4, 15) and 20 % g
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 512, size=n).astype(np.int32) for n in (7, 20, 13)]
    jrec, trec = _RecordPrefill(jmodel), _RecordPrefill(tmodel)
    jeng = JaxServeEngine(jrec, jparams, max_batch=3)
    teng = ServeEngine(trec, max_batch=3)
    for p in prompts:
        jeng.submit(p, max_new_tokens=6)
        teng.submit(p, max_new_tokens=6)
    jdone, tdone = jeng.run(), teng.run()
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert all(len(r.output) == 6 for r in tdone)
    [jl], [tl] = jrec.logits, trec.logits
    np.testing.assert_allclose(tl, jl, **TOL["float32"])
    assert teng.wave_stats[0]["prompt_lens"] == [7, 20, 13]


def test_padded_wave_matches_the_jax_engine():
    _padded_wave_against_jax("mixtral-8x22b")


def test_arctic_padded_wave_matches_the_jax_engine():
    """The same wave through arctic-480b: GQA 2 on the smoke config, and the
    dense residual MLP beside the capacity-dropping experts."""
    _padded_wave_against_jax("arctic-480b")

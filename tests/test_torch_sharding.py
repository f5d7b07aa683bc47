"""The port's sharding rules and launch policies against the reference's
(``repro.train.sharding``, ``repro.launch.{presets,specs}``), and the checks
of ``tests/test_sharding_and_hlo.py:38-103`` for the port.

Rules are evaluated on the production meshes without a process group: a
``FakeMesh`` has the axis names and sizes of (16, 16) over ("data",
"model") or (2, 16, 16) over ("pod", "data", "model").  Full-size models are
built on the ``meta`` device (no memory), the reference's with
``init_abstract()``; a port leaf that is one layer of a stacked reference
leaf takes that leaf's spec without the leading repeat dim.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import presets as jax_presets  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import sharding as jax_sharding  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import presets, specs  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.train.sharding import (ShardingRules, batch_specs,  # noqa: E402
                                        cache_specs, opt_state_specs,
                                        param_specs)
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer  # noqa: E402
from repro_torch.weights import jax_layout  # noqa: E402


class FakeMesh:
    """Just enough Mesh interface for rule evaluation (``devices`` for the
    reference's ``resolve_layout``, which counts them)."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)
        self.devices = np.empty(tuple(shape_map.values()), dtype=np.int8)


MESHES = {"pod": FakeMesh({"data": 16, "model": 16}),
          "multipod": FakeMesh({"pod": 2, "data": 16, "model": 16})}


@pytest.fixture
def rules():
    return ShardingRules(MESHES["pod"])


@pytest.fixture
def rules_mp():
    return ShardingRules(MESHES["multipod"])


_META = {}


def _meta_params(arch):
    if arch not in _META:
        cfg = get_config(arch)
        model = build_model(cfg, RuntimeConfig(), device="meta")
        _META[arch] = (cfg, {k: v for k, v in model.named_parameters()})
    return _META[arch]


def _tuple(spec):
    """A spec as a plain tuple; a one-name tuple entry as the name, as
    ``PartitionSpec`` compares them."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


def _jax_param_specs(arch, mesh):
    jmodel = jax_build_model(jax_get_config(arch), JaxRuntimeConfig())
    return jax_sharding.param_specs(jmodel.init_abstract(),
                                    jax_sharding.ShardingRules(mesh))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_leaf_for_leaf(arch, mesh):
    cfg, params = _meta_params(arch)
    assert all(p.device.type == "meta" for p in params.values())
    got = param_specs(params, ShardingRules(MESHES[mesh]), len(cfg.pattern))
    assert set(got) == set(params)
    want = _jax_param_specs(arch, MESHES[mesh])
    layout = jax_layout(params, len(cfg.pattern))
    n = 0
    for path, spec in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        ref = "/".join(p.key for p in path)
        names = layout[ref]
        if isinstance(names, list):
            assert tuple(spec)[0] is None, ref
            for name in names:
                assert _tuple(got[name]) == _tuple(spec)[1:], (ref, name)
        else:
            assert _tuple(got[names]) == _tuple(spec), ref
        n += 1
    assert n == len(layout)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, shape, mesh):
    cfg = get_config(arch)
    batch = specs.input_specs(cfg, SHAPES[shape])
    assert all(v.device.type == "meta" for v in batch.values())
    got = batch_specs(batch, ShardingRules(MESHES[mesh]))
    jbatch = jax_specs.input_specs(jax_get_config(arch), SHAPES[shape])
    want = jax_sharding.batch_specs(jbatch, jax_sharding.ShardingRules(MESHES[mesh]))
    assert set(got) == set(want)
    for k, spec in want.items():
        assert tuple(batch[k].shape) == jbatch[k].shape, k
        assert _tuple(got[k]) == _tuple(spec), k


def _rules_fields(r):
    return (r.batch_axes, r.fsdp_axis, r.tp_axis, r.expert_axis,
            r.shard_activations_embed, r.attn_shard_mode, r.moe_layout, r.seq_axis)


_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
_IMPLS = {"attn_impl": {"xla": "chunked"}, "ssd_impl": {"xla": "chunked"},
          "rglru_impl": {"xla": "scan"}}


def _runtime_fields(rt, port: bool):
    out = {}
    for f in ("param_dtype", "compute_dtype", "attn_impl", "ssd_impl", "rglru_impl",
              "remat", "scan_layers", "attn_block_q", "attn_block_k", "moe_group_size",
              "max_cache_len", "constrain_attn_heads", "moe_impl"):
        v = getattr(rt, f)
        if not port:
            v = _DTYPES.get(v, v) if "dtype" in f else _IMPLS.get(f, {}).get(v, v)
        out[f] = v
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_policies_agree_with_the_reference(arch, shape, mesh):
    """resolve_layout (every layout), runtime_for with its overrides and
    train_config_for agree on every cell."""
    cfg, jcfg, sh = get_config(arch), jax_get_config(arch), SHAPES[shape]
    for layout in presets.LAYOUTS:
        rules, rt_over, tc_over = presets.resolve_layout(cfg, sh, MESHES[mesh], layout)
        jrules, jrt_over, jtc_over = jax_presets.resolve_layout(jcfg, sh, MESHES[mesh],
                                                                layout)
        assert _rules_fields(rules) == _rules_fields(jrules), layout
        assert rt_over == jrt_over and tc_over == jtc_over, layout
        rt = specs.runtime_for(cfg, sh, **rt_over)
        jrt = jax_specs.runtime_for(jcfg, sh, **jrt_over)
        assert _runtime_fields(rt, True) == _runtime_fields(jrt, False), layout
    dp = math.prod(MESHES[mesh].shape.values())
    for data_parallel in (1, 16, dp):
        tc = specs.train_config_for(cfg, sh, data_parallel)
        jtc = jax_specs.train_config_for(jcfg, sh, data_parallel)
        assert tc.microbatches == jtc.microbatches
        assert tc.optimizer.__dict__ == jtc.optimizer.__dict__


def test_auto_layout_trains_gemma2_under_zero3():
    """The policy phase 7 of chip_smoke.py runs: dense over 5 B parameters."""
    cfg = get_config("gemma2-9b")
    rules, rt, tc = presets.resolve_layout(cfg, SHAPES["train_4k"], MESHES["pod"])
    assert rt == {"remat": "dots"} and tc == {"microbatches": 1}
    assert rules.fsdp_axis == ("data", "model") and rules.tp_axis is None
    run = specs.runtime_for(cfg, SHAPES["train_4k"], **rt)
    assert run.param_dtype == torch.bfloat16 and run.remat == "dots"
    assert specs.train_config_for(cfg, SHAPES["train_4k"], 1).optimizer.name == "adamw"
    assert specs.train_config_for(get_config("arctic-480b"), SHAPES["train_4k"],
                                  1).optimizer.name == "adafactor"


def test_opt_state_specs_follow_the_params():
    cfg, params = _meta_params("gemma2-9b")
    period = len(cfg.pattern)
    rules = ShardingRules(MESHES["pod"])
    ps = param_specs(params, rules, period)
    name = "blocks.0.mlp.wi"
    adamw = make_optimizer(OptimizerConfig(name="adamw")).init(params)
    got = opt_state_specs(adamw, params, ps, rules, period)
    assert got["m"][name] == ps[name] and got["step"] == ()
    ada = make_optimizer(OptimizerConfig(name="adafactor"), period=period).init(params)
    got = opt_state_specs(ada, params, ps, rules, period)
    assert got["v"]["blocks/pos0/mlp/wi"] == {"vr": (None,) + ps[name][:-1],
                                              "vc": (None, ps[name][-1])}
    assert got["v"]["blocks/pos0/norm1/scale"] == {"v": (None, None)}
    q8 = make_optimizer(OptimizerConfig(name="adamw8bit"), period=period).init(
        {k: v for k, v in params.items() if v.numel() < 2 ** 22})
    small = {k: v for k, v in params.items() if v.numel() < 2 ** 22}
    got = opt_state_specs(q8, small, param_specs(small, rules, period), rules, period)
    assert got["m"]["blocks/pos0/norm1/scale"] == {"q": (None, None), "scale": (None, None)}


def test_cache_specs_shard_batch_and_heads():
    cfg = get_config("gemma2-9b")
    cache = [{"k": torch.empty((16, 4096, cfg.n_kv_heads, cfg.head_dim), device="meta"),
              "v": torch.empty((16, 4096, cfg.n_kv_heads, cfg.head_dim), device="meta")}]
    got = cache_specs(cache, ShardingRules(MESHES["pod"]), 16)
    assert got == [{"k": (("data",), None, None, "model"),
                    "v": (("data",), None, None, "model")}]


# ---------------------------------------------------------------------------
# tests/test_sharding_and_hlo.py:38-103, for the port
# ---------------------------------------------------------------------------


def test_param_specs_qwen(rules):
    cfg, params = _meta_params("qwen2.5-32b")
    got = param_specs(params, rules, len(cfg.pattern))
    assert got["embed"] == ("model", "data")
    # the stacked leading dim never sharded (dropped for one layer); wq (D, H*dh)
    assert got["blocks.0.attn.wq.w"] == ("data", "model")
    assert got["blocks.0.attn.wo.w"] == ("model", "data")
    assert got["blocks.0.mlp.wi"] == ("data", "model")
    assert got["blocks.0.mlp.wo"] == ("model", "data")
    assert got["blocks.0.norm1.scale"] == (None,)
    assert got["lm_head"] == ("data", "model")


def test_param_specs_moe_expert_parallel(rules):
    cfg, params = _meta_params("arctic-480b")
    got = param_specs(params, rules, len(cfg.pattern))
    # 128 experts / 16 = 8 per shard -> expert-parallel over data
    assert got["blocks.0.moe.wi"] == ("data", None, "model")
    assert got["blocks.0.moe.wo"] == ("data", "model", None)


def test_param_specs_moe_small_expert_count(rules):
    cfg, params = _meta_params("mixtral-8x22b")
    got = param_specs(params, rules, len(cfg.pattern))
    # 8 experts < 16-way axis: experts unsharded, d_model/d_ff sharded
    assert got["blocks.0.moe.wi"] == (None, "data", "model")
    assert got["blocks.0.moe.wo"] == (None, "model", "data")


def test_param_specs_never_invalid_divisibility(rules, rules_mp):
    """No spec may shard a dim that the axis size does not divide."""
    for arch in ["qwen2.5-32b", "arctic-480b", "mamba2-1.3b", "recurrentgemma-9b",
                 "seamless-m4t-medium", "gemma3-12b"]:
        cfg, params = _meta_params(arch)
        for r in (rules, rules_mp):
            for name, spec in param_specs(params, r, len(cfg.pattern)).items():
                assert len(spec) == params[name].dim(), name
                for dim, axis in zip(params[name].shape, spec):
                    if axis is not None:
                        assert dim % r.size(axis) == 0, (arch, name, spec)


def test_batch_specs_shard_batch(rules, rules_mp):
    batch = {"tokens": torch.empty((256, 4096), dtype=torch.int32, device="meta")}
    assert batch_specs(batch, rules)["tokens"] == (("data",), None)
    assert batch_specs(batch, rules_mp)["tokens"] == (("pod", "data"), None)
    one = {"tokens": torch.empty((1, 1), dtype=torch.int32, device="meta")}
    assert batch_specs(one, rules)["tokens"] == (None, None)
    b32 = {"tokens": torch.empty((32, 10), dtype=torch.int32, device="meta")}
    assert batch_specs(b32, rules_mp)["tokens"] == (("pod", "data"), None)


def test_vocab_padding_divisible():
    for arch in ["seamless-m4t-medium", "mamba2-1.3b", "internvl2-2b"]:
        cfg = get_config(arch)
        assert cfg.padded_vocab % 256 == 0
        assert cfg.padded_vocab >= cfg.vocab_size

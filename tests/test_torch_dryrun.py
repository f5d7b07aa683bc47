"""The port's dry-run (``repro_torch.launch.dryrun``) at smoke size, and its
model-side terms against the reference's (``repro.launch.dryrun``).

- ``model_flops_for``, ``model_memory_bytes`` and ``_add_model_terms`` equal
  the reference's on all 40 cells and both production meshes' device
  counts.  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices at
  import, so it is imported after ``jax.devices()`` has started the backend
  and the variable is restored afterwards (a later test's subprocess would
  inherit it).
- ``run_cell`` with the smoke configs (``get_config`` patched to
  ``get_smoke_config``, the shapes cut to 8 rows of 64 tokens) on a fake
  (2, 2) mesh over ("data", "model") gives ``status == "ok"`` for mamba2,
  recurrentgemma, gemma2, internvl2, mixtral under ``moe_ep`` and seamless,
  for train, prefill and decode each (the (2, 2, 2) mesh's cells are in
  tests/test_torch_dryrun_multipod.py).
- The per-device ``argument_bytes`` equal the bytes of the local shards the
  specs give; the traced FLOPs on a 1-rank mesh equal ``FlopCounterMode`` on
  the real CPU step, exactly; ``run_cell_roofline``'s 2-point extrapolation
  equals the full-depth trace at 3 superblocks, exactly; two microbatches
  trace the matmul FLOPs of one.
- Under zero3 (FSDP over both mesh dims, one row a rank) four ranks at 4
  rows trace each rank's FLOPs as one rank at 1 row, to the last digit, and
  the all-gathers' and reduce-scatters' wire bytes equal the FSDP shard
  sizes worked out by hand.
- The command line writes records that ``benchmarks/roofline.py`` renders,
  and refuses ``--device cuda`` without a CUDA runtime.

Each test makes its own fake process group and destroys it
(``fake_process_group``): the training driver trains in whatever group is up.
"""

import dataclasses
import math
import os
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_analysis import HW  # noqa: E402

SMALL = {k: dataclasses.replace(v, seq_len=64, global_batch=8) for k, v in SHAPES.items()}
CELL_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b", "gemma2-9b", "internvl2-2b",
              "mixtral-8x22b", "seamless-m4t-medium"]
KINDS = ["train_4k", "prefill_32k", "decode_32k"]


@pytest.fixture(scope="module")
def reference_dryrun():
    jax = pytest.importorskip("jax")
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.fixture
def smoke():
    """get_config -> get_smoke_config and the shapes cut to smoke size."""
    with mock.patch.object(dryrun, "get_config", get_smoke_config), \
            mock.patch.dict(dryrun.SHAPES, SMALL):
        yield
    assert not dist.is_initialized()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def smoke_cell(arch: str, shape_name: str, mesh_shape, names):
    """``run_cell`` of a smoke cell on a fake mesh (mixtral under moe_ep)."""
    with dryrun.fake_process_group(math.prod(mesh_shape)):
        mesh = _mesh(mesh_shape, names)
        kw = {}
        if arch == "mixtral-8x22b":
            from repro_torch.launch.presets import resolve_layout
            rules, rt_o, tc_o = resolve_layout(get_smoke_config(arch), SMALL[shape_name],
                                               mesh, "moe_ep")
            kw = dict(rules=rules, rt_overrides=rt_o, tc_overrides=tc_o)
        return dryrun.run_cell(arch, shape_name, mesh, **kw)


def check_cell(rec, one_rank=False):
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                          + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert (rec["collectives"]["total_wire_bytes"] == 0) == one_rank
    assert rec["roofline"]["bound_s"] > 0


@pytest.mark.parametrize("shape_name", KINDS)
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_smoke_cell_on_a_2x2_mesh(smoke, arch, shape_name):
    rec = smoke_cell(arch, shape_name, (2, 2), ("data", "model"))
    check_cell(rec)
    assert rec["mesh"] == "2x2"
    if shape_name == "train_4k":
        assert rec["step_kind"] == "train_step" and rec["microbatches"] >= 1


# ---------------------------------------------------------------------------
# model-side terms against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [256, 512])
def test_model_terms_equal_the_reference_on_every_cell(reference_dryrun, n_dev):
    from repro.configs import get_config as jax_get_config
    from repro.configs import SHAPES as JAX_SHAPES

    hw = HW()
    assert len(ARCHS) * len(SHAPES) == 40
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            cfg, jcfg, jshape = get_config(arch), jax_get_config(arch), JAX_SHAPES[name]
            assert dryrun.model_flops_for(cfg, shape) == \
                reference_dryrun.model_flops_for(jcfg, jshape)
            assert dryrun.model_memory_bytes(cfg, shape, n_dev) == \
                reference_dryrun.model_memory_bytes(jcfg, jshape, n_dev)
            recs = []
            for mod, c, s in ((dryrun, cfg, shape), (reference_dryrun, jcfg, jshape)):
                rec = {"hlo_flops": 3.0e13, "roofline": {
                    "compute_s": 0.03, "memory_s": 0.02, "collective_s": 0.01,
                    "dominant": "compute", "bound_s": 0.03}}
                mod._add_model_terms(rec, c, s, n_dev, hw)
                recs.append(rec)
            assert recs[0] == recs[1], (arch, name)


# ---------------------------------------------------------------------------
# memory, FLOPs and the extrapolation
# ---------------------------------------------------------------------------


def test_argument_bytes_are_the_local_shards_the_specs_give(smoke):
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.sharding import (ShardingRules, batch_specs, local_shape,
                                            named, opt_state_specs, param_specs)
    from repro_torch.launch.specs import input_specs, runtime_for, train_config_for

    arch, shape = "gemma2-9b", SMALL["train_4k"]
    cfg = get_smoke_config(arch)
    with dryrun.fake_process_group(4):
        mesh = _mesh((2, 2), ("data", "model"))
        rec = dryrun.run_cell(arch, "train_4k", mesh)
        rules = ShardingRules(mesh)
        model = build_model(cfg, runtime_for(cfg, shape), device="meta")
        params = dict(model.named_parameters())
        pspecs = param_specs(params, rules, len(cfg.pattern))
        opt = make_optimizer(train_config_for(cfg, shape, 2).optimizer, len(cfg.pattern))
        state = opt.init(params)
        ospecs = opt_state_specs(state, params, pspecs, rules, len(cfg.pattern))
        batch = input_specs(cfg, shape)

        def local_bytes(tree, specs):
            if isinstance(tree, torch.Tensor):
                if tree.dim() == 0:
                    return tree.element_size()
                return math.prod(local_shape(tree.shape, named(mesh, specs))) \
                    * tree.element_size()
            return sum(local_bytes(v, specs[k]) for k, v in tree.items())

        want = (local_bytes(params, pspecs) + local_bytes(state, ospecs)
                + local_bytes(batch, batch_specs(batch, rules)))
    check_cell(rec)
    assert rec["memory"]["argument_bytes"] == want
    # every param and moment is updated in place: they alias the outputs
    assert rec["memory"]["alias_bytes"] == want - local_bytes(
        batch, batch_specs(batch, rules)) - 4


@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-1.3b"])
def test_one_rank_trace_counts_the_flops_of_the_real_step(smoke, arch):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import input_specs, runtime_for, train_config_for
    from repro_torch.models import build_model
    from repro_torch.train import make_optimizer, make_train_step

    shape = SMALL["train_4k"]
    with dryrun.fake_process_group(1):
        rec = dryrun.run_cell(arch, "train_4k", _mesh((1,), ("data",)))
    check_cell(rec, one_rank=True)

    cfg = get_smoke_config(arch)
    model = build_model(cfg, runtime_for(cfg, shape), device="cpu", seed=0)
    tc = train_config_for(cfg, shape, 1)
    assert rec["microbatches"] == tc.microbatches
    params = dict(model.named_parameters())
    state = make_optimizer(tc.optimizer, len(cfg.pattern)).init(params)
    gen = torch.Generator().manual_seed(0)
    batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=gen, dtype=v.dtype)
                 if k != "segments" else torch.ones(v.shape, dtype=v.dtype))
             for k, v in input_specs(cfg, shape).items()}
    step = make_train_step(model, tc)
    with FlopCounterMode(display=False) as counter:
        step(params, state, batch)
    assert rec["hlo_flops"] == counter.get_total_flops()


def _zero3_cell(arch, mesh_shape, batch, remat=None):
    """``run_cell`` of smoke ``arch``'s train step under the zero3 layout
    (FSDP over ("data", "model"), one batch row a rank) at ``batch`` rows,
    one microbatch; with the bytes each FSDP-sharded param lacks on a rank
    (its full bytes less its local shard's), by name."""
    from repro_torch.launch.presets import resolve_layout
    from repro_torch.launch.specs import runtime_for
    from repro_torch.models import build_model
    from repro_torch.train.sharding import local_shape, named, param_specs

    cfg = get_smoke_config(arch)
    shape = dataclasses.replace(SMALL["train_4k"], global_batch=batch)
    with dryrun.fake_process_group(math.prod(mesh_shape)):
        mesh = _mesh(mesh_shape, ("data", "model"))
        rules, rt_o, tc_o = resolve_layout(cfg, shape, mesh, "zero3")
        if remat is not None:
            rt_o = dict(rt_o, remat=remat)
        rec = dryrun.run_cell(arch, "train_4k", mesh, rules=rules, rt_overrides=rt_o,
                              tc_overrides=dict(tc_o, microbatches=1), shape=shape)
        params = dict(build_model(cfg, runtime_for(cfg, shape), device="meta")
                      .named_parameters())
        specs = param_specs(params, rules, len(cfg.pattern))
        missing = {k: (p.numel() - math.prod(local_shape(p.shape, named(mesh, specs[k]))))
                   * p.element_size() for k, p in params.items()}
    check_cell(rec, one_rank=math.prod(mesh_shape) == 1)
    return rec, {k: b for k, b in missing.items() if b}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-1.3b", "recurrentgemma-9b"])
def test_zero3_per_device_flops_equal_one_rank_at_its_batch_share(smoke, arch, mesh_shape):
    """Four ranks at 4 rows, one row a rank, trace each rank's matmuls: the
    FLOPs of one rank at 1 row, to the last digit (no global op of DTensor's
    propagation, of ``local_map``'s kernels or of the loss is counted)."""
    four, _ = _zero3_cell(arch, mesh_shape, 4)
    one, _ = _zero3_cell(arch, (1, 1), 1)
    assert four["microbatches"] == one["microbatches"] == 1
    assert four["hlo_flops"] == one["hlo_flops"]


def test_zero3_gathers_every_fsdp_weight_on_use(smoke):
    """Smoke gemma2 under zero3 on (2, 2): the all-gathers' wire bytes are
    the FSDP shards' worked out by hand (a rank receives the 3/4 of each
    weight it does not hold).  Without remat each layer's weights are
    gathered once and the tied embedding twice (the lookup and the logits),
    and every gather's gradient is reduce-scattered back; under the layout's
    remat "dots" the backward gathers the layers' weights once more."""
    rec, missing = _zero3_cell("gemma2-9b", (2, 2), 4, remat="none")
    layers = sum(b for k, b in missing.items() if k.startswith("blocks."))
    assert set(missing) - {k for k in missing if k.startswith("blocks.")} == {"embed"}
    # one layer: wq, wk, wv, wo and the MLP's three, d_model rows over four ranks
    cfg = get_smoke_config("gemma2-9b")
    q, kv, f = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff
    one_layer = 4 * cfg.d_model * (2 * q + 2 * kv + 3 * f) * 3 // 4
    assert sum(b for k, b in missing.items() if k.startswith("blocks.0.")) == one_layer
    assert layers == cfg.n_layers * one_layer
    by_kind = rec["collectives"]["bytes_by_kind"]
    assert by_kind["all-gather"] == layers + 2 * missing["embed"]
    assert by_kind["reduce-scatter"] == by_kind["all-gather"]
    dots, _ = _zero3_cell("gemma2-9b", (2, 2), 4)
    assert dots["collectives"]["bytes_by_kind"]["all-gather"] == \
        2 * layers + 2 * missing["embed"]
    assert dots["collectives"]["bytes_by_kind"]["reduce-scatter"] == by_kind["reduce-scatter"]


def test_two_point_extrapolation_equals_the_full_depth_trace(smoke):
    arch = "gemma2-9b"
    cfg = get_smoke_config(arch)
    deep = dataclasses.replace(cfg, n_layers=3 * len(cfg.pattern))
    S = SMALL["train_4k"].seq_len
    with mock.patch.object(dryrun, "get_config", lambda a: deep), \
            dryrun.fake_process_group(4):
        mesh = _mesh((2, 2), ("data", "model"))
        est = dryrun.run_cell_roofline(arch, "train_4k", mesh)
        full = dryrun.run_cell(arch, "train_4k", mesh,
                               rt_overrides={"scan_layers": False, "attn_block_q": S,
                                             "attn_block_k": S},
                               tc_overrides={"microbatches": 1})
    assert est["status"] == "ok" and full["status"] == "ok", (est, full)
    assert est["per_superblock"]["flops"] > 0
    assert est["hlo_flops"] == full["hlo_flops"]
    assert est["hlo_bytes"] == full["hlo_bytes"]
    assert est["wire_bytes"] == full["collectives"]["total_wire_bytes"]


def test_microbatches_split_the_same_matmul_flops(smoke):
    """Two microbatches of each rank's rows trace the FLOPs of one: the
    sharded step slices every rank's piece of the batch."""
    with dryrun.fake_process_group(4):
        mesh = _mesh((2, 2), ("data", "model"))
        one, two = (dryrun.run_cell("gemma2-9b", "train_4k", mesh,
                                    tc_overrides={"microbatches": m}) for m in (1, 2))
    check_cell(one)
    check_cell(two)
    assert (one["microbatches"], two["microbatches"]) == (1, 2)
    assert one["hlo_flops"] == two["hlo_flops"]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_main_writes_records_that_the_roofline_tables_render(smoke, tmp_path, capsys):
    from benchmarks.roofline import dryrun_table, load, roofline_table

    out = tmp_path / "dryrun"
    assert dryrun.main(["--device", "cpu", "--arch", "mamba2-1.3b", "--shape",
                        "prefill_32k", "--mesh", "single", "--out", str(out)]) == 0
    assert dryrun.main(["--device", "cpu", "--arch", "mamba2-1.3b", "--shape",
                        "prefill_32k", "--mesh", "single", "--roofline",
                        "--out", str(out)]) == 0
    recs = load(str(out))
    assert {r["status"] for r in recs.values()} == {"ok"}
    assert {r["mesh"] for r in recs.values()} == {"16x16"}
    exec_rows, roof_rows = dryrun_table(recs), roofline_table(recs)
    assert any("mamba2-1.3b" in row and "ok" in row for row in exec_rows)
    assert any("mamba2-1.3b" in row for row in roof_rows[2:])


def test_main_refuses_cuda_without_a_runtime(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA runtime is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert not dist.is_initialized()

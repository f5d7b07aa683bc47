"""One train step with the params really sharded (FSDP over "data", tensor
parallel over "model": ``shard_model``'s DTensors) on gloo meshes of four
CPU processes, against the JAX package's jitted step on the same numpy
weights and batch.

- (2, 2) over ("data", "model"): FSDP and TP over two ranks each;
- (2, 2, 1) over ("pod", "data", "model"): data parallelism over two batch
  axes of two ranks each (the step used to raise there).

Smoke gemma2 (local and global attention, GQA, softcaps, post-norms) and
mamba2 (SSD) in fp32: the loss, the gradient norm and every gradient that
the step updates with (gathered from the shards, against ``jax.grad``)
within the reference's fp32 tolerance (tests/test_kernels.py::_tol, 3e-4),
and every parameter's change in one AdamW step, gathered from the shards,
within 2e-6 of the JAX step's: 1/50 of the step's update (AdamW's first
step moves each element by about lr_t, 1e-4), so a step that leaves a
shard unchanged or writes it to the wrong place fails.  On (2, 2) also smoke
mixtral's loss and gradients under the baseline layout (``moe_apply`` per
shard) and ``moe_ep`` (``moe_apply_shardmap``) against the same model whole,
within 1e-5 (tests/test_moe_shardmap.py's value tolerance).  Each mesh's four ranks run
both models in one spawn (``torch.multiprocessing``); every group is made
with ``init_method="file://..."`` and a 60 s timeout and every process is
joined with a timeout, as tests/test_torch_distributed.py does.
"""

import dataclasses
import os
import traceback
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 150
TOL = dict(atol=3e-4, rtol=3e-4)
# A parameter's change in the step: 1/50 of AdamW's first update at lr_t 1e-4
DELTA_TOL = dict(atol=2e-6, rtol=0)
ARCHS = {"gemma2-9b": dict(n_layers=2, S=32), "mamba2-1.3b": dict(n_layers=2, S=32)}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
OPT = dict(name="adamw", lr=1e-4, warmup_steps=2, total_steps=6)
BATCH = 4


def _sharded_step(rank, world, tmp, mesh_shape, names):
    """Every arch's step on this rank's shards; rank 0 returns the loss, the
    gradient norm and every parameter gathered whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                            batch_specs, opt_state_specs,
                                            param_specs, shard_model, shard_tree)
    from repro_torch.weights import params_to_jax

    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    rules = ShardingRules(mesh)
    out = {}
    for arch, case in ARCHS.items():
        ref = torch.load(os.path.join(tmp, f"{arch}.pt"), weights_only=False)
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=case["n_layers"])
        rt = RuntimeConfig(compute_dtype=torch.float32, attn_impl="ref",
                           ssd_impl="chunked", rglru_impl="scan",
                           act_sharding=ActivationSharding(rules))
        model = build_model(cfg, rt, device="cpu", seed=1)
        model.load_jax_params(ref["params"])
        train = TrainConfig(optimizer=OptimizerConfig(**OPT))
        opt = make_optimizer(train.optimizer, period=len(cfg.pattern))
        params = dict(model.named_parameters())
        state = opt.init(params)
        ospecs = opt_state_specs(state, params, param_specs(params, rules, len(cfg.pattern)),
                                 rules, len(cfg.pattern))
        specs = shard_model(model, rules)
        params = dict(model.named_parameters())
        state = shard_tree(state, ospecs, mesh)
        batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
        batch = shard_tree(batch, batch_specs(batch, rules), mesh)
        step = make_train_step(model, train)
        with implicit_replication():
            _, grads = step.value_and_grad(params, batch)
            grads = {k: g.full_tensor() for k, g in grads.items()}
        params, state, metrics = step(params, state, batch)
        whole = {k: p.full_tensor().detach() for k, p in params.items()}
        out[arch] = {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
                     "grads": params_to_jax(grads, len(cfg.pattern)),
                     "params": params_to_jax(whole, len(cfg.pattern)),
                     "sharded": sum(any(pl.is_shard() for pl in p.placements)
                                    for p in params.values()),
                     "split": sorted({a for s in specs.values() for x in s
                                      for a in (x if isinstance(x, tuple) else (x,))
                                      if a is not None})}
    if names == ("data", "model"):
        out["mixtral"] = {layout: _moe_grads(mesh, layout) for layout in MOE_LAYOUTS}
    else:
        out["plain"] = _plain_params_step(mesh, rules)
    return out if rank == 0 else None


def _plain_params_step(mesh, rules):
    """Smoke mamba2's step with whole params on every rank, data-parallel
    over the two batch axes ("pod", "data"): each rank takes its rows and
    the gradients are summed over the two axes flattened into one group."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.sharding import ActivationSharding, batch_specs, shard_tree
    from repro_torch.train.step import data_parallel_group
    from repro_torch.weights import params_to_jax

    arch = "mamba2-1.3b"
    ref = torch.load(os.path.join(tmp_dir(), f"{arch}.pt"), weights_only=False)
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=ARCHS[arch]["n_layers"])
    rt = RuntimeConfig(compute_dtype=torch.float32, ssd_impl="chunked",
                       act_sharding=ActivationSharding(rules))
    assert data_parallel_group(rt).size() == 4
    model = build_model(cfg, rt, device="cpu", seed=1)
    model.load_jax_params(ref["params"])
    train = TrainConfig(optimizer=OptimizerConfig(**OPT))
    params = dict(model.named_parameters())
    state = make_optimizer(train.optimizer, period=len(cfg.pattern)).init(params)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    batch = shard_tree(batch, batch_specs(batch, rules), mesh)
    params, state, metrics = make_train_step(model, train)(params, state, batch)
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "params": params_to_jax({k: p.detach() for k, p in params.items()},
                                    len(cfg.pattern))}


MOE_LAYOUTS = ("baseline", "moe_ep")


def _moe_grads(mesh, layout):
    """Smoke mixtral's loss and gradients with its params sharded under
    ``layout`` (baseline: ``moe_apply`` per shard, d_ff over "model";
    moe_ep: ``moe_apply_shardmap``, experts over "data") against the same
    model whole in this process.  Groups of 16 tokens and a capacity of
    every token keep a shard's groups the batch's and drop nothing."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.presets import resolve_layout
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train.sharding import (ActivationSharding, batch_specs,
                                            shard_model, shard_tree)
    from test_torch_train_loss import packed_batch

    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              capacity_factor=4.0)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=BATCH, seq_len=32)
    rules, rt_over, _ = resolve_layout(cfg, shape, mesh, layout)
    rt_over = {k: v for k, v in rt_over.items() if k != "remat"}
    kw = dict(compute_dtype=torch.float32, attn_impl="ref", moe_group_size=16)
    whole = build_model(cfg, RuntimeConfig(**kw), device="cpu", seed=1)
    model = build_model(cfg, RuntimeConfig(**kw, **rt_over,
                                           act_sharding=ActivationSharding(rules)),
                        device="cpu", seed=1)
    batch = {k: torch.from_numpy(v) for k, v in packed_batch(7, BATCH, 32).items()}
    want, _ = whole.loss(batch)
    want_grads = torch.autograd.grad(want, list(whole.parameters()))
    shard_model(model, rules)
    with implicit_replication():
        loss, _ = model.loss(shard_tree(batch, batch_specs(batch, rules), mesh))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        grads = [g.redistribute(p.device_mesh, p.placements).full_tensor()
                 for g, p in zip(grads, model.parameters())]
        loss = loss.full_tensor()
    return {"loss": (loss.item(), want.item()),
            "grads": {n: (g, w) for (n, _), g, w in
                      zip(whole.named_parameters(), grads, want_grads)}}


_TMP = []


def tmp_dir() -> str:
    return _TMP[0]


def _entry(rank, world, tmp, args):
    _TMP.append(tmp)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = _sharded_step(rank, world, tmp, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(tmp, world, *args):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    errs = {r: (tmp / f"err{r}.txt").read_text() for r in range(world)
            if (tmp / f"err{r}.txt").exists()}
    assert not hung, f"ranks {hung} did not finish within {JOIN_TIMEOUT_S} s; {errs}"
    assert all(p.exitcode == 0 for p in procs), errs
    return torch.load(tmp / "out0.pt", weights_only=False)


def _jax_reference(tmp):
    """The JAX package's step on each arch's weights and batch; writes the
    inputs for the ranks and returns what the step gives."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import RuntimeConfig as JaxRuntimeConfig
    from repro.models import build_model as jax_build_model
    from repro.train import optimizer as jax_optimizer
    from repro.train.step import TrainConfig as JaxTrainConfig
    from repro.train.step import make_train_step as jax_make_train_step
    from test_torch_train_loss import packed_batch

    want = {}
    for i, (arch, case) in enumerate(ARCHS.items()):
        cfg = dataclasses.replace(jax_smoke_config(arch), n_layers=case["n_layers"])
        model = jax_build_model(cfg, JaxRuntimeConfig(
            compute_dtype=jnp.float32, attn_impl="naive", ssd_impl="xla", rglru_impl="xla"))
        params = model.init(jax.random.PRNGKey(i))
        train = JaxTrainConfig(optimizer=jax_optimizer.OptimizerConfig(**OPT))
        state = jax_optimizer.make_optimizer(train.optimizer).init(params)
        batch = packed_batch(20 + i, BATCH, case["S"])
        torch.save({"params": jax.tree.map(np.asarray, params), "batch": batch},
                   tmp / f"{arch}.pt")
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(params, jbatch)
        new, _, metrics = jax.jit(jax_make_train_step(model, train))(params, state, jbatch)
        want[arch] = {"loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "grads": jax.tree.map(np.asarray, grads),
                      "old": jax.tree.map(np.asarray, params),
                      "params": jax.tree.map(np.asarray, new)}
    return want


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    return tmp, _jax_reference(tmp)


_RUNS = {}


def _mesh_run(name, jax_run):
    """The four ranks' results on mesh ``name``, spawned once a module."""
    if name not in _RUNS:
        tmp, want = jax_run
        run = tmp / name
        run.mkdir()
        for arch in ARCHS:
            (run / f"{arch}.pt").symlink_to(tmp / f"{arch}.pt")
        _RUNS[name] = (name, want, _spawn(run, 4, *MESHES[name]))
    return _RUNS[name]


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request, jax_run):
    return _mesh_run(request.param, jax_run)


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return np.asarray(tree)


def _assert_step_matches(got, want, where):
    """The loss, the gradient norm, every gradient (where ``got`` has them)
    and every parameter's change against the JAX step's."""
    import jax

    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want["params"])[0]:
        msg = f"{where}: {jax.tree_util.keystr(path)}"
        if "grads" in got:
            np.testing.assert_allclose(_leaf(got["grads"], path),
                                       _leaf(want["grads"], path), **TOL, err_msg=msg)
        old = _leaf(want["old"], path)
        change = leaf - old
        # AdamW's first update moves every element by about lr_t (1e-4
        # here); a step that left a leaf or one of its shards as it was
        # would miss by that much
        assert np.abs(change).max() > 10 * DELTA_TOL["atol"], msg
        np.testing.assert_allclose(_leaf(got["params"], path) - old, change,
                                   **DELTA_TOL, err_msg=msg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_step_matches_the_jax_step(mesh_run, arch):
    mesh, want, got = mesh_run
    want, got = want[arch], got[arch]
    # the params really are split: FSDP over "data", TP over "model" where
    # it has ranks
    assert got["sharded"] > 0
    assert "data" in got["split"] and "model" in got["split"]
    _assert_step_matches(got, want, f"{arch} on {MESHES[mesh][1]}")


@pytest.mark.parametrize("layout", MOE_LAYOUTS)
def test_sharded_moe_gradients_equal_the_whole_model(jax_run, layout):
    got = _mesh_run("2x2", jax_run)[2]["mixtral"][layout]
    np.testing.assert_allclose(*got["loss"], rtol=1e-5)
    for name, (g, w) in got["grads"].items():
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)


def test_plain_params_train_data_parallel_over_two_batch_axes(jax_run):
    """Whole params on every rank over ("pod", "data") of (2, 2, 1): the
    step sums the gradients over both axes and equals the JAX step."""
    _, want, got = _mesh_run("2x2x1", jax_run)
    _assert_step_matches(got["plain"], want["mamba2-1.3b"], "plain mamba2")

"""The port's distributed paths on the CPU: several processes joined by a
gloo process group (``torch.multiprocessing``, spawn), each on its own
rank of a DeviceMesh.

- Data parallelism: two ranks, each taking its rows of a global batch,
  against one process on the whole batch: the loss, the gradient norm and
  the params after 2 steps (fp32, 3e-4, tests/test_kernels.py::_tol), and
  the training driver's losses on two ranks against one.
- ``moe_apply_shardmap`` on (2, 1) and (2, 2) meshes of ("data", "model")
  against the port's ``moe_apply`` on the gathered batch: the outputs, the
  input's gradient and the parameters' gradients summed over the ranks
  (fp32, 1e-5 for values and 2e-4 for gradients, tests/test_moe_shardmap.py's
  tolerances).  S = 16 and ``moe_group_size`` 16 make each row one token
  group, so the groups a rank routes are groups of the gathered batch too,
  with the same capacity.  At (1, 1) it also equals the JAX package's
  ``moe_apply_shardmap`` (tests/test_moe_shardmap.py, mirrored).
- Elastic restore: a checkpoint written by one process restores onto a
  two-rank mesh as DTensors.

Every group is made with ``init_method="file://..."`` and a 60 s timeout,
and every process is joined with a timeout, so a hung collective fails its
test instead of stalling the suite.
"""

import os
import traceback
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 150
FP32_TOL = dict(atol=3e-4, rtol=3e-4)
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
MOE_GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# process plumbing
# ---------------------------------------------------------------------------


def _entry(rank, world, tmp, fn_name, args):
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = globals()[fn_name](rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(tmp_path, world, fn_name, *args):
    """Run ``fn_name(rank, world, *args)`` on ``world`` ranks; their results
    in rank order."""
    tmp = tmp_path / f"{fn_name}-{world}"
    tmp.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, str(tmp), fn_name, args))
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
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]


def _batch(seed, B, S, vocab=512):
    """A loader-shaped batch: two documents a row, padding at the end of
    odd rows, labels masked there and at random places."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, vocab, size=(B, S + 1)).astype(np.int32)
    segments = np.zeros((B, S), np.int32)
    positions = np.zeros((B, S), np.int32)
    for b in range(B):
        cut = int(rng.integers(S // 4, 3 * S // 4))
        segments[b, cut:] = 1
        positions[b] = np.concatenate([np.arange(cut), np.arange(S - cut)])
        if b % 2:
            segments[b, -5:] = -1
    labels = np.where(segments >= 0, tokens[:, 1:], -1)
    labels[rng.random((B, S)) < 0.1] = -1
    return {"tokens": tokens[:, :S], "labels": labels.astype(np.int32),
            "segments": segments, "positions": positions}


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

TRAIN_RT = dict(compute_dtype=torch.float32, attn_impl="ref", ssd_impl="chunked",
                rglru_impl="scan")
OPT = dict(name="adamw", lr=1e-4, warmup_steps=2, total_steps=6)


def _dp_steps(rank, world, arch, steps, micro=1, order=None):
    """``steps`` train steps of a smoke model on the global batches (their
    rows in ``order``, if given); with a process group, data-parallel over a
    1-D "data" mesh of its ranks."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig

    rt = RuntimeConfig(**TRAIN_RT)
    feed = None
    if world:
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                                batch_specs, from_global, named)
        mesh = make_local_mesh("cpu")
        rules = ShardingRules(mesh, batch_axes=("data",), fsdp_axis=None, tp_axis=None)
        rt = rt.with_(act_sharding=ActivationSharding(rules))

        def feed(batch):
            return {k: from_global(v, s) for (k, v), s in zip(
                batch.items(), named(mesh, batch_specs(batch, rules)).values())}
    model = build_model(get_smoke_config(arch), rt, device="cpu", seed=3)
    train_cfg = TrainConfig(optimizer=OptimizerConfig(**OPT), microbatches=micro)
    step_fn = make_train_step(model, train_cfg)
    params = dict(model.named_parameters())
    state = make_optimizer(train_cfg.optimizer, period=len(model.pattern)).init(params)
    metrics = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v if order is None else v[order])
                 for k, v in _batch(20 + step, 4, 32).items()}
        if feed is not None:
            batch = feed(batch)
            assert batch["tokens"].to_local().shape[0] == 4 // world
        params, state, m = step_fn(params, state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, {k: v.detach().clone() for k, v in params.items()}


@pytest.mark.parametrize("arch,micro", [("mamba2-1.3b", 1), ("gemma2-9b", 1),
                                        ("mamba2-1.3b", 2)])
def test_two_rank_data_parallel_steps_equal_one_process(tmp_path, arch, micro):
    """With microbatches, microbatch i is the union of each rank's i-th
    slice (rows 0 and 2, then 1 and 3), so the one process takes the global
    batch's rows in that order."""
    order = None if micro == 1 else [0, 2, 1, 3]
    want_metrics, want_params = _dp_steps(0, 0, arch, 2, micro, order)
    for metrics, params in _spawn(tmp_path, 2, "_dp_steps", arch, 2, micro):
        np.testing.assert_allclose(np.array(metrics), np.array(want_metrics), **FP32_TOL)
        for k, v in want_params.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), **FP32_TOL, err_msg=k)


def _driver(rank, world, steps):
    from repro_torch.launch.train import main
    out = main(["--smoke", "--device", "cpu", "--steps", str(steps), "--batch", "4",
                "--seq-len", "32", "--checkpoint-every", "100", "--log-every", "100"])
    return out["losses"]


def test_training_driver_on_two_ranks_equals_one(tmp_path):
    """The driver's Fig. 1 flow: every rank reads the global batch and the
    feed hands it its rows; the losses equal a one-rank run's."""
    (one,) = _spawn(tmp_path, 1, "_driver", 3)
    two = _spawn(tmp_path, 2, "_driver", 3)
    assert len(one) == 3 and all(np.isfinite(one))
    for losses in two:
        np.testing.assert_allclose(losses, one, **FP32_TOL)


# ---------------------------------------------------------------------------
# MoE expert parallelism
# ---------------------------------------------------------------------------


def _moe_setup(mesh_shape, params_np=None):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig
    from repro_torch.models.common import Initializer
    from repro_torch.models.moe import moe_init
    from repro_torch.train.sharding import ActivationSharding, ShardingRules

    cfg = get_smoke_config("mixtral-8x22b")
    rt = RuntimeConfig(compute_dtype=torch.float32, moe_group_size=16)
    if mesh_shape is not None:
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        rt = rt.with_(act_sharding=ActivationSharding(ShardingRules(mesh)))
    p = moe_init(Initializer(0, "cpu"), cfg, torch.float32)
    if params_np is not None:
        with torch.no_grad():
            for k, v in params_np.items():
                p[k].copy_(torch.from_numpy(v))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    return cfg, rt, p, x


def _moe_grads(fn, p, x, cfg, rt):
    x = x.clone().requires_grad_()
    y, aux = fn(p, x, cfg, rt)
    grads = torch.autograd.grad(torch.sum(y ** 2), [x] + list(p.values()))
    return (y.detach(), aux.detach(), grads[0],
            {k: g for k, g in zip(p.keys(), grads[1:])})


def _moe_shardmap_rank(rank, world, mesh_shape):
    from repro_torch.models.moe import moe_apply_shardmap

    cfg, rt, p, x = _moe_setup(mesh_shape)
    mesh = rt.act_sharding.rules.mesh
    d, n_d = mesh.get_local_rank("data"), mesh_shape[0]
    rows = slice(d * 4 // n_d, (d + 1) * 4 // n_d)
    y, aux, gx, gp = _moe_grads(moe_apply_shardmap, p, x[rows], cfg, rt)
    for g in gp.values():
        dist.all_reduce(g)
    return {"rows": (rows.start, rows.stop), "y": y, "aux": aux, "gx": gx, "gp": gp}


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_moe_shardmap_equals_moe_apply_on_the_gathered_batch(tmp_path, mesh_shape):
    from repro_torch.models.moe import moe_apply

    cfg, rt, p, x = _moe_setup(None)
    y, _, gx, gp = _moe_grads(moe_apply, p, x, cfg, rt)
    # the aux loss is the mean of each rank's, over the groups it routed
    n = mesh_shape[0] * mesh_shape[1]
    aux = np.mean([moe_apply(p, x[i * 4 // n:(i + 1) * 4 // n], cfg, rt)[1].item()
                   for i in range(n)])
    outs = _spawn(tmp_path, n, "_moe_shardmap_rank", mesh_shape)
    for out in outs:
        rows = slice(*out["rows"])
        np.testing.assert_allclose(out["y"].numpy(), y[rows].numpy(), **MOE_TOL)
        np.testing.assert_allclose(out["gx"].numpy(), gx[rows].numpy(), **MOE_GRAD_TOL)
        np.testing.assert_allclose(out["aux"].item(), aux, rtol=1e-5)
        for k, g in gp.items():
            np.testing.assert_allclose(out["gp"][k].numpy(), g.numpy(), **MOE_GRAD_TOL,
                                       err_msg=k)


def _moe_mesh11(rank, world, params_np):
    """tests/test_moe_shardmap.py at (1, 1): the values, the gradients and a
    decoder's loss against the capacity path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_apply, moe_apply_shardmap

    cfg, rt, p, x = _moe_setup((1, 1), params_np)
    y, aux, _, gp = _moe_grads(moe_apply_shardmap, p, x[:2, :], cfg, rt)
    y_ref, aux_ref, _, gp_ref = _moe_grads(moe_apply, p, x[:2, :], cfg, rt)
    model = build_model(cfg, rt.with_(moe_impl="shard_map", attn_impl="ref"),
                        device="cpu", seed=0)
    model_ref = build_model(cfg, rt.with_(attn_impl="ref"), device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 17)).astype(np.int64))
    batch = {"tokens": tokens[:, :16], "labels": tokens[:, 1:]}
    return {"y": y, "aux": aux, "y_ref": y_ref, "aux_ref": aux_ref, "gp": gp,
            "gp_ref": gp_ref, "loss": model.loss(batch)[0].item(),
            "loss_ref": model_ref.loss(batch)[0].item()}


def test_moe_shardmap_at_1x1_matches_moe_apply_and_the_jax_package(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.launch.mesh import _auto_kwargs
    from repro.models import RuntimeConfig as JaxRuntimeConfig
    from repro.models.common import Initializer as JaxInitializer
    from repro.models.moe import moe_apply_shardmap as jax_moe_apply_shardmap
    from repro.models.moe import moe_init as jax_moe_init
    from repro.train.sharding import ActivationSharding as JaxActivationSharding
    from repro.train.sharding import ShardingRules as JaxShardingRules

    cfg = jax_smoke_config("mixtral-8x22b")
    mesh = jax.make_mesh((1, 1), ("data", "model"), **_auto_kwargs(2))
    jrt = JaxRuntimeConfig(compute_dtype=jnp.float32, moe_group_size=16,
                           act_sharding=JaxActivationSharding(JaxShardingRules(mesh)))
    jp = jax_moe_init(JaxInitializer(jax.random.PRNGKey(0)), cfg, jnp.float32)
    params_np = {k: np.asarray(v) for k, v in jp.items()}
    x = np.random.default_rng(1).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    y_jax, aux_jax = jax_moe_apply_shardmap(jp, jnp.asarray(x[:2]), cfg, jrt)
    (out,) = _spawn(tmp_path, 1, "_moe_mesh11", params_np)
    np.testing.assert_allclose(out["y"].numpy(), out["y_ref"].numpy(), **MOE_TOL)
    np.testing.assert_allclose(out["aux"].item(), out["aux_ref"].item(), rtol=1e-5)
    for k, g in out["gp_ref"].items():
        np.testing.assert_allclose(out["gp"][k].numpy(), g.numpy(), **MOE_GRAD_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(out["loss"], out["loss_ref"], rtol=1e-5)
    np.testing.assert_allclose(out["y"].numpy(), np.asarray(y_jax), **MOE_TOL)
    np.testing.assert_allclose(out["aux"].item(), float(aux_jax), rtol=1e-5)


def _refuses_unsplit_batch(rank, world):
    from repro_torch.models.moe import moe_apply_shardmap
    from repro_torch.train.sharding import ActivationSharding, ShardingRules

    cfg, rt, p, x = _moe_setup((2, 1))
    rules = ShardingRules(rt.act_sharding.rules.mesh, batch_axes=("model",))
    with pytest.raises(ValueError, match="split over the expert axis"):
        moe_apply_shardmap(p, x, cfg, rt.with_(act_sharding=ActivationSharding(rules)))
    return True


def test_moe_shardmap_refuses_a_batch_not_split_over_the_expert_axis(tmp_path):
    assert _spawn(tmp_path, 2, "_refuses_unsplit_batch") == [True, True]


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------


def _restore_on_mesh(rank, world, repo):
    from repro_torch.core import DatasetManager, FileBackend, ObjectStore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.checkpoint import load_checkpoint
    from repro_torch.train.sharding import named

    mesh = make_local_mesh("cpu")
    dm = DatasetManager(ObjectStore(FileBackend(repo)))
    like = {"w": torch.empty((4, 4)), "b": torch.empty((3,))}
    sh = {"w": named(mesh, ("data", None)), "b": named(mesh, (None,))}
    params, _, extra = load_checkpoint(dm, "ckpt/elastic", like, param_shardings=sh,
                                       period=1)
    return {"placements": [str(params[k].placements) for k in ("w", "b")],
            "local_w": params["w"].to_local(), "full_w": params["w"].full_tensor(),
            "full_b": params["b"].full_tensor(), "extra": extra}


def test_elastic_restore_onto_a_two_rank_mesh(tmp_path):
    from repro_torch.core import DatasetManager, FileBackend, ObjectStore
    from repro_torch.train.checkpoint import save_checkpoint

    repo = str(tmp_path / "repo")
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    b = torch.tensor([1.0, 2.0, 3.0])
    save_checkpoint(DatasetManager(ObjectStore(FileBackend(repo))), "ckpt/elastic", 1,
                    {"w": w, "b": b}, extra={"step": 1}, period=1)
    outs = _spawn(tmp_path, 2, "_restore_on_mesh", repo)
    for rank, out in enumerate(outs):
        assert out["placements"] == ["(Shard(dim=0),)", "(Replicate(),)"]
        assert torch.equal(out["local_w"], w[2 * rank:2 * rank + 2])
        assert torch.equal(out["full_w"], w) and torch.equal(out["full_b"], b)
        assert out["extra"] == {"step": 1}


# ---------------------------------------------------------------------------
# a batch laid onto the mesh, and a constraint on a DTensor
# ---------------------------------------------------------------------------


def _device_batch_rank(rank, world):
    from repro_torch.data import ShardedSnapshotLoader
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build_platform
    from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                            batch_specs, constrain)

    plat, _ = build_platform(32, n_docs=64)
    loader = ShardedSnapshotLoader(plat.dataset("corpus/packed").plan(), 4, 32)
    host = loader.next_batch()
    mesh = make_local_mesh("cpu")
    rules = ShardingRules(mesh, batch_axes=("data",), fsdp_axis=None, tp_axis=None)
    batch = loader.device_batch(host, mesh, batch_specs(host, rules))
    whole = constrain(batch["tokens"], rules, (None, None))
    hidden = ActivationSharding(rules).hidden(torch.ones(4, 3, 2))
    return {"host": host, "local": {k: v.to_local() for k, v in batch.items()},
            "shape": tuple(batch["tokens"].shape),
            "whole": whole.to_local(), "whole_placements": str(whole.placements),
            "hidden_is_plain": type(hidden) is torch.Tensor}


def test_device_batch_and_constrain_on_a_two_rank_mesh(tmp_path):
    """``device_batch`` gives each rank its rows of the batch as a DTensor of
    the global shape; ``constrain`` redistributes a DTensor (here to
    replicated) and ``ActivationSharding`` hands a plain tensor back."""
    outs = _spawn(tmp_path, 2, "_device_batch_rank")
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["host"]["tokens"], outs[0]["host"]["tokens"])
        for k, v in out["local"].items():
            np.testing.assert_array_equal(v.numpy(), out["host"][k][2 * rank:2 * rank + 2])
        assert out["shape"] == out["host"]["tokens"].shape
        np.testing.assert_array_equal(out["whole"].numpy(), out["host"]["tokens"])
        assert out["whole_placements"] == "(Replicate(),)"
        assert out["hidden_is_plain"]

"""Smoke seamless-m4t-medium's loss and gradients with its params sharded
(``shard_model``: FSDP over "data", tensor parallel over "model") on a gloo
(2, 4) mesh of eight CPU processes, against the same model whole.

Four "model" ranks over smoke seamless's four heads leave one head a rank,
as the production mesh's 16 do over seamless-m4t-medium's 16.  There the
attention's key gradient comes back from each rank transposed, and the
projection's backward used to fail its view (``RuntimeError: view size is
not compatible with input tensor's size and stride``); the dry-run's
seamless train_4k cell on 16 x 16 failed so.  The sharded loss and every
gradient (gathered from the shards) equal the whole model's within 1e-5, as
``tests/test_torch_sharded_step.py`` holds smoke mixtral.  Every group is
made with ``init_method="file://..."`` and a 60 s timeout and every process
is joined with a timeout, as tests/test_torch_distributed.py does.
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
MESH = ((2, 4), ("data", "model"))
B, S = 8, 64
TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(cfg):
    rng = np.random.default_rng(11)
    tokens = rng.integers(3, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[rng.random((B, S)) < 0.1] = -1
    return {"tokens": torch.from_numpy(tokens[:, :S]),
            "labels": torch.from_numpy(labels),
            "frontend_embeds": torch.from_numpy(
                rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))}


def _grads(rank, world, tmp):
    """The loss and every gradient, sharded and whole; rank 0 returns them."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                            batch_specs, shard_model, shard_tree)

    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    rules = ShardingRules(mesh)
    cfg = get_smoke_config("seamless-m4t-medium")
    assert cfg.n_heads == MESH[0][1]          # one head a "model" rank
    kw = dict(compute_dtype=torch.float32, attn_impl="ref")
    whole = build_model(cfg, RuntimeConfig(**kw), device="cpu", seed=1)
    model = build_model(cfg, RuntimeConfig(**kw, act_sharding=ActivationSharding(rules)),
                        device="cpu", seed=1)
    batch = _batch(cfg)
    want, _ = whole.loss(batch)
    want_grads = torch.autograd.grad(want, list(whole.parameters()))
    shard_model(model, rules)
    with implicit_replication():
        loss, _ = model.loss(shard_tree(batch, batch_specs(batch, rules), mesh))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        grads = [g.redistribute(p.device_mesh, p.placements).full_tensor()
                 for g, p in zip(grads, model.parameters())]
        loss = loss.full_tensor()
    split = sum(any(pl.is_shard() for pl in p.placements) for p in model.parameters())
    out = {"loss": (loss.item(), want.item()), "split": split,
           "grads": {n: (g, w) for (n, _), g, w in
                     zip(whole.named_parameters(), grads, want_grads)}}
    return out if rank == 0 else None


def _entry(rank, world, tmp):
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = _grads(rank, world, tmp)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_encdec")
    world = MESH[0][0] * MESH[0][1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, str(tmp))) for r in range(world)]
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


def test_sharded_seamless_loss_equals_the_whole_model(sharded):
    assert sharded["split"] > 0
    np.testing.assert_allclose(*sharded["loss"], **TOL)


def test_sharded_seamless_gradients_equal_the_whole_model(sharded):
    for name, (g, w) in sharded["grads"].items():
        assert torch.count_nonzero(w) > 0, name
        torch.testing.assert_close(g, w, **TOL, msg=name)

"""The layouts that the multi-pod dry-run's grid repairs, executed on a mesh
with a "pod" axis, each against the JAX package on the same numpy weights.

The JAX package runs first, in this process.  Then eight gloo CPU
processes, spawned once for the module (the group made with
``init_method="file://..."`` and a 60 s timeout, every process joined with a
timeout, as tests/test_torch_decode_layout.py does), run each case on a
(2, 2, 2) or (2, 1, 4) ("pod", "data", "model") mesh, the smoke configs at 4
rows of 32 tokens, fp32:

- train cases: the loss and every gradient gathered from the shards within
  3e-4 of ``jax.grad`` of the JAX package's loss:
  - ``zero3`` at fewer rows than ranks (ZeRO-3 with sequence parallelism,
    the multi-pod ``auto`` layout of dense train_4k), smoke gemma2 and
    recurrentgemma: q/k/v stay split on their sequence over "model", the
    attention splits the query rows there (``ActivationSharding.heads``),
    every matmul of a sequence-split activation is pinned
    (``models/common.py::linear``) and the gradients are reduce-scattered
    before they are all-reduced over "pod" (``models/common.py::gather``);
  - ``moe_ep`` at fewer rows than ranks, smoke arctic with 4 experts over
    "data": each "model" rank runs its share of the token groups
    (``models/moe.py::_group_axis``);
  - ``baseline`` on (2, 1, 4), smoke gemma2 whose 4 q heads divide "model"
    and whose 2 KV heads do not: each rank takes its q heads' K/V from the
    ranks that hold them (``kernels/_local.py::repeat_heads``);
- serve cases, ``seqpar`` at one row a rank: smoke arctic and mixtral with
  4 experts (8-token groups): the prefill's MoE runs each rank's own token
  groups (``models/moe.py::_moe_rows``), and three greedy decode steps fed
  the JAX package's tokens run the experts where they lie on "data"
  (``models/moe.py::_moe_decode_ep``): every step's logits within 3e-4 of
  the JAX package's ``prefill`` and ``decode_step``, and the same greedy
  tokens.

Each repair that changes what a rank computes has a mutant that the checks
refuse, run on the same ranks: a rows split whose ranks all attend from row
0, a group split that takes the next rank's groups, a rank's token groups
misplaced by one before the MoE's dispatch, an expert-parallel decode whose
ranks all take the first block of experts' gates, and K/V whose received
columns come in reverse order.
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

WORLD = 8
GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300
TOL = dict(atol=3e-4, rtol=3e-4)
BATCH, S, STEPS = 4, 32, 3
CACHE_LEN = S + STEPS + 1
GROUP = 8                          # moe_group_size: 2 groups of a rank's 16 tokens
AXES = ("pod", "data", "model")
# name -> (smoke arch, config change, layout, mesh, what a mutant breaks)
TRAIN = {
    "gemma2-zero3": ("gemma2-9b", dict(n_layers=2), "zero3", (2, 2, 2), "row_offset"),
    "recurrentgemma-zero3": ("recurrentgemma-9b", {}, "zero3", (2, 2, 2), None),
    "arctic-moe_ep": ("arctic-480b", {}, "moe_ep", (2, 2, 2), "split_over"),
    "gemma2-kv-heads": ("gemma2-9b", dict(n_layers=2), "baseline", (2, 1, 4), "a2a_reversed"),
}
SERVE = {
    "arctic-seqpar": ("arctic-480b", {}, "seqpar", (2, 2, 2), ("group_roll", "ep_block")),
    "mixtral-seqpar": ("mixtral-8x22b", {}, "seqpar", (2, 2, 2), None),
}


def _rt(**kw):
    from repro_torch.models import RuntimeConfig

    return RuntimeConfig(compute_dtype=torch.float32, attn_impl="ref", ssd_impl="chunked",
                         rglru_impl="scan", max_cache_len=CACHE_LEN, moe_group_size=GROUP,
                         **kw)


def _model(tmp, name, arch, change, layout, mesh, kind):
    """The sharded port model with the JAX package's weights, and its rules."""
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch.presets import resolve_layout
    from repro_torch.models import build_model
    from repro_torch.train.sharding import ActivationSharding, shard_model

    ref = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
    cfg = dataclasses.replace(get_smoke_config(arch), **change)
    rules, rt_over, _ = resolve_layout(cfg, ShapeConfig(kind, S, BATCH, kind), mesh, layout)
    model = build_model(cfg, _rt(act_sharding=ActivationSharding(rules), **rt_over),
                        device="cpu", seed=2)
    model.load_jax_params(ref["params"])
    shard_model(model, rules)
    return model, rules, ref


def _train(tmp, name, mesh, grads=True):
    """The loss and (``grads``) every gradient, gathered, as the JAX
    package's tree."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.sharding import batch_specs, shard_tree
    from repro_torch.weights import params_to_jax

    arch, change, layout, _, _ = TRAIN[name]
    model, rules, ref = _model(tmp, name, arch, change, layout, mesh, "train")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    batch = shard_tree(batch, batch_specs(batch, rules), mesh)
    params = dict(model.named_parameters())
    with implicit_replication():
        if not grads:
            return {"loss": model.loss(batch)[0].full_tensor().item()}
        loss, g = make_train_step(model, TrainConfig()).value_and_grad(params, batch)
        g = {k: t.full_tensor() for k, t in g.items()}
    return {"loss": loss.full_tensor().item(), "grads": params_to_jax(g, len(model.pattern))}


def _serve(tmp, name, mesh):
    """The prefill's and every decode step's logits, gathered."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.sharding import batch_specs, shard_tree

    arch, change, layout, _, _ = SERVE[name]
    model, rules, ref = _model(tmp, name, arch, change, layout, mesh, "prefill")

    def put(t):
        t = torch.from_numpy(t)
        return shard_tree(t, batch_specs({"t": t}, rules)["t"], mesh)

    with implicit_replication(), torch.inference_mode():
        logits, cache, pos = model.prefill(put(ref["tokens"]))
        steps = [logits.full_tensor().numpy()]
        for i, tok in enumerate(ref["fed"]):
            logits, cache = model.decode_step(cache, put(tok), pos + i)
            steps.append(logits.full_tensor().numpy())
    return steps


class _Mutant:
    """One of the module docstring's mutants, patched in while active."""

    def __init__(self, kind):
        import torch.distributed._functional_collectives as funcol

        import repro_torch.kernels.flash_attention.ops as flash_ops
        import repro_torch.models.moe as moe

        if kind == "row_offset":
            self.patch = (flash_ops, "row_offset", lambda mesh, layout, rows: 0)
        elif kind == "split_over":
            forward = moe._SplitOver.forward
            self.patch = (moe._SplitOver, "forward", staticmethod(
                lambda ctx, x, group, n, i: forward(ctx, x, group, n, (i + 1) % n)))
        elif kind == "group_roll":
            dispatch = moe._dispatch_groups
            self.patch = (moe, "_dispatch_groups", lambda p, xg, cfg, C: dispatch(
                p, torch.roll(xg, 1, dims=0), cfg, C))
        elif kind == "ep_block":
            block = moe.block_index
            self.patch = (moe, "block_index", lambda mesh, dims: (0, block(mesh, dims)[1]))
        else:
            a2a = funcol.all_to_all_single_autograd
            self.patch = (funcol, "all_to_all_single_autograd",
                          lambda *a, **k: a2a(*a, **k).flip(0))

    def __enter__(self):
        owner, attr, new = self.patch
        self.old = owner.__dict__[attr]
        setattr(owner, attr, new)

    def __exit__(self, *exc):
        owner, attr, _ = self.patch
        setattr(owner, attr, self.old)


def _ranks(rank, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
        return meshes[shape]

    out = {}
    for name, (_, _, _, shape, mutant) in TRAIN.items():
        out[name] = _train(tmp, name, mesh(shape))
        if mutant:
            with _Mutant(mutant):
                out[f"{name}/{mutant}"] = _train(tmp, name, mesh(shape), grads=False)
    for name, (_, _, _, shape, mutants) in SERVE.items():
        out[name] = _serve(tmp, name, mesh(shape))
        for mutant in mutants or ():
            with _Mutant(mutant):
                out[f"{name}/{mutant}"] = _serve(tmp, name, mesh(shape))
    return out if rank == 0 else None


def _entry(rank, tmp):
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=WORLD,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = _ranks(rank, tmp)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _jax_reference(tmp):
    """The JAX package's loss and gradients of each train case, and its
    greedy prefill and decode steps of each serve case, on its own weights
    (saved with the inputs for the ranks)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import RuntimeConfig, build_model
    from test_torch_train_loss import packed_batch

    def model_of(arch, change):
        cfg = dataclasses.replace(get_smoke_config(arch), **change)
        return cfg, build_model(cfg, RuntimeConfig(
            compute_dtype=jnp.float32, attn_impl="naive", ssd_impl="xla",
            rglru_impl="xla", max_cache_len=CACHE_LEN, moe_group_size=GROUP))

    want = {}
    for i, (name, (arch, change, _, _, _)) in enumerate(TRAIN.items()):
        cfg, model = model_of(arch, change)
        params = model.init(jax.random.PRNGKey(70 + i))
        batch = packed_batch(80 + i, BATCH, S)
        torch.save({"params": jax.tree.map(np.asarray, params), "batch": batch},
                   tmp / f"{name}.pt")
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))(
            params, jbatch)
        want[name] = {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}
    for i, (name, (arch, change, _, _, _)) in enumerate(SERVE.items()):
        cfg, model = model_of(arch, change)
        params = model.init(jax.random.PRNGKey(90 + i))
        tokens = np.random.default_rng(95 + i).integers(
            3, cfg.vocab_size, size=(BATCH, S)).astype(np.int32)
        logits, cache, pos = jax.jit(model.prefill)(params, jnp.asarray(tokens))
        decode = jax.jit(model.decode_step)
        steps, fed = [np.asarray(logits)], []
        for step in range(STEPS):
            fed.append(np.argmax(steps[-1][:, -1], axis=-1)[:, None].astype(np.int32))
            logits, cache = decode(params, cache, jnp.asarray(fed[-1]),
                                   jnp.asarray(int(pos) + step, jnp.int32))
            steps.append(np.asarray(logits))
        torch.save({"params": jax.tree.map(np.asarray, params), "tokens": tokens,
                    "fed": fed}, tmp / f"{name}.pt")
        want[name] = steps
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX package's results and rank 0's, once a module."""
    tmp = tmp_path_factory.mktemp("multipod_layout")
    want = _jax_reference(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, str(tmp))) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    errs = {r: (tmp / f"err{r}.txt").read_text() for r in range(WORLD)
            if (tmp / f"err{r}.txt").exists()}
    assert not hung, f"ranks {hung} did not finish within {JOIN_TIMEOUT_S} s; {errs}"
    assert all(p.exitcode == 0 for p in procs), errs
    return want, torch.load(tmp / "out0.pt", weights_only=False)


def _close(a, b) -> bool:
    return np.allclose(a, b, **TOL)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax(run, name):
    import jax

    from test_torch_sharded_step import _leaf

    want, got = run
    np.testing.assert_allclose(got[name]["loss"], want[name]["loss"], **TOL)
    leaves = jax.tree_util.tree_flatten_with_path(want[name]["grads"])[0]
    for path, leaf in leaves:
        np.testing.assert_allclose(_leaf(got[name]["grads"], path), leaf, **TOL,
                                   err_msg=f"{name}: {jax.tree_util.keystr(path)}")
    mutant = TRAIN[name][-1]
    if mutant:
        assert not _close(got[f"{name}/{mutant}"]["loss"], want[name]["loss"]), mutant


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_matches_jax(run, name):
    want, got = run
    for i, (mine, theirs) in enumerate(zip(got[name], want[name])):
        np.testing.assert_allclose(mine, theirs, **TOL, err_msg=f"{name} step {i}")
        assert (mine[:, -1].argmax(-1) == theirs[:, -1].argmax(-1)).all(), (name, i)
    for mutant in SERVE[name][-1] or ():
        steps = got[f"{name}/{mutant}"]
        # the prefill's MoE (group_roll) or the decode steps' (ep_block) break
        broken = steps[:1] if mutant == "group_roll" else steps[1:]
        good = want[name][:1] if mutant == "group_roll" else want[name][1:]
        assert not all(_close(a, b) for a, b in zip(broken, good)), mutant

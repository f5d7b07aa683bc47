"""Context parallelism in the port: the attention's query-rows split, and
FSDP weights left sharded where the batch does not split, executed.

Four gloo CPU processes, spawned once for the module (``torch.multiprocessing``;
the group made with ``init_method="file://..."`` and a 60 s timeout, every
process joined with a timeout, as tests/test_torch_sharded_step.py does):

- one train step on a (1, 4) ("data", "model") mesh, whose four "model"
  ranks split the query rows, of two models built with
  ``dataclasses.replace`` in both packages: smoke qwen2.5-32b with 6 q heads
  on 2 KV heads (6 does not divide 4) under the baseline rules, and smoke
  gemma2 (softcaps, a local window, packed segments) under the ``seqpar``
  rules (q/k/v constrained to their sequence, the reference's
  ``attn_shard_mode="seq"``).  Each against the JAX package's jitted step on
  the same numpy weights and batch: the loss, the gradient norm and every
  gradient gathered from the shards within 3e-4
  (tests/test_kernels.py::_tol, fp32), every parameter's change within 2e-6
  (1/50 of AdamW's first update) of the JAX step's, and of the JAX
  optimizer's update of the port's own gradients, and a prefill's logits
  within 3e-4.  The ranks record the query offset each attention call took:
  rank r's rows start at r S / 4.  And on the same mesh, an attention whose
  4 q heads divide the "model" ranks, whose 2 KV heads do not, and whose 30
  query rows do not split four ways: K/V are repeated to the q heads, and
  the output split by heads equals the whole attention;
- on a (2, 2) mesh of the same ranks, one row: smoke mamba2 and
  recurrentgemma's prefill and four greedy decode steps with the params
  sharded, against the JAX package's prefill and decode_step on the same
  numpy weights and tokens within 3e-4; the 2-d weights keep their FSDP
  shard on "data", where the row cannot split.

In one process, on a fake group of four ranks taken one rank at a time:
``per_shard``'s ``"rows"`` role (each rank's output, with its offset, equals
its rows of the whole attention: causal, a window, a softcap, segments;
q sharded on its sequence, or heads that do not divide the mesh dim), the
roles ``shard_layout`` gives, and where ``on_use`` keeps a weight's FSDP
shard.
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
JOIN_TIMEOUT_S = 180
TOL = dict(atol=3e-4, rtol=3e-4)
DELTA_TOL = dict(atol=2e-6, rtol=0)
# 100 x AdamW's eps: below it the first update is not yet +-lr_t
NOISE_GRAD = 1e-6
OPT = dict(name="adamw", lr=1e-4, warmup_steps=2, total_steps=6)
BATCH, S, CACHE_LEN = 4, 32, 48
# name -> (smoke arch, config changes, layout)
CASES = {"qwen-6-heads": ("qwen2.5-32b", dict(n_heads=6, n_kv_heads=2), "baseline"),
         "gemma2-seqpar": ("gemma2-9b", dict(n_layers=2), "seqpar")}
ONE_ROW_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
ONE_ROW_PROMPT = 16
DECODE_STEPS = 4


def _rules(mesh, cfg, layout):
    from repro_torch.configs import SHAPES
    from repro_torch.launch.presets import resolve_layout
    from repro_torch.train.sharding import ShardingRules

    if layout == "baseline":
        return ShardingRules(mesh), {}
    rules, rt_over, _ = resolve_layout(cfg, SHAPES["prefill_32k"], mesh, layout)
    return rules, rt_over


def _rows_step(tmp, mesh, name):
    """One train step and one prefill of case ``name`` on this rank's
    shards; rank 0's result is the loss, the gradient norm, every gradient
    and parameter gathered whole, and the prefill's logits."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.sharding import (ActivationSharding, batch_specs,
                                            opt_state_specs, param_specs,
                                            shard_model, shard_tree)
    from repro_torch.weights import params_to_jax

    arch, change, layout = CASES[name]
    ref = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
    cfg = dataclasses.replace(get_smoke_config(arch), **change)
    rules, rt_over = _rules(mesh, cfg, layout)
    rt = RuntimeConfig(compute_dtype=torch.float32, attn_impl="ref",
                       max_cache_len=CACHE_LEN, act_sharding=ActivationSharding(rules),
                       **rt_over)
    model = build_model(cfg, rt, device="cpu", seed=1)
    model.load_jax_params(ref["params"])
    period = len(cfg.pattern)
    train = TrainConfig(optimizer=OptimizerConfig(**OPT))
    params = dict(model.named_parameters())
    state = make_optimizer(train.optimizer, period=period).init(params)
    ospecs = opt_state_specs(state, params, param_specs(params, rules, period), rules,
                             period)
    shard_model(model, rules)
    params = dict(model.named_parameters())
    state = shard_tree(state, ospecs, mesh)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    batch = shard_tree(batch, batch_specs(batch, rules), mesh)
    tokens = torch.from_numpy(ref["prompt"])
    tokens = shard_tree(tokens, batch_specs({"t": tokens}, rules)["t"], mesh)
    step = make_train_step(model, train)
    with implicit_replication():
        logits, _, _ = model.prefill(tokens)      # (before the step moves the params)
        logits = logits.full_tensor()
        _, grads = step.value_and_grad(params, batch)
        grads = {k: g.full_tensor() for k, g in grads.items()}
    params, state, metrics = step(params, state, batch)
    whole = {k: p.full_tensor().detach() for k, p in params.items()}
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "grads": params_to_jax(grads, period), "params": params_to_jax(whole, period),
            "logits": logits.numpy()}


def _one_row(tmp, mesh):
    """Smoke mamba2's and recurrentgemma's prefill and greedy decode at one
    row, with the JAX package's weights loaded and the params sharded over
    ("data", "model"), fed the tokens the JAX package chose; returns the
    logits of every step and the weights that ``on_use`` left FSDP-sharded."""
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.models.common as common
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                            shard_model, shard_tree)

    kept = []
    fsdp_kept = common._fsdp_kept

    def spy(p, layout, x):
        out = fsdp_kept(p, layout, x)
        kept.append(tuple(p.shape)) if out else None
        return out

    common._fsdp_kept = spy
    rules = ShardingRules(mesh)
    out = {}
    for arch in ONE_ROW_ARCHS:
        ref = torch.load(os.path.join(tmp, f"{arch}.pt"), weights_only=False)
        rt = RuntimeConfig(compute_dtype=torch.float32, ssd_impl="chunked",
                           rglru_impl="scan", attn_impl="ref", max_cache_len=CACHE_LEN,
                           act_sharding=ActivationSharding(rules))
        model = build_model(get_smoke_config(arch), rt, device="cpu", seed=3)
        model.load_jax_params(ref["params"])
        shard_model(model, rules)
        kept.clear()

        def put(t):
            t = torch.from_numpy(t)
            return shard_tree(t, (None,) * t.dim(), mesh)

        with implicit_replication():
            logits, cache, pos = model.prefill(put(ref["tokens"]))
            steps = [logits]
            for i, tok in enumerate(ref["fed"]):
                logits, cache = model.decode_step(cache, put(tok), pos + i)
                steps.append(logits)
        out[arch] = {"logits": [t.full_tensor().numpy() for t in steps],
                     "kept": sorted(set(kept))}
    common._fsdp_kept = fsdp_kept
    return out


# 4 q heads divide the 4 "model" ranks, 2 KV heads do not, and 30 query
# rows do not split four ways
GQA_SHAPE = dict(B=2, Sq=30, Hq=4, Hkv=2, D=16)
GQA_OPTS = dict(causal=True, impl="chunked", block_q=16, block_k=16)


def _gqa_inputs():
    B, Sq, Hq, Hkv, D = (GQA_SHAPE[k] for k in ("B", "Sq", "Hq", "Hkv", "D"))
    rng = np.random.default_rng(8)
    return [torch.from_numpy(rng.standard_normal((B, Sq, h, D)).astype(np.float32))
            for h in (Hq, Hkv, Hkv)]


def _gqa_uneven_rows(mesh):
    """The per-shard attention of whole q, k and v on ``mesh``: whether its
    output is split by heads on "model", and the output gathered."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (DTensor.from_local(t, mesh, [Replicate(), Replicate()], run_check=False)
               for t in _gqa_inputs())
    out = flash_attention(q, k, v, **GQA_OPTS)
    return {"heads_split": out.placements[1].is_shard(2), "out": out.full_tensor()}


def _ranks(rank, world, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.kernels.flash_attention.ops as flash_ops

    offsets = set()
    row_offset = flash_ops.row_offset

    def record(mesh, layout, rows):
        off = row_offset(mesh, layout, rows)
        offsets.add((rows, off))
        return off

    flash_ops.row_offset = record
    rows_mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    out = {name: _rows_step(tmp, rows_mesh, name) for name in CASES}
    flash_ops.row_offset = row_offset
    out["gqa"] = _gqa_uneven_rows(rows_mesh)
    seen = [None] * world
    dist.all_gather_object(seen, sorted(offsets))
    out["offsets"] = seen
    out["one_row"] = _one_row(tmp, init_device_mesh("cpu", (2, 2),
                                                    mesh_dim_names=("data", "model")))
    return out if rank == 0 else None


def _entry(rank, world, tmp):
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = _ranks(rank, world, tmp)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(tmp, world):
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


def _jax_reference(tmp):
    """The JAX package's step and prefill on each case's weights and batch;
    writes the inputs for the ranks and returns what the JAX package gives."""
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
    for i, (name, (arch, change, _)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(jax_smoke_config(arch), **change)
        model = jax_build_model(cfg, JaxRuntimeConfig(
            compute_dtype=jnp.float32, attn_impl="naive", max_cache_len=CACHE_LEN))
        params = model.init(jax.random.PRNGKey(10 + i))
        train = JaxTrainConfig(optimizer=jax_optimizer.OptimizerConfig(**OPT))
        state = jax_optimizer.make_optimizer(train.optimizer).init(params)
        batch = packed_batch(30 + i, BATCH, S)
        prompt = np.random.default_rng(40 + i).integers(
            3, cfg.vocab_size, size=(BATCH, S)).astype(np.int32)
        torch.save({"params": jax.tree.map(np.asarray, params), "batch": batch,
                    "prompt": prompt}, tmp / f"{name}.pt")
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(params, jbatch)
        new, _, metrics = jax.jit(jax_make_train_step(model, train))(params, state, jbatch)
        logits, _, _ = model.prefill(params, jnp.asarray(prompt))
        want[name] = {"loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "grads": jax.tree.map(np.asarray, grads),
                      "old": jax.tree.map(np.asarray, params),
                      "params": jax.tree.map(np.asarray, new),
                      "logits": np.asarray(logits)}
    for i, arch in enumerate(ONE_ROW_ARCHS):
        cfg = jax_smoke_config(arch)
        model = jax_build_model(cfg, JaxRuntimeConfig(
            compute_dtype=jnp.float32, attn_impl="naive", ssd_impl="xla",
            rglru_impl="xla", max_cache_len=CACHE_LEN))
        params = model.init(jax.random.PRNGKey(20 + i))
        tokens = np.random.default_rng(50 + i).integers(
            3, cfg.vocab_size, size=(1, ONE_ROW_PROMPT)).astype(np.int32)
        logits, cache, pos = jax.jit(model.prefill)(params, jnp.asarray(tokens))
        decode = jax.jit(model.decode_step)
        steps, fed = [np.asarray(logits)], []
        for step in range(DECODE_STEPS):
            fed.append(np.argmax(steps[-1][:, -1], axis=-1)[:, None].astype(np.int32))
            logits, cache = decode(params, cache, jnp.asarray(fed[-1]),
                                   jnp.asarray(int(pos) + step, jnp.int32))
            steps.append(np.asarray(logits))
        torch.save({"params": jax.tree.map(np.asarray, params), "tokens": tokens,
                    "fed": fed}, tmp / f"{arch}.pt")
        want[arch] = steps
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX package's results and the four ranks', once a module."""
    tmp = tmp_path_factory.mktemp("context_parallel")
    want = _jax_reference(tmp)
    return want, _spawn(tmp, 4)


def _own_update(got, want):
    """The JAX package's clip and AdamW update (its train step's) applied to
    the port's own gradients from the JAX step's starting parameters."""
    import jax
    import jax.numpy as jnp

    from repro.train import optimizer as jax_optimizer
    from test_torch_sharded_step import _leaf

    cfg = jax_optimizer.OptimizerConfig(**OPT)
    opt = jax_optimizer.make_optimizer(cfg)
    old = jax.tree.map(jnp.asarray, want["old"])
    grads = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(_leaf(got["grads"], path)), old)
    grads, _ = jax_optimizer.clip_by_norm(grads, cfg.grad_clip)
    new, _ = opt.update(grads, opt.init(old), old)
    return jax.tree.map(np.asarray, new)


def _assert_step_matches(got, want, where):
    """The loss, the gradient norm, every gradient and every parameter's
    change against the JAX step's (tests/test_torch_sharded_step.py's
    checks), but for the change of an element whose JAX gradient is at fp32
    cancellation noise (under ``NOISE_GRAD``): AdamW's first update there,
    lr_t g / (|g| + eps), can take any value in (-lr_t, lr_t) as g moves by
    a rounding.  qwen's K bias has such a gradient (mathematically 0: a bias
    on the keys shifts every score of a query alike), and one element of an
    MLP weight (-1.2e-9 in JAX, -1.8e-9 here, of a gradient norm of 1.46).
    So every element's change, those included, is also held within 2e-6 of
    the JAX optimizer's update of the port's own gradients."""
    import jax

    from test_torch_sharded_step import _leaf

    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    own = _own_update(got, want)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want["params"])[0]:
        msg = f"{where}: {jax.tree_util.keystr(path)}"
        grad, mine = _leaf(want["grads"], path), _leaf(got["grads"], path)
        np.testing.assert_allclose(mine, grad, **TOL, err_msg=msg)
        old = _leaf(want["old"], path)
        change, got_change = leaf - old, _leaf(got["params"], path) - old
        assert np.abs(change).max() > 10 * DELTA_TOL["atol"], msg
        noise = np.abs(grad) < NOISE_GRAD
        np.testing.assert_allclose(got_change[~noise], change[~noise], **DELTA_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(got_change, _leaf(own, path) - old, **DELTA_TOL,
                                   err_msg=f"{msg}, against its own gradients' update")


@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_split_step_matches_the_jax_step(run, name):
    want, got = run
    _assert_step_matches(got[name], want[name], name)
    np.testing.assert_allclose(got[name]["logits"], want[name]["logits"], **TOL,
                               err_msg=f"{name} prefill logits")


def test_gqa_splits_heads_where_only_the_q_heads_divide(run):
    """K/V are repeated to the q heads and the heads split (the rows, which
    cannot split, are never asked for): the output, split by heads on
    "model", equals the whole attention."""
    from repro_torch.kernels.flash_attention import flash_attention

    _, got = run
    assert got["gqa"]["heads_split"]
    whole = flash_attention(*_gqa_inputs(), **GQA_OPTS)
    torch.testing.assert_close(got["gqa"]["out"], whole, atol=1e-6, rtol=1e-6)


def test_each_rank_attends_from_its_own_rows(run):
    """Every attention call of the step and the prefill split S = 32 query
    rows four ways (the prefill's too): rank r's start at 8 r."""
    _, got = run
    assert got["offsets"] == [[(S // 4, r * S // 4)] for r in range(4)]


@pytest.mark.parametrize("arch", ONE_ROW_ARCHS)
def test_one_row_keeps_the_fsdp_shards_and_matches_jax(run, arch):
    want, got = run
    res = got["one_row"][arch]
    assert res["kept"], "no weight kept its FSDP shard at one row"
    assert len(res["logits"]) == len(want[arch]) == DECODE_STEPS + 1
    for i, (g, w) in enumerate(zip(res["logits"], want[arch])):
        assert g.shape == w.shape, (arch, i)
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"{arch} step {i}")


# ---------------------------------------------------------------------------
# One process: a fake group of four ranks, one rank coordinate at a time.
# ---------------------------------------------------------------------------


def _at_rank(rank, fn):
    """``fn(mesh)`` as rank ``rank`` of a fake group of four (no collective
    returns data), on a (1, 4) ("data", "model") cpu mesh."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
    try:
        return fn(init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


ATTN_CASES = {
    # name: (Hq, Hkv, q sharded on its sequence, causal, window, softcap, segments)
    "seq, causal, window, softcap, segments": (4, 2, True, True, 24, 30.0, True),
    "seq, non-causal": (4, 4, True, False, None, None, False),
    "heads do not divide, causal, segments": (6, 2, False, True, None, None, True),
    "heads do not divide, window": (6, 3, False, True, 16, None, False),
}


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_per_shard_rows_give_each_rank_its_rows(case, rank):
    """A rank's local output of the per-shard attention, with the offset of
    its coordinate, equals its quarter of the rows of the whole attention.
    The inputs arrive in the split's layout (q's rows, whole K/V), so no
    collective runs and the fake group's are never read."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attention import flash_attention

    Hq, Hkv, seq, causal, window, cap, segs = ATTN_CASES[case]
    B, Sq, D = 2, 64, 16
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, Sq, h, D)).astype(np.float32))
               for h in (Hq, Hkv, Hkv))
    seg = torch.from_numpy((np.arange(Sq)[None] >= np.array([[20], [41]])).astype(np.int32))
    opts = dict(causal=causal, window=window, softcap=cap, impl="chunked",
                block_q=16, block_k=16)
    whole = flash_attention(q, k, v, q_segments=seg if segs else None,
                            kv_segments=seg if segs else None, **opts)
    rows = slice(rank * Sq // 4, (rank + 1) * Sq // 4)

    def local(mesh):
        rep = [Replicate(), Replicate()]
        q_pl = [Replicate(), Shard(1)] if seq else rep

        def dt(t, pl):
            part = t[:, rows] if pl[1] != Replicate() else t
            return DTensor.from_local(part, mesh, pl, run_check=False, shape=t.shape,
                                      stride=t.stride())

        out = flash_attention(dt(q, q_pl), dt(k, rep), dt(v, rep),
                              q_segments=dt(seg, q_pl) if segs else None,
                              kv_segments=dt(seg, rep) if segs else None, **opts)
        assert out.placements[1] == Shard(1)
        return out.to_local()

    torch.testing.assert_close(_at_rank(rank, local), whole[:, rows], atol=1e-6, rtol=1e-6)


def test_shard_layout_roles():
    """q's sequence sharded: "rows" even where the heads divide; heads that
    divide: "heads"; heads that do not: "rows" (one query row: replicated);
    rows that do not divide: refused."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels._local import shard_layout
    from repro_torch.kernels.flash_attention.ops import Q_ROLES

    def roles(mesh):
        def layout(Sq, Hq, pl):
            q = DTensor.from_local(torch.empty((2, Sq // (4 if pl.is_shard() else 1), Hq, 8),
                                               device="meta"),
                                   mesh, [Replicate(), pl], run_check=False)
            return shard_layout(q, Q_ROLES, (Hq,))[1]

        got = {"seq": layout(32, 8, Shard(1)), "heads": layout(32, 8, Replicate()),
               "uneven heads": layout(32, 6, Replicate()),
               "one row": layout(1, 6, Replicate())}
        with pytest.raises(ValueError, match="query rows do not split"):
            layout(30, 6, Replicate())
        return got

    assert _at_rank(0, roles) == {"seq": ["heads", "rows"], "heads": ["heads", "heads"],
                                  "uneven heads": ["heads", "rows"],
                                  "one row": ["heads", None]}


def test_on_use_keeps_fsdp_where_the_batch_does_not_split():
    """On a (2, 2) mesh: a block's 2-d weights gathered on "data" for an
    input whose batch splits there over several tokens a row, kept sharded
    for one row and for one token a row (decode, where the activation is
    the smaller); ``linear`` then returns the product in x's layout on
    "data" (meta shards, fake group)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.models.common import Kept, linear, on_use, weight
    from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                            shard_model, shard_tree)

    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = ShardingRules(mesh)
        model = build_model(get_smoke_config("mamba2-1.3b"),
                            RuntimeConfig(act_sharding=ActivationSharding(rules)),
                            device="meta")
        shard_model(model, rules)
        block = model.blocks[0]
        D = model.cfg.d_model
        for batch, tokens, spec, want in ((4, 8, ("data", None, None), Replicate()),
                                          (4, 1, ("data", None, None), Shard(0)),
                                          (1, 1, (None, None, None), Shard(0))):
            x = shard_tree(torch.empty((batch, tokens, D), device="meta"), spec, mesh)
            p = on_use(block, x)
            w = p["ssm"]["in_proj"]
            assert weight(w).placements[0] == want, (batch, weight(w).placements)
            assert isinstance(w, Kept) == (tokens == 1)
            assert tokens > 1 or w.dims == (0,)
            y = linear(x, w)
            assert y.placements[0] == x.placements[0]
            assert y.placements[1] == Shard(2)

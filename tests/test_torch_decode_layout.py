"""The sharded decode step, the regroup of a projection and the
sequence-parallel residual stream of the port, each against the JAX
package on the same inputs (and its plain version), and the bytes they
move.

The JAX package runs first, in this process: smoke mixtral-8x22b with 3
experts (2 and 1 KV heads) at one row, and smoke mamba2 and recurrentgemma
at two rows of 32 tokens, each a prefill and three greedy decode steps
(``prefill``, ``decode_step``) on its own weights.  Then four gloo CPU
processes, spawned once for the module (the group made with
``init_method="file://..."`` and a 60 s timeout, every process joined with a
timeout, as tests/test_torch_context_parallel.py does):

- on a (2, 2) ("data", "model") mesh, ``ssd_step`` with the SSM state laid
  out as ``cache_specs`` lays it out (the batch over "data", N over
  "model") and ``rglru_step`` with its state's width over "model" equal the
  plain step and the JAX package's within 3e-4 (fp32), and the state never
  moves: no collective's result is as large as a rank's piece of the state
  (the SSD step moves x and y, the RG-LRU step nothing);
- ``regroup`` of a tensor split on its last dim gives ``torch.split``'s
  pieces and the same gradient, in one all-to-all each way;
- a one-token attention in the cache's own layout (its head dim split where
  the KV heads do not divide "model", its heads where they do) equals the
  plain one, and the cache never moves; the whole decode attention layer
  (``attn_decode``: projections, RoPE, the cache write and the attention)
  on tensor-parallel weights and that cache equals the JAX package's
  ``attn_decode`` on the same numpy weights, output and cache;
- smoke mixtral with 3 experts at one row, with the JAX package's weights
  loaded and the params sharded (the experts keep their FSDP shard of
  d_model), fed the tokens the JAX package chose: the prefill's and every
  decode step's logits equal the JAX package's within 3e-4, with 2 KV heads
  (split by heads) and with 1 (its head dim split);
- on a (1, 4) mesh under ``seqpar``, smoke mamba2's and recurrentgemma's
  prefill, whose residual stream stays split on its sequence (the SSD and
  the RG-LRU scan on the channels' split), and their decode steps after it,
  the same way.

In one process, on a fake group of four: smoke mixtral-8x22b's decode at one
row moves neither the embedding, the output head nor an expert stack: no
collective's result is as large as a rank's piece of any of them.
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
SSD = dict(B=2, H=4, P=8, N=16)
RG = dict(B=2, W=8)
SIZES = (8, 12, 4)                 # regroup's pieces of a last dim of 24
PROMPT, STEPS, CACHE_LEN = 8, 3, 16
SP_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
MIXTRAL_KV = (2, 1)
# 3 experts do not divide "data" (as mixtral's 8 do not divide 16 ranks): the
# expert stacks' FSDP split is on d_model, which they keep at one row
MIXTRAL = dict(n_experts=3)
# name: (arch, config change, layout, mesh, tokens' shape, cache length)
CASES = {
    **{f"mixtral_kv{h}": ("mixtral-8x22b", dict(MIXTRAL, n_kv_heads=h), "baseline",
                          (2, 2), (1, PROMPT), CACHE_LEN) for h in MIXTRAL_KV},
    **{arch: (arch, {}, "seqpar", (1, 4), (2, 4 * PROMPT), 4 * PROMPT + STEPS + 1)
       for arch in SP_ARCHS},
}
# the decode attention layer: a cache of ATTN_LEN slots, written at ATTN_POS
ATTN_LEN, ATTN_POS = 12, 8


def _inputs():
    rng = np.random.default_rng(5)
    B, H, P, N = (SSD[k] for k in "BHPN")
    ssd = {"state": rng.standard_normal((B, H, P, N)),
           "x": rng.standard_normal((B, H, P)),
           "a": rng.uniform(0.5, 1.0, (B, H)),
           "b": rng.standard_normal((B, N)), "c": rng.standard_normal((B, N))}
    B, W = RG["B"], RG["W"]
    rg = {"h": rng.standard_normal((B, W)), "x": rng.standard_normal((B, W)),
          "r": rng.standard_normal((B, W)), "i": rng.standard_normal((B, W)),
          "lam": rng.standard_normal((W,))}
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return f32(ssd), f32(rg), rng.standard_normal((2, 3, sum(SIZES))).astype(np.float32)


class _Spy:
    """The (kind, result bytes) of every collective a ``CollectiveCounter``
    records while it is active."""

    def __init__(self):
        from repro_torch.launch.hlo_analysis import CollectiveCounter, CollectiveStats

        self.seen, self.counter, stats = [], CollectiveCounter(), CollectiveStats
        self._add = stats.add
        spy = self

        def add(s, kind, result_bytes, n):
            spy.seen.append((kind, int(result_bytes)))
            return spy._add(s, kind, result_bytes, n)

        self._stats, self._patched = stats, add

    def __enter__(self):
        self._stats.add = self._patched
        self.counter.__enter__()
        return self

    def __exit__(self, *exc):
        self.counter.__exit__(*exc)
        self._stats.add = self._add


def _steps(mesh):
    """ssd_step, rglru_step and regroup on ``mesh``'s shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels._local import regroup
    from repro_torch.kernels.rglru.ops import rglru_step
    from repro_torch.kernels.ssd.ops import ssd_step
    from repro_torch.train.sharding import ShardingRules, cache_specs, shard_tree

    ssd, rg, x = _inputs()
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    rules = ShardingRules(mesh)
    spec = cache_specs({"ssd": t(ssd["state"])}, rules, SSD["B"])["ssd"]
    out = {"ssd_spec": spec}
    state = shard_tree(t(ssd["state"]), spec, mesh)
    args = [shard_tree(t(ssd[k]), s, mesh) for k, s in
            (("x", ("data", "model", None)), ("a", ("data", "model")),
             ("b", ("data", "model")), ("c", ("data", "model")))]
    with _Spy() as spy:
        y, new = ssd_step(state, *args)
    out["ssd"] = {"y": y.full_tensor(), "state": new.full_tensor(),
                  "state_placements": new.placements, "seen": spy.seen,
                  "local_state_bytes": state.to_local().nbytes}
    spec = cache_specs({"h": t(rg["h"])}, rules, RG["B"])["h"]
    h = shard_tree(t(rg["h"]), spec, mesh)
    args = [shard_tree(t(rg[k]), spec, mesh) for k in "xri"]
    lam = shard_tree(t(rg["lam"]), (None,), mesh)
    with _Spy() as spy:
        y, new = rglru_step(h, *args, lam)
    out["rglru"] = {"y": y.full_tensor(), "h": new.full_tensor(), "seen": spy.seen,
                    "spec": spec}
    whole = t(x).requires_grad_(True)
    xd = DTensor.from_local(whole.detach().chunk(2, dim=-1)[mesh.get_local_rank(1)],
                            mesh, [Replicate(), Shard(2)], run_check=False,
                            shape=whole.shape, stride=whole.stride()).requires_grad_(True)
    weights = [torch.arange(1.0, 1.0 + s) for s in SIZES]
    with _Spy() as spy, implicit_replication():
        pieces = regroup(xd, SIZES)
        loss = sum((p * w).sum() for p, w in zip(pieces, weights))
        loss.backward()
    out["regroup"] = {"pieces": [p.full_tensor().detach() for p in pieces],
                      "placements": [p.placements for p in pieces],
                      "grad": xd.grad.full_tensor(), "seen": spy.seen}
    return out


def _attention(mesh):
    """One query a row against a cache laid out by ``cache_specs``, with 1
    and with 2 KV heads (2 divide "model", 1 does not)."""
    from functools import partial

    from repro_torch.models import attention
    from repro_torch.train.sharding import ShardingRules, cache_specs, shard_tree

    rng = np.random.default_rng(9)
    B, L, Hq, dh = 2, 12, 4, 16
    out = {}
    for hkv in (1, 2):
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, 1, Hq, dh), (B, L, hkv, dh), (B, L, hkv, dh)))
        valid = torch.arange(L)[None, :].expand(B, L) < torch.tensor([[L], [L - 3]])
        spec = cache_specs({"k": k}, ShardingRules(mesh), B)["k"]
        kd, vd = (shard_tree(t, spec, mesh) for t in (k, v))
        qd = shard_tree(q, ("data", None, "model", None), mesh)
        vd_ = shard_tree(valid, ("data", None), mesh)
        with _Spy() as spy:
            got = attention._decode_per_shard(qd, kd, vd, vd_, softcap=20.0)
        out[hkv] = {"got": got.full_tensor(), "spec": spec, "seen": spy.seen,
                    "local_cache_bytes": kd.to_local().nbytes,
                    "want": partial(attention._decode_core, softcap=20.0)(q, k, v, valid)}
    return out


def _attn_case(get_smoke_config, hkv):
    """The decode attention layer's config, numpy weights, input and cache
    (2 rows; the cache's slots past ATTN_POS hold stale values)."""
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"), n_kv_heads=hkv,
                              attn_softcap=20.0)
    rng = np.random.default_rng(11 + hkv)
    D, Hq, dh, B = cfg.d_model, cfg.n_heads, cfg.head_dim, 2
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"wq": {"w": f32(D, Hq * dh) * D ** -0.5},
              "wk": {"w": f32(D, hkv * dh) * D ** -0.5},
              "wv": {"w": f32(D, hkv * dh) * D ** -0.5},
              "wo": {"w": f32(Hq * dh, D) * (Hq * dh) ** -0.5}}
    cache = {"k": f32(B, ATTN_LEN, hkv, dh), "v": f32(B, ATTN_LEN, hkv, dh)}
    return cfg, params, f32(B, 1, D), cache


def _attention_layer(mesh):
    """``attn_decode`` on weights split over "model" (q, k, v by columns,
    the output projection by rows) and a cache laid out by ``cache_specs``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig
    from repro_torch.models.attention import attn_decode
    from repro_torch.train.sharding import ShardingRules, cache_specs, shard_tree

    out = {}
    for hkv in (1, 2):
        cfg, params, x, cache = _attn_case(get_smoke_config, hkv)
        t = torch.from_numpy
        spec = cache_specs({"k": t(cache["k"])}, ShardingRules(mesh), x.shape[0])["k"]
        p = {n: {"w": shard_tree(t(w["w"]), ("model", None) if n == "wo"
                                 else (None, "model"), mesh)} for n, w in params.items()}
        kv = {n: shard_tree(t(c), spec, mesh) for n, c in cache.items()}
        local = kv["k"].to_local().nbytes
        with _Spy() as spy, implicit_replication():
            y, new = attn_decode(p, shard_tree(t(x), (None, None, None), mesh), kv,
                                 ATTN_POS, cfg, RuntimeConfig(compute_dtype=torch.float32))
        out[hkv] = {"y": y.full_tensor(), "k": new["k"].full_tensor(),
                    "v": new["v"].full_tensor(), "seen": spy.seen, "local_cache_bytes": local}
    return out


def _greedy(model, ref, put):
    """Prefill of the JAX package's tokens and a decode step of each token it
    fed; the logits of each, gathered."""
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    logits, cache, pos = model.prefill(put(torch.from_numpy(ref["tokens"])))
    steps = [whole(logits).detach()]
    for i, tok in enumerate(ref["fed"]):
        logits, cache = model.decode_step(cache, put(torch.from_numpy(tok)), pos + i)
        steps.append(whole(logits).detach())
    return steps


def _models(arch, change, mesh, layout, cache_len, params):
    """The plain and the sharded port model, both with the JAX package's
    weights ``params``."""
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.presets import resolve_layout
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train.sharding import ActivationSharding, shard_model

    cfg = dataclasses.replace(get_smoke_config(arch), **change)
    rules, rt_over, _ = resolve_layout(cfg, SHAPES["prefill_32k"], mesh, layout)
    kw = dict(compute_dtype=torch.float32, ssd_impl="chunked", rglru_impl="scan",
              attn_impl="ref", max_cache_len=cache_len)
    plain = build_model(cfg, RuntimeConfig(**kw), device="cpu", seed=4)
    sharded = build_model(cfg, RuntimeConfig(act_sharding=ActivationSharding(rules),
                                             **kw, **rt_over), device="cpu", seed=4)
    plain.load_jax_params(params)
    sharded.load_jax_params(params)
    shard_model(sharded, rules)
    return plain, sharded


def _model_runs(tmp):
    import contextlib

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.sharding import shard_tree

    out = {}
    for name, (arch, change, layout, shape, _, cache_len) in CASES.items():
        ref = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        put = lambda t: shard_tree(t, (None,) * t.dim(), mesh)  # noqa: E731
        plain, sharded = _models(arch, change, mesh, layout, cache_len, ref["params"])
        # (the sequence-parallel prefill runs as serving does, in inference mode)
        mode = torch.inference_mode if layout == "seqpar" else contextlib.nullcontext
        with implicit_replication(), mode():
            got = _greedy(sharded, ref, put)
        with mode():
            want = _greedy(plain, ref, lambda t: t)
        out[name] = {"got": got, "plain": want}
    return out


def _ranks(rank, world, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {"steps": _steps(mesh), "attention": _attention(mesh),
           "attention_layer": _attention_layer(mesh)}
    out["models"] = _model_runs(tmp)
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


def _jax_reference(tmp):
    """The JAX package's greedy prefill and decode steps of each case, on
    its own weights (saved with the tokens for the ranks): the logits of
    each step."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import RuntimeConfig, build_model

    want = {}
    for i, (name, (arch, change, _, _, shape, cache_len)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(get_smoke_config(arch), **change)
        model = build_model(cfg, RuntimeConfig(
            compute_dtype=jnp.float32, attn_impl="naive", ssd_impl="xla",
            rglru_impl="xla", max_cache_len=cache_len))
        params = model.init(jax.random.PRNGKey(30 + i))
        tokens = np.random.default_rng(60 + i).integers(
            3, cfg.vocab_size, size=shape).astype(np.int32)
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


def _jax_attention(hkv):
    """The JAX package's ``attn_decode`` of :func:`_attn_case`: y, k, v."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models.attention import attn_decode

    cfg, params, x, cache = _attn_case(get_smoke_config, hkv)
    y, new = attn_decode(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                         jax.tree.map(jnp.asarray, cache), jnp.asarray(ATTN_POS, jnp.int32),
                         cfg, None)
    return np.asarray(y), np.asarray(new["k"]), np.asarray(new["v"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results (rank 0's), with the JAX package's greedy
    runs under ``"jax"``, once a module."""
    tmp = tmp_path_factory.mktemp("decode_layout")
    want = _jax_reference(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, 4, str(tmp))) for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    errs = {r: (tmp / f"err{r}.txt").read_text() for r in range(4)
            if (tmp / f"err{r}.txt").exists()}
    assert not hung, f"ranks {hung} did not finish within {JOIN_TIMEOUT_S} s; {errs}"
    assert all(p.exitcode == 0 for p in procs), errs
    out = torch.load(tmp / "out0.pt", weights_only=False)
    out["jax"] = want
    return out


def test_ssd_step_runs_in_the_states_layout(run):
    """Against the port's plain step and the JAX package's, and the state
    (the batch over "data", N over "model") never moves."""
    import jax.numpy as jnp

    from repro.kernels.ssd.ref import ssd_step_reference as jax_step
    from repro_torch.kernels.ssd.ref import ssd_step_reference

    got = run["steps"]["ssd"]
    assert run["steps"]["ssd_spec"] == (("data",), None, None, "model")
    ssd, _, _ = _inputs()
    args = [ssd[k] for k in ("state", "x", "a", "b", "c")]
    y, state = ssd_step_reference(*map(torch.from_numpy, args))
    jy, jstate = jax_step(*map(jnp.asarray, args))
    for g, w, j in ((got["y"], y, jy), (got["state"], state, jstate)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)
    assert [p.is_shard(3) for p in got["state_placements"]] == [False, True]
    assert got["seen"], "y's partial sums were not reduced"
    assert max(b for _, b in got["seen"]) < got["local_state_bytes"], got["seen"]


def test_rglru_step_moves_nothing(run):
    import jax.numpy as jnp

    from repro.kernels.rglru.ref import rglru_step_reference as jax_step
    from repro_torch.kernels.rglru.ref import rglru_step_reference

    got = run["steps"]["rglru"]
    assert got["spec"] == (("data",), "model")
    _, rg, _ = _inputs()
    args = [rg[k] for k in ("h", "x", "r", "i", "lam")]
    y, h = rglru_step_reference(*map(torch.from_numpy, args))
    jy, jh = jax_step(*map(jnp.asarray, args))
    for g, w, j in ((got["y"], y, jy), (got["h"], h, jh)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)
    assert got["seen"] == []


def test_regroup_splits_in_one_all_to_all(run):
    got = run["steps"]["regroup"]
    _, _, x = _inputs()
    want = torch.split(torch.from_numpy(x), SIZES, dim=-1)
    for g, w, pl in zip(got["pieces"], want, got["placements"]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        assert pl[1].is_shard(2)
    grad = torch.cat([torch.arange(1.0, 1.0 + s).expand(2, 3, s) for s in SIZES], dim=-1)
    np.testing.assert_array_equal(got["grad"].numpy(), grad.numpy())
    kinds = [k for k, _ in got["seen"]]
    assert kinds.count("all-to-all") == 2 and "all-gather" not in kinds, got["seen"]


@pytest.mark.parametrize("hkv", (1, 2))
def test_decode_attention_reads_the_cache_where_it_lies(run, hkv):
    """1 KV head: the head dim split on "model" (partial scores, all-reduced);
    2: the heads split.  The cache never moves, in the attention alone and in
    the whole layer, which equals the JAX package's ``attn_decode``."""
    got = run["attention"][hkv]
    assert got["spec"] == (("data",), None, "model" if hkv == 2 else None,
                           None if hkv == 2 else "model")
    np.testing.assert_allclose(got["got"].numpy(), got["want"].numpy(), **TOL)
    assert all(b < got["local_cache_bytes"] for _, b in got["seen"]), got["seen"]
    if hkv == 2:
        assert got["seen"] == []
    layer = run["attention_layer"][hkv]
    for g, w in zip((layer["y"], layer["k"], layer["v"]), _jax_attention(hkv)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert all(b < layer["local_cache_bytes"] for _, b in layer["seen"]), layer["seen"]


def _assert_matches_jax(run, name):
    """The sharded port's logits at every step against the JAX package's,
    and the plain port's too."""
    res, want = run["models"][name], run["jax"][name]
    assert len(res["got"]) == len(res["plain"]) == len(want) == STEPS + 1
    for i, (g, p, w) in enumerate(zip(res["got"], res["plain"], want)):
        assert g.shape == w.shape, (name, i)
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"{name} step {i}")
        np.testing.assert_allclose(p.numpy(), w, **TOL, err_msg=f"{name} step {i}, plain")


@pytest.mark.parametrize("hkv", MIXTRAL_KV)
def test_one_row_mixtral_decode_matches_the_plain_model(run, hkv):
    """Prefill and greedy decode at one row, sharded, against the JAX
    package's on the same weights (and the plain port model)."""
    _assert_matches_jax(run, f"mixtral_kv{hkv}")


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sequence_parallel_prefill_matches_the_plain_model(run, arch):
    """Prefill under ``seqpar`` and greedy decode after it, sharded, against
    the JAX package's on the same weights (and the plain port model)."""
    _assert_matches_jax(run, arch)


def test_one_row_decode_moves_no_weight():
    """Smoke mixtral-8x22b's decode step at one row on a fake (2, 2) group:
    the embedding, the output head and the expert stacks stay where they
    lie (no collective is as large as a rank's piece of any of them)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                            shard_model, shard_tree)

    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = ShardingRules(mesh)
        model = build_model(dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                                                **MIXTRAL),
                            RuntimeConfig(max_cache_len=CACHE_LEN,
                                          act_sharding=ActivationSharding(rules)),
                            device="meta")
        shard_model(model, rules)
        smallest = min(p.to_local().nbytes for n, p in model.named_parameters()
                       if p.dim() == 3 or n in ("embed", "lm_head"))
        with implicit_replication(), torch.inference_mode():
            cache = model.init_cache(1)
        token = shard_tree(torch.zeros((1, 1), dtype=torch.int32, device="meta"),
                           (None, None), mesh)
        with _Spy() as spy, implicit_replication():
            model.decode_step(cache, token, CACHE_LEN - 1)
    assert spy.seen
    assert max(b for _, b in spy.seen) < smallest, (smallest, sorted(spy.seen)[-3:])

"""Checkpoints through the platform, across packages, and the driver's
bit-exact resume.

A checkpoint written by the port (``repro_torch.train.checkpoint``) must load
in the JAX package and one written by the JAX package in the port, with the
same params and optimizer trees (bit for bit: the records are raw bytes) and
logits within fp32 3e-4 (tests/test_kernels.py::_tol).  Both packages open
one repository directory.  The records keep the reference's names, attrs,
tags and lineage; bf16 params cross as raw bits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.platform import Platform as JaxPlatform  # noqa: E402
from repro.train import checkpoint as jax_checkpoint  # noqa: E402
from repro.train import optimizer as jax_optimizer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Record  # noqa: E402
from repro_torch.core.lineage import EdgeKind, NodeKind  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402
from repro_torch.train import checkpoint, make_optimizer  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.weights import params_to_jax  # noqa: E402

TOL = dict(atol=3e-4, rtol=3e-4)
DATASET = "checkpoints/smoke"
CASES = {"mamba2-1.3b": 2, "recurrentgemma-9b": 5}     # arch -> n_layers


def _pair(arch, param_dtype):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if param_dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    n_layers = CASES[arch]
    jmodel = jax_build_model(
        dataclasses.replace(jax_smoke_config(arch), n_layers=n_layers),
        JaxRuntimeConfig(param_dtype=jdt, compute_dtype=jnp.float32,
                         attn_impl="naive", ssd_impl="xla", rglru_impl="xla"))
    tmodel = build_model(
        dataclasses.replace(get_smoke_config(arch), n_layers=n_layers),
        RuntimeConfig(param_dtype=tdt, compute_dtype=torch.float32, attn_impl="ref",
                      ssd_impl="chunked", rglru_impl="scan"),
        device="cpu", seed=7)
    return jmodel, tmodel


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(got_np, want):
    """``got_np``: params_to_jax output (bf16 as uint16 bits)."""
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert leaves
    for path, leaf in leaves:
        node = got_np
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(_bits(node), _bits(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def _logits_close(jmodel, jparams, tmodel):
    tokens = np.random.default_rng(0).integers(3, 512, size=(2, 48)).astype(np.int32)
    want = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tmodel({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _one_adamw_step(params, opt_state):
    """Move the port's state off its init so the checkpoint carries data."""
    opt = make_optimizer(OptimizerConfig(lr=1e-2, warmup_steps=0))
    grads = {k: torch.full_like(p, 0.5, dtype=torch.float32) for k, p in params.items()}
    return opt.update(grads, opt_state, params)


@pytest.mark.parametrize("arch,param_dtype", [
    ("mamba2-1.3b", "float32"), ("mamba2-1.3b", "bfloat16"),
    ("recurrentgemma-9b", "float32")])
def test_port_checkpoint_loads_in_the_reference(tmp_path, arch, param_dtype):
    jmodel, tmodel = _pair(arch, param_dtype)
    period = len(tmodel.pattern)
    params = dict(tmodel.named_parameters())
    opt_state = make_optimizer(OptimizerConfig()).init(params)
    with torch.no_grad():
        params, opt_state = _one_adamw_step(params, opt_state)
    plat = Platform.open(str(tmp_path), actor="trainer")
    cid = checkpoint.save_checkpoint(
        plat.manager, DATASET, 1, params, opt_state, extra={"loader": {"step": 1}},
        period=period)

    jplat = JaxPlatform.open(str(tmp_path), actor="trainer")
    like_p = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    like_o = jax.eval_shape(jax_optimizer.make_optimizer(
        jax_optimizer.OptimizerConfig()).init, like_p)
    jparams, jopt, extra = jax_checkpoint.load_checkpoint(
        jplat.manager, DATASET, like_p, like_o)
    assert extra == {"loader": {"step": 1}}
    assert jax_checkpoint.latest_step(jplat.manager, DATASET) == 1
    _assert_trees_equal(params_to_jax(params, period), jparams)
    for moment in ("m", "v"):
        _assert_trees_equal(params_to_jax(opt_state[moment], period), jopt[moment])
    assert int(jopt["step"]) == 1 and jopt["step"].dtype == jnp.int32
    _logits_close(jmodel, jparams, tmodel)
    assert cid


@pytest.mark.parametrize("arch,param_dtype", [
    ("mamba2-1.3b", "float32"), ("mamba2-1.3b", "bfloat16"),
    ("recurrentgemma-9b", "float32")])
def test_reference_checkpoint_loads_in_the_port(tmp_path, arch, param_dtype):
    jmodel, tmodel = _pair(arch, param_dtype)
    period = len(tmodel.pattern)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    jopt_fn = jax_optimizer.make_optimizer(jax_optimizer.OptimizerConfig(lr=1e-2))
    jopt = jopt_fn.init(jparams)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5), jparams)
    jparams, jopt = jax.jit(jopt_fn.update)(grads, jopt, jparams)
    jplat = JaxPlatform.open(str(tmp_path), actor="trainer")
    jax_checkpoint.save_checkpoint(jplat.manager, DATASET, 1, jparams, jopt,
                                   extra={"loader": {"step": 1}})

    plat = Platform.open(str(tmp_path), actor="trainer")
    like_p = dict(tmodel.named_parameters())
    like_o = make_optimizer(OptimizerConfig()).init(like_p)
    params, opt_state, extra = checkpoint.load_checkpoint(
        plat.manager, DATASET, like_p, like_o, period=period)
    assert extra == {"loader": {"step": 1}}
    assert set(params) == set(like_p)
    assert all(params[k].dtype == p.dtype for k, p in like_p.items())
    _assert_trees_equal(params_to_jax(params, period), jparams)
    for moment in ("m", "v"):
        _assert_trees_equal(params_to_jax(opt_state[moment], period), jopt[moment])
    assert opt_state["step"].dtype == torch.int32 and int(opt_state["step"]) == 1
    tmodel.load_state_dict(params)
    _logits_close(jmodel, jparams, tmodel)


def test_tags_latest_step_and_lineage():
    _, tmodel = _pair("mamba2-1.3b", "float32")
    params = dict(tmodel.named_parameters())
    plat = Platform.open(actor="trainer")
    dm = plat.manager
    plat.dataset("corpus").check_in([Record("r0", b"x", {})], actor="ingest")
    snap = plat.dataset("corpus").checkout()
    dm.lineage.add_node("train_run:1", NodeKind.WORKFLOW_RUN)
    c7 = checkpoint.save_checkpoint(dm, DATASET, 7, params, period=1,
                                    data_snapshot_id=snap.snapshot_id,
                                    run_node="train_run:1")
    c9 = checkpoint.save_checkpoint(dm, DATASET, 9, params, period=1)
    assert checkpoint.latest_step(dm, DATASET) == 9
    tags = dm.versions.list_tags(DATASET)
    assert {"step-7", "step-9", "latest"} <= set(tags)
    snap7 = dm.checkout(DATASET, "trainer", rev="step-7", register_snapshot=False)
    assert snap7.commit_id == c7 != c9
    ids = set(snap7.iter_record_ids())
    assert "params/blocks/pos0/ssm/in_proj" in ids and "params/embed" in ids
    attrs = snap7.attrs("params/blocks/pos0/ssm/in_proj")
    assert attrs["shape"][0] == 2 and attrs["dtype"] == "float32"
    assert attrs["shard"] == "full"
    node = checkpoint.checkpoint_node_id(DATASET, 7)
    assert node == f"checkpoint:{DATASET}@step7"
    assert dm.lineage.node(node).kind == NodeKind.CHECKPOINT
    derived = {e.dst for e in dm.lineage.edges_out(node, EdgeKind.DERIVED_FROM)}
    assert snap.snapshot_id in derived and len(derived) == 2
    anc = dm.lineage.ancestors(node)
    assert "train_run:1" in anc and snap.snapshot_id in anc


def test_driver_resumes_bit_exact_after_a_kill():
    args = ["--smoke", "--device", "cpu", "--steps", "6", "--checkpoint-every", "3",
            "--batch", "4", "--seq-len", "32"]
    full = train_main(args)
    killed = train_main(args + ["--kill-at", "3"])
    assert len(full["losses"]) == len(killed["losses"]) == 6
    assert killed["losses"][3:] == full["losses"][3:]           # bit for bit
    assert killed["loader"].state() == full["loader"].state()
    assert killed["ckpt_load_s"] is not None and full["ckpt_load_s"] is None
    assert np.isfinite(full["losses"]).all() and full["steps"] == 6
    assert len(full["step_s"]) == 6
    for run in (full, killed):
        snap = run["dm"].checkout("checkpoints/mamba2-1.3b", "trainer",
                                  register_snapshot=False)
        run["digest"] = {rid: snap.read(rid) for rid in snap.iter_record_ids()
                         if rid != "extra.json"}
    assert killed["digest"] == full["digest"]                   # params, m, v


def test_driver_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--smoke", "--steps", "1"])

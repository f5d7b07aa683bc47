"""The port's ServeEngine against the JAX package's (tests/test_serve_engine.py
for mamba2 and recurrentgemma): on the same weights, greedy tokens must agree
token for token, including EOS stopping and how the queue drains in waves."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_driver  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "mamba2-1.3b"
JRT = JaxRuntimeConfig(compute_dtype=jnp.float32, attn_impl="naive",
                       ssd_impl="xla", rglru_impl="xla", max_cache_len=64)
TRT = RuntimeConfig(compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config(ARCH), JRT)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_smoke_config(ARCH), TRT, device="cpu")
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _serve_both(models, prompts, max_batch, **submit_kw):
    jmodel, jparams, tmodel = models
    jeng = JaxServeEngine(jmodel, jparams, max_batch=max_batch)
    teng = ServeEngine(tmodel, max_batch=max_batch)
    for p in prompts:
        jeng.submit(p, **submit_kw)
        teng.submit(p, **submit_kw)
    return jeng.run(), teng.run(), teng


def test_single_request_matches_jax(models):
    prompt = np.arange(3, 19, dtype=np.int32)
    [jreq], [treq], _ = _serve_both(models, [prompt], 4, max_new_tokens=8)
    assert treq.output == jreq.output and len(treq.output) == 8


def test_batched_equal_prompts_match_jax(models):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, 512, size=6).astype(np.int32) for _ in range(2)]
    jdone, tdone, _ = _serve_both(models, prompts, 2, max_new_tokens=4)
    assert [r.output for r in tdone] == [r.output for r in jdone]


def test_eos_stops_early(models):
    prompt = np.arange(3, 13, dtype=np.int32)
    [jfull], [tfull], _ = _serve_both(models, [prompt], 4, max_new_tokens=8)
    assert tfull.output == jfull.output
    eos = tfull.output[2]
    [jreq], [treq], _ = _serve_both(models, [prompt], 4, max_new_tokens=8,
                                    eos_id=eos)
    assert treq.output == jreq.output == tfull.output[:tfull.output.index(eos) + 1]
    assert treq.done


def test_queue_drains_in_waves(models):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 100, size=n).astype(np.int32)
               for n in (8, 8, 5, 8, 8, 5)]
    jdone, tdone, teng = _serve_both(models, prompts, 2, max_new_tokens=3)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.wave for r in tdone] == [r.wave for r in jdone]
    assert len({r.wave for r in tdone}) == 3     # 8+8, then 5+5, then 8+8
    assert teng.pending() == 0
    assert [s["prompt_len"] for s in teng.wave_stats] == [8, 5, 8]


def test_temperature_sampling_is_seeded(models):
    _, _, tmodel = models
    outs = []
    for _ in range(2):
        eng = ServeEngine(tmodel, max_batch=2, seed=7)
        eng.submit(np.arange(3, 11, dtype=np.int32), max_new_tokens=5,
                   temperature=1.0)
        eng.submit(np.arange(11, 19, dtype=np.int32), max_new_tokens=5)
        outs.append([r.output for r in eng.run()])
    assert outs[0] == outs[1]


def test_serve_driver_runs_on_cpu():
    out = serve_driver.main(["--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "16", "--gen", "3"])
    assert out["tokens"].shape == (2, 3)


RG_ARCH = "recurrentgemma-9b"


@pytest.fixture(scope="module")
def rg_models():
    """recurrentgemma smoke config with 5 layers (2 unscanned tail layers),
    local window 32 in a 64-slot ring."""
    import dataclasses
    jcfg = dataclasses.replace(jax_smoke_config(RG_ARCH), n_layers=5)
    jmodel = jax_build_model(jcfg, JRT)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke_config(RG_ARCH), n_layers=5)
    tmodel = build_model(tcfg, TRT.with_(max_cache_len=64), device="cpu")
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def test_recurrentgemma_greedy_matches_jax(rg_models):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 512, size=n).astype(np.int32)
               for n in (16, 16, 80, 80)]
    jdone, tdone, teng = _serve_both(rg_models, prompts, 2, max_new_tokens=6)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.wave for r in tdone] == [r.wave for r in jdone]
    assert all(len(r.output) == 6 and r.done for r in tdone)
    assert [s["prompt_len"] for s in teng.wave_stats] == [16, 80]


def test_recurrentgemma_eos_stops_early(rg_models):
    prompt = np.arange(3, 43, dtype=np.int32)
    [jfull], [tfull], _ = _serve_both(rg_models, [prompt], 4, max_new_tokens=6)
    assert tfull.output == jfull.output
    eos = tfull.output[3]
    [jreq], [treq], _ = _serve_both(rg_models, [prompt], 4, max_new_tokens=6,
                                    eos_id=eos)
    assert treq.output == jreq.output == tfull.output[:tfull.output.index(eos) + 1]


def test_serve_driver_runs_recurrentgemma_on_cpu():
    out = serve_driver.main(["--arch", RG_ARCH, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "40", "--gen", "30"])
    assert out["tokens"].shape == (2, 30)       # decode runs past the window

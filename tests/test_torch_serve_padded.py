"""Padded serving waves: the port's ServeEngine against the JAX package's
(tests/test_serve_engine.py) and against each prompt decoded alone.

Attention-only families take the first ``max_batch`` queued requests
whatever their lengths, LEFT-pad them to the longest, mask the pads by
segment and pass ``context_start`` to every decode step.  Greedy tokens must
be equal token for token (fp32 compute at smoke size, where RoPE's shift
equivariance holds to the last greedy token), and each row's logits, at
prefill and at every decode step, must match those of its prompt decoded
alone within 3e-4: gemma2's smoke model gives the same greedy token over and
over, so its tokens alone would not see a pad attended.  For gemma2 and
gemma3 the prompts straddle their local window (32), and one passes the
128-slot ring of their local layers, so the ring's shifted write and the
window and pad masks all run on one wave; qwen2.5 adds QKV bias and
internvl2 is served text-only, as both engines serve it.  Stateful families
keep equal-length waves.
"""

import dataclasses

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
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

CACHE_LEN = 176


def _pair(arch, cache_len=CACHE_LEN, **cfg_changes):
    jrt = JaxRuntimeConfig(compute_dtype=jnp.float32, attn_impl="naive",
                           ssd_impl="xla", rglru_impl="xla", max_cache_len=cache_len)
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **cfg_changes),
                             jrt)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(dataclasses.replace(get_smoke_config(arch), **cfg_changes),
                         RuntimeConfig(compute_dtype=torch.float32,
                                       max_cache_len=cache_len), device="cpu")
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def stablelm():
    return _pair("stablelm-1.6b")


@pytest.fixture(scope="module")
def gemma2():
    return _pair("gemma2-9b")


@pytest.fixture(scope="module")
def qwen25():
    return _pair("qwen2.5-32b")


@pytest.fixture(scope="module")
def internvl2():
    return _pair("internvl2-2b")


@pytest.fixture(scope="module")
def gemma3():
    return _pair("gemma3-12b")


def _serve_both(models, prompts, max_batch, **submit_kw):
    jmodel, jparams, tmodel = models
    jeng = JaxServeEngine(jmodel, jparams, max_batch=max_batch)
    teng = ServeEngine(tmodel, max_batch=max_batch)
    for p in prompts:
        jeng.submit(p, **submit_kw)
        teng.submit(p, **submit_kw)
    return jeng.run(), teng.run(), teng


def _alone(tmodel, prompt, n):
    """The port's greedy decode of one prompt, unpadded: (tokens, the logits
    each token was drawn from)."""
    logits, cache, pos = tmodel.prefill(torch.as_tensor(prompt)[None].long())
    out, seen = [], []
    for i in range(n):
        seen.append(logits[0, -1])
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(int(tok))
        if i + 1 < n:
            logits, cache = tmodel.decode_step(cache, tok, pos + i)
    return out, seen


class _Recorded:
    """Records the logits of every prefill and decode step of ``model``."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        out = self.model.prefill(*args, **kw)
        self.logits.append(out[0][:, -1])
        return out

    def decode_step(self, *args, **kw):
        out = self.model.decode_step(*args, **kw)
        self.logits.append(out[0][:, -1])
        return out


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch,lengths", [
    ("stablelm-1.6b", (5, 11, 16)),          # tests/test_serve_engine.py's wave
    ("gemma2-9b", (5, 11, 16)),
    ("gemma2-9b", (20, 33, 45)),             # straddling the local window (32)
    ("gemma2-9b", (31, 150, 97)),            # the longest passes the 128-slot ring
    ("qwen2.5-32b", (5, 11, 16)),            # QKV bias, GQA 2
    ("internvl2-2b", (5, 11, 16)),           # text only, as both engines serve it
    ("gemma3-12b", (20, 33, 45)),            # 5:1 local/global, window 32
    ("gemma3-12b", (31, 150, 97)),
])
def test_unequal_prompts_match_jax_and_decoding_alone(arch, lengths, request):
    jmodel, jparams, tmodel = request.getfixturevalue(
        arch.split("-")[0].replace(".", ""))
    recorded = _Recorded(tmodel)
    prompts = _prompts(len(lengths) + lengths[0], lengths)
    jdone, tdone, teng = _serve_both((jmodel, jparams, recorded), prompts, 3,
                                     max_new_tokens=6)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert len(recorded.logits) == 6                # prefill and 5 decode steps
    for row, (req, prompt) in enumerate(zip(tdone, prompts)):
        tokens, logits = _alone(tmodel, prompt, 6)
        assert req.output == tokens, req.req_id
        for step, want in enumerate(logits):
            np.testing.assert_allclose(recorded.logits[step][row].numpy(), want.numpy(),
                                       atol=3e-4, rtol=3e-4, err_msg=f"row {row} step {step}")
    [stats] = teng.wave_stats
    assert stats["prompt_lens"] == list(lengths)
    assert stats["prompt_len"] == max(lengths) and stats["batch"] == 3


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma2-9b"])
def test_padded_wave_stops_each_row_at_its_eos(arch, request):
    models = request.getfixturevalue(arch.split("-")[0].replace(".", ""))
    prompts = _prompts(9, (7, 19))
    _, full, _ = _serve_both(models, prompts, 2, max_new_tokens=8)
    eos = full[1].output[2]                    # the long row's third token
    jdone, tdone, _ = _serve_both(models, prompts, 2, max_new_tokens=8, eos_id=eos)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    for got, want in zip(tdone, full):
        cut = want.output.index(eos) + 1 if eos in want.output else len(want.output)
        assert got.output == want.output[:cut] and got.done


def test_queue_drains_in_padded_waves_of_2_2_1(gemma2):
    prompts = _prompts(4, (8, 5, 40, 3, 6))
    jdone, tdone, teng = _serve_both(gemma2, prompts, 2, max_new_tokens=3)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.wave for r in tdone] == [r.wave for r in jdone] == [0, 0, 1, 1, 2]
    assert [s["prompt_lens"] for s in teng.wave_stats] == [[8, 5], [40, 3], [6]]
    assert [s["prompt_len"] for s in teng.wave_stats] == [8, 40, 6]
    assert teng.pending() == 0


@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", 2), ("recurrentgemma-9b", 5)])
def test_stateful_families_keep_equal_length_waves(arch, n_layers):
    models = _pair(arch, cache_len=64, n_layers=n_layers)
    prompts = _prompts(6, (16, 9, 16, 9, 12))
    jdone, tdone, teng = _serve_both(models, prompts, 4, max_new_tokens=4)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.wave for r in tdone] == [r.wave for r in jdone] == [0, 1, 0, 1, 2]
    assert [s["prompt_lens"] for s in teng.wave_stats] == [[16, 16], [9, 9], [12]]


def test_recurrentgemma_serves_700_token_prompts():
    """700 is a multiple of neither the reference's RG-LRU chunk (256) nor the
    flash blocks (512 / 1024): the port's routes take it."""
    models = _pair("recurrentgemma-9b", cache_len=704, n_layers=3)
    prompts = _prompts(7, (700, 700))
    jdone, tdone, teng = _serve_both(models, prompts, 2, max_new_tokens=4)
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert all(len(r.output) == 4 for r in tdone)
    assert teng.wave_stats[0]["prompt_lens"] == [700, 700]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2.5-32b", "gemma2-9b",
                                  "gemma3-12b", "internvl2-2b", "mixtral-8x22b",
                                  "arctic-480b", "seamless-m4t-medium"])
def test_serve_cli_runs_attention_families_on_cpu(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "40", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    # on CPU tensors every route is the plain version: no kernel launched,
    # and the command says so before its timings
    assert out["launches"] == {"flash_fwd_wgmma": 0, "flash_fwd": 0,
                               "ssd_fwd_wgmma": 0, "ssd_fwd": 0, "rglru_fwd": 0}
    printed = capsys.readouterr().out
    assert printed.index("kernel launches: flash_fwd_wgmma=0") < printed.index("prefill:")

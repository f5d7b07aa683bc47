"""The plain reference agrees with the port's plain CPU path (float32
compute, the chunked attention, no dropped tokens) on the smoke configs:
logits of a prefill and of decode steps through the cache, and every
served token of padded waves through the engine."""

import pytest
import torch

from portbench import harness
from portbench.reference.decoder import Reference
from portbench.tests.smoke import dense_smoke_config, smoke_cell

CELLS = ["mixtral-8x22b-d8.eval_score", "mixtral-8x22b-d8.gen_long"]


def _fp32(cell):
    cell.config = dict(cell.config, compute_dtype="float32")
    return cell


def _model(cell, seed):
    from repro_torch.configs import get_smoke_config
    return harness.build_program(cell.config, seed, "cpu", get_smoke_config)


@pytest.mark.parametrize("dense", [False, True], ids=["moe", "dense"])
def test_prefill_and_decode_logits(dense):
    cell = _fp32(smoke_cell(CELLS[0]))
    if dense:
        cell.config = dict(dense_smoke_config(), compute_dtype="float32")
    model = _model(cell, 11)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cell.config["vocab_size"], (1, 13), generator=gen)
    with torch.inference_mode():
        logits, cache, n = model.prefill(tokens[:, :10])
        got = [logits[0, -1]]
        for i in range(10, 13):
            logits, cache = model.decode_step(cache, tokens[:, i:i + 1], i)
            got.append(logits[0, -1])
    got = torch.stack(got)[:, : cell.config["vocab_size"]]
    want = Reference(cell.config, 11, "cpu").logits([tokens[0]], [torch.arange(9, 13)])[0]
    assert torch.allclose(got, want, atol=1e-4 * want.abs().max(), rtol=0)


@pytest.mark.parametrize("workload", CELLS)
def test_served_tokens_are_the_reference_best(workload):
    cell = _fp32(smoke_cell(workload, clients=4, judge=6))
    run = harness.Run(cell, _model(cell, 5), 5)
    run.window(0.0)
    run.window(0.0)
    verdict, _ = harness.judge(cell, run.requests, run.model.prefills, 5, "cpu")
    assert verdict["judged_requests"] == 6
    assert verdict["max_logit_gap"] < 1e-4
    assert verdict["logit_error_max"] < 1e-4


def test_a_program_that_drops_tokens_differs():
    """With the program's default capacity (1.25) the smoke MoE drops
    tokens, and its logits leave the reference's: the reason the
    configuration runs it at E / k."""
    cell = _fp32(smoke_cell("mixtral-8x22b-d8.eval_score"))
    cell.config["runtime"] = dict(cell.config["runtime"], capacity_factor=1.0)
    model = _model(cell, 3)
    tokens = torch.randint(0, cell.config["vocab_size"], (1, 64),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = model.prefill(tokens)[0][0, -1, : cell.config["vocab_size"]]
    want = Reference(cell.config, 3, "cpu").logits([tokens[0]], [torch.tensor([63])])[0][0]
    assert not torch.allclose(got, want, atol=1e-3 * want.abs().max(), rtol=0)

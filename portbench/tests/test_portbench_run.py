"""A CPU rehearsal of ``run.py`` on the smoke cells: the result line's keys,
the metrics each cell reports, the numbers compared last; and the command
refuses to run without a card."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness, run
from portbench.tests.smoke import smoke_cell

CELLS = ["mixtral-8x22b-d8.eval_score", "mixtral-8x22b-d8.gen_long"]
SEED = 3 * 2 ** 31 + 11          # larger than 32 signed bits


def _run(workload, trace, **kw):
    from repro_torch.configs import get_smoke_config
    return run.run_cell(smoke_cell(workload, **kw), SEED, 0.0, trace, device="cpu",
                        base_config=get_smoke_config)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, trace):
    cell = harness.load_cell(workload)
    result = _run(workload, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert json.loads(json.dumps(result)) == result
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        wanted.discard("flash_fwd_wgmma_roofline")       # no such kernel on the CPU
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert set(result["metrics"]) == wanted
    assert all(v["value"] > 0 for k, v in result["metrics"].items()
               if not k.startswith("device_idle"))
    assert set(result["checks"]) == {"failed_requests", *cell.spec["limits"]}


def test_the_same_seed_serves_the_same_tokens():
    from repro_torch.configs import get_smoke_config
    outs = []
    for _ in range(2):
        cell = smoke_cell("mixtral-8x22b-d8.gen_long")
        r = harness.Run(cell, harness.build_program(cell.config, SEED, "cpu",
                                                    get_smoke_config), SEED)
        r.window(0.0)
        assert r.requests
        outs.append([(list(q["prompt"]), q["output"]) for q in r.requests])
    assert outs[0] == outs[1]


def test_no_card_no_result(capsys):
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert run.main(["--workload", CELLS[1], "--seed", "1", "2", "--seconds", "1",
                     "--control", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_alone_it_exits_non_zero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_window_runs_whole_cycles_through_the_engines_queue():
    """The job keeps ``clients`` requests in the engine, more than a wave
    holds, and the window ends with whole cycles of the traffic; each
    request's time to first token runs from its own submission."""
    from repro_torch.configs import get_smoke_config
    cell = smoke_cell("mixtral-8x22b-d8.eval_score", clients=4)
    assert cell.spec["max_batch"] == 2
    r = harness.Run(cell, harness.build_program(cell.config, SEED, "cpu",
                                                get_smoke_config), SEED)
    rec = r.window(0.3)
    cycle = 2 * cell.mix["cycle_waves"]
    assert len(rec["requests"]) % cycle == 0 and len(rec["requests"]) >= cycle
    assert all(w["batch"] == 2 for w in rec["waves"])
    assert len(rec["waves"]) == len(rec["requests"]) // 2
    waits = {round(q["ttft_s"], 6) for q in rec["requests"]}
    assert len(waits) > 1 and min(waits) > 0
    for w in rec["waves"]:
        assert sorted(w["output_lens"]) == [1, 1]

"""The control comes out not correct: the plain reference computed in
float8 e4m3 takes the program's place (its logits and first choices) and is
judged by the same numbers the cell compares, at the smoke sizes and with
limits for them, in the run's own judge (``run_cell(..., control=True)``,
``run.py --control 1`` on the card); the program itself passes on the same
seeds."""

import pytest

from portbench import run
from portbench.tests.smoke import smoke_cell

CELLS = ["mixtral-8x22b-d8.eval_score", "mixtral-8x22b-d8.gen_long"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload, seed):
    from repro_torch.configs import get_smoke_config
    clients, rows = (16, 8) if "eval" in workload else (32, 32)
    cell = smoke_cell(workload, clients=clients, judge=64, max_batch=rows)
    result = run.run_cell(cell, seed, 0.0, False, device="cpu",
                          base_config=get_smoke_config, control=True)
    assert result["correct"], result["checks"]
    assert not result["control"]["correct"], result["control"]
    assert list(result)[-1] == "checks"

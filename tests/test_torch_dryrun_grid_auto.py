"""The port's dry-run on the whole production grid at full size, under the
``auto`` layout (``launch/presets.py``): the checks of
tests/test_torch_dryrun_grid.py, one case per cell, in a file of its own so
that ``--dist loadfile`` runs the two layouts on two workers.

Every runnable cell is ``ok`` but mixtral-8x22b x train_4k: ``auto`` gives
it ``moe_ep``, which puts its 8 experts on the 16-rank "data" axis, and
``moe_apply_shardmap`` refuses, as the reference's ``shard_map`` refuses the
same cell ("axis sizes that are not evenly divisible", from
``python -m repro.launch.dryrun --layout auto``).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cell_runnable  # noqa: E402

from test_torch_dryrun_grid import (CELLS, check_grid_cell, grid_record,  # noqa: E402,F401
                                    production_mesh)

# (arch, shape) -> what its error says, where the reference fails too.
ERRORS = {("mixtral-8x22b", "train_4k"):
          "ValueError: moe_apply_shardmap needs the batch split over the expert axis"}


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_auto_grid_cell(production_mesh, arch, shape):
    rec = grid_record(production_mesh, arch, shape, "auto")
    want = ("skipped" if not cell_runnable(arch, shape).runnable
            else "error" if (arch, shape) in ERRORS else "ok")
    check_grid_cell(rec, want)
    if want == "error":
        assert rec["error"].startswith(ERRORS[arch, shape]), rec["error"]

"""The port's dry-run cells on a fake (2, 2, 2) mesh over ("pod", "data",
"model"), the multi-pod mesh's axes at smoke size: ``run_cell`` gives
``status == "ok"`` for mamba2, recurrentgemma, gemma2, internvl2, mixtral
under ``moe_ep`` and seamless, for train, prefill and decode each (see
tests/test_torch_dryrun.py for the (2, 2) cells and the checks).
"""

import pytest

pytest.importorskip("torch")

from test_torch_dryrun import CELL_ARCHS, KINDS, check_cell, smoke, smoke_cell  # noqa: E402,F401


@pytest.mark.parametrize("shape_name", KINDS)
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_smoke_cell_on_a_2x2x2_mesh(smoke, arch, shape_name):  # noqa: F811
    rec = smoke_cell(arch, shape_name, (2, 2, 2), ("pod", "data", "model"))
    check_cell(rec)
    assert rec["mesh"] == "2x2x2"

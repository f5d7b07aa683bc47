"""The port stands alone: it imports neither ``jax`` nor ``repro``.

Its card machine has no JAX, so every module of ``repro_torch`` must import
with both blocked, and no source file of the port (nor ``chip_smoke.py``)
may name either in an import.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro|ml_dtypes)\b(?!_)"
    r"|from\s+(?:jax|repro|ml_dtypes)\b(?!_)[\w.]*\s+import)", re.M)

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
for name in sys.argv[1:]:
    assert name in names, name
print(len(names))
"""

# The training and distribution modules (each must be among those visited).
DISTRIBUTION_MODULES = ["repro_torch.train.optimizer", "repro_torch.train.sharding",
                        "repro_torch.train.step", "repro_torch.train.checkpoint",
                        "repro_torch.launch.mesh", "repro_torch.launch.specs",
                        "repro_torch.launch.presets", "repro_torch.launch.train",
                        "repro_torch.models.moe", "repro_torch.data.loader",
                        "repro_torch.weights"]


def test_every_module_imports_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, *DISTRIBUTION_MODULES],
                          cwd=ROOT / "src", capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 19       # every module was visited


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _BLOCKED_IMPORT.findall(text), path

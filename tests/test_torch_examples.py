"""The port's model-side examples (``examples/torch_*.py``) run end to end
on the CPU with ``--device cpu``, each in a subprocess: batched serving
across three families, governance (train, checkpoint, revoke a raw record,
find the checkpoint through lineage), and end-to-end training at a cut
width with a checkpoint, a restart from it and a loss that falls.  Without
``--device cpu`` and without a card they raise: nothing falls back.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("script,args,ok", [
    ("torch_serve_batched.py", [], "OK: batched serving across families"),
    ("torch_governance_lineage.py", [], "OK: the checkpoint that ingested"),
    ("torch_train_end_to_end.py",
     ["--steps", "12", "--layers", "2", "--d-model", "64", "--checkpoint-every", "6",
      "--kill-at", "6"], "OK: end-to-end training improved the loss"),
])
def test_example_runs_on_the_cpu(script, args, ok):
    proc = _run(script, "--device", "cpu", *args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ok in proc.stdout
    if script == "torch_train_end_to_end.py":
        assert "simulated crash at step 6" in proc.stdout
        assert "restored at step 6" in proc.stdout


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="a card is present")
def test_example_without_device_cpu_raises_without_a_card():
    proc = _run("torch_serve_batched.py", timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr

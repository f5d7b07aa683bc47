"""A configuration with a reference module of its own comes in as new files
alone: a module written outside ``portbench/`` and put on
``portbench.reference``'s path stands for a new ``reference/<name>.py``.
It re-exports the decoder's definitions, adds a key to ``CONFIG_KEYS`` and
counts its own prefill operations; a smoke configuration naming it is
served and judged on the CPU as the decoder's is, its ``prefill_mfu`` reads
the module's count, and the program is refused where the module lacks a
part or where its new key differs from the program's field."""

import dataclasses
import hashlib
import importlib
import json
import sys

import pytest

from portbench import counts, harness, reference
from portbench.tests.smoke import smoke_cell
from portbench.tests.test_portbench_counts import TINY
from portbench.tests.test_portbench_metrics import rec, read

WORKLOAD = "mixtral-8x22b-d8.gen_long"
SEED = 2 ** 33 + 5

OWN = '''
from portbench import counts

from .decoder import *  # noqa: F401,F403
from .decoder import CONFIG_KEYS as _DECODER_KEYS

CONFIG_KEYS = dict(_DECODER_KEYS, model_family="family")


def prefill_flops(cfg, lens):
    return 3 * counts.decoder_prefill_flops(cfg, lens)
'''

LACKING = '''
from .decoder import *  # noqa: F401,F403


def lacks(mc):
    return ["every part"]
'''


def _files():
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in harness.BENCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def modules(tmp_path, monkeypatch):
    """Writes the two modules outside ``portbench/`` and puts their
    directory on ``portbench.reference``'s path; takes them away after."""
    names = {"own": f"own_{tmp_path.name}".replace("-", "_"),
             "lacking": f"lacking_{tmp_path.name}".replace("-", "_")}
    pkg = tmp_path / "references"
    pkg.mkdir()
    (pkg / f"{names['own']}.py").write_text(OWN)
    (pkg / f"{names['lacking']}.py").write_text(LACKING)
    monkeypatch.setattr(reference, "__path__", [*reference.__path__, str(pkg)])
    importlib.invalidate_caches()
    before = _files()
    yield names
    for name in names.values():
        sys.modules.pop(f"{reference.__name__}.{name}", None)
        if hasattr(reference, name):
            delattr(reference, name)
    assert _files() == before


def _own_config(name, **keys):
    cfg = smoke_cell(WORKLOAD).config
    return {**cfg, "reference": name, "model_family": "moe", **keys}


def _verdict(cell):
    from repro_torch.configs import get_smoke_config
    model = harness.build_program(cell.config, SEED, "cpu", get_smoke_config)
    run = harness.Run(cell, model, SEED)
    run.window(0.0)
    return harness.judge(cell, run.requests, run.model.prefills, SEED, "cpu")[0]


def test_served_and_judged_as_the_decoders(modules, tmp_path):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "own.json").write_text(json.dumps(_own_config(modules["own"])))
    bench["configs"] = [dict(c, file="own.json") for c in bench["configs"]]
    loaded = harness.load_cell(WORKLOAD, bench, root=tmp_path)
    ref = reference.module(loaded.config)
    assert ref.__name__ == f"portbench.reference.{modules['own']}"
    assert not ref.__file__.startswith(str(harness.BENCH))
    smoke = smoke_cell(WORKLOAD)
    assert reference.module(smoke.config).__name__ == "portbench.reference.decoder"
    own = dataclasses.replace(loaded, mix=smoke.mix, spec=smoke.spec)
    verdict = _verdict(own)
    assert verdict["judged_requests"] > 0 and verdict["judged_tokens"] > 0
    assert verdict == _verdict(smoke)
    assert harness.passes(harness.checks(own, 0, verdict))


def test_prefill_mfu_reads_the_modules_count(modules):
    own = dict(TINY, reference=modules["own"])
    assert counts.prefill_flops(own, [4, 1]) == 3 * counts.prefill_flops(TINY, [4, 1])
    # the other counts are the decoder's
    assert counts.decode_step(own, [5], 7) == counts.decode_step(TINY, [5], 7)
    assert read("prefill_mfu", dict(rec(), config=own)) == pytest.approx(
        3 * read("prefill_mfu", rec()), rel=1e-12)


def test_a_part_the_module_lacks_is_refused(modules):
    from repro_torch.configs import get_smoke_config
    cfg = dict(smoke_cell(WORKLOAD).config, reference=modules["lacking"])
    with pytest.raises(ValueError, match="parts the reference lacks: every part"):
        harness.program_config(cfg, get_smoke_config)


def test_the_modules_key_is_compared(modules):
    from repro_torch.configs import get_smoke_config
    assert harness.program_config(_own_config(modules["own"]), get_smoke_config)
    with pytest.raises(ValueError, match="model_family"):
        harness.program_config(_own_config(modules["own"], model_family="dense"),
                               get_smoke_config)

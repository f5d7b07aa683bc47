"""The port's copy of the platform (``repro_torch.core``,
``repro_torch.platform``, ``repro_torch.data.components``) against the JAX
package's.

The port imports nothing from ``repro``, so it carries these modules as its
own copies.  Each must equal its source once the package name is changed, so
the copy cannot drift; and on one synthetic corpus, the Fig. 1 flow of both
training drivers (check-in, the tokenize -> pack workflow, checkout) must
give the same commit ids, ``pages_digest``, snapshot id and lineage.  Commit
ids hash a timestamp and workflow runs draw uuid4 ids, so both flows run on
a fixed clock and a counter for uuid4.
"""

import re
import time
import uuid
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro"
COPIED = sorted(str(p.relative_to(SRC)) for p in (SRC / "core").glob("*.py")) + [
    "platform.py", "data/components.py"]


def to_port(text: str) -> str:
    """The package name changed: ``repro.`` -> ``repro_torch.`` (and the
    platform's docstring example imports ``Platform`` from its module)."""
    text = text.replace("from repro import Platform",
                        "from repro_torch.platform import Platform")
    return re.sub(r"\brepro\.", "repro_torch.", text)


def test_every_core_module_is_copied():
    assert len(COPIED) == 14
    port = {str(p.relative_to(ROOT / "src" / "repro_torch"))
            for p in (ROOT / "src" / "repro_torch" / "core").glob("*.py")}
    assert port == {p for p in COPIED if p.startswith("core/")}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_its_source(rel):
    src = (SRC / rel).read_text()
    port = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert port == to_port(src), f"src/repro_torch/{rel} drifted from src/repro/{rel}"


def _fig1_flow(monkeypatch, launch_train):
    """The driver's build_platform on a fixed clock and uuid counter; what a
    platform derives from it."""
    counter = iter(range(1, 1 << 30))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
    plat, run = launch_train.build_platform(seq_len=32, n_docs=64)
    raw = plat.dataset("corpus/raw")
    packed = plat.dataset("corpus/packed")
    snap = packed.checkout()
    plan = packed.plan()
    lineage = plat.manager.lineage
    out = {
        "raw_head": plat.manager.versions.get_branch("corpus/raw", "main"),
        "packed_head": run.output_commit,
        "pipeline": run.derivation_key,
        "pages_digest": plan.pages_digest(),
        "content": snap.content_digest(),
        "snapshot": snap.snapshot_id,
        "ancestors": sorted(lineage.ancestors(snap.snapshot_id)),
        "records": sorted(plan.iter_record_ids()),
        "payload": packed.checkout().read(sorted(plan.iter_record_ids())[3]),
        "raw_pages": raw.plan().pages_digest(),
    }
    monkeypatch.undo()
    return out


def test_both_platforms_derive_the_same_versions(monkeypatch):
    import repro.launch.train as jax_train
    import repro_torch.launch.train as torch_train
    want = _fig1_flow(monkeypatch, jax_train)
    got = _fig1_flow(monkeypatch, torch_train)
    assert len(want["records"]) > 0 and len(want["ancestors"]) > 1
    for key in want:
        assert got[key] == want[key], key


def test_pipeline_fingerprints_are_the_same_across_packages():
    from repro.core import Pipeline as JaxPipeline
    from repro.data import PackComponent as JaxPack
    from repro.data import TokenizeComponent as JaxTokenize
    from repro_torch.core import Pipeline
    from repro_torch.data import PackComponent, TokenizeComponent
    want = JaxPipeline([JaxTokenize(), JaxPack(seq_len=64)], name="tp").fingerprint()
    got = Pipeline([TokenizeComponent(), PackComponent(seq_len=64)], name="tp").fingerprint()
    assert got == want

"""The port's copy of the platform (``repro_torch.core``,
``repro_torch.platform``, ``repro_torch.data.components``, the remote stores
``repro_torch.store`` and the CLI ``repro_torch.cli``) against the JAX
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
    "platform.py", "data/components.py", "cli.py", "store/__init__.py"] + sorted(
    str(p.relative_to(SRC)) for p in (SRC / "store" / "remote").glob("*.py"))


def to_port(text: str) -> str:
    """The package name changed: ``repro.`` -> ``repro_torch.`` (and the
    platform's docstring example imports ``Platform`` from its module)."""
    text = text.replace("from repro import Platform",
                        "from repro_torch.platform import Platform")
    return re.sub(r"\brepro\.", "repro_torch.", text)


def test_every_core_module_is_copied():
    assert len(COPIED) == 23
    for pkg in ("core", "store"):
        port = {str(p.relative_to(ROOT / "src" / "repro_torch"))
                for p in (ROOT / "src" / "repro_torch" / pkg).rglob("*.py")}
        assert port == {p for p in COPIED if p.startswith(pkg + "/")}


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


def _store_history(platform_cls, record_cls, url: str):
    """Check-ins on a platform opened from ``url``, under a fixed clock: the
    commit ids, the head and what a checkout reads back."""
    counter = iter(range(1, 1 << 30))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: 1_700_000_000.0)
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        plat = platform_cls.open(url)
        ds = plat.dataset("speech/raw")
        commits = [ds.check_in([record_cls(f"r{i}", f"payload {i} of {n}".encode(),
                                           {"lang": "en" if i % 2 else "de"})
                                for i in range(n)], message=f"v{n}").commit_id
                   for n in (3, 5)]
        snap = ds.checkout()
        payload = snap.read(sorted(snap.record_ids())[2])
        head = plat.manager.versions.get_branch("speech/raw", "main")
    return {"commits": commits, "head": head, "payload": payload,
            "records": sorted(snap.record_ids())}


@pytest.mark.parametrize("scheme", ["memory", "file", "memory-simulated"])
def test_both_packages_open_remote_stores_alike(scheme, tmp_path):
    """``Platform.open(url)`` through the port's copy of ``repro.store``:
    the same check-ins give the same commits in both packages."""
    from repro.core import Record as JaxRecord
    from repro.platform import Platform as JaxPlatform
    from repro_torch.core import Record
    from repro_torch.platform import Platform

    def url(tag):
        if scheme == "file":
            return f"file://{tmp_path / tag}"
        return "memory://" + ("?rtt=0.001&seed=3" if scheme == "memory-simulated" else "")

    want = _store_history(JaxPlatform, JaxRecord, url("jax"))
    got = _store_history(Platform, Record, url("torch"))
    assert len(set(want["commits"])) == 2
    assert got == want

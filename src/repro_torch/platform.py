"""The platform facade — one front door over the storage engine.

The paper describes one coherent system (storage engine as source of truth,
versioning, access control, workflows, lineage, revocation); this module is
the single entry point that owns all of it:

>>> from repro_torch.platform import Platform
>>> from repro_torch.core.query import attr
>>> plat = Platform.open("/data/repo", actor="alice")     # or open() for RAM
>>> ds = plat.dataset("speech")
>>> ds.check_in([Record("r0", b"...", {"lang": "en"})], message="ingest")
>>> snap = ds.checkout(rev="golden", where=attr("lang") == "en")
>>> plan = ds.plan(where="lang=en & split!=test", shard=(0, 4))  # lazy
>>> plat.revoke("r0", reason="user request")

``Platform.open`` accepts a directory path (FileBackend), ``None`` (in-
memory), a :class:`StorageBackend`, an :class:`ObjectStore`, or an existing
:class:`DatasetManager` to wrap.  Handles carry the platform's default
actor so call sites stop threading ``actor=`` through every operation
(still overridable per call — ACL is enforced on every one).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Mapping, Optional, Sequence, Tuple, Union

from .core.acl import AccessController
from .core.dataset import (CheckoutPlan, DatasetManager, Record, Snapshot,
                           version_node_id)
from .core.derive import DerivationResult, ExecPolicy
from .core.lineage import LineageGraph
from .core.revocation import RevocationEngine, RevocationReport
from .core.store import (FileBackend, MemoryBackend, ObjectStore,
                         StorageBackend)
from .core.versioning import Commit, Manifest, RecordEntry, VersionDiff
from .core.workflow import Workflow, WorkflowManager, WorkflowRun

__all__ = ["Platform", "DatasetHandle", "VersionHandle"]


class Platform:
    """Session-style facade owning every platform subsystem.

    Attributes (all live on one shared store):

    - ``store``      — content-addressed :class:`ObjectStore`
    - ``manager``    — the :class:`DatasetManager` engine
    - ``versions``   — commit/ref layer
    - ``acl``        — access controller
    - ``lineage``    — provenance graph
    - ``revocation`` — GDPR-delete engine
    - ``workflows``  — workflow manager (triggers, sharded runs)
    - ``derivations``— derivation engine (cached/incremental transforms)
    """

    def __init__(
        self,
        manager: DatasetManager,
        *,
        actor: str = "platform",
        worker_slots: int = 8,
    ) -> None:
        self.manager = manager
        self.store = manager.store
        self.versions = manager.versions
        self.acl = manager.acl
        self.lineage = manager.lineage
        self.actor = actor
        self.revocation = RevocationEngine(manager)
        # One WorkflowManager per engine: a second Platform over the same
        # manager must not register a second commit listener, or commit
        # triggers fire once per facade (worker_slots then comes from the
        # first construction).
        existing = getattr(manager, "_workflow_manager", None)
        self.workflows = existing if existing is not None else \
            WorkflowManager(manager, worker_slots=worker_slots)
        # The workflow manager created (or found) the shared derivation
        # engine for this manager; surface it as a first-class subsystem.
        self.derivations = self.workflows.engine

    # ------------------------------------------------------------------ open

    @classmethod
    def open(
        cls,
        target: Union[str, os.PathLike, StorageBackend, ObjectStore,
                      DatasetManager, None] = None,
        *,
        actor: str = "platform",
        worker_slots: int = 8,
        acl: Optional[AccessController] = None,
        lineage: Optional[LineageGraph] = None,
        page_size: Optional[int] = None,
        **store_kwargs,
    ) -> "Platform":
        """Open (or create) a platform over ``target``.

        - ``None``            → ephemeral in-memory store
        - URL string          → resolved by :func:`repro_torch.store.remote.
          backend_from_url`: ``memory://`` / ``file:///path`` /
          ``http://host:port`` (plus simulation query params, e.g.
          ``memory://?rtt=0.05``)
        - path / str          → :class:`FileBackend` repository directory
        - ``StorageBackend``  → wrapped in an :class:`ObjectStore`
        - ``ObjectStore``     → used as-is
        - ``DatasetManager``  → wrapped directly (compat path)

        ``**store_kwargs`` reach the :class:`ObjectStore` — notably
        ``disk_cache_bytes=`` / ``disk_cache_dir=`` to put a local disk
        tier under the chunk cache of a remote backend.

        ``page_size`` sets the manifest page fanout (``0`` = legacy
        monolithic manifests — the measurable baseline; reads always
        accept both layouts).
        """
        if isinstance(target, DatasetManager):
            # The manager already owns its ACL/lineage/store — accepting
            # overrides here would silently not apply them.
            if acl is not None or lineage is not None or store_kwargs \
                    or page_size is not None:
                raise ValueError(
                    "acl=/lineage=/page_size=/store kwargs cannot be "
                    "combined with an existing DatasetManager — configure "
                    "the manager itself")
            manager = target
        else:
            if target is None:
                backend: StorageBackend = MemoryBackend()
                store = ObjectStore(backend, **store_kwargs)
            elif isinstance(target, str) and "://" in target:
                # Lazy import: the remote subsystem (http.client etc.)
                # should not load for purely local platforms.
                from .store.remote import backend_from_url
                store = ObjectStore(backend_from_url(target), **store_kwargs)
            elif isinstance(target, (str, os.PathLike)):
                store = ObjectStore(FileBackend(os.fspath(target)),
                                    **store_kwargs)
            elif isinstance(target, StorageBackend):
                store = ObjectStore(target, **store_kwargs)
            elif isinstance(target, ObjectStore):
                if store_kwargs:
                    raise ValueError(
                        "store kwargs cannot be combined with an existing "
                        "ObjectStore — configure the store itself")
                store = target
            else:
                raise TypeError(
                    f"cannot open a Platform over {type(target).__name__}")
            manager = DatasetManager(store, acl=acl, lineage=lineage,
                                     page_size=page_size)
        return cls(manager, actor=actor, worker_slots=worker_slots)

    def _actor(self, actor: Optional[str]) -> str:
        return actor if actor is not None else self.actor

    # ------------------------------------------------------------------ datasets

    def dataset(self, name: str) -> "DatasetHandle":
        """Typed handle on one dataset (existing or to-be-created)."""
        return DatasetHandle(self, name)

    def datasets(
        self,
        name_glob: str = "*",
        tags: Sequence[str] = (),
        attrs: Optional[Mapping[str, object]] = None,
    ) -> List["DatasetHandle"]:
        """Query datasets by name pattern / tags / info attrs — handles."""
        return [DatasetHandle(self, n)
                for n in self.manager.query_datasets(name_glob, tags=tags,
                                                     attrs=attrs)]

    def list_datasets(self) -> List[str]:
        return self.manager.list_datasets()

    # ------------------------------------------------------------------ governance

    def grant(self, subject: str, pattern: str, action) -> None:
        self.acl.grant(subject, pattern, action)

    def revoke(self, record_id: str, reason: str = "",
               actor: Optional[str] = None) -> RevocationReport:
        """GDPR-delete a record everywhere it propagated."""
        return self.revocation.revoke(record_id, actor=self._actor(actor),
                                      reason=reason)

    def audit_log(self) -> List[dict]:
        return self.acl.audit_log()

    def gc(self) -> int:
        return self.manager.gc()

    # ------------------------------------------------------------------ stats

    def store_stats(self) -> dict:
        """Storage-engine counters: the verified-once read cache plus the
        batched write path (``put_calls`` / ``chunks_written`` /
        ``chunks_deduped`` / ``exists_probes`` — a fully-deduplicated
        re-check-in shows up as one probe and zero chunk writes), the
        meta-batching counters (``meta_requests`` / ``meta_batched`` /
        ``ref_cas_retries`` — a commit-scoped batch collapses the meta
        namespace into a handful of round trips), plus the remote I/O
        counters (``remote_requests`` / ``retries`` / ``hedges_issued`` /
        ``hedge_wins``) and both cache tiers."""
        from dataclasses import asdict

        out = asdict(self.store.stats)
        out["cache"] = self.store.cache_info()
        out["disk_cache"] = self.store.disk_cache_info()
        return out

    # ------------------------------------------------------------------ lifecycle

    def close(self) -> None:
        """Flush buffered state (audit events, lineage deltas) to the store.

        Safe to call repeatedly; a platform left unclosed loses at most the
        events buffered since the last commit boundary (every check_in also
        flushes).  Both flushes ride one meta batch."""
        with self.store.meta_batch(prefetch=[
                self.acl.pending_seg_key(),
                self.lineage.pending_seg_key()]):
            self.acl.flush_audit()
            self.lineage.flush()

    def __enter__(self) -> "Platform":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ------------------------------------------------------------------ workflows

    def register(self, workflow: Workflow) -> None:
        self.workflows.register(workflow)

    def run(self, workflow_name: str, trigger: str = "manual") -> WorkflowRun:
        return self.workflows.run(workflow_name, trigger=trigger)

    def resume(self, run_id: str) -> WorkflowRun:
        return self.workflows.resume(run_id)

    # ------------------------------------------------------------------ lineage

    def ancestors(self, node_id: str) -> List[str]:
        return self.lineage.ancestors(node_id)

    def descendants(self, node_id: str) -> List[str]:
        return self.lineage.descendants(node_id)

    def __repr__(self) -> str:
        return (f"Platform(backend={type(self.store.backend).__name__}, "
                f"datasets={len(self.list_datasets())}, actor={self.actor!r})")


class DatasetHandle:
    """All operations on one named dataset, through the platform."""

    def __init__(self, platform: Platform, name: str) -> None:
        self._plat = platform
        self.name = name

    @property
    def _dm(self) -> DatasetManager:
        return self._plat.manager

    def _actor(self, actor: Optional[str]) -> str:
        return self._plat._actor(actor)

    def exists(self) -> bool:
        return self._dm.dataset_info(self.name) is not None

    def info(self) -> Optional[dict]:
        return self._dm.dataset_info(self.name)

    # -- write side ----------------------------------------------------------

    def check_in(
        self,
        records: Iterable[Record],
        message: str = "",
        actor: Optional[str] = None,
        **kwargs,
    ) -> Commit:
        return self._dm.check_in(self.name, records, self._actor(actor),
                                 message=message, **kwargs)

    def delete_records(self, record_ids: Sequence[str],
                       actor: Optional[str] = None,
                       message: str = "delete records") -> Commit:
        return self._dm.delete_records(self.name, record_ids,
                                       self._actor(actor), message=message)

    def tag(self, tag: str, actor: Optional[str] = None) -> None:
        """Tag the *dataset* (discovery tag, not a version tag)."""
        self._dm.tag_dataset(self.name, tag, self._actor(actor))

    def tag_version(self, rev: str, tag: str,
                    actor: Optional[str] = None) -> None:
        self._dm.tag_version(self.name, rev, tag, self._actor(actor))

    # -- read side -------------------------------------------------------------

    def plan(
        self,
        rev: str = "main",
        where=None,
        attrs_equal: Optional[Mapping[str, object]] = None,
        limit: Optional[int] = None,
        shard: Optional[Tuple[int, int]] = None,
        actor: Optional[str] = None,
        use_index: bool = True,
    ) -> CheckoutPlan:
        """Lazy checkout plan — streamable, shardable, fingerprinted.

        ``use_index=False`` forces the full-scan path (identical results;
        exists for benchmarking and as an escape hatch).
        """
        return self._dm.plan_checkout(self.name, self._actor(actor), rev=rev,
                                      where=where, attrs_equal=attrs_equal,
                                      limit=limit, shard=shard,
                                      use_index=use_index)

    def index_stats(self, rev: str = "main",
                    actor: Optional[str] = None) -> Optional[dict]:
        """Attribute-index summary for one version (``None`` when the commit
        predates attribute indexing): record count plus, per field, how it
        is indexed (postings / zones) and its posting cardinality."""
        self._dm.acl.check(self._actor(actor), "READ", self.name,
                           note=f"index_stats:{rev}")
        commit_id = self.versions.resolve(self.name, rev)
        tree = self.versions.get_commit(commit_id).tree
        index = self.versions.get_attr_index(tree)
        return index.stats() if index is not None else None

    def page_stats(self, rev: str = "main",
                   actor: Optional[str] = None) -> Optional[dict]:
        """Page-directory shape + per-page attribute summaries for one
        version (``None`` for legacy monolithic manifests): page count and
        fanout, and per page its record count, key range, and the
        attr/zone summary quality tooling reads without loading pages."""
        self._dm.acl.check(self._actor(actor), "READ", self.name,
                           note=f"page_stats:{rev}")
        commit_id = self.versions.resolve(self.name, rev)
        tree = self.versions.get_commit(commit_id).tree
        directory = self.versions.get_page_directory(tree)
        return directory.stats() if directory is not None else None

    def checkout(
        self,
        rev: str = "main",
        where=None,
        attrs_equal: Optional[Mapping[str, object]] = None,
        limit: Optional[int] = None,
        actor: Optional[str] = None,
        register_snapshot: bool = True,
    ) -> Snapshot:
        """Materialized, lineage-registered checkout (cached by query)."""
        plan = self.plan(rev=rev, where=where, attrs_equal=attrs_equal,
                         limit=limit, actor=actor)
        return plan.snapshot(register=register_snapshot)

    def derive(
        self,
        pipeline,
        output: Optional[str] = None,
        rev: str = "main",
        where=None,
        actor: Optional[str] = None,
        message: str = "",
        policy: Optional[ExecPolicy] = None,
        **kwargs,
    ) -> DerivationResult:
        """Run ``pipeline`` over (a queried subset of) this dataset and
        check the result into ``output`` — cached, incremental, streaming.

        The derivation is identified by (input commit, query fingerprint,
        pipeline fingerprint): an identical call — from any process over
        the same backend — returns the cached output commit with zero
        component executions, and a call against a new input commit
        recomputes only changed records for per-record stages.
        """
        plan = self.plan(rev=rev, where=where, actor=actor)
        return self._plat.derivations.derive(
            plan, pipeline, output_dataset=output,
            actor=self._actor(actor), message=message, policy=policy,
            **kwargs)

    def read(self, record_id: str, rev: str = "main",
             actor: Optional[str] = None) -> bytes:
        return self._dm.read_record(self.name, record_id,
                                    self._actor(actor), rev=rev)

    # -- versions ---------------------------------------------------------------

    def version(self, rev: str = "main") -> "VersionHandle":
        commit_id = self.versions.resolve(self.name, rev)
        return VersionHandle(self._plat, self.name, commit_id)

    @property
    def versions(self):
        return self._dm.versions

    def log(self, rev: str = "main", limit: int = 100) -> List[Commit]:
        return self.versions.log(self.versions.resolve(self.name, rev),
                                 limit=limit)

    def branches(self) -> List[str]:
        return self.versions.list_branches(self.name)

    def tags(self) -> List[str]:
        return self.versions.list_tags(self.name)

    def diff(self, rev_a: str, rev_b: str,
             actor: Optional[str] = None) -> VersionDiff:
        return self._dm.diff(self.name, rev_a, rev_b, self._actor(actor))

    def __repr__(self) -> str:
        return f"DatasetHandle({self.name!r})"


class VersionHandle:
    """One immutable dataset version, addressable and inspectable."""

    def __init__(self, platform: Platform, dataset: str,
                 commit_id: str) -> None:
        self._plat = platform
        self.dataset = dataset
        self.commit_id = commit_id

    @property
    def commit(self) -> Commit:
        return self._plat.versions.get_commit(self.commit_id)

    @property
    def node_id(self) -> str:
        """This version's lineage node id."""
        return version_node_id(self.dataset, self.commit_id)

    def manifest(self) -> Manifest:
        return self._plat.versions.get_manifest(self.commit.tree)

    def entries(self) -> List[RecordEntry]:
        return self.manifest().entries()

    def record_ids(self) -> List[str]:
        return self.manifest().record_ids()

    def __len__(self) -> int:
        return len(self.manifest())

    def checkout(self, where=None, limit: Optional[int] = None,
                 actor: Optional[str] = None, **kwargs) -> Snapshot:
        """Checkout pinned to exactly this commit."""
        return self._plat.dataset(self.dataset).checkout(
            rev=self.commit_id, where=where, limit=limit, actor=actor,
            **kwargs)

    def plan(self, where=None, limit: Optional[int] = None,
             shard: Optional[Tuple[int, int]] = None,
             actor: Optional[str] = None) -> CheckoutPlan:
        return self._plat.dataset(self.dataset).plan(
            rev=self.commit_id, where=where, limit=limit, shard=shard,
            actor=actor)

    def tag(self, tag: str, actor: Optional[str] = None) -> None:
        self._plat.dataset(self.dataset).tag_version(self.commit_id, tag,
                                                     actor=actor)

    def diff(self, other: Union[str, "VersionHandle"],
             actor: Optional[str] = None) -> VersionDiff:
        other_rev = other.commit_id if isinstance(other, VersionHandle) \
            else other
        return self._plat.dataset(self.dataset).diff(
            self.commit_id, other_rev, actor=actor)

    def parents(self) -> List["VersionHandle"]:
        return [VersionHandle(self._plat, self.dataset, p)
                for p in self.commit.parents]

    def ancestors(self) -> List[str]:
        """Lineage ancestry of this version (full provenance)."""
        return self._plat.lineage.ancestors(self.node_id)

    def __repr__(self) -> str:
        return f"VersionHandle({self.dataset}@{self.commit_id[:12]})"

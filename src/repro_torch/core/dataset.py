"""Dataset manager — check-in / checkout, tagging, querying, ACL enforcement.

Paper: "The dataset manager is used to store datasets, manage versions, for
access control and to checkout datasets. ... Users can use a command-line
interface (CLI) or other user interface to check-in data.  Data or datasets
can be tagged with one or more tags. ... It also provides query
capabilities, e.g., querying for datasets by tags, dataset name, or other
attributes.  Users or workflows can checkout data by specifying query
conditions.  The type of data stored is unrestricted."
"""

from __future__ import annotations

import bisect
import fnmatch
import hashlib
import json
import random
import time
import uuid
from dataclasses import dataclass, field
from typing import (Callable, Dict, FrozenSet, Iterable, Iterator, List,
                    Mapping, Optional, Sequence, Tuple, Union)

from .acl import AccessController, Action
from .lineage import EdgeKind, LineageGraph, NodeKind
from .query import ALL, Cmp, Query, TrueQuery, as_query
from .store import (BlobRef, CommitConflictError, MemoryBackend,
                    NotFoundError, ObjectStore)
from .versioning import (Commit, Manifest, RecordEntry, VersionDiff,
                         VersionStore)

__all__ = ["Record", "Snapshot", "CheckoutPlan", "DatasetManager",
           "version_node_id"]


def version_node_id(dataset: str, commit_id: str) -> str:
    return f"version:{dataset}@{commit_id[:16]}"


@dataclass
class Record:
    """A unit of data checked into the platform.  Payload is arbitrary bytes
    ("the type of data stored is unrestricted")."""

    record_id: str
    data: bytes
    attrs: Dict[str, object] = field(default_factory=dict)


class Snapshot:
    """An immutable, queryable materialization of (a subset of) a version.

    This is the paper's "dataset (snapshot) to serve different purposes":
    the object handed to training / evaluation / labeling pipelines.
    Payload bytes are fetched lazily from the CAS.
    """

    def __init__(
        self,
        snapshot_id: str,
        dataset: str,
        commit_id: str,
        entries: Sequence[RecordEntry],
        store: ObjectStore,
    ) -> None:
        self.snapshot_id = snapshot_id
        self.dataset = dataset
        self.commit_id = commit_id
        self._entries = list(entries)
        self._by_id = {e.record_id: e for e in self._entries}
        self._store = store

    def __len__(self) -> int:
        return len(self._entries)

    def record_ids(self) -> List[str]:
        return [e.record_id for e in self._entries]

    def count(self) -> int:
        """Number of records (always cheap — see :meth:`CheckoutPlan.count`
        for the streaming twin)."""
        return len(self._entries)

    def iter_record_ids(self) -> Iterator[str]:
        """Stream record ids without building the full list."""
        for e in self._entries:
            yield e.record_id

    def entries(self) -> List[RecordEntry]:
        return list(self._entries)

    def attrs(self, record_id: str) -> Mapping[str, object]:
        return self._by_id[record_id].attrs

    def read(self, record_id: str) -> bytes:
        return self._store.get_blob(self._by_id[record_id].blob)

    def read_batch(self, record_ids: Sequence[str]) -> List[bytes]:
        """Batched payload fetch (grouped CAS lookups, chunk dedup)."""
        return self._store.get_blobs(
            [self._by_id[r].blob for r in record_ids])

    def read_entries(self, entries: Sequence[RecordEntry]) -> List[bytes]:
        """Grouped payload fetch for already-resolved entries (no id
        lookup — the loader's page-window path holds entries directly)."""
        return self._store.get_blobs([e.blob for e in entries])

    # -- page-granular feed surface (ShardedSnapshotLoader page-window mode)
    #
    # A materialized snapshot holds every entry anyway, so its "pages" are
    # synthesized fixed-size slices — the surface exists for interface
    # parity with CheckoutPlan, where pure paged plans serve real manifest
    # pages without materializing anything.

    FEED_PAGE_SIZE = 1024

    def page_count(self) -> int:
        n = len(self._entries)
        return (n + self.FEED_PAGE_SIZE - 1) // self.FEED_PAGE_SIZE

    def page_sizes(self) -> List[int]:
        n, step = len(self._entries), self.FEED_PAGE_SIZE
        return [min(step, n - off) for off in range(0, n, step)] or []

    def page_record_ids(self, page_index: int) -> List[str]:
        return [e.record_id for e in self.page_entries(page_index)]

    def page_entries(self, page_index: int) -> List[RecordEntry]:
        step = self.FEED_PAGE_SIZE
        return self._entries[page_index * step:(page_index + 1) * step]

    def read_pages(self, page_indices: Sequence[int]
                   ) -> List[List[RecordEntry]]:
        """Many pages' entries in one call (everything is resident here;
        the CheckoutPlan twin batches the underlying CAS reads)."""
        return [self.page_entries(pi) for pi in page_indices]

    def pages_digest(self) -> str:
        """Content identity for page feeds; a materialized snapshot just
        reuses its exact content digest (everything is resident already)."""
        return self.content_digest()

    def __iter__(self):
        for e in self._entries:
            yield Record(e.record_id, self._store.get_blob(e.blob), dict(e.attrs))

    def content_digest(self) -> str:
        """Deterministic digest of the snapshot contents (id order + blobs)."""
        import hashlib

        h = hashlib.sha256()
        for e in self._entries:
            h.update(e.record_id.encode())
            h.update(e.blob.digest.encode())
        return h.hexdigest()


Predicate = Callable[[RecordEntry], bool]


class CheckoutPlan:
    """A lazy, declarative checkout: (dataset, commit, query, shard, limit).

    The plan streams manifest entries through the query without building
    intermediate lists, so a trainer can feed
    :class:`~repro_torch.data.loader.ShardedSnapshotLoader` directly from a plan
    (it duck-types the Snapshot read surface: ``record_ids`` / ``read`` /
    ``attrs`` / ``content_digest``).  Call :meth:`snapshot` to register the
    checkout in lineage; identical plans over the same commit dedupe onto a
    single snapshot node via the plan digest.
    """

    def __init__(
        self,
        dm: "DatasetManager",
        dataset: str,
        commit_id: str,
        rev: str,
        query: Optional[Query] = None,
        limit: Optional[int] = None,
        shard: Optional[Tuple[int, int]] = None,
        use_index: bool = True,
    ) -> None:
        if shard is not None:
            idx, n = shard
            if not (0 <= idx < n):
                raise ValueError(f"bad shard spec {shard!r}")
        self._dm = dm
        self.dataset = dataset
        self.commit_id = commit_id
        self.rev = rev
        self.query = query if query is not None else ALL
        self.limit = limit
        self.shard = tuple(shard) if shard is not None else None
        # Execution hint only — indexed and scan paths return identical
        # entries, so use_index is deliberately NOT part of the plan digest.
        self.use_index = use_index
        self._entries: Optional[List[RecordEntry]] = None
        self._by_id: Optional[Dict[str, RecordEntry]] = None
        self._explain: Optional[Dict[str, object]] = None

    # -- identity ------------------------------------------------------------

    @property
    def serializable(self) -> bool:
        return self.query.serializable

    def to_json(self) -> dict:
        return {
            "dataset": self.dataset,
            "rev": self.rev,
            "commit": self.commit_id,
            "query": self.query.to_json(),
            "limit": self.limit,
            "shard": list(self.shard) if self.shard else None,
        }

    def query_digest(self) -> Optional[str]:
        """Digest of (query, limit, shard) — commit-independent; ``None``
        for opaque callable predicates (never cached)."""
        if not self.query.serializable:
            return None
        body = {"query": self.query.canonical(), "limit": self.limit,
                "shard": list(self.shard) if self.shard else None}
        blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    # -- streaming iteration ---------------------------------------------------

    def iter_entries(self) -> Iterator[RecordEntry]:
        """Stream matching entries without materializing the manifest list.

        When the commit carries an attribute index and the query algebra can
        be resolved against it, only candidate positions are deserialized
        into :class:`RecordEntry` objects (and re-evaluated only when the
        index answer is a superset); otherwise this is a full scan.  Paged
        trees stream page-by-page (batched CAS reads) and pruned plans skip
        whole pages — candidate-free page blobs are never deserialized;
        ``explain()`` reports ``pages_total``/``pages_scanned``.  All paths
        emit identical entry streams — shard and limit count *matches*,
        which the index path reproduces exactly.
        """
        if self._entries is not None:
            yield from self._entries
            return
        versions = self._dm.versions
        tree = versions.get_commit(self.commit_id).tree
        directory = versions.get_page_directory(tree)
        plan = None
        if (self.use_index and self.query.serializable
                and not isinstance(self.query, TrueQuery)):
            index = versions.get_attr_index(tree)
            if index is not None:
                plan = self.query.index_plan(index)
        if directory is not None:
            yield from self._iter_paged(versions, directory, plan)
        elif plan is not None:
            positions, exact = plan
            records = versions.get_raw_records(tree)
            self._explain = {"mode": "indexed", "n_records": len(records),
                             "candidates": len(positions), "exact": exact,
                             "pages_total": 1, "pages_scanned": 1}
            candidates = (
                RecordEntry.from_raw(records[pos])
                for pos in sorted(positions))
            yield from self._filtered(candidates, evaluate=not exact)
        else:
            manifest = versions.get_manifest(tree)
            self._explain = {"mode": "scan", "n_records": len(manifest),
                             "pages_total": 1, "pages_scanned": 1}
            yield from self._filtered(manifest.iter_entries(), evaluate=True)

    def _iter_paged(self, versions, directory,
                    plan) -> Iterator[RecordEntry]:
        """Page-wise execution: load candidate pages lazily, in order.

        ``pages_scanned`` counts pages actually deserialized — index plans
        skip candidate-free pages entirely, and a satisfied ``limit`` stops
        the page stream early."""
        explain: Dict[str, object] = {
            "n_records": directory.n,
            "pages_total": len(directory.pages),
            "pages_scanned": 0,
        }
        self._explain = explain
        if plan is not None:
            positions, exact = plan
            offsets = directory.offsets()
            by_page: Dict[int, List[int]] = {}
            for pos in sorted(positions):
                pi = bisect.bisect_right(offsets, pos) - 1
                by_page.setdefault(pi, []).append(pos - offsets[pi])
            explain.update(mode="indexed", candidates=len(positions),
                           exact=exact)
            page_order = sorted(by_page)

            def candidates():
                for pi, raw in zip(
                        page_order,
                        versions.iter_page_records(directory, page_order)):
                    explain["pages_scanned"] += 1
                    for lp in by_page[pi]:
                        yield RecordEntry.from_raw(raw[lp])

            yield from self._filtered(candidates(), evaluate=not exact)
        else:
            explain["mode"] = "scan"

            def stream():
                for raw in versions.iter_page_records(directory):
                    explain["pages_scanned"] += 1
                    for o in raw:
                        yield RecordEntry.from_raw(o)

            yield from self._filtered(stream(), evaluate=True)

    def _filtered(self, entries: Iterable[RecordEntry],
                  evaluate: bool) -> Iterator[RecordEntry]:
        """Shared match/shard/limit tail of both checkout paths."""
        matched = 0
        emitted = 0
        for entry in entries:
            if evaluate and not self.query(entry):
                continue
            keep = self.shard is None or matched % self.shard[1] == self.shard[0]
            matched += 1
            if not keep:
                continue
            yield entry
            emitted += 1
            if self.limit is not None and emitted >= self.limit:
                return

    def explain(self) -> Dict[str, object]:
        """How the last (or a forced) iteration executed: ``mode`` is
        ``"indexed"`` (with ``candidates``/``exact``) or ``"scan"``."""
        if self._explain is None:
            self.entries()
        assert self._explain is not None
        return dict(self._explain)

    def entries(self) -> List[RecordEntry]:
        if self._entries is None:
            self._entries = list(self.iter_entries())
            self._by_id = {e.record_id: e for e in self._entries}
        return list(self._entries)

    def __len__(self) -> int:
        return len(self.entries())

    def __iter__(self):
        for e in self.iter_entries():
            yield Record(e.record_id, self._dm.store.get_blob(e.blob),
                         dict(e.attrs))

    # -- Snapshot-compatible read surface (feeds the loader directly) ---------

    def record_ids(self) -> List[str]:
        """Compatibility wrapper — materializes the full id list.

        Streaming callers should prefer :meth:`iter_record_ids` /
        :meth:`count`, which stay O(page) for pure paged plans."""
        return [e.record_id for e in self.entries()]

    def count(self) -> int:
        """Record count without materializing entries when possible.

        A *pure* plan (no query/shard/limit) over a paged tree answers from
        the page directory header — O(1), no page reads.  Filtered plans
        fall back to the cached entry list."""
        directory = self._pure_directory()
        if directory is not None:
            return directory.n
        return len(self.entries())

    def iter_record_ids(self) -> Iterator[str]:
        """Stream record ids page-by-page; never builds the full list for
        pure paged plans (O(window) resident, grouped CAS reads)."""
        if self._entries is not None:
            for e in self._entries:
                yield e.record_id
            return
        directory = self._pure_directory()
        if directory is None:
            for e in self.iter_entries():
                yield e.record_id
            return
        for raw in self._dm.versions.iter_page_records(directory):
            for o in raw:
                yield o["id"]

    def _entry(self, record_id: str) -> RecordEntry:
        self.entries()
        assert self._by_id is not None
        return self._by_id[record_id]

    def attrs(self, record_id: str) -> Mapping[str, object]:
        return self._entry(record_id).attrs

    def read(self, record_id: str) -> bytes:
        return self._dm.store.get_blob(self._entry(record_id).blob)

    def read_batch(self, record_ids: Sequence[str]) -> List[bytes]:
        """Batched payload fetch (grouped CAS lookups, chunk dedup)."""
        return self._dm.store.get_blobs(
            [self._entry(r).blob for r in record_ids])

    def read_entries(self, entries: Sequence[RecordEntry]) -> List[bytes]:
        """Grouped payload fetch for already-resolved entries.

        Unlike :meth:`read_batch` this never forces :meth:`entries` — the
        loader's page-window mode resolves entries page-by-page and reads
        payloads here, so a feed stays O(window) resident end to end."""
        return self._dm.store.get_blobs([e.blob for e in entries])

    def content_digest(self) -> str:
        h = hashlib.sha256()
        for e in self.entries():  # cached — the loader calls this + ids
            h.update(e.record_id.encode())
            h.update(e.blob.digest.encode())
        return h.hexdigest()

    # -- page-granular feed surface (ShardedSnapshotLoader page-window mode) --
    #
    # Pure plans (no query/shard/limit) over paged trees serve the commit's
    # real manifest pages: page count / sizes come from the directory header
    # (no page reads), per-page ids/entries read exactly one page blob, and
    # payloads ride the grouped ``get_blobs`` machinery.  Anything else
    # (filtered plans, legacy monolithic trees, materialized snapshots)
    # degrades to fixed-size slices of the cached entry list — same
    # interface, without the O(window) memory guarantee.

    def _pure_directory(self):
        """The commit's page directory iff this plan is a full-tree read
        (TrueQuery, no shard, no limit) over a paged manifest; else None."""
        if not isinstance(self.query, TrueQuery) or self.shard is not None \
                or self.limit is not None:
            return None
        return self._dm.versions.get_page_directory(
            self._dm.versions.get_commit(self.commit_id).tree)

    def page_count(self) -> int:
        directory = self._pure_directory()
        if directory is not None:
            return len(directory.pages)
        n = len(self.entries())
        step = Snapshot.FEED_PAGE_SIZE
        return (n + step - 1) // step

    def page_sizes(self) -> List[int]:
        """Per-page record counts — directory metadata only (no page
        reads), which is what lets the loader seek to any stream position
        without touching data."""
        directory = self._pure_directory()
        if directory is not None:
            return [p.n for p in directory.pages]
        n, step = len(self.entries()), Snapshot.FEED_PAGE_SIZE
        return [min(step, n - off) for off in range(0, n, step)] or []

    def page_record_ids(self, page_index: int) -> List[str]:
        directory = self._pure_directory()
        if directory is not None:
            return [o["id"] for o in self._dm.versions.get_page_records(
                directory.pages[page_index].digest)]
        return [e.record_id for e in self.page_entries(page_index)]

    def page_entries(self, page_index: int) -> List[RecordEntry]:
        """One page's entries — O(page) for pure paged plans."""
        directory = self._pure_directory()
        if directory is not None:
            return [RecordEntry.from_raw(o)
                    for o in self._dm.versions.get_page_records(
                        directory.pages[page_index].digest)]
        step = Snapshot.FEED_PAGE_SIZE
        return self.entries()[page_index * step:(page_index + 1) * step]

    def read_pages(self, page_indices: Sequence[int]
                   ) -> List[List[RecordEntry]]:
        """Many pages' entries per grouped CAS read — the loader's
        page-window fill path (one ``get_jsons`` window per
        ``_PAGE_FETCH_WINDOW`` pages instead of a round trip per page)."""
        directory = self._pure_directory()
        if directory is not None:
            return [[RecordEntry.from_raw(o) for o in raw]
                    for raw in self._dm.versions.iter_page_records(
                        directory, list(page_indices))]
        return [self.page_entries(pi) for pi in page_indices]

    def pages_digest(self) -> str:
        """Cheap content identity for page feeds.

        For pure paged plans this hashes the page directory rows (page
        blobs are content-addressed, so equal digests == equal content)
        without reading a single page; otherwise it equals
        :meth:`content_digest`."""
        directory = self._pure_directory()
        if directory is None:
            return self.content_digest()
        h = hashlib.sha256()
        h.update(b"pages:")
        for p in directory.pages:
            h.update(p.digest.encode())
        return h.hexdigest()

    # -- materialization -------------------------------------------------------

    def snapshot(self, register: bool = True) -> Snapshot:
        """Materialize a :class:`Snapshot`; register=True records lineage,
        deduping onto an existing snapshot node for identical plans."""
        return self._dm._materialize(self, register=register)

    def transform(self, pipeline, output: Optional[str] = None,
                  actor: str = "derive", **kwargs):
        """Derive a new version by running ``pipeline`` over this plan's
        record stream — cached, incremental, streaming (see
        :class:`repro_torch.core.derive.DerivationEngine`).

        ``output`` names the dataset the result is checked into; with a
        serializable query the derivation is cached on (commit, query,
        pipeline) and an identical call short-circuits to the cached
        output commit.  Returns a
        :class:`~repro_torch.core.derive.DerivationResult`.
        """
        from .derive import DerivationEngine

        engine = DerivationEngine.for_manager(self._dm)
        return engine.derive(self, pipeline, output_dataset=output,
                             actor=actor, **kwargs)

    def __repr__(self) -> str:
        return (f"CheckoutPlan({self.dataset}@{self.rev}, "
                f"commit={self.commit_id[:12]}, "
                f"digest={(self.query_digest() or 'opaque')[:12]})")


class DatasetManager:
    """Core module #1 of the platform (Fig. 2).

    .. note:: new code should go through :class:`repro_torch.platform.Platform`
       and its dataset handles — that facade is the supported public
       surface; the methods here are its engine (and the deprecation shim
       for pre-facade callers).
    """

    def __init__(
        self,
        store: Optional[ObjectStore] = None,
        acl: Optional[AccessController] = None,
        lineage: Optional[LineageGraph] = None,
        page_size: Optional[int] = None,
    ) -> None:
        self.store = store if store is not None else ObjectStore(MemoryBackend())
        self.versions = VersionStore(self.store, page_size=page_size)
        self.acl = acl if acl is not None else AccessController(self.store)
        self.lineage = lineage if lineage is not None else LineageGraph(self.store)
        # Commit listeners: the workflow manager subscribes here to implement
        # "Trigger a workflow by event (new dataset version ...)".
        self._commit_listeners: List[Callable[[str, Commit], None]] = []
        # Per-dataset commit-DAG adjacency memo, keyed by the dataset's
        # commit-id list so any writer (including merges that bypass
        # check_in) invalidates it for the cost of one metadata read.
        self._children_cache: Dict[
            str, Tuple[Tuple[str, ...], Tuple[Dict[str, List[str]], set]]] = {}

    def on_commit(self, fn: Callable[[str, Commit], None]) -> None:
        self._commit_listeners.append(fn)

    # ------------------------------------------------------------------ datasets

    def _dataset_meta_key(self, name: str) -> str:
        return f"dataset/{name}"

    def list_datasets(self) -> List[str]:
        prefix = "dataset/"
        return sorted(k[len(prefix):] for k in self.store.list_meta(prefix))

    def dataset_info(self, name: str) -> Optional[dict]:
        return self.store.get_meta(self._dataset_meta_key(name))

    def _ensure_dataset(self, name: str, actor: str) -> dict:
        info = self.dataset_info(name)
        if info is None:
            info = {
                "name": name,
                "created_by": actor,
                "created_at": time.time(),
                "tags": [],
            }
            self.store.put_meta(self._dataset_meta_key(name), info)
        return info

    def tag_dataset(self, name: str, tag: str, actor: str) -> None:
        with self.store.meta_batch(prefetch=[self._dataset_meta_key(name)]):
            self.acl.check(actor, Action.WRITE, name,
                           note=f"tag_dataset:{tag}")
            info = self._ensure_dataset(name, actor)
            if tag not in info["tags"]:
                info["tags"].append(tag)
                self.store.put_meta(self._dataset_meta_key(name), info)

    def query_datasets(
        self,
        name_glob: str = "*",
        tags: Sequence[str] = (),
        attrs: Optional[Mapping[str, object]] = None,
    ) -> List[str]:
        """Query datasets by name pattern / dataset tags / info attributes."""
        out = []
        for name in self.list_datasets():
            if not fnmatch.fnmatch(name, name_glob):
                continue
            info = self.dataset_info(name) or {}
            if tags and not set(tags).issubset(set(info.get("tags", []))):
                continue
            if attrs and any(info.get(k) != v for k, v in attrs.items()):
                continue
            out.append(name)
        return out

    # ------------------------------------------------------------------ check-in

    # Optimistic multi-writer retry: how many times a lost head CAS is
    # rebased onto the new head before giving up, and the backoff base
    # (doubled per attempt, jittered, capped at 1 s) so contended writers
    # spread out instead of thundering.  The bound is sized for the worst
    # case the stress harness produces — many processes all racing one
    # fresh branch with injected CAS faults slowing every swap.
    _REBASE_MAX_RETRIES = 16
    _REBASE_BACKOFF_S = 0.01
    _REBASE_BACKOFF_CAP_S = 1.0

    def check_in(
        self,
        dataset: str,
        records: Iterable[Record],
        actor: str,
        message: str = "",
        branch: str = "main",
        version_tags: Sequence[str] = (),
        base: Optional[str] = None,
        remove_ids: Sequence[str] = (),
        derived_from: Sequence[str] = (),
        produced_by: Optional[str] = None,
        meta: Optional[Mapping[str, object]] = None,
        replace: bool = False,
        on_conflict: str = "rebase",
        notify: bool = True,
    ) -> Commit:
        """Add/replace records on top of ``base`` (default: branch head).

        ``records`` may mix :class:`Record` (payload bytes, stored here)
        and :class:`RecordEntry` (a ref whose blob is already in the CAS —
        the derivation engine's reuse path, which must not re-hash
        unchanged payloads).

        The delta path never materializes the base manifest: the records
        become an add/remove delta that ``VersionStore.commit_delta``
        applies at page granularity, so committing a small change to a
        huge dataset costs O(delta + touched pages), not O(dataset).

        ``replace=True`` makes the new manifest exactly ``records``
        (materialized-view semantics: base records not re-supplied are
        dropped); the commit still parents onto ``base`` so history and
        diffs are preserved.

        **Concurrent writers.** The branch head moves through a strict
        compare-and-swap; losing the swap never loses the update.  With
        ``on_conflict="rebase"`` (default) the loser re-reads the new head
        and replays its delta on top — disjoint-page writers merge by pure
        page-digest skipping, overlapping pages re-apply record adds and
        removes with deterministic per-record last-writer-wins — inside a
        bounded, jitter-backed retry loop.  ``on_conflict="error"`` raises
        :class:`~repro_torch.core.store.CommitConflictError` (naming the
        dataset, ref, and overlapping records) when the rebase would touch
        a record the winning commit also changed; disjoint writers still
        merge silently.  Each rebase is counted in
        ``store.stats.commit_rebases``.

        ``derived_from`` — lineage node ids this version derives from.
        ``produced_by``  — workflow/component run node id.
        ``notify=False`` skips the commit listeners (callers composing a
        larger atomic flush run them via :meth:`notify_commit` once their
        own scope has landed).
        """
        if on_conflict not in ("rebase", "error"):
            raise ValueError("on_conflict must be 'rebase' or 'error'")
        retryable = {f"refs/{dataset}/heads/{branch}",
                     f"commits/{dataset}", f"recindex/{dataset}"}
        state: Dict[str, object] = {}
        attempt = 0
        while True:
            try:
                commit = self._check_in_attempt(
                    dataset, records, actor, message, branch, version_tags,
                    base, remove_ids, derived_from, produced_by, meta,
                    replace, on_conflict, attempt, state)
                break
            except CommitConflictError as err:
                # Only head/commit-index/record-index races are rebased;
                # a conflict naming records is the strict mode's verdict
                # and anything else is not ours to absorb.
                if err.records or err.ref not in retryable \
                        or attempt >= self._REBASE_MAX_RETRIES:
                    raise
                cid = state.pop("commit_id", None)
                if cid and self._commit_published(
                        dataset, branch, cid, state.get("first_base")):
                    # Our head swap actually APPLIED — its response was
                    # lost and another writer built on top before the CAS
                    # loop could observe the replay.  The commit is live
                    # history, not junk: retrying would double-publish it
                    # and scrub a reachable commit from the GC-root index.
                    commit = self.versions.get_commit(cid)
                    break
                attempt += 1
                self.store.stats.commit_rebases += 1
                # The aborted attempt's commit id may already sit in the
                # commit/record indexes (they land before the head CAS that
                # just lost) — remember it so the retry scrubs it out.
                if cid:
                    state.setdefault("junk", set()).add(cid)
                time.sleep(random.uniform(0.0, min(
                    self._REBASE_BACKOFF_CAP_S,
                    self._REBASE_BACKOFF_S * (2 ** (attempt - 1)))))
        # Listeners run after the flush: a triggered workflow's own
        # check_ins must see (and build on) fully-landed state.
        if notify:
            self.notify_commit(dataset, commit)
        return commit

    def _commit_published(self, dataset: str, branch: str, cid: str,
                          stop: Optional[str]) -> bool:
        """Did ``cid`` actually land on the branch despite a lost CAS?
        Walks the current head's first-parent chain back to ``stop`` (the
        attempt's base) — a conditional swap whose response was lost still
        applied iff the commit is an ancestor of whatever head we lost to."""
        cur = self.versions.get_branch(dataset, branch)
        seen = set()
        while cur is not None and cur != stop and cur not in seen:
            if cur == cid:
                return True
            seen.add(cur)
            try:
                c = self.versions.get_commit(cur)
            except NotFoundError:
                return False
            cur = c.parents[0] if c.parents else None
        return False

    def notify_commit(self, dataset: str, commit: Commit) -> None:
        """Run the commit listeners (workflow triggers).  ``check_in``
        calls this itself unless ``notify=False`` deferred it to a caller
        composing a larger atomic flush."""
        for fn in self._commit_listeners:
            fn(dataset, commit)

    def _check_rebase_overlap(
        self,
        dataset: str,
        branch: str,
        first_base: Optional[str],
        head: Optional[str],
        adds: Mapping[str, RecordEntry],
        removes: Iterable[str],
        replace: bool,
    ) -> None:
        """Strict-mode gate before a rebase attempt: raise if the records
        this delta touches intersect what moved under us."""
        ref = f"refs/{dataset}/heads/{branch}"
        ours = set(adds) | set(removes)
        if replace:
            # replace rewrites the whole manifest: any head move conflicts
            raise CommitConflictError(
                ref, expected=first_base, current=head,
                dataset=dataset, records=sorted(ours))
        if first_base and head:
            moved = self.versions.diff(first_base, head)
            theirs = set(moved.added) | set(moved.modified) \
                | set(moved.removed)
        elif head:
            # No common base (we started from an empty branch): everything
            # now on the head counts as the winner's change set.
            tree = self.versions.get_commit(head).tree
            theirs = set(self.versions.get_manifest(tree).record_ids())
        else:
            theirs = set()
        overlap = ours & theirs
        if overlap:
            raise CommitConflictError(
                ref, expected=first_base, current=head,
                dataset=dataset, records=sorted(overlap))

    def _check_in_attempt(
        self,
        dataset: str,
        records: Iterable[Record],
        actor: str,
        message: str,
        branch: str,
        version_tags: Sequence[str],
        base: Optional[str],
        remove_ids: Sequence[str],
        derived_from: Sequence[str],
        produced_by: Optional[str],
        meta: Optional[Mapping[str, object]],
        replace: bool,
        on_conflict: str,
        attempt: int,
        state: Dict[str, object],
    ) -> Commit:
        # The whole commit runs in ONE meta-batch scope: the known read
        # set prefetches in one grouped get, every meta write (dataset
        # info, commit body+index, record index, lineage + audit segments)
        # stages, and the flush lands blobs → write-once meta → the branch
        # ref (CAS-guarded) in a handful of round trips.
        prefetch = [
            self._dataset_meta_key(dataset),
            f"commits/{dataset}",
            f"refs/{dataset}/heads/{branch}",
            f"recindex/{dataset}",
            self.lineage.pending_seg_key(),
            self.acl.pending_seg_key(),
        ]
        with self.store.meta_batch(prefetch=prefetch):
            self.acl.check(actor, Action.WRITE, dataset, note="check_in")
            self._ensure_dataset(dataset, actor)

            head = self.versions.get_branch(dataset, branch)
            base_id = base or head
            if "adds" not in state:
                # Payloads content-address once: blobs flush before any
                # conflict can surface, so a rebase retry reuses the same
                # RecordEntry refs without re-hashing or re-uploading.
                state["adds"] = self._store_records(records)
                state["removes"] = list(remove_ids)
                state["first_base"] = base_id
            if attempt and on_conflict == "error" and base is None:
                self._check_rebase_overlap(
                    dataset, branch, state["first_base"], head,
                    state["adds"], state["removes"], replace)
            adds = dict(state["adds"])
            removes = list(state["removes"])
            for rid in removes:
                adds.pop(rid, None)  # removal wins over a same-call add

            if replace or base_id is None:
                manifest = Manifest(adds.values())
                commit = self.versions.commit(
                    dataset,
                    manifest,
                    parents=[base_id] if base_id else [],
                    author=actor,
                    message=message,
                    meta=meta,
                )
                # Page-wise diff vs base (shared pages skip wholesale); a
                # replace of an unchanged view costs O(pages), not
                # O(records).
                delta = (self.versions.diff(base_id, commit.commit_id)
                         if base_id else VersionDiff(added=sorted(adds)))
                n_records = len(manifest)
            else:
                commit, delta, n_records = self.versions.commit_delta(
                    dataset, base_id, adds, removes,
                    author=actor, message=message, meta=meta)
            state["commit_id"] = commit.commit_id
            junk = frozenset(state.get("junk") or ())
            if junk:
                # Scrub this call's own aborted attempts from the GC-root
                # commit index: their commits never published, so leaving
                # them would pin dead pages forever.  The merge keeps
                # scrubbing when the CAS re-reads a copy that has them.
                ikey = f"commits/{dataset}"
                idx = [c for c in self.store.get_meta(ikey, default=[])
                       if c not in junk]
                if commit.commit_id not in idx:
                    idx.append(commit.commit_id)
                self.store.put_meta(ikey, idx)
                self.store.require_meta_cas(
                    ikey,
                    merge=lambda cur, cid=commit.commit_id, junk=junk:
                        [c for c in (cur or [])
                         if c not in junk and c != cid] + [cid])
            self.versions.set_branch(dataset, branch, commit.commit_id,
                                     strict=True)
            for tag in version_tags:
                self.versions.set_tag(dataset, tag, commit.commit_id)

            # Record-containment index (drives revocation without full
            # scans): only the records this commit actually
            # added/changed/removed are indexed, so the blob grows
            # O(delta) per commit, not O(records).
            self._index_records(dataset, commit.commit_id, delta, drop=junk)

            # Lineage: version node + derivation/production edges.
            vnode = version_node_id(dataset, commit.commit_id)
            self.lineage.add_node(vnode, NodeKind.DATASET_VERSION,
                                  dataset=dataset, commit=commit.commit_id,
                                  n_records=n_records)
            if base_id:
                self.lineage.add_edge(vnode,
                                      version_node_id(dataset, base_id),
                                      EdgeKind.DERIVED_FROM)
            for src in derived_from:
                self.lineage.add_edge(vnode, src, EdgeKind.DERIVED_FROM)
            if produced_by:
                self.lineage.add_edge(vnode, produced_by,
                                      EdgeKind.PRODUCED_BY)
            self.lineage.flush()
            # Commit boundary = audit boundary: buffered allow/deny
            # decisions persist with the commit (free inside the batch)
            # instead of waiting for the every-64th-event trigger.
            self.acl.flush_audit()
        return commit

    # Payload batching: how many records / bytes one grouped
    # ``ObjectStore.put_blobs`` flush may span (bounds peak memory for the
    # encoded copies while keeping the per-call dedup probe amortized).
    _PUT_WINDOW_RECORDS = 1024
    _PUT_WINDOW_BYTES = 32 * 1024 * 1024

    def _store_records(
        self, records: Iterable[Union[Record, RecordEntry]]
    ) -> Dict[str, RecordEntry]:
        """Content-address every payload through the batched write path.

        Mixed inputs are fine: :class:`RecordEntry` refs pass through
        (their blobs are already stored — the derivation reuse contract),
        :class:`Record` payloads flush through ``put_blobs`` in bounded
        windows.  Insertion order matches the input order, so a duplicate
        record id keeps its last occurrence exactly like the sequential
        loop did.
        """
        adds: Dict[str, RecordEntry] = {}
        slots: List[Union[RecordEntry, Record]] = []
        window: List[Record] = []
        window_bytes = 0

        def flush() -> None:
            nonlocal window_bytes
            if not window:
                return
            refs = self.store.put_blobs([r.data for r in window])
            resolved = iter(refs)
            for i, slot in enumerate(slots):
                if isinstance(slot, Record):
                    slots[i] = RecordEntry(slot.record_id, next(resolved),
                                           dict(slot.attrs))
            for slot in slots:
                adds[slot.record_id] = slot  # type: ignore[assignment]
            window.clear()
            slots.clear()
            window_bytes = 0

        for rec in records:
            if isinstance(rec, RecordEntry):
                slots.append(RecordEntry(rec.record_id, rec.blob,
                                         dict(rec.attrs)))
                continue
            slots.append(rec)
            window.append(rec)
            window_bytes += len(rec.data)
            if (len(window) >= self._PUT_WINDOW_RECORDS
                    or window_bytes >= self._PUT_WINDOW_BYTES):
                flush()
        flush()
        for slot in slots:  # tail of RecordEntry-only input
            adds[slot.record_id] = slot  # type: ignore[assignment]
        return adds

    def _index_records(self, dataset: str, commit_id: str,
                       delta: Union[VersionDiff, Manifest],
                       drop: FrozenSet[str] = frozenset()) -> None:
        """Event index: record -> commits where it was added/changed or
        removed.  Containment at any commit is reconstructed by walking the
        commit DAG forward from add events (:meth:`versions_with_record`),
        so unchanged records cost nothing per commit.

        A full :class:`Manifest` is also accepted (compat for out-of-band
        commits, e.g. merges): every record counts as an add event.
        ``drop`` scrubs events left behind by this call's own aborted
        rebase attempts (their commits never published).
        """
        if isinstance(delta, Manifest):
            delta = VersionDiff(added=delta.record_ids())
        if delta.is_empty and not drop:
            return
        key = f"recindex/{dataset}"

        def apply(idx):
            if idx is None:
                idx = {"v": 2, "added": {}, "removed": {}}
            elif "added" not in idx:
                idx = self._migrate_legacy_index(dataset, idx)
            if drop:
                for bucket in ("added", "removed"):
                    table = idx.get(bucket, {})
                    for rid in list(table):
                        kept = [c for c in table[rid] if c not in drop]
                        if kept:
                            table[rid] = kept
                        else:
                            del table[rid]
            for rid in delta.added + delta.modified:
                cids = idx["added"].setdefault(rid, [])
                if commit_id not in cids:
                    cids.append(commit_id)
            for rid in delta.removed:
                cids = idx["removed"].setdefault(rid, [])
                if commit_id not in cids:
                    cids.append(commit_id)
            return idx

        self.store.put_meta(key, apply(self.store.get_meta(key, default=None)))
        # The index drives revocation: a lost update would hide a record's
        # containment.  Inside a batch the key goes through CAS with
        # ``apply`` as the conflict merge — a concurrent writer's events
        # are kept and this commit's re-applied on top, never clobbered.
        self.store.require_meta_cas(key, merge=apply)

    def _migrate_legacy_index(self, dataset: str, legacy: Dict) -> dict:
        """One-time upgrade of a pre-delta flat index (rid -> [commits]).

        The flat lists are *exact* containment with no removal events, so
        they must NOT seed the forward DAG walk (that would extend records
        past pre-migration deletions).  They are kept verbatim in a
        ``legacy`` bucket; records still live on some branch head get a
        fresh add event there so post-migration commits are covered.
        """
        idx = {"v": 2, "added": {}, "removed": {}, "legacy": legacy}
        for branch in self.versions.list_branches(dataset):
            head = self.versions.get_branch(dataset, branch)
            if head is None:
                continue
            try:
                man = self.versions.get_manifest(
                    self.versions.get_commit(head).tree)
            except NotFoundError:
                continue
            for rid in legacy:
                if rid in man:
                    cids = idx["added"].setdefault(rid, [])
                    if head not in cids:
                        cids.append(head)
        return idx

    # ------------------------------------------------------------------ checkout

    def plan_checkout(
        self,
        dataset: str,
        actor: str,
        rev: str = "main",
        where: Union[Query, Predicate, str, dict, None] = None,
        attrs_equal: Optional[Mapping[str, object]] = None,
        limit: Optional[int] = None,
        shard: Optional[Tuple[int, int]] = None,
        use_index: bool = True,
    ) -> CheckoutPlan:
        """Build a lazy :class:`CheckoutPlan` for a queried dataset version.

        "Users or workflows can checkout data by specifying query
        conditions." — ``where`` is a declarative
        :class:`~repro_torch.core.query.Query` (also accepted: a CLI string, a
        query-JSON dict, or — deprecated — a bare callable predicate);
        ``attrs_equal`` is the exact-match shorthand, folded into the query.
        """
        self.acl.check(actor, Action.READ, dataset, note=f"checkout:{rev}")
        commit_id = self.versions.resolve(dataset, rev)
        query = as_query(where)
        if attrs_equal:
            eq = [Cmp(k, "eq", v) for k, v in sorted(attrs_equal.items())]
            for c in eq:
                query = c if query is None else query & c
        return CheckoutPlan(self, dataset, commit_id, rev, query=query,
                            limit=limit, shard=shard, use_index=use_index)

    def checkout(
        self,
        dataset: str,
        actor: str,
        rev: str = "main",
        where: Union[Query, Predicate, str, dict, None] = None,
        attrs_equal: Optional[Mapping[str, object]] = None,
        limit: Optional[int] = None,
        register_snapshot: bool = True,
    ) -> Snapshot:
        """Materialize (a queried subset of) a dataset version.

        Shim over :meth:`plan_checkout` + :meth:`CheckoutPlan.snapshot`;
        prefer ``Platform.open(...).dataset(name).checkout(...)``.
        """
        plan = self.plan_checkout(dataset, actor, rev=rev, where=where,
                                  attrs_equal=attrs_equal, limit=limit)
        return plan.snapshot(register=register_snapshot)

    def _materialize(self, plan: CheckoutPlan, register: bool = True) -> Snapshot:
        """Turn a plan into a Snapshot, deduping lineage registration.

        The snapshot id is a pure function of ``(dataset, commit_id,
        query_digest)``, so the dedup "cache" is simply: does that lineage
        node already exist?  No side-band cache state to race or go stale.
        """
        digest = plan.query_digest()
        if digest is not None:
            sid_body = f"{plan.dataset}:{plan.commit_id}:{digest}"
            snap_id = "snapshot:" + hashlib.sha256(
                sid_body.encode()).hexdigest()[:16]
            if register and self.lineage.node(snap_id) is not None:
                return Snapshot(snap_id, plan.dataset, plan.commit_id,
                                plan.entries(), self.store)
        else:
            snap_id = f"snapshot:{uuid.uuid4().hex[:16]}"
        entries = plan.entries()
        snap = Snapshot(snap_id, plan.dataset, plan.commit_id, entries,
                        self.store)
        if register:
            with self.store.meta_batch(
                    prefetch=[self.lineage.pending_seg_key()]):
                self.lineage.add_node(
                    snap_id, NodeKind.SNAPSHOT,
                    dataset=plan.dataset, commit=plan.commit_id,
                    n_records=len(entries), content=snap.content_digest(),
                    query=digest)
                self.lineage.add_edge(
                    snap_id, version_node_id(plan.dataset, plan.commit_id),
                    EdgeKind.DERIVED_FROM)
                self.lineage.flush()
        return snap

    # ------------------------------------------------------------------ misc ops

    def read_record(self, dataset: str, record_id: str, actor: str,
                    rev: str = "main") -> bytes:
        snap = self.checkout(dataset, actor, rev=rev, register_snapshot=False)
        return snap.read(record_id)

    def delete_records(self, dataset: str, record_ids: Sequence[str], actor: str,
                       message: str = "delete records") -> Commit:
        """Logical delete: a new version without the records."""
        return self.check_in(dataset, [], actor, message=message,
                             remove_ids=record_ids)

    def diff(self, dataset: str, rev_a: str, rev_b: str, actor: str) -> VersionDiff:
        self.acl.check(actor, Action.READ, dataset, note="diff")
        a = self.versions.resolve(dataset, rev_a)
        b = self.versions.resolve(dataset, rev_b)
        return self.versions.diff(a, b)

    def tag_version(self, dataset: str, rev: str, tag: str, actor: str) -> None:
        self.acl.check(actor, Action.WRITE, dataset, note=f"tag:{tag}")
        self.versions.set_tag(dataset, tag, self.versions.resolve(dataset, rev))

    def _commit_children(
        self, dataset: str
    ) -> Tuple[Dict[str, List[str]], set]:
        """Forward adjacency of the commit DAG + the set of merge commits.

        Memoized per dataset: rebuilding the adjacency costs one commit-blob
        read per commit, while validating the memo costs one metadata read
        (the commit-id list), so repeated revocation/containment walks stop
        re-reading the whole DAG.  Callers must not mutate the result.
        """
        cids = tuple(self.versions.list_commits(dataset))
        cached = self._children_cache.get(dataset)
        if cached is not None and cached[0] == cids:
            return cached[1]
        children: Dict[str, List[str]] = {}
        merges: set = set()
        for cid in cids:
            try:
                c = self.versions.get_commit(cid)
            except NotFoundError:
                continue
            if len(c.parents) > 1:
                merges.add(cid)
            for p in c.parents:
                children.setdefault(p, []).append(cid)
        self._children_cache[dataset] = (cids, (children, merges))
        return children, merges

    def _manifest_contains(self, commit_id: str, record_id: str) -> bool:
        try:
            man = self.versions.get_manifest(
                self.versions.get_commit(commit_id).tree)
        except NotFoundError:
            return False
        return record_id in man

    def versions_with_record(self, record_id: str) -> List[Tuple[str, str]]:
        """(dataset, commit_id) pairs whose manifests contain the record.

        Containment = forward walk over the commit DAG from each commit
        that added/changed the record, pruned at commits that removed it.
        Merge commits are created outside :meth:`check_in` (no delta
        events), so containment there is verified against the manifest.
        Pre-migration ``legacy`` entries are exact containment lists.
        """
        out: List[Tuple[str, str]] = []
        for name in self.list_datasets():
            idx = self.store.get_meta(f"recindex/{name}", default={})
            if "added" in idx:
                containing = set(
                    idx.get("legacy", {}).get(record_id, []))
                added = idx["added"].get(record_id, [])
                if added:
                    removed = set(
                        idx.get("removed", {}).get(record_id, []))
                    children, merges = self._commit_children(name)
                    frontier = [c for c in added if c not in removed]
                    seen: set = set()
                    while frontier:
                        cid = frontier.pop()
                        if cid in seen:
                            continue
                        seen.add(cid)
                        if cid in merges and not self._manifest_contains(
                                cid, record_id):
                            continue  # merge resolved to drop the record
                        containing.add(cid)
                        frontier.extend(c for c in children.get(cid, [])
                                        if c not in removed)
                if containing:
                    out.extend((name, cid)
                               for cid in self.versions.list_commits(name)
                               if cid in containing)
            else:  # legacy flat index: rid -> [containing commits]
                seen = set()
                for cid in idx.get(record_id, []):
                    if cid not in seen:
                        seen.add(cid)
                        out.append((name, cid))
        return out

    def gc(self) -> int:
        """Collect unreferenced blobs (after revocations / history pruning).

        Roots: every dataset's live digests plus the derivation cache (its
        map blob, provenance blobs, and cached prefix-output payloads) —
        a gc must not silently turn every cached derivation into a cold
        recompute.
        """
        from .derive import derivation_gc_roots

        roots: List[str] = []
        for name in self.list_datasets():
            roots.extend(self.versions.live_digests(name))
        roots.extend(derivation_gc_roots(self.store))
        return self.store.gc(roots)

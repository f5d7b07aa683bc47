"""Dataset versioning: paged merkle manifests, commit DAG, refs, diff, merge.

Paper features covered here: "Dataset versioning — Version control and
version difference".

A dataset *version* is a :class:`Commit` pointing at a *manifest*: the
ordered map ``record_id -> (blob digest, attrs)``.  Manifests are stored as
a **paged merkle tree**: the record-id-sorted entry stream is split into
contiguous pages (``page_size`` records each, content-addressed blobs), and
a small root *page directory* blob — page digests, record counts, key
ranges, per-page attribute summaries — is the commit ``tree``.  The payoff
is that every manifest operation costs what actually changed:

- ``commit_delta`` starts from the parent directory, rewrites only the
  pages the delta touches, and reuses every other page digest verbatim
  (structural sharing), so a small check-in on a huge dataset writes a few
  pages plus one directory instead of re-serializing the whole map.
- ``diff``/``merge`` skip page pairs with equal digests wholesale and only
  deserialize the pages that differ.
- checkout streams page-by-page, and per-page attribute indexes (see
  :mod:`repro_torch.core.index`) let query plans prune whole pages before any
  page blob is read.

Legacy monolithic manifests (one ``{"records": [...]}`` blob per commit)
still load transparently — every reader sniffs the tree blob and takes the
appropriate path ("migrate on read": the first commit on top of a legacy
tree writes the paged layout).  ``VersionStore(page_size=0)`` keeps writing
the monolithic layout, which the equivalence tests and benches use as the
baseline.  Commits form a DAG (parents), enabling branches, tags,
three-way merge and O(changed) diffs.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Set, Tuple, Union)

from .index import AttributeIndex, PagedAttributeIndex, page_summary
from .store import BlobRef, NotFoundError, ObjectStore, sha256_hex

__all__ = [
    "RecordEntry",
    "Manifest",
    "PagedManifest",
    "PageInfo",
    "PageDirectory",
    "Commit",
    "VersionDiff",
    "MergeConflict",
    "VersionStore",
    "raw_entry_matches",
    "DEFAULT_PAGE_SIZE",
]

DEFAULT_PAGE_SIZE = 1024


@dataclass(frozen=True)
class RecordEntry:
    """One record inside a dataset version."""

    record_id: str
    blob: BlobRef
    attrs: Mapping[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "id": self.record_id,
            "blob": self.blob.to_json(),
            "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_json(obj: dict) -> "RecordEntry":
        return RecordEntry(obj["id"], BlobRef.from_json(obj["blob"]), obj.get("attrs", {}))

    @staticmethod
    def from_raw(obj: dict) -> "RecordEntry":
        """Deserialize one raw (possibly cache-shared) manifest record —
        attrs are copied so callers never alias the shared parse.  The ONE
        deserializer behind both checkout paths (full scan via
        ``get_manifest`` and index-pruned candidates), so they cannot
        drift."""
        return RecordEntry(obj["id"], BlobRef.from_json(obj["blob"]),
                           dict(obj.get("attrs", {})))


class Manifest:
    """Ordered record_id -> RecordEntry map; content-addressed when stored."""

    def __init__(self, entries: Optional[Iterable[RecordEntry]] = None) -> None:
        self._entries: Dict[str, RecordEntry] = {}
        for e in entries or []:
            self.add(e)

    def add(self, entry: RecordEntry) -> None:
        self._entries[entry.record_id] = entry

    def remove(self, record_id: str) -> None:
        self._entries.pop(record_id, None)

    def get(self, record_id: str) -> Optional[RecordEntry]:
        return self._entries.get(record_id)

    def __contains__(self, record_id: str) -> bool:
        return record_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter(self.entries())

    def record_ids(self) -> List[str]:
        return sorted(self._entries)

    def entries(self) -> List[RecordEntry]:
        return [self._entries[rid] for rid in self.record_ids()]

    def iter_entries(self) -> Iterable[RecordEntry]:
        """Stream entries in record-id order without building a list copy."""
        for rid in sorted(self._entries):
            yield self._entries[rid]

    def to_json(self) -> dict:
        return {"records": [e.to_json() for e in self.entries()]}

    @staticmethod
    def from_json(obj: dict) -> "Manifest":
        return Manifest(RecordEntry.from_json(e) for e in obj.get("records", []))

    def copy(self) -> "Manifest":
        return Manifest(self.entries())


# ---------------------------------------------------------------------------
# Paged layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PageInfo:
    """Directory row for one manifest page."""

    digest: str                       # page blob digest
    n: int                            # records in the page
    lo: str                           # first record id
    hi: str                           # last record id
    summary: Mapping[str, dict] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"blob": self.digest, "n": self.n, "lo": self.lo,
                "hi": self.hi, "summary": dict(self.summary)}

    @staticmethod
    def from_json(obj: dict) -> "PageInfo":
        return PageInfo(obj["blob"], int(obj["n"]), obj["lo"], obj["hi"],
                        obj.get("summary", {}))


class PageDirectory:
    """The root of a paged manifest: ordered page rows + key ranges."""

    VERSION = 1

    def __init__(self, pages: Sequence[PageInfo],
                 page_size: int = DEFAULT_PAGE_SIZE) -> None:
        self.pages = list(pages)
        self.page_size = page_size
        self.n = sum(p.n for p in self.pages)
        self._his = [p.hi for p in self.pages]

    def offsets(self) -> List[int]:
        """Global position of each page's first record."""
        out, total = [], 0
        for p in self.pages:
            out.append(total)
            total += p.n
        return out

    def page_for(self, record_id: str) -> int:
        """Index of the page that contains — or would receive — ``rid``.

        Pages partition the sorted record-id space contiguously, so this is
        the first page whose ``hi`` bound is >= the id (ids past the last
        ``hi`` route to the last page).  -1 iff the directory is empty.
        """
        if not self.pages:
            return -1
        return min(bisect.bisect_left(self._his, record_id),
                   len(self.pages) - 1)

    def page_digests(self) -> Set[str]:
        return {p.digest for p in self.pages}

    def to_json(self) -> dict:
        return {
            "v": self.VERSION,
            "kind": "pagedir",
            "page_size": self.page_size,
            "n": self.n,
            "pages": [p.to_json() for p in self.pages],
        }

    @staticmethod
    def from_json(obj: dict) -> "PageDirectory":
        return PageDirectory(
            [PageInfo.from_json(p) for p in obj.get("pages", [])],
            int(obj.get("page_size", DEFAULT_PAGE_SIZE)))

    def stats(self) -> dict:
        """Page-level shape + per-page summaries (quality-tooling surface)."""
        return {
            "n_records": self.n,
            "n_pages": len(self.pages),
            "page_size": self.page_size,
            "pages": [{"n": p.n, "lo": p.lo, "hi": p.hi,
                       "summary": dict(p.summary)} for p in self.pages],
        }


class PagedManifest(Manifest):
    """Lazy read view over a page directory.

    Satisfies the full :class:`Manifest` surface; reads resolve through
    the directory (``get``/``in`` load one page, ``iter_entries`` streams
    pages, ``len`` is free) and the first mutation materializes the entry
    dict so writers see plain-Manifest semantics.
    """

    def __init__(self, vs: "VersionStore", directory: PageDirectory) -> None:
        self._vs = vs
        self._dir = directory
        self._entries: Optional[Dict[str, RecordEntry]] = None  # type: ignore[assignment]

    @property
    def directory(self) -> PageDirectory:
        return self._dir

    def _materialize(self) -> Dict[str, RecordEntry]:
        if self._entries is None:
            self._entries = {e.record_id: e for e in self._iter_pages()}
        return self._entries

    def _iter_pages(self) -> Iterator[RecordEntry]:
        for raw in self._vs.iter_page_records(self._dir):
            for o in raw:
                yield RecordEntry.from_raw(o)

    # -- reads ---------------------------------------------------------------

    def get(self, record_id: str) -> Optional[RecordEntry]:
        if self._entries is not None:
            return self._entries.get(record_id)
        pi = self._dir.page_for(record_id)
        if pi < 0:
            return None
        recs = self._vs.get_page_records(self._dir.pages[pi].digest)
        i = bisect.bisect_left(recs, record_id, key=lambda o: o["id"])
        if i < len(recs) and recs[i]["id"] == record_id:
            return RecordEntry.from_raw(recs[i])
        return None

    def __contains__(self, record_id: str) -> bool:
        return self.get(record_id) is not None

    def __len__(self) -> int:
        if self._entries is not None:
            return len(self._entries)
        return self._dir.n

    def record_ids(self) -> List[str]:
        if self._entries is not None:
            return sorted(self._entries)
        return [o["id"] for raw in self._vs.iter_page_records(self._dir)
                for o in raw]

    def entries(self) -> List[RecordEntry]:
        if self._entries is not None:
            return [self._entries[rid] for rid in sorted(self._entries)]
        return list(self._iter_pages())

    def iter_entries(self) -> Iterable[RecordEntry]:
        if self._entries is not None:
            yield from (self._entries[rid] for rid in sorted(self._entries))
            return
        yield from self._iter_pages()

    def to_json(self) -> dict:
        return {"records": [e.to_json() for e in self.entries()]}

    def copy(self) -> "Manifest":
        return Manifest(self.iter_entries())

    # -- writes (materialize first) ------------------------------------------

    def add(self, entry: RecordEntry) -> None:
        self._materialize()[entry.record_id] = entry

    def remove(self, record_id: str) -> None:
        self._materialize().pop(record_id, None)


@dataclass(frozen=True)
class Commit:
    """One immutable dataset version."""

    commit_id: str            # digest of the commit body
    dataset: str
    tree: str                 # manifest blob digest
    parents: Tuple[str, ...]
    author: str
    message: str
    timestamp: float
    meta: Mapping[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "dataset": self.dataset,
            "tree": self.tree,
            "parents": list(self.parents),
            "author": self.author,
            "message": self.message,
            "timestamp": self.timestamp,
            "meta": dict(self.meta),
        }

    @staticmethod
    def from_json(commit_id: str, obj: dict) -> "Commit":
        return Commit(
            commit_id=commit_id,
            dataset=obj["dataset"],
            tree=obj["tree"],
            parents=tuple(obj.get("parents", [])),
            author=obj.get("author", ""),
            message=obj.get("message", ""),
            timestamp=obj.get("timestamp", 0.0),
            meta=obj.get("meta", {}),
        )


@dataclass
class VersionDiff:
    """Difference between two versions — the paper's "version difference"."""

    added: List[str] = field(default_factory=list)
    removed: List[str] = field(default_factory=list)
    modified: List[str] = field(default_factory=list)
    unchanged: int = 0

    @property
    def is_empty(self) -> bool:
        return not (self.added or self.removed or self.modified)

    def summary(self) -> str:
        return (
            f"+{len(self.added)} -{len(self.removed)} ~{len(self.modified)} "
            f"={self.unchanged}"
        )


class MergeConflict(RuntimeError):
    def __init__(self, record_ids: Sequence[str]):
        super().__init__(f"merge conflict on {len(record_ids)} record(s): "
                         f"{list(record_ids)[:5]}")
        self.record_ids = list(record_ids)


class VersionStore:
    """Commit/ref layer over an :class:`ObjectStore`.

    Refs are mutable metadata: ``refs/<dataset>/heads/<branch>`` and
    ``refs/<dataset>/tags/<tag>`` point at commit ids.

    ``page_size`` controls how new manifests are written: the default
    paged merkle layout, or — with ``page_size=0`` — the legacy monolithic
    blob (kept as the measurable baseline; reads always accept both).
    """

    # Parsed caches.  Trees, pages and page indexes are content-addressed
    # (immutable), so entries can never go stale; caps only bound memory.
    _RECORDS_CACHE_CAP = 4
    _PAGE_CACHE_CAP = 128
    _DIR_CACHE_CAP = 16
    _INDEX_CACHE_CAP = 8
    _COMMIT_CACHE_CAP = 256
    _PAGEIDX_MEMO_CAP = 4096
    # Pages are rewritten on touch and split once they exceed twice the
    # target; a touched page that shrinks below half the target merges
    # with a neighbor (the mirror rule), so steady-state pages hold
    # between page_size/2 and 2*page_size records and a delta commit
    # rewrites O(touched pages).
    _SPLIT_FACTOR = 2
    # Batched page fetch window for streaming scans.
    _PAGE_FETCH_WINDOW = 8
    # How many pages flush per grouped write call.
    _PAGE_WRITE_WINDOW = 64

    def __init__(self, store: ObjectStore,
                 page_size: Optional[int] = None) -> None:
        self.store = store
        self.page_size = DEFAULT_PAGE_SIZE if page_size is None \
            else max(0, int(page_size))
        self._cache_lock = threading.Lock()
        self._records_cache: "OrderedDict[str, list]" = OrderedDict()
        self._page_cache: "OrderedDict[str, list]" = OrderedDict()
        self._dir_cache: "OrderedDict[str, Optional[PageDirectory]]" = \
            OrderedDict()
        self._index_cache: "OrderedDict[str, Optional[object]]" = \
            OrderedDict()
        # Commit bodies are content-addressed and Commit objects are
        # treated as immutable by every caller, so they cache safely —
        # this is what keeps the warm commit path's only uncached read
        # (the base commit body) off the backend.
        self._commit_cache: "OrderedDict[str, Commit]" = OrderedDict()
        # page digest -> its attribute-index blob digest, remembered once
        # this process built or validated it (content-addressed: a page's
        # index can never go stale, so the memo only bounds memory).
        self._pageidx_memo: "OrderedDict[str, str]" = OrderedDict()

    # -- cache plumbing ------------------------------------------------------

    def _cache_get(self, cache: OrderedDict, key: str):
        with self._cache_lock:
            if key in cache:
                cache.move_to_end(key)
                return cache[key]
        return None

    def _cache_put(self, cache: OrderedDict, key: str, value, cap: int):
        with self._cache_lock:
            cache[key] = value
            while len(cache) > cap:
                cache.popitem(last=False)

    # -- manifests -----------------------------------------------------------

    def put_manifest(self, manifest: Manifest) -> str:
        """Write a manifest from scratch; returns the tree digest.

        Paged stores paginate the sorted entry stream and flush every page
        through one grouped :meth:`ObjectStore.put_blobs` window (a page
        whose content already exists — identical runs of records — dedupes
        structurally and is never re-written); ``page_size=0`` writes the
        legacy blob.
        """
        if not self.page_size:
            return self.store.put_json(manifest.to_json()).digest
        raw = [e.to_json() for e in manifest.iter_entries()]
        step = self.page_size
        batches = [raw[off:off + step] for off in range(0, len(raw), step)]
        directory = PageDirectory(self._write_pages(batches), self.page_size)
        return self._put_directory(directory)

    def _write_pages(self, batches: Sequence[List[dict]]) -> List[PageInfo]:
        """Write many pages per grouped store call (bounded windows), so a
        large check-in pays one dedup probe + one grouped write per window
        instead of one round trip per page."""
        out: List[PageInfo] = []
        window = self._PAGE_WRITE_WINDOW
        for off in range(0, len(batches), window):
            group = batches[off:off + window]
            refs = self.store.put_jsons([{"records": b} for b in group])
            for raw_records, ref in zip(group, refs):
                self._cache_put(self._page_cache, ref.digest, raw_records,
                                self._PAGE_CACHE_CAP)
                out.append(PageInfo(
                    ref.digest, len(raw_records),
                    raw_records[0]["id"], raw_records[-1]["id"],
                    page_summary([o.get("attrs", {})
                                  for o in raw_records])))
        return out

    def _put_directory(self, directory: PageDirectory) -> str:
        digest = self.store.put_json(directory.to_json()).digest
        self._cache_put(self._dir_cache, digest, directory,
                        self._DIR_CACHE_CAP)
        return digest

    def get_page_directory(self, tree_digest: str) -> Optional[PageDirectory]:
        """Parsed page directory for a tree; ``None`` for legacy monolithic
        trees (callers then take the records-list paths)."""
        with self._cache_lock:
            if tree_digest in self._dir_cache:
                self._dir_cache.move_to_end(tree_digest)
                return self._dir_cache[tree_digest]
            if tree_digest in self._records_cache:  # known-legacy tree
                return None
        obj = self.store.get_json(tree_digest)
        if obj.get("kind") == "pagedir":
            directory = PageDirectory.from_json(obj)
            self._cache_put(self._dir_cache, tree_digest, directory,
                            self._DIR_CACHE_CAP)
            return directory
        self._cache_put(self._dir_cache, tree_digest, None,
                        self._DIR_CACHE_CAP)
        self._cache_put(self._records_cache, tree_digest,
                        obj.get("records", []), self._RECORDS_CACHE_CAP)
        return None

    def get_page_records(self, page_digest: str) -> list:
        """One page's parsed raw record list (treat as immutable)."""
        hit = self._cache_get(self._page_cache, page_digest)
        if hit is not None:
            return hit
        records = self.store.get_json(page_digest).get("records", [])
        self._cache_put(self._page_cache, page_digest, records,
                        self._PAGE_CACHE_CAP)
        return records

    def iter_page_records(self, directory: PageDirectory,
                          page_indices: Optional[Sequence[int]] = None
                          ) -> Iterator[list]:
        """Yield raw record lists page-by-page (batched CAS reads).

        Uncached pages are fetched through ``ObjectStore.get_blobs`` in
        bounded windows, so a full-manifest stream pays grouped backend
        reads instead of one round-trip per page.
        """
        indices = list(page_indices) if page_indices is not None \
            else range(len(directory.pages))
        window = self._PAGE_FETCH_WINDOW
        batch: List[int] = []
        for pi in indices:
            batch.append(pi)
            if len(batch) >= window:
                yield from self._fetch_pages(directory, batch)
                batch = []
        if batch:
            yield from self._fetch_pages(directory, batch)

    def _fetch_pages(self, directory: PageDirectory,
                     page_indices: Sequence[int]) -> Iterator[list]:
        digests = [directory.pages[pi].digest for pi in page_indices]
        missing = [d for d in digests
                   if self._cache_get(self._page_cache, d) is None]
        if missing:
            for d, doc in zip(missing, self.store.get_jsons(missing)):
                self._cache_put(self._page_cache, d, doc.get("records", []),
                                self._PAGE_CACHE_CAP)
        for d in digests:
            yield self.get_page_records(d)

    def get_raw_records(self, tree_digest: str) -> list:
        """The manifest's parsed ``records`` list (record-id-sorted), cached.

        Works for both layouts (paged trees concatenate their pages).
        Callers must treat the returned list and its dicts as immutable.
        """
        hit = self._cache_get(self._records_cache, tree_digest)
        if hit is not None:
            return hit
        directory = self.get_page_directory(tree_digest)
        if directory is None:
            # usually populated by get_page_directory's sniff; re-fetch if
            # the records cache evicted it since the tree was last seen
            records = self._cache_get(self._records_cache, tree_digest)
            if records is None:
                records = self.store.get_json(tree_digest).get("records", [])
        else:
            records = [o for raw in self.iter_page_records(directory)
                       for o in raw]
        self._cache_put(self._records_cache, tree_digest, records,
                        self._RECORDS_CACHE_CAP)
        return records

    def get_manifest(self, tree_digest: str) -> Manifest:
        directory = self.get_page_directory(tree_digest)
        if directory is not None:
            return PagedManifest(self, directory)
        return Manifest(RecordEntry.from_raw(o)
                        for o in self.get_raw_records(tree_digest))

    # -- attribute index (built at commit, drives checkout pruning) ----------

    def _attr_index_meta_key(self, tree_digest: str) -> str:
        return f"attridx/{tree_digest}"

    def _page_index_meta_key(self, page_digest: str) -> str:
        return f"attridx/page/{page_digest}"

    def _ensure_page_indexes(self, pages: Sequence[PageInfo]) -> List[str]:
        """Idempotently build/write the pages' attribute indexes; returns
        their blob digests in page order.

        Batched: one grouped meta probe finds the pages lacking a valid
        pointer, their indexes are built straight from the raw page records
        (no :class:`RecordEntry` materialization — only attrs matter),
        flushed through one grouped :meth:`ObjectStore.put_blobs`, and the
        pointers land in one grouped meta write.  Content-addressed by page
        digest, so pages carried verbatim from a parent commit never
        rebuild.
        """
        keys = [self._page_index_meta_key(p.digest) for p in pages]
        out: List[Optional[str]] = [None] * len(pages)
        build: List[int] = []
        probe: List[int] = []
        for i, p in enumerate(pages):
            memo = self._cache_get(self._pageidx_memo, p.digest)
            if memo is not None:
                out[i] = memo
            elif self.store.blob_is_staged(p.digest):
                # A page written inside the open meta batch is new content;
                # its index build is deterministic, so skip the pointer
                # probe and rebuild — byte-identical either way.
                build.append(i)
            else:
                probe.append(i)
        if probe:
            ptrs = self.store.get_metas([keys[i] for i in probe])
            candidates = [(i, ptr) for i, ptr in zip(probe, ptrs)
                          if ptr is not None]
            alive = self.store.has_blobs(
                [ptr["blob"] for _, ptr in candidates])
            valid = {i: ptr["blob"] for (i, ptr), ok
                     in zip(candidates, alive) if ok}
            for i in probe:
                blob = valid.get(i)
                if blob is not None:
                    out[i] = blob
                    self._cache_put(self._pageidx_memo, pages[i].digest,
                                    blob, self._PAGEIDX_MEMO_CAP)
                else:
                    build.append(i)
            build.sort()
        # Build in bounded windows: grouped page prefetch (held locally —
        # a cold rebuild larger than the page LRU must not degrade to one
        # blob read per page), grouped index write, grouped pointer write.
        for woff in range(0, len(build), self._PAGE_WRITE_WINDOW):
            wbuild = build[woff:woff + self._PAGE_WRITE_WINDOW]
            raw_by_digest: Dict[str, list] = {}
            missing: List[str] = []
            for i in wbuild:
                digest = pages[i].digest
                hit = self._cache_get(self._page_cache, digest)
                raw_by_digest[digest] = hit
                if hit is None:
                    missing.append(digest)
            if missing:
                for d, doc in zip(missing, self.store.get_jsons(missing)):
                    records = doc.get("records", [])
                    raw_by_digest[d] = records
                    self._cache_put(self._page_cache, d, records,
                                    self._PAGE_CACHE_CAP)
            refs = self.store.put_jsons(
                [AttributeIndex.build_attrs(
                    [o.get("attrs") for o in raw_by_digest[pages[i].digest]]
                 ).to_json() for i in wbuild])
            self.store.put_metas(
                [(keys[i], {"blob": ref.digest, "v": AttributeIndex.VERSION})
                 for i, ref in zip(wbuild, refs)])
            for i, ref in zip(wbuild, refs):
                out[i] = ref.digest
                self._cache_put(self._pageidx_memo, pages[i].digest,
                                ref.digest, self._PAGEIDX_MEMO_CAP)
        return out  # type: ignore[return-value]

    def ensure_attr_index(self, tree_digest: str,
                          manifest: Optional[Manifest] = None) -> None:
        """Write the attribute index for ``tree`` (idempotent).

        Paged trees get one index blob per page plus a small pointer doc
        naming them; legacy trees keep the single global index blob.
        """
        directory = self.get_page_directory(tree_digest)
        key = self._attr_index_meta_key(tree_digest)
        if directory is not None:
            # A tree staged in the open meta batch is new content: its
            # index is rebuilt deterministically (pages carried from the
            # parent hit the memo), so the pointer probe is skipped.
            ptr = None if self.store.blob_is_staged(tree_digest) \
                else self.store.get_meta(key)
            if ptr is not None and self._paged_index_intact(ptr):
                return
            page_idx = self._ensure_page_indexes(directory.pages)
            doc = {"v": PagedAttributeIndex.VERSION, "pages": page_idx,
                   "counts": [p.n for p in directory.pages],
                   "n": directory.n}
            ref = self.store.put_json(doc)
            self.store.put_meta(key, {"blob": ref.digest,
                                      "v": PagedAttributeIndex.VERSION})
            with self._cache_lock:
                self._index_cache.pop(tree_digest, None)
            return
        ptr = self.store.get_meta(key)
        if ptr is not None and self.store.has_blob(ptr["blob"]):
            return  # pointer must not satisfy us if the blob was GC'd
        if manifest is None:
            manifest = self.get_manifest(tree_digest)
        idx = AttributeIndex.build(manifest.entries())
        ref = self.store.put_json(idx.to_json())
        self.store.put_meta(key, {"blob": ref.digest, "v": idx.VERSION})
        with self._cache_lock:
            self._index_cache.pop(tree_digest, None)

    def _paged_index_intact(self, ptr: dict) -> bool:
        """A v2 pointer is valid only while the doc AND every per-page
        index blob it names survive (a GC'd page index must trigger a
        rebuild, not a checkout-time crash)."""
        if not self.store.has_blob(ptr["blob"]):
            return False
        try:
            doc = self.store.get_json(ptr["blob"])
        except NotFoundError:
            return False
        pages = doc.get("pages", [])
        return all(self.store.has_blobs(pages)) if pages else True

    def _fetch_index_jsons(self, digests: List[str]) -> List[dict]:
        return self.store.get_jsons(digests)

    def get_attr_index(self, tree_digest: str):
        """Load (cached) the attribute index for a tree — a global
        :class:`AttributeIndex` for legacy trees, a lazy
        :class:`PagedAttributeIndex` for paged ones; ``None`` for
        pre-index commits — callers fall back to a full scan."""
        with self._cache_lock:
            if tree_digest in self._index_cache:
                self._index_cache.move_to_end(tree_digest)
                return self._index_cache[tree_digest]
        ptr = self.store.get_meta(self._attr_index_meta_key(tree_digest))
        idx = None
        if ptr is not None:
            try:
                doc = self.store.get_json(ptr["blob"])
                if int(ptr.get("v", 1)) >= PagedAttributeIndex.VERSION \
                        or "pages" in doc:
                    # validate now, not at plan time: a swept per-page
                    # index blob must degrade checkout to a scan, never
                    # crash it mid-iteration (one grouped probe)
                    if all(self.store.has_blobs(doc["pages"])):
                        idx = PagedAttributeIndex(self._fetch_index_jsons,
                                                  doc["pages"],
                                                  doc["counts"])
                else:
                    idx = AttributeIndex.from_json(doc)
            except NotFoundError:
                idx = None
        self._cache_put(self._index_cache, tree_digest, idx,
                        self._INDEX_CACHE_CAP)
        return idx

    # -- commits ---------------------------------------------------------------

    def commit(
        self,
        dataset: str,
        manifest: Manifest,
        parents: Sequence[str],
        author: str,
        message: str,
        meta: Optional[Mapping[str, object]] = None,
        timestamp: Optional[float] = None,
    ) -> Commit:
        # One commit = one meta-batch scope: pages, indexes, the commit
        # body and the commits index flush together (joins an enclosing
        # scope when check_in already opened one).
        with self.store.meta_batch(prefetch=[f"commits/{dataset}"]):
            tree = self.put_manifest(manifest)
            self.ensure_attr_index(tree, manifest)
            return self._commit_tree(dataset, tree, parents, author,
                                     message, meta, timestamp)

    def _commit_tree(
        self,
        dataset: str,
        tree: str,
        parents: Sequence[str],
        author: str,
        message: str,
        meta: Optional[Mapping[str, object]] = None,
        timestamp: Optional[float] = None,
    ) -> Commit:
        body = {
            "dataset": dataset,
            "tree": tree,
            "parents": list(parents),
            "author": author,
            "message": message,
            "timestamp": time.time() if timestamp is None else timestamp,
            "meta": dict(meta or {}),
        }
        ref = self.store.put_json(body)
        commit = Commit.from_json(ref.digest, body)
        self._cache_put(self._commit_cache, ref.digest, commit,
                        self._COMMIT_CACHE_CAP)
        # Index commit ids per dataset for listing/GC roots.  The index is
        # a GC root source, so a lost update here could strand a live
        # commit — and then GC could sweep pages a head still references.
        # Inside a batch the key goes through CAS with an append-merge:
        # a concurrent appender's ids are kept and ours re-applied on top,
        # so the index never loses an entry no matter who wins the race.
        key = f"commits/{dataset}"
        idx = self.store.get_meta(key, default=[])
        if ref.digest not in idx:
            idx.append(ref.digest)
            self.store.put_meta(key, idx)
            self.store.require_meta_cas(
                key, merge=lambda cur, cid=ref.digest:
                    list(cur or []) + ([] if cid in (cur or []) else [cid]))
        return commit

    def commit_delta(
        self,
        dataset: str,
        base_commit_id: str,
        adds: Mapping[str, RecordEntry],
        removes: Iterable[str],
        author: str,
        message: str,
        meta: Optional[Mapping[str, object]] = None,
        parents: Optional[Sequence[str]] = None,
        timestamp: Optional[float] = None,
    ) -> Tuple[Commit, VersionDiff, int]:
        """Commit a delta on top of ``base`` in O(delta + touched pages).

        Only pages receiving adds/removes are loaded and rewritten (split
        when they outgrow the fanout, dropped when emptied); every other
        page digest — and its per-page attribute index — is carried
        verbatim from the parent directory.  Returns the commit, the
        resulting :class:`VersionDiff` vs base (computed from the same
        page loads, no extra passes), and the new record count.
        """
        parents = list(parents) if parents is not None else [base_commit_id]
        # Normalize once: removal wins over a same-call add (the check_in
        # contract), identically on every layout.
        removes = set(removes)
        if any(rid in removes for rid in adds):
            adds = {rid: e for rid, e in adds.items() if rid not in removes}
        with self.store.meta_batch(prefetch=[f"commits/{dataset}"]):
            base_tree = self.get_commit(base_commit_id).tree
            directory = self.get_page_directory(base_tree)
            if not self.page_size or directory is None:
                # Legacy base (or legacy-writing store): materialize+rewrite.
                manifest = self.get_manifest(base_tree).copy()
                diff = self._delta_diff_from_map(
                    {e.record_id: e.blob.digest
                     for e in manifest.iter_entries()}, adds, removes)
                for entry in adds.values():
                    manifest.add(entry)
                for rid in removes:
                    manifest.remove(rid)
                commit = self.commit(dataset, manifest, parents, author,
                                     message, meta, timestamp)
                return commit, diff, len(manifest)

            new_dir, diff = self._apply_delta(directory, adds, removes)
            tree = self._put_directory(new_dir)
            self.ensure_attr_index(tree)
            commit = self._commit_tree(dataset, tree, parents, author,
                                       message, meta, timestamp)
            return commit, diff, new_dir.n

    @staticmethod
    def _delta_diff_from_map(base_digests: Mapping[str, str],
                             adds: Mapping[str, RecordEntry],
                             removes: Iterable[str]) -> VersionDiff:
        d = VersionDiff()
        removed = {rid for rid in removes if rid in base_digests}
        for rid, entry in adds.items():
            old = base_digests.get(rid)
            if old is None:
                d.added.append(rid)
            elif old != entry.blob.digest:
                d.modified.append(rid)
        d.added.sort()
        d.modified.sort()
        d.removed = sorted(removed)
        d.unchanged = len(base_digests) - len(d.modified) - len(removed)
        return d

    def _apply_delta(
        self,
        directory: PageDirectory,
        adds: Mapping[str, RecordEntry],
        removes: Iterable[str],
    ) -> Tuple[PageDirectory, VersionDiff]:
        """Page-level delta application with structural sharing."""
        removes = set(removes)
        touched: Dict[int, Dict[str, Optional[RecordEntry]]] = {}
        overflow: Dict[str, RecordEntry] = {}
        for rid, entry in adds.items():
            pi = directory.page_for(rid)
            if pi < 0:
                overflow[rid] = entry
            else:
                touched.setdefault(pi, {})[rid] = entry
        for rid in removes:
            pi = directory.page_for(rid)
            if pi >= 0:
                touched.setdefault(pi, {}).setdefault(rid, None)

        # ``parts`` interleaves carried PageInfo rows with *pending* pages
        # (raw record lists the delta rewrote).  Pendings are flushed in one
        # grouped write at the end, after the neighbor-merge pass.
        diff = VersionDiff()
        parts: List[Union[PageInfo, List[dict]]] = []
        for pi, page in enumerate(directory.pages):
            changes = touched.get(pi)
            if changes is None:
                parts.append(page)  # carried verbatim — the whole point
                continue
            by_id = {o["id"]: o for o in self.get_page_records(page.digest)}
            for rid, entry in changes.items():
                old = by_id.get(rid)
                if entry is None:  # removal
                    if old is not None:
                        del by_id[rid]
                        diff.removed.append(rid)
                    continue
                if old is None:
                    diff.added.append(rid)
                elif old["blob"]["digest"] != entry.blob.digest:
                    diff.modified.append(rid)
                by_id[rid] = entry.to_json()
            parts.extend(self._split_raw(
                [by_id[rid] for rid in sorted(by_id)]))
        if overflow:  # empty base directory
            raw = [overflow[rid].to_json() for rid in sorted(overflow)]
            parts.extend(self._split_raw(raw))
            diff.added.extend(sorted(overflow))
        parts = self._merge_undersized(parts)
        new_pages = self._flush_parts(parts)
        diff.added.sort()
        diff.removed.sort()
        diff.modified.sort()
        diff.unchanged = directory.n - len(diff.modified) - len(diff.removed)
        return PageDirectory(new_pages, self.page_size), diff

    def _split_raw(self, raw_records: List[dict]) -> List[List[dict]]:
        """One touched page's records back into page-sized pendings:
        splitting if it outgrew the fanout, vanishing if it emptied."""
        if not raw_records:
            return []
        if len(raw_records) <= self._SPLIT_FACTOR * self.page_size:
            return [raw_records]
        n_parts = -(-len(raw_records) // self.page_size)
        return [raw_records[i * len(raw_records) // n_parts:
                            (i + 1) * len(raw_records) // n_parts]
                for i in range(n_parts)]

    def _merge_undersized(
        self, parts: List[Union[PageInfo, List[dict]]]
    ) -> List[Union[PageInfo, List[dict]]]:
        """Neighbor-merge rule — the mirror of the >2x split rule.

        A delta that shrinks pages below half the fanout merges them into
        an adjacent page (loading a carried neighbor's records if needed)
        as long as the combined page stays within the split threshold, so
        shrink-heavy workloads stop bloating the page directory.  Only
        pairs involving at least one page this delta rewrote are
        considered: untouched history is never rewritten spontaneously.
        Pages are contiguous runs of the sorted id space, so any adjacent
        merge preserves directory order.
        """
        half = self.page_size // 2
        cap = self._SPLIT_FACTOR * self.page_size
        out: List[Union[PageInfo, List[dict]]] = []
        for part in parts:
            if out:
                prev = out[-1]
                prev_n = len(prev) if isinstance(prev, list) else prev.n
                cur_n = len(part) if isinstance(part, list) else part.n
                if ((isinstance(prev, list) or isinstance(part, list))
                        and (prev_n < half or cur_n < half)
                        and prev_n + cur_n <= cap):
                    out[-1] = self._part_records(prev) \
                        + self._part_records(part)
                    continue
            out.append(part)
        return out

    def _part_records(self, part: Union[PageInfo, List[dict]]) -> List[dict]:
        if isinstance(part, list):
            return part
        return list(self.get_page_records(part.digest))

    def _flush_parts(
        self, parts: List[Union[PageInfo, List[dict]]]
    ) -> List[PageInfo]:
        """Write every pending page through one grouped batch, splicing the
        results back between the carried rows in order."""
        written = iter(self._write_pages(
            [p for p in parts if isinstance(p, list)]))
        return [next(written) if isinstance(p, list) else p for p in parts]

    def get_commit(self, commit_id: str) -> Commit:
        hit = self._cache_get(self._commit_cache, commit_id)
        if hit is not None:
            return hit
        commit = Commit.from_json(commit_id, self.store.get_json(commit_id))
        self._cache_put(self._commit_cache, commit_id, commit,
                        self._COMMIT_CACHE_CAP)
        return commit

    def list_commits(self, dataset: str) -> List[str]:
        return list(self.store.get_meta(f"commits/{dataset}", default=[]))

    def log(self, commit_id: str, limit: int = 100) -> List[Commit]:
        """First-parent history, newest first."""
        out: List[Commit] = []
        cur: Optional[str] = commit_id
        while cur and len(out) < limit:
            c = self.get_commit(cur)
            out.append(c)
            cur = c.parents[0] if c.parents else None
        return out

    # -- refs -------------------------------------------------------------------

    def set_branch(self, dataset: str, branch: str, commit_id: str,
                   strict: bool = False) -> None:
        """Move a branch head.  ``strict=True`` (the multi-writer commit
        path) makes a concurrent head move raise
        :class:`~repro_torch.core.store.CommitConflictError` at flush instead of
        last-writer-wins — the caller rebases onto the new head."""
        name = f"refs/{dataset}/heads/{branch}"
        self.store.put_meta(name, commit_id)
        if strict:
            self.store.require_meta_cas(name)

    def get_branch(self, dataset: str, branch: str) -> Optional[str]:
        return self.store.get_meta(f"refs/{dataset}/heads/{branch}")

    def set_tag(self, dataset: str, tag: str, commit_id: str) -> None:
        self.store.put_meta(f"refs/{dataset}/tags/{tag}", commit_id)

    def get_tag(self, dataset: str, tag: str) -> Optional[str]:
        return self.store.get_meta(f"refs/{dataset}/tags/{tag}")

    def list_branches(self, dataset: str) -> List[str]:
        prefix = f"refs/{dataset}/heads/"
        return [k[len(prefix):] for k in self.store.list_meta(prefix)]

    def list_tags(self, dataset: str) -> List[str]:
        prefix = f"refs/{dataset}/tags/"
        return [k[len(prefix):] for k in self.store.list_meta(prefix)]

    def resolve(self, dataset: str, rev: str) -> str:
        """Resolve branch / tag / commit-id to a commit id (branch and tag
        probed in ONE grouped meta read)."""
        head, tag = self.store.get_metas(
            [f"refs/{dataset}/heads/{rev}", f"refs/{dataset}/tags/{rev}"])
        found = head or tag
        if found:
            return found
        try:
            self.get_commit(rev)
            return rev
        except NotFoundError:
            raise NotFoundError(f"unknown revision {rev!r} for dataset {dataset!r}")

    # -- diff / merge -------------------------------------------------------------

    def _unshared_digest_maps(
        self, dir_a: PageDirectory, dir_b: PageDirectory
    ) -> Tuple[Dict[str, str], Dict[str, str], int]:
        """id -> payload digest maps over the *unshared* pages of two paged
        trees, plus the record count of the shared pages.

        A page digest present in both directories denotes byte-identical
        records on both sides (and pages are contiguous runs of the sorted
        id space, so none of its ids can reappear in an unshared page) —
        those pages are skipped without a read."""
        shared = dir_a.page_digests() & dir_b.page_digests()
        n_shared = sum(p.n for p in dir_a.pages if p.digest in shared)

        def collect(directory: PageDirectory) -> Dict[str, str]:
            indices = [i for i, p in enumerate(directory.pages)
                       if p.digest not in shared]
            return {o["id"]: o["blob"]["digest"]
                    for raw in self.iter_page_records(directory, indices)
                    for o in raw}

        return collect(dir_a), collect(dir_b), n_shared

    def diff(self, commit_a: str, commit_b: str) -> VersionDiff:
        """What changed going a -> b.  Paged trees compare page digests
        first and deserialize only differing pages — O(changed pages);
        legacy (or mixed) trees fall back to the full record walk."""
        tree_a = self.get_commit(commit_a).tree
        tree_b = self.get_commit(commit_b).tree
        dir_a = self.get_page_directory(tree_a)
        dir_b = self.get_page_directory(tree_b)
        if dir_a is not None and dir_b is not None:
            da, db, n_shared = self._unshared_digest_maps(dir_a, dir_b)
            d = _diff_digest_maps(da, db)
            d.unchanged += n_shared
            return d
        return diff_manifests(self.get_manifest(tree_a),
                              self.get_manifest(tree_b))

    def merge_base(self, a: str, b: str) -> Optional[str]:
        """Nearest common ancestor (BFS over parents)."""
        seen_a: Dict[str, int] = {}
        frontier = [(a, 0)]
        while frontier:
            cid, d = frontier.pop(0)
            if cid in seen_a:
                continue
            seen_a[cid] = d
            frontier.extend((p, d + 1) for p in self.get_commit(cid).parents)
        best: Tuple[int, Optional[str]] = (1 << 30, None)
        frontier = [(b, 0)]
        seen_b = set()
        while frontier:
            cid, d = frontier.pop(0)
            if cid in seen_b:
                continue
            seen_b.add(cid)
            if cid in seen_a:
                best = min(best, (seen_a[cid] + d, cid))
                continue
            frontier.extend((p, d + 1) for p in self.get_commit(cid).parents)
        return best[1]

    def merge(
        self,
        dataset: str,
        ours: str,
        theirs: str,
        author: str,
        message: str = "merge",
    ) -> Commit:
        """Three-way merge at record granularity.

        A record changed on both sides to *different* blobs is a conflict
        (raised, never silently resolved — datasets are training inputs).
        Paged trees resolve only the records living in pages the two sides
        do not share; the result is committed as a delta on ``ours`` so
        agreed-on pages flow through untouched.
        """
        base_id = self.merge_base(ours, theirs)
        tree_o = self.get_commit(ours).tree
        tree_t = self.get_commit(theirs).tree
        dir_o = self.get_page_directory(tree_o)
        dir_t = self.get_page_directory(tree_t)
        base = (self.get_manifest(self.get_commit(base_id).tree)
                if base_id else Manifest())

        if dir_o is not None and dir_t is not None:
            mo_part, mt_part, _ = self._unshared_digest_maps(dir_o, dir_t)
            ids = set(mo_part) | set(mt_part)
            mo = mt = None  # record lookups stay within the unshared maps
        else:
            mo = self.get_manifest(tree_o)
            mt = self.get_manifest(tree_t)
            ids = set(mo.record_ids()) | set(mt.record_ids()) \
                | set(base.record_ids())
            mo_part = {e.record_id: e.blob.digest for e in mo.iter_entries()}
            mt_part = {e.record_id: e.blob.digest for e in mt.iter_entries()}

        adds: Dict[str, RecordEntry] = {}
        removes: List[str] = []
        conflicts: List[str] = []
        theirs_man: Optional[Manifest] = mt
        for rid in sorted(ids):
            eb = base.get(rid)
            db = eb.blob.digest if eb else None
            do = mo_part.get(rid)
            dt = mt_part.get(rid)
            if do == dt:
                continue  # same on both sides (incl. both deleted)
            if dt == db:
                continue  # theirs untouched -> keep ours
            if do == db:
                # ours untouched -> take theirs
                if dt is None:
                    removes.append(rid)
                else:
                    if theirs_man is None:
                        theirs_man = self.get_manifest(tree_t)
                    adds[rid] = theirs_man.get(rid)  # type: ignore[assignment]
                continue
            conflicts.append(rid)
        if conflicts:
            raise MergeConflict(conflicts)
        commit, _, _ = self.commit_delta(
            dataset, ours, adds, removes, author=author, message=message,
            parents=[ours, theirs])
        return commit

    # -- GC roots -----------------------------------------------------------------

    def live_digests(self, dataset: str) -> List[str]:
        """Top-level digests kept alive by this dataset's history.

        Page-granular: each distinct page is expanded exactly once no
        matter how many commits share it, so the root walk itself costs
        O(distinct pages), not O(commits × records)."""
        out: List[str] = []
        seen_pages: Set[str] = set()
        for cid in self.list_commits(dataset):
            out.append(cid)
            try:
                c = self.get_commit(cid)
            except NotFoundError:
                continue
            out.append(c.tree)
            # the tree's attribute index blobs are owned by the commit too —
            # without these roots, the first gc() would sweep every index
            # and degrade all filtered checkouts to full scans permanently
            ptr = self.store.get_meta(self._attr_index_meta_key(c.tree))
            if ptr is not None:
                out.append(ptr["blob"])
            try:
                directory = self.get_page_directory(c.tree)
            except NotFoundError:
                continue
            if directory is None:
                for e in self.get_manifest(c.tree).entries():
                    out.append(e.blob.digest)
                continue
            for page in directory.pages:
                if page.digest in seen_pages:
                    continue
                seen_pages.add(page.digest)
                out.append(page.digest)
                pidx = self.store.get_meta(
                    self._page_index_meta_key(page.digest))
                if pidx is not None:
                    out.append(pidx["blob"])
                for o in self.get_page_records(page.digest):
                    out.append(o["blob"]["digest"])
        return out


def raw_entry_matches(raw: dict, entry: RecordEntry) -> bool:
    """True iff a raw manifest record denotes the same content as ``entry``.

    Covers payload digest AND attrs: components and queries both see
    attrs, so a version diff (payload digests only) is not a sufficient
    "unchanged" witness for derivation reuse — a record whose attrs
    changed must recompute even though :func:`diff_manifests` reports it
    unchanged.
    """
    return (raw["blob"]["digest"] == entry.blob.digest
            and raw.get("attrs", {}) == entry.attrs)


def _diff_digest_maps(da: Mapping[str, str],
                      db: Mapping[str, str]) -> VersionDiff:
    d = VersionDiff()
    ids_a, ids_b = set(da), set(db)
    d.added = sorted(ids_b - ids_a)
    d.removed = sorted(ids_a - ids_b)
    for rid in sorted(ids_a & ids_b):
        if da[rid] != db[rid]:
            d.modified.append(rid)
        else:
            d.unchanged += 1
    return d


def diff_manifests(ma: Manifest, mb: Manifest) -> VersionDiff:
    return _diff_digest_maps(
        {e.record_id: e.blob.digest for e in ma.iter_entries()},
        {e.record_id: e.blob.digest for e in mb.iter_entries()})

"""Content-addressed storage engine — the platform's *source of truth*.

The paper: "A storage engine is described that acts as a source of truth for
all data and handles versioning, access control etc."  It also requires that
"The type of data stored is unrestricted" and that "The underlying storage
for the data can be any suitable mechanism such as a file system or cloud
storage."

Design
------
- Every blob is split into fixed-size chunks (default 4 MiB).  Each chunk is
  stored under ``sha256(raw_chunk)`` — identical content across datasets and
  versions dedupes structurally, which is what makes git-style versioning
  viable for large binary ML data (the paper's critique of git is its object
  model for large files, not the DAG).
- Chunks may be zlib-compressed when that actually shrinks them; the chunk
  header records the codec so reads are self-describing.
- A multi-chunk blob gets a *blob manifest* (JSON list of chunk digests)
  stored content-addressed as well; a ``BlobRef`` names the top digest.
- Integrity: every read from the backend re-hashes and verifies; corruption
  raises :class:`IntegrityError`.
- **Verified-once read cache**: a bounded LRU of raw chunks sits in front of
  the backend.  Because chunks are content-addressed, a chunk that verified
  against its digest once can be served from memory without re-reading the
  backend *or* re-hashing — ``sha256(raw) == digest`` is a property of the
  bytes, not of the read.  The cache is only populated on verified reads
  (never on writes), so a corrupted backend is still always detected the
  first time a chunk is fetched, and revocation/GC evict eagerly so deleted
  payloads cannot be served from memory after the backend forgot them.
- **Batched ingest hot path**: :meth:`ObjectStore.put_blobs` writes many
  payloads in one call — every chunk is hashed *first* (a shared thread
  pool; ``hashlib`` releases the GIL so sha256 parallelizes), duplicates
  within the call collapse to one chunk, a single grouped
  ``exists_many`` probe discovers which chunks the backend already holds,
  and only the missing ones are encoded and written through one grouped
  ``put_many``.  A fully-deduplicated re-ingest therefore costs one
  membership probe and zero chunk writes.  The sequential
  :meth:`put_blob` and the batch produce byte-identical backend state and
  identical :class:`BlobRef` results.  ``StoreStats`` counts the write
  side (``put_calls`` / ``chunks_written`` / ``chunks_deduped`` /
  ``exists_probes``).
- Chunk encoding samples the payload before compressing: a high-entropy
  sample (already-compressed / encrypted / random data) skips the zlib
  attempt entirely — addresses are digests of the *raw* bytes, so the
  storage codec never affects identity, and the chunk header keeps reads
  self-describing either way.
- Garbage collection is mark-and-sweep from a caller-provided root set
  (commits / manifests / lineage heads own references).

- **Commit-scoped metadata batching**: ``store.meta_batch()`` opens a
  :class:`MetaBatch` scope on the current thread.  Inside it, mutable
  ``meta/`` reads are served from a grouped prefetch plus read-through
  (one ``get_many`` per miss group) and ``meta/`` writes are *staged*;
  content-addressed blob writes are staged too.  On scope exit everything
  flushes in happens-before order — data blobs (one probe + one grouped
  write), then write-once meta (ONE grouped ``put_metas``), then mutable
  ``refs/`` *last*, each through the :meth:`StorageBackend.put_if`
  compare-and-swap guard — so batching collapses a commit's ~16 meta
  round trips into a handful without widening the lost-update window.
  The resulting backend state is byte-identical to the unbatched path,
  and a flush failure surfaces like the first failing single write.

- **Tiered chunk cache**: below the memory LRU sits an optional on-disk
  tier (:class:`DiskChunkTier`, ``disk_cache_bytes=`` /
  ``disk_cache_dir=``).  Chunks are immutable and content-addressed, so
  the disk tier needs no invalidation protocol beyond the same eager
  eviction revocation/GC already perform — and a *cold process* against a
  remote backend warms from local disk instead of the network.

Backends implement a tiny KV interface so "file system or cloud storage" is
a subclass away.  The grouped operations (``exists_many`` / ``get_many`` /
``put_many`` / ``delete_many``) are *optional capabilities* with loop
fallbacks on the base class: a minimal backend implementing only the five
abstract methods works everywhere, while :class:`FileBackend` /
:class:`MemoryBackend` override them natively (one lock acquisition, no
redundant per-key stat — the store-level existence probe is authoritative
on the write path), and the remote backends in :mod:`repro_torch.store.remote`
drive them through a pipelined, hedged scheduler (see that package).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import threading
import time
import zlib
from abc import ABC, abstractmethod
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Set, Tuple, Union)

__all__ = [
    "StorageBackend",
    "MemoryBackend",
    "FileBackend",
    "BlobRef",
    "ObjectStore",
    "MetaBatch",
    "DiskChunkTier",
    "IntegrityError",
    "NotFoundError",
    "CommitConflictError",
]

DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024

# Chunk header: 1 byte codec (0 = raw, 1 = zlib) + 8 byte big-endian raw size.
_HDR = struct.Struct(">BQ")
_CODEC_RAW = 0
_CODEC_ZLIB = 1


class IntegrityError(RuntimeError):
    """Stored bytes do not hash to their address."""


class NotFoundError(KeyError):
    """Requested object is not in the store."""


class CommitConflictError(RuntimeError):
    """A compare-and-swap on a mutable meta key lost to a concurrent writer.

    Raised when a key escalated to strict CAS semantics (see
    :meth:`ObjectStore.require_meta_cas`) observes a concurrent change, or
    when the last-writer-wins retry loop exhausts its cap — callers can
    tell contention apart from corruption and react (rebase, surface to
    the user) instead of seeing an undifferentiated failure.

    Attributes carry everything a caller needs to act: the ``ref`` name,
    the value this writer ``expected`` vs what is ``current`` in the
    backend (decoded JSON where possible, raw bytes otherwise), the CAS
    ``attempts`` made, and — when raised from the commit layer in
    ``on_conflict="error"`` mode — the ``dataset`` and the overlapping
    ``records`` that made an automatic rebase unsafe.
    """

    def __init__(self, ref: str, expected=None, current=None,
                 attempts: int = 1, dataset: Optional[str] = None,
                 records: Sequence[str] = ()):
        self.ref = ref
        self.expected = expected
        self.current = current
        self.attempts = attempts
        self.dataset = dataset
        self.records = list(records)
        detail = f"commit conflict on {ref!r}"
        if dataset:
            detail += f" (dataset {dataset!r})"
        detail += (f": expected {expected!r}, found {current!r} after "
                   f"{attempts} attempt(s)")
        if self.records:
            shown = ", ".join(self.records[:8])
            if len(self.records) > 8:
                shown += f" (+{len(self.records) - 8} more)"
            detail += f"; conflicting records: {shown}"
        super().__init__(detail)


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class StorageBackend(ABC):
    """Minimal KV contract every physical store satisfies.

    The ``*_many`` methods are optional grouped capabilities: the defaults
    loop over the abstract primitives so any subclass works unchanged,
    while real backends override them to turn N round trips into one.
    ``put_many`` carries a stronger contract than ``put``: the caller has
    already established the keys need writing (the store-level existence
    probe is authoritative), so implementations must write unconditionally
    and skip any per-key existence check of their own.

    **Idempotency contract** (required by the remote retry layer): ``put``
    of the same (key, bytes), ``delete`` of a missing key, and their
    grouped forms must all be safe to replay.  A retried grouped write or
    delete — issued because a *response* was lost after the *effect*
    applied — must be a no-op, never an error.  ``delete``/``delete_many``
    therefore treat missing keys as already-deleted.
    """

    @abstractmethod
    def put(self, key: str, data: bytes) -> None: ...

    @abstractmethod
    def get(self, key: str) -> bytes: ...

    @abstractmethod
    def exists(self, key: str) -> bool: ...

    @abstractmethod
    def delete(self, key: str) -> None: ...

    @abstractmethod
    def list_keys(self, prefix: str = "") -> Iterator[str]: ...

    # -- optional grouped capabilities (loop fallbacks) ----------------------

    def exists_many(self, keys: Sequence[str]) -> List[bool]:
        """One membership answer per key, in order."""
        return [self.exists(k) for k in keys]

    def get_many(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        """One payload (or ``None`` for a missing key) per key, in order.

        Unlike ``get``, absence is an answer, not an error — the grouped
        read path treats membership and payload as one round trip.
        """
        out: List[Optional[bytes]] = []
        for k in keys:
            try:
                out.append(self.get(k))
            except NotFoundError:
                out.append(None)
        return out

    def put_many(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """Write every (key, data) pair unconditionally (see class doc)."""
        for key, data in items:
            self.put(key, data)

    def delete_many(self, keys: Sequence[str]) -> None:
        for key in keys:
            self.delete(key)

    # -- optional conditional write (loop fallback) --------------------------

    def put_if(self, key: str, expected: Optional[bytes],
               data: bytes) -> bool:
        """Conditional put: write ``data`` only while the key's current
        value is ``expected`` (``None`` ⇒ the key must be absent).
        Returns True when the write applied, False on a mismatch.

        This fallback is get-compare-put in two round trips *without*
        backend-side atomicity; backends with a native primitive
        (If-Match, generation preconditions, a process-wide lock) override
        it.  Either way the caller's retry loop turns the race window into
        a detected conflict instead of a silent lost update.
        """
        try:
            current: Optional[bytes] = self.get(key)
        except NotFoundError:
            current = None
        if current != expected:
            return False
        self.put(key, data)
        return True


class MemoryBackend(StorageBackend):
    """In-process store for tests and ephemeral pipelines."""

    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(data)

    def get(self, key: str) -> bytes:
        # Reads take the lock too: the workflow manager's thread pool hits
        # this dict concurrently with writers, and unlocked reads can tear.
        with self._lock:
            try:
                return self._data[key]
            except KeyError:
                raise NotFoundError(key) from None

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list_keys(self, prefix: str = "") -> Iterator[str]:
        # Snapshot under lock so concurrent writers don't invalidate iteration.
        with self._lock:
            keys = [k for k in self._data if k.startswith(prefix)]
        return iter(sorted(keys))

    # Grouped capabilities: one lock acquisition for the whole batch.

    def exists_many(self, keys: Sequence[str]) -> List[bool]:
        with self._lock:
            return [k in self._data for k in keys]

    def get_many(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        with self._lock:
            return [self._data.get(k) for k in keys]

    def put_many(self, items: Sequence[Tuple[str, bytes]]) -> None:
        with self._lock:
            for key, data in items:
                self._data[key] = bytes(data)

    def delete_many(self, keys: Sequence[str]) -> None:
        with self._lock:
            for key in keys:
                self._data.pop(key, None)

    def put_if(self, key: str, expected: Optional[bytes],
               data: bytes) -> bool:
        # Natively atomic: compare and swap under the one store lock.
        with self._lock:
            if self._data.get(key) != expected:
                return False
            self._data[key] = bytes(data)
            return True


class FileBackend(StorageBackend):
    """Local-filesystem store; two-level fan-out to keep directories small.

    Writes are atomic (tempfile + rename) so a crashed pipeline never leaves
    a half-written chunk at a content address.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    @staticmethod
    def _encode_key(key: str) -> str:
        return key.replace("%", "%25").replace("/", "%2F")

    @staticmethod
    def _decode_key(name: str) -> str:
        return name.replace("%2F", "/").replace("%25", "%")

    def _path(self, key: str) -> str:
        safe = self._encode_key(key)
        if len(safe) >= 4:
            return os.path.join(self.root, safe[:2], safe[2:4], safe)
        return os.path.join(self.root, "__short__", safe)

    @staticmethod
    def _write_atomic(path: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        # Skip rewrites ONLY for content-addressed namespaces (same key ⇒
        # same bytes); mutable ``meta/`` keys must always be replaced.
        if not key.startswith("meta/") and os.path.exists(path):
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._write_atomic(path, data)

    def get(self, key: str) -> bytes:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise NotFoundError(key) from None

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        # Missing keys are a no-op (idempotency contract): a grouped delete
        # replayed by the remote retry layer must never raise on keys the
        # first, response-lost attempt already removed.
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    # -- grouped capabilities ------------------------------------------------

    def exists_many(self, keys: Sequence[str]) -> List[bool]:
        return [os.path.exists(self._path(k)) for k in keys]

    def get_many(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        out: List[Optional[bytes]] = []
        for k in keys:
            try:
                with open(self._path(k), "rb") as f:
                    out.append(f.read())
            except FileNotFoundError:
                out.append(None)
        return out

    def put_many(self, items: Sequence[Tuple[str, bytes]]) -> None:
        # Unlike ``put`` there is no per-key existence stat here: the caller
        # (the store's grouped probe) already knows these keys are missing.
        # Fan-out directories are created once per distinct parent.
        made: Set[str] = set()
        for key, data in items:
            path = self._path(key)
            parent = os.path.dirname(path)
            if parent not in made:
                os.makedirs(parent, exist_ok=True)
                made.add(parent)
            self._write_atomic(path, data)

    def delete_many(self, keys: Sequence[str]) -> None:
        for key in keys:
            try:
                os.unlink(self._path(key))
            except FileNotFoundError:
                pass

    _LOCK_STALE_S = 10.0

    def _lock_path(self, key: str) -> str:
        lock_dir = os.path.join(self.root, "__locks__")
        os.makedirs(lock_dir, exist_ok=True)
        return os.path.join(lock_dir, self._encode_key(key))

    @staticmethod
    def _lock_payload() -> bytes:
        # ``pid:monotonic`` — liveness is checked against the pid, age
        # against CLOCK_MONOTONIC (system-wide on Linux, so stamps compare
        # across the processes sharing this filesystem, and immune to
        # wall-clock jumps).
        return f"{os.getpid()}:{time.monotonic():.6f}".encode()

    def _lock_is_stale(self, lock: str) -> bool:
        """True only when the holder is *provably* dead or the lock has
        outlived the deadline — never merely because it looks old while
        its holder still runs."""
        try:
            with open(lock, "rb") as f:
                payload = f.read()
        except OSError:
            return False        # released meanwhile — nothing to break
        try:
            pid_s, ts_s = payload.decode().split(":", 1)
            pid, ts = int(pid_s), float(ts_s)
        except (ValueError, UnicodeDecodeError):
            # Unparseable (legacy empty lock, torn write): only the
            # wall-clock mtime age is available.
            try:
                return (time.time() - os.path.getmtime(lock)
                        > self._LOCK_STALE_S)
            except OSError:
                return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True         # holder is provably dead (crash, SIGKILL)
        except OSError:
            pass                # alive but other-owned, or unknown: keep it
        now = time.monotonic()
        if ts > now:
            # Stamp from a previous boot (monotonic restarted): fall back
            # to wall-clock age rather than waiting forever.
            try:
                return (time.time() - os.path.getmtime(lock)
                        > self._LOCK_STALE_S)
            except OSError:
                return False
        return now - ts > self._LOCK_STALE_S

    def _break_lock(self, lock: str) -> None:
        """Break one stale lock, serialized through an O_EXCL guard file so
        two waiters can never double-unlink (the second unlink could
        otherwise destroy a lock a third writer just re-acquired)."""
        guard = lock + ".__break__"
        try:
            fd = os.open(guard, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # Another waiter is breaking it.  If *they* died mid-break the
            # guard itself ages out exactly like a lock.
            if self._lock_is_stale(guard):
                try:
                    os.unlink(guard)
                except OSError:
                    pass
            return
        try:
            try:
                os.write(fd, self._lock_payload())
            finally:
                os.close(fd)
            if self._lock_is_stale(lock):   # re-check under the guard
                try:
                    os.unlink(lock)
                except OSError:
                    pass
        finally:
            try:
                os.unlink(guard)
            except OSError:
                pass

    def put_if(self, key: str, expected: Optional[bytes],
               data: bytes) -> bool:
        # Atomic across processes sharing one filesystem: writers serialize
        # on an O_CREAT|O_EXCL lock file in a dedicated ``__locks__`` dir
        # (outside the two-level fan-out, so listings never see it).  The
        # lock records ``pid:monotonic``, so a lock left behind by a
        # crashed writer is broken as soon as its holder is provably dead
        # — a SIGKILLed holder never blocks the next writer for long —
        # and a live-but-stuck holder is broken after 10 s.
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lock = self._lock_path(key)
        deadline = time.monotonic() + 2 * self._LOCK_STALE_S
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:
                    os.write(fd, self._lock_payload())
                finally:
                    os.close(fd)
                break
            except FileExistsError:
                if self._lock_is_stale(lock):
                    self._break_lock(lock)
                    continue
                if time.monotonic() > deadline:
                    raise TimeoutError(f"put_if lock on {key!r} stuck")
                time.sleep(0.01)
        try:
            try:
                with open(path, "rb") as f:
                    current: Optional[bytes] = f.read()
            except FileNotFoundError:
                current = None
            if current != expected:
                return False
            self._write_atomic(path, data)
            return True
        finally:
            try:
                os.unlink(lock)
            except FileNotFoundError:
                pass

    @staticmethod
    def _listdir(path: str) -> List[str]:
        try:
            return sorted(os.listdir(path))
        except (FileNotFoundError, NotADirectoryError):
            return []

    def list_keys(self, prefix: str = "") -> Iterator[str]:
        # The key encoding substitutes per character, so ``encode(prefix)``
        # is a string prefix of ``encode(key)`` exactly when ``prefix`` is a
        # prefix of ``key`` — which lets the walk skip every fan-out
        # directory inconsistent with the first four encoded characters
        # instead of touching all chunk dirs for a ``meta/`` listing.
        safe = self._encode_key(prefix)
        if len(safe) < 4:  # only then can a __short__ (len<4) key match
            for name in self._listdir(os.path.join(self.root, "__short__")):
                if name.startswith(safe):
                    key = self._decode_key(name)
                    if key.startswith(prefix):
                        yield key
        want1, want2 = safe[:2], safe[2:4]
        for d1 in self._listdir(self.root):
            if d1 == "__short__" or len(d1) != 2 or not d1.startswith(want1):
                continue
            for d2 in self._listdir(os.path.join(self.root, d1)):
                if len(d2) != 2 or not d2.startswith(want2):
                    continue
                for name in self._listdir(os.path.join(self.root, d1, d2)):
                    if not name.startswith(safe):
                        continue
                    key = self._decode_key(name)
                    if key.startswith(prefix):
                        yield key


# ---------------------------------------------------------------------------
# Object store
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlobRef:
    """Handle to a stored blob: content digest + logical size."""

    digest: str
    size: int
    n_chunks: int = 1

    def to_json(self) -> dict:
        return {"digest": self.digest, "size": self.size, "n_chunks": self.n_chunks}

    @staticmethod
    def from_json(obj: dict) -> "BlobRef":
        return BlobRef(obj["digest"], int(obj["size"]), int(obj.get("n_chunks", 1)))


@dataclass
class StoreStats:
    puts: int = 0
    gets: int = 0
    dedup_hits: int = 0
    cache_hits: int = 0
    bytes_in: int = 0
    bytes_stored: int = 0
    # Write-path counters (batched ingest): blob-level put calls
    # (``put_blobs`` counts once per call), chunks physically written vs
    # skipped (backend hit or intra-call duplicate), and how many existence
    # *round trips* the write path issued — a grouped probe counts once.
    put_calls: int = 0
    chunks_written: int = 0
    chunks_deduped: int = 0
    exists_probes: int = 0
    # Remote-backend counters (bound into the backend's scheduler via
    # ``bind_store_stats`` when the backend is latency-aware): physical
    # requests issued, duplicate requests hedged against tail latency and
    # how many of those duplicates won, and transient-fault retries.
    remote_requests: int = 0
    hedges_issued: int = 0
    hedge_wins: int = 0
    retries: int = 0
    # Second cache tier: chunk reads served from the on-disk tier instead
    # of the backend (the memory LRU counts separately as ``cache_hits``).
    disk_tier_hits: int = 0
    # Meta-namespace counters: ``meta_requests`` counts meta *round trips*
    # (a grouped prefetch/flush counts once, like ``exists_probes``);
    # ``meta_batched`` counts writes absorbed into a MetaBatch instead of
    # paying their own round trip; ``ref_cas_retries`` counts
    # compare-and-swap conflicts on mutable refs that forced a re-read.
    meta_requests: int = 0
    meta_batched: int = 0
    ref_cas_retries: int = 0
    # Optimistic multi-writer commits: how many times a lost head CAS was
    # resolved by rebasing the loser's delta onto the new head (each rebase
    # is one extra commit attempt, not a lost update).
    commit_rebases: int = 0


DEFAULT_CACHE_BYTES = 64 * 1024 * 1024

# Shared hashing/encoding pool for the batched write path.  Module-global so
# short-lived stores (tests, benches) don't each spin up worker threads;
# tasks are pure functions of their bytes, so sharing is safe.
_POOL_LOCK = threading.Lock()
_POOL: Optional["ThreadPoolExecutor"] = None
_POOL_WORKERS = min(8, os.cpu_count() or 1)
# Below this many payload bytes a batch is hashed inline — pool dispatch
# would cost more than the parallelism buys.
_PARALLEL_THRESHOLD = 2 * 1024 * 1024


def _hash_pool() -> "ThreadPoolExecutor":
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=_POOL_WORKERS,
                thread_name_prefix="repro-store")
        return _POOL


def _drop_pool_after_fork() -> None:
    # Worker threads do not survive fork(); a child inheriting the parent's
    # executor would block forever on its first grouped write.  Drop the
    # reference so the child lazily builds a fresh pool.
    global _POOL
    _POOL = None


if hasattr(os, "register_at_fork"):  # pragma: no branch - POSIX
    os.register_at_fork(after_in_child=_drop_pool_after_fork)


class DiskChunkTier:
    """Second chunk-cache tier on local disk, below the in-memory LRU.

    Chunks are immutable and content-addressed, so this tier needs no
    invalidation protocol: a file named by a digest either holds exactly
    those bytes or is corrupt (detected by re-hash on read and dropped).
    Its job is to let a cold process against a *remote* backend warm from
    local disk instead of the network.  Eviction is LRU by file mtime
    (reads touch the file); revocation and GC evict eagerly through
    :meth:`ObjectStore._cache_evict` so deleted payloads cannot be served
    from disk after the backend forgot them.

    Cross-process use of one directory is supported (that is the point);
    accounting is best-effort per process and re-scanned lazily.
    """

    def __init__(self, root: str, cap_bytes: int) -> None:
        self.root = os.path.abspath(root)
        self.cap = max(0, int(cap_bytes))
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._size: Optional[int] = None  # lazy scan on first write

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, digest[:2], digest)

    def _entries(self) -> List[Tuple[float, str, int]]:
        """(mtime, path, size) for every cached chunk file."""
        out: List[Tuple[float, str, int]] = []
        for d1 in FileBackend._listdir(self.root):
            sub = os.path.join(self.root, d1)
            for name in FileBackend._listdir(sub):
                path = os.path.join(sub, name)
                try:
                    st = os.stat(path)
                except FileNotFoundError:  # pragma: no cover - racing evict
                    continue
                out.append((st.st_mtime, path, st.st_size))
        return out

    def _scan_locked(self) -> int:
        if self._size is None:
            self._size = sum(sz for _, _, sz in self._entries())
        return self._size

    def get(self, digest: str) -> Optional[bytes]:
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except (FileNotFoundError, NotADirectoryError):
            return None
        try:
            os.utime(path)  # recency for mtime-LRU eviction
        except OSError:  # pragma: no cover - concurrent evict
            pass
        return raw

    def put(self, digest: str, raw: bytes) -> None:
        if not self.cap or len(raw) > self.cap:
            return
        path = self._path(digest)
        with self._lock:
            size = self._scan_locked()
            if os.path.exists(path):
                return
            os.makedirs(os.path.dirname(path), exist_ok=True)
            FileBackend._write_atomic(path, raw)
            self._size = size + len(raw)
            if self._size > self.cap:
                self._evict_lru_locked()

    def _evict_lru_locked(self) -> None:
        entries = sorted(self._entries())
        self._size = sum(sz for _, _, sz in entries)
        while entries and self._size > self.cap:
            _, path, sz = entries.pop(0)
            try:
                os.unlink(path)
            except FileNotFoundError:  # pragma: no cover
                pass
            self._size -= sz

    def evict(self, digest: str) -> None:
        path = self._path(digest)
        with self._lock:
            try:
                sz = os.stat(path).st_size
                os.unlink(path)
            except (FileNotFoundError, NotADirectoryError):
                return
            if self._size is not None:
                self._size -= sz

    def info(self) -> Dict[str, int]:
        entries = self._entries()
        return {"entries": len(entries),
                "bytes": sum(sz for _, _, sz in entries),
                "capacity": self.cap}


class ObjectStore:
    """Chunked, deduplicating, content-addressed store over a backend."""

    # Key namespaces.  Chunks and blob manifests are content-addressed; the
    # ``meta/`` namespace is mutable (refs, graphs) and is NOT content-keyed.
    _CHUNK = "c-"
    _BLOBMAN = "b-"
    META = "meta/"

    def __init__(
        self,
        backend: Optional[StorageBackend] = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        compress: bool = True,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        compress_sniff: bool = True,
        disk_cache_bytes: int = 0,
        disk_cache_dir: Optional[str] = None,
        meta_batching: bool = True,
    ) -> None:
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.backend = backend if backend is not None else MemoryBackend()
        self.chunk_size = chunk_size
        self.compress = compress
        # Skip the zlib attempt for chunks the entropy sniff deems
        # incompressible; False = always attempt (see _looks_compressible).
        self.compress_sniff = compress_sniff
        self.stats = StoreStats()
        # Latency-aware backends expose a stats hook so their scheduler's
        # remote/hedge/retry counters land directly in this store's stats.
        bind = getattr(self.backend, "bind_store_stats", None)
        if callable(bind):
            bind(self.stats)
        # Verified-once chunk cache (see module docstring): digest -> raw
        # bytes, bounded by total payload size, LRU eviction.  Thread-safe:
        # the loader prefetch thread and workflow workers read concurrently.
        self._cache_cap = max(0, int(cache_bytes))
        self._cache: "OrderedDict[str, bytes]" = OrderedDict()
        self._cache_size = 0
        self._cache_lock = threading.Lock()
        # Second, on-disk cache tier below the memory LRU (off by default —
        # ``disk_cache_bytes=0`` mirrors ``cache_bytes=0``).  Populated on
        # verified reads only, like the memory tier, so backend corruption
        # is still detected the first time a chunk is fetched.
        self._disk: Optional[DiskChunkTier] = None
        if disk_cache_bytes > 0:
            if disk_cache_dir is None:
                disk_cache_dir = os.path.join(tempfile.gettempdir(),
                                              "repro-chunk-cache")
            self._disk = DiskChunkTier(disk_cache_dir, disk_cache_bytes)
        # Commit-scoped metadata batching.  The active scope is per-thread
        # (``_batch_tls``) so concurrent committers never share staging
        # state, but staged-yet-unflushed chunk/manifest bytes live in a
        # store-global refcounted table so reads from ANY thread can be
        # served while a batch is open.  ``meta_batching=False`` turns
        # every ``meta_batch()`` scope into a no-op — the measurable
        # pre-batch baseline.
        self.meta_batching = bool(meta_batching)
        self._batch_tls = threading.local()
        self._pending_lock = threading.Lock()
        self._pending_chunks: Dict[str, Tuple[bytes, int]] = {}
        self._pending_manifests: Dict[str, Tuple[bytes, int]] = {}
        # Crash-consistency kill points (tests/harnesses only): when set,
        # called with a string naming the flush stage about to run (e.g.
        # ``"flush:pre_ref:refs/ds/heads/main"``); a hook that raises
        # simulates a crash at exactly that boundary.
        self.killpoint_hook = None

    def _killpoint(self, point: str) -> None:
        hook = self.killpoint_hook
        if hook is not None:
            hook(point)

    # -- verified-once chunk cache -----------------------------------------

    def _cache_get(self, digest: str) -> Optional[bytes]:
        if not self._cache_cap:
            return None
        with self._cache_lock:
            raw = self._cache.get(digest)
            if raw is not None:
                self._cache.move_to_end(digest)
                self.stats.cache_hits += 1
            return raw

    def _cache_put(self, digest: str, raw: bytes) -> None:
        if not self._cache_cap or len(raw) > self._cache_cap:
            return
        with self._cache_lock:
            if digest in self._cache:
                self._cache.move_to_end(digest)
                return
            self._cache[digest] = raw
            self._cache_size += len(raw)
            while self._cache_size > self._cache_cap:
                _, evicted = self._cache.popitem(last=False)
                self._cache_size -= len(evicted)

    def _cache_evict(self, digest: str) -> None:
        # Evicts BOTH tiers: revocation/GC must leave no copy of a deleted
        # chunk servable from memory or disk.
        with self._cache_lock:
            evicted = self._cache.pop(digest, None)
            if evicted is not None:
                self._cache_size -= len(evicted)
        if self._disk is not None:
            self._disk.evict(digest)

    def cache_info(self) -> Dict[str, int]:
        with self._cache_lock:
            return {"entries": len(self._cache), "bytes": self._cache_size,
                    "capacity": self._cache_cap,
                    "hits": self.stats.cache_hits}

    def _disk_get(self, digest: str) -> Optional[bytes]:
        """Disk-tier lookup with re-verification (local disk can rot; a
        mismatch is dropped and treated as a miss, never served)."""
        if self._disk is None:
            return None
        raw = self._disk.get(digest)
        if raw is None:
            return None
        if sha256_hex(raw) != digest:
            self._disk.evict(digest)
            return None
        self.stats.disk_tier_hits += 1
        self._cache_put(digest, raw)
        return raw

    def disk_cache_info(self) -> Optional[Dict[str, int]]:
        if self._disk is None:
            return None
        info = self._disk.info()
        info["hits"] = self.stats.disk_tier_hits
        return info

    # -- commit-scoped meta batching -----------------------------------------

    def meta_batch(self, prefetch: Sequence[str] = ()) -> "MetaBatch":
        """Open a commit-scoped :class:`MetaBatch` on this thread.

        ``with store.meta_batch(prefetch=[...]):`` — inside the scope,
        ``meta/`` reads come from one grouped prefetch plus read-through
        for misses, and ``meta/`` writes (plus content-addressed blob
        writes) are staged and flushed on exit in happens-before order:
        data blobs → write-once meta (ONE grouped put) → mutable ``refs/``
        last, each through the :meth:`put_meta_if` CAS guard.  Scopes
        nest: an inner ``meta_batch()`` joins the outer one and only the
        outermost exit flushes.  If the body raises, staged writes are
        discarded.  With ``meta_batching=False`` the scope is a no-op and
        every operation goes straight to the backend.
        """
        return MetaBatch(self, prefetch)

    def _active_batch(self) -> Optional["MetaBatch"]:
        if not self.meta_batching:
            return None
        return getattr(self._batch_tls, "batch", None)

    def require_meta_cas(self, name: str, merge: Optional[Callable] = None,
                         after_refs: bool = False) -> None:
        """Escalate a staged meta key to *strict* CAS semantics for the
        current batch: at flush it goes through the ``put_if`` guard.  On
        a concurrent change, a key with a ``merge`` callback self-heals —
        ``merge(current_value)`` re-applies this batch's mutation onto the
        winner's value (append-shaped indexes: zero lost updates, never
        aborts) — while a key without one raises
        :class:`CommitConflictError` instead of being absorbed
        last-writer-wins (the branch head: the rebase trigger).
        ``after_refs=True`` additionally orders the key after every
        ``refs/`` CAS — for pointers (like the derivation cache) that must
        never land before the head they name.  No-op when no batch is
        open: the caller's own read-modify-write semantics apply unbatched.
        """
        batch = self._active_batch()
        if batch is not None:
            batch.require_cas(name, merge=merge, after_refs=after_refs)

    # Staged-but-unflushed chunk/manifest bytes, refcounted per open batch
    # so two concurrent batches staging the same digest both stay readable.

    def _pending_add(self, table: Dict[str, Tuple[bytes, int]],
                     digest: str, raw: bytes) -> None:
        with self._pending_lock:
            ent = table.get(digest)
            table[digest] = (raw, 1) if ent is None else (ent[0], ent[1] + 1)

    def _pending_release(self, chunk_digests: Iterable[str],
                         man_digests: Iterable[str]) -> None:
        with self._pending_lock:
            for table, digests in ((self._pending_chunks, chunk_digests),
                                   (self._pending_manifests, man_digests)):
                for digest in digests:
                    ent = table.get(digest)
                    if ent is None:
                        continue
                    if ent[1] <= 1:
                        del table[digest]
                    else:
                        table[digest] = (ent[0], ent[1] - 1)

    def _pending_get(self, table: Dict[str, Tuple[bytes, int]],
                     digest: str) -> Optional[bytes]:
        if not table:
            return None
        with self._pending_lock:
            ent = table.get(digest)
            return None if ent is None else ent[0]

    def blob_is_staged(self, digest: str) -> bool:
        """True while ``digest`` is staged (unflushed) in an open batch."""
        if not (self._pending_chunks or self._pending_manifests):
            return False
        with self._pending_lock:
            return (digest in self._pending_chunks
                    or digest in self._pending_manifests)

    # -- chunk plumbing ----------------------------------------------------

    # Entropy sniff: count distinct byte values in a small strided sample
    # spread across the chunk.  A near-uniform sample (random / encrypted /
    # already-compressed data) cannot win under zlib, so the expensive
    # full-chunk attempt is skipped; the decision only picks the storage
    # codec — chunk identity is always the digest of the raw bytes.  128
    # random bytes show ~101 distinct values on average (σ ≈ 6), typical
    # text or JSON far fewer; a misjudged borderline chunk merely stores
    # raw, it never corrupts.  Wide-alphabet chunks of ``_SNIFF_DEEP_CHUNK``
    # or more get one extra contiguous-prefix probe so high-entropy data
    # that *repeats* (tiled blocks, re-padded shards) — and struct-packed
    # numeric data with many byte values — is still caught; below that the
    # strided sample alone decides (the savings there are smallest), and
    # repetition at periods beyond the prefix stays a deliberate blind
    # spot, as it is for zlib's own 32 KiB window.  Construct with
    # ``compress_sniff=False`` to restore the unconditional zlib attempt
    # when storage size matters more than ingest speed.
    _SNIFF_BYTES = 128
    _SNIFF_MIN_CHUNK = 1024       # below this, compressing is cheap anyway
    _SNIFF_MAX_DISTINCT = 88
    _SNIFF_DEEP_CHUNK = 4096      # prefix-probe threshold
    _SNIFF_DEEP_BYTES = 2048

    @classmethod
    def _looks_compressible(cls, raw: bytes) -> bool:
        if len(raw) < cls._SNIFF_MIN_CHUNK:
            return True
        sample = raw[::len(raw) // cls._SNIFF_BYTES][:cls._SNIFF_BYTES]
        if len(set(sample)) <= cls._SNIFF_MAX_DISTINCT:
            return True
        if len(raw) >= cls._SNIFF_DEEP_CHUNK:
            prefix = raw[:cls._SNIFF_DEEP_BYTES]
            return len(zlib.compress(prefix, 1)) < len(prefix) - 64
        return False

    def _encode(self, raw: bytes) -> bytes:
        if self.compress and len(raw) > 64 \
                and (not self.compress_sniff
                     or self._looks_compressible(raw)):
            z = zlib.compress(raw, 1)
            if len(z) < len(raw):
                return _HDR.pack(_CODEC_ZLIB, len(raw)) + z
        return _HDR.pack(_CODEC_RAW, len(raw)) + raw

    @staticmethod
    def _decode(stored: bytes) -> bytes:
        codec, raw_len = _HDR.unpack_from(stored)
        body = stored[_HDR.size :]
        if codec == _CODEC_RAW:
            raw = body
        elif codec == _CODEC_ZLIB:
            raw = zlib.decompress(body)
        else:  # pragma: no cover - corrupted header
            raise IntegrityError(f"unknown codec byte {codec}")
        if len(raw) != raw_len:
            raise IntegrityError("chunk size mismatch after decode")
        return raw

    def _put_chunk(self, raw: bytes) -> str:
        digest = sha256_hex(raw)
        key = self._CHUNK + digest
        self.stats.bytes_in += len(raw)
        self.stats.exists_probes += 1
        if self.backend.exists(key):
            self.stats.dedup_hits += 1
            self.stats.chunks_deduped += 1
            return digest
        enc = self._encode(raw)
        # put_many, not put: the probe above is authoritative, so the
        # backend must not pay a second per-key existence check.
        self.backend.put_many([(key, enc)])
        self.stats.puts += 1
        self.stats.chunks_written += 1
        self.stats.bytes_stored += len(enc)
        return digest

    def _get_chunk(self, digest: str) -> bytes:
        return self._get_chunks([digest])[digest]

    def _get_chunks(self, digests: Sequence[str]) -> Dict[str, bytes]:
        """Fetch distinct chunks through the tiers: memory LRU → disk tier
        → ONE grouped backend read for whatever is left.

        Every distinct requested digest counts one ``gets``; backend bytes
        are decoded, verified against their address, and then populate
        both cache tiers (verified-once: never populated on writes).
        """
        out: Dict[str, bytes] = {}
        misses: List[str] = []
        for digest in dict.fromkeys(digests):
            self.stats.gets += 1
            # Staged-but-unflushed batch writes are readable immediately
            # (read-your-writes inside and across threads during a batch).
            raw = self._pending_get(self._pending_chunks, digest)
            if raw is None:
                raw = self._cache_get(digest)
            if raw is None:
                raw = self._disk_get(digest)
            if raw is None:
                misses.append(digest)
            else:
                out[digest] = raw
        if misses:
            stored = self.backend.get_many(
                [self._CHUNK + d for d in misses])
            for digest, enc in zip(misses, stored):
                if enc is None:
                    raise NotFoundError(digest)
                raw = self._decode(enc)
                if sha256_hex(raw) != digest:
                    raise IntegrityError(
                        f"chunk {digest[:12]}… failed verification")
                self._cache_put(digest, raw)
                if self._disk is not None:
                    self._disk.put(digest, raw)
                out[digest] = raw
        return out

    # -- blob API ------------------------------------------------------------

    def put_blob(self, data: bytes) -> BlobRef:
        """Store arbitrary bytes; returns a stable content-addressed ref."""
        data = bytes(data)
        self.stats.put_calls += 1
        batch = self._active_batch()
        if batch is not None:
            # Content addresses are computable locally, so the write can
            # join the batch's single grouped probe + put at flush time.
            self.stats.bytes_in += len(data)
            return batch.stage_blob(data)
        if len(data) <= self.chunk_size:
            digest = self._put_chunk(data)
            return BlobRef(digest, len(data), 1)
        chunk_digests: List[str] = []
        for off in range(0, len(data), self.chunk_size):
            chunk_digests.append(self._put_chunk(data[off : off + self.chunk_size]))
        manifest = self._blob_manifest(chunk_digests, len(data))
        top = sha256_hex(manifest)
        man_key = self._BLOBMAN + top
        # Same contract as chunks: the store-level probe is authoritative,
        # so the backend write skips its own per-key existence check.
        self.stats.exists_probes += 1
        if not self.backend.exists(man_key):
            self.backend.put_many([(man_key, manifest)])
        return BlobRef(top, len(data), len(chunk_digests))

    @staticmethod
    def _blob_manifest(chunk_digests: Sequence[str], size: int) -> bytes:
        return json.dumps(
            {"chunks": list(chunk_digests), "size": size},
            separators=(",", ":")).encode()

    def put_blobs(self, payloads: Sequence[bytes]) -> List[BlobRef]:
        """Store many blobs in one batched write — the ingest hot path.

        Byte- and ref-identical to a sequential :meth:`put_blob` loop, but
        grouped: every chunk of every payload is hashed up front (thread
        pool for large batches — sha256 releases the GIL), duplicate chunks
        within the call collapse, ONE ``exists_many`` round trip asks the
        backend which distinct chunks it is missing, and only those are
        encoded (in parallel) and written through one ``put_many``.  A
        batch whose content is already stored costs a single membership
        probe and zero writes.
        """
        payloads = [bytes(p) for p in payloads]
        if not payloads:
            return []
        self.stats.put_calls += 1

        # 1. Chunk split + hash-first (grouped, parallel for large batches).
        chunk_lists: List[List[bytes]] = []
        flat: List[bytes] = []
        for data in payloads:
            if len(data) <= self.chunk_size:
                chunks = [data]
            else:
                chunks = [data[off:off + self.chunk_size]
                          for off in range(0, len(data), self.chunk_size)]
            chunk_lists.append(chunks)
            flat.extend(chunks)
            self.stats.bytes_in += len(data)
        digests = self._hash_chunks(flat)

        # 2. Intra-call dedup: first occurrence of each distinct chunk wins.
        unique: "OrderedDict[str, bytes]" = OrderedDict()
        for raw, digest in zip(flat, digests):
            if digest not in unique:
                unique[digest] = raw

        # 3. Blob manifests for multi-chunk payloads (content known now, so
        #    they join the same grouped probe/write as the chunks).
        refs: List[BlobRef] = []
        manifests: "OrderedDict[str, bytes]" = OrderedDict()
        pos = 0
        for data, chunks in zip(payloads, chunk_lists):
            n = len(chunks)
            if n == 1:
                refs.append(BlobRef(digests[pos], len(data), 1))
            else:
                man = self._blob_manifest(digests[pos:pos + n], len(data))
                top = sha256_hex(man)
                manifests.setdefault(top, man)
                refs.append(BlobRef(top, len(data), n))
            pos += n

        # 3b. Inside a meta batch the probe and write are deferred to the
        #     batch flush (refs are already final — content addressing).
        batch = self._active_batch()
        if batch is not None:
            for raw, digest in zip(flat, digests):
                batch.stage_chunk(digest, raw)
            for top, man in manifests.items():
                batch.stage_manifest(top, man)
            batch.maybe_spill()
            return refs

        # 4. One grouped existence probe over distinct chunks + manifests.
        keys = [self._CHUNK + d for d in unique]
        keys.extend(self._BLOBMAN + d for d in manifests)
        present = self.backend.exists_many(keys)
        self.stats.exists_probes += 1

        # 5. Encode and write only what the backend is missing.
        missing = [d for d, hit in zip(unique, present[:len(unique)])
                   if not hit]
        encoded = self._encode_chunks([unique[d] for d in missing])
        items: List[Tuple[str, bytes]] = [
            (self._CHUNK + d, enc) for d, enc in zip(missing, encoded)]
        items.extend(
            (self._BLOBMAN + d, man)
            for (d, man), hit in zip(manifests.items(), present[len(unique):])
            if not hit)
        if items:
            self.backend.put_many(items)
        n_written = len(missing)
        self.stats.puts += n_written
        self.stats.chunks_written += n_written
        self.stats.bytes_stored += sum(len(enc) for enc in encoded)
        self.stats.chunks_deduped += len(flat) - n_written
        self.stats.dedup_hits += len(flat) - n_written
        return refs

    @staticmethod
    def _pool_map(fn, chunks: Sequence[bytes]) -> List:
        """Apply ``fn`` chunk-wise with a few contiguous slice tasks.

        One future per *slice* (not per chunk — future dispatch would cost
        more than small-chunk hashing), and the main thread works the first
        slice itself while the pool handles the rest; sha256/zlib release
        the GIL so the slices genuinely overlap.
        """
        pool = _hash_pool()
        n_slices = min(1 + _POOL_WORKERS, len(chunks))
        bounds = [(i * len(chunks) // n_slices,
                   (i + 1) * len(chunks) // n_slices)
                  for i in range(n_slices)]
        futures = [pool.submit(lambda sl: [fn(c) for c in sl],
                               chunks[lo:hi]) for lo, hi in bounds[1:]]
        out = [fn(c) for c in chunks[bounds[0][0]:bounds[0][1]]]
        for fut in futures:
            out.extend(fut.result())
        return out

    def _hash_chunks(self, chunks: Sequence[bytes]) -> List[str]:
        if len(chunks) < 2 or sum(map(len, chunks)) < _PARALLEL_THRESHOLD:
            return [sha256_hex(c) for c in chunks]
        return self._pool_map(sha256_hex, chunks)

    def _encode_chunks(self, chunks: Sequence[bytes]) -> List[bytes]:
        if len(chunks) < 2 or sum(map(len, chunks)) < _PARALLEL_THRESHOLD:
            return [self._encode(c) for c in chunks]
        return self._pool_map(self._encode, chunks)

    def get_blob(self, ref) -> bytes:
        """Fetch a blob by :class:`BlobRef` or digest string."""
        return self.get_blobs([ref])[0]

    def get_blobs(self, refs: Sequence[Union[BlobRef, str]]) -> List[bytes]:
        """Fetch many blobs in one call.

        Resolves every blob manifest up front (ONE grouped ``get_many`` —
        a manifest's absence means "single chunk", so membership and
        payload are the same round trip), then fetches each distinct chunk
        digest exactly once per call through the cache tiers — a batch
        whose blobs share chunks (dedup) pays one grouped backend read for
        the unique misses, and the verified-once tiers serve repeats free.
        """
        if not refs:
            return []
        parsed: List[Tuple[str, Optional[int]]] = []
        for ref in refs:
            if isinstance(ref, BlobRef):
                parsed.append((ref.digest, ref.n_chunks))
            else:
                parsed.append((ref, None))
        # One grouped manifest pass for every ref not known single-chunk.
        # Digests staged in an open batch resolve without a backend probe:
        # a staged manifest serves its bytes, a staged chunk is by
        # construction a single-chunk blob.
        man_pos = [i for i, (_, n) in enumerate(parsed) if n != 1]
        staged_man: Dict[int, bytes] = {}
        if self._pending_chunks or self._pending_manifests:
            with self._pending_lock:
                keep: List[int] = []
                for i in man_pos:
                    digest = parsed[i][0]
                    ent = self._pending_manifests.get(digest)
                    if ent is not None:
                        staged_man[i] = ent[0]
                    elif digest not in self._pending_chunks:
                        keep.append(i)
                man_pos = keep
        man_raw = self.backend.get_many(
            [self._BLOBMAN + parsed[i][0] for i in man_pos]) if man_pos \
            else []
        plans: List[Tuple[List[str], Optional[int]]] = [
            ([digest], None) for digest, _ in parsed]
        for i, raw in list(staged_man.items()) + list(zip(man_pos, man_raw)):
            if raw is not None:
                man = json.loads(raw)
                plans[i] = (list(man["chunks"]), int(man["size"]))
        chunk_map = self._get_chunks(
            [d for chunks, _ in plans for d in chunks])
        out: List[bytes] = []
        for chunks, size in plans:
            parts = [chunk_map[d] for d in chunks]
            data = parts[0] if len(parts) == 1 else b"".join(parts)
            if size is not None and len(data) != size:
                raise IntegrityError("blob size mismatch")
            out.append(data)
        return out

    def has_blob(self, digest: str) -> bool:
        # One grouped probe, not two sequential round trips.
        return self.has_blobs([digest])[0]

    def has_blobs(self, digests: Sequence[str]) -> List[bool]:
        """Grouped membership: ONE probe round trip answers every digest
        (both key forms each); staged-but-unflushed batch writes count."""
        out: List[Optional[bool]] = [None] * len(digests)
        if self._pending_chunks or self._pending_manifests:
            with self._pending_lock:
                for i, digest in enumerate(digests):
                    if (digest in self._pending_chunks
                            or digest in self._pending_manifests):
                        out[i] = True
        miss = [i for i, hit in enumerate(out) if hit is None]
        if miss:
            keys: List[str] = []
            for i in miss:
                keys.append(self._CHUNK + digests[i])
                keys.append(self._BLOBMAN + digests[i])
            present = self.backend.exists_many(keys)
            for j, i in enumerate(miss):
                out[i] = present[2 * j] or present[2 * j + 1]
        return [bool(hit) for hit in out]

    def delete_blob(self, ref) -> None:
        """Physically remove a blob (used by revocation + GC)."""
        self.delete_blobs([ref])

    def delete_blobs(self, refs: Sequence[Union[BlobRef, str]]) -> None:
        """Physically remove many blobs with grouped backend round trips.

        One ``exists_many`` resolves which digests are multi-chunk blob
        manifests, their chunk lists are expanded, and every doomed key is
        dropped in a single ``delete_many`` (cache entries evicted first so
        deleted payloads are never served from memory).
        """
        digests = [ref.digest if isinstance(ref, BlobRef) else ref
                   for ref in refs]
        if not digests:
            return
        man_keys = [self._BLOBMAN + d for d in digests]
        manifests = self.backend.get_many(man_keys)
        doomed: List[str] = []
        dead_chunks: List[str] = []
        for digest, man_key, raw in zip(digests, man_keys, manifests):
            if raw is not None:
                man = json.loads(raw)
                for d in man["chunks"]:
                    self._cache_evict(d)
                    dead_chunks.append(d)
                    doomed.append(self._CHUNK + d)
                doomed.append(man_key)
            else:
                self._cache_evict(digest)
                dead_chunks.append(digest)
                doomed.append(self._CHUNK + digest)
        # Drop any staged copies outright (all refcounts): a later batch
        # flush must never resurrect a physically deleted payload.
        with self._pending_lock:
            for d in dead_chunks:
                self._pending_chunks.pop(d, None)
            for d in digests:
                self._pending_manifests.pop(d, None)
        self.backend.delete_many(doomed)

    # -- JSON convenience (commits, manifests, graphs) -----------------------

    @staticmethod
    def _dump_json(obj) -> bytes:
        return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()

    def put_json(self, obj) -> BlobRef:
        return self.put_blob(self._dump_json(obj))

    def put_jsons(self, objs: Sequence[object]) -> List[BlobRef]:
        """Batched :meth:`put_json` — one grouped write (and one dedup
        probe) for many small documents (manifest pages, page indexes)."""
        return self.put_blobs([self._dump_json(o) for o in objs])

    def get_json(self, ref):
        return json.loads(self.get_blob(ref).decode())

    def get_jsons(self, refs: Sequence[Union[BlobRef, str]]) -> List[dict]:
        """Batched :meth:`get_json` — one grouped chunk pass for many small
        documents (manifest pages, per-page indexes)."""
        return [json.loads(b.decode()) for b in self.get_blobs(refs)]

    # -- mutable metadata (refs live here, not content-addressed) ------------

    @staticmethod
    def _meta_bytes(obj) -> bytes:
        # THE serialization for ``meta/`` values.  Batched writes, unbatched
        # writes and CAS expected-value encodings must all agree
        # byte-for-byte, or batching would not be state-identical.
        return json.dumps(obj, sort_keys=True).encode()

    def put_meta(self, name: str, obj) -> None:
        data = self._meta_bytes(obj)
        batch = self._active_batch()
        if batch is not None:
            batch.stage_meta(name, data)
            return
        self.stats.meta_requests += 1
        self.backend.put(self.META + name, data)

    def put_metas(self, items: Sequence[Tuple[str, object]]) -> None:
        """Grouped :meth:`put_meta` (meta keys are mutable — always
        written, so ``put_many``'s unconditional contract fits exactly)."""
        batch = self._active_batch()
        if batch is not None:
            for name, obj in items:
                batch.stage_meta(name, self._meta_bytes(obj))
            return
        self.stats.meta_requests += 1
        self.backend.put_many(
            [(self.META + name, self._meta_bytes(obj))
             for name, obj in items])

    def put_meta_if(self, name: str, expected, value) -> bool:
        """Compare-and-swap on a mutable meta key.

        ``expected`` is the object the caller last observed (``None`` ⇒
        the key must still be absent); returns True when the write
        applied.  Never staged: the conditional check IS the ordering
        primitive, so it always goes to the backend immediately — the
        batch flush uses it to land mutable ``refs/`` last without
        widening the lost-update window.
        """
        self.stats.meta_requests += 1
        return self.backend.put_if(
            self.META + name,
            None if expected is None else self._meta_bytes(expected),
            self._meta_bytes(value))

    def get_meta(self, name: str, default=None):
        # Absence-is-an-answer: one round trip, not exists + get.
        batch = self._active_batch()
        if batch is not None:
            raw = batch.fetch_raw([name])[name]
        else:
            self.stats.meta_requests += 1
            try:
                raw = self.backend.get(self.META + name)
            except NotFoundError:
                raw = None
        # Parse fresh on every read: callers mutate the returned object
        # (read-modify-write), so cached raw bytes must never alias.
        return default if raw is None else json.loads(raw.decode())

    def get_metas(self, names: Sequence[str], default=None) -> List:
        """Grouped :meth:`get_meta`: ONE round trip for all names
        (membership and payload together via ``get_many``)."""
        batch = self._active_batch()
        if batch is not None:
            got = batch.fetch_raw(list(names))
            raws = [got[n] for n in names]
        else:
            self.stats.meta_requests += 1
            raws = self.backend.get_many([self.META + n for n in names])
        return [default if raw is None else json.loads(raw.decode())
                for raw in raws]

    def delete_meta(self, name: str) -> None:
        # Write-through even inside a batch (deletes are rare on the commit
        # path and ordering against staged puts stays trivially correct:
        # a staged value for the name is dropped, a later staged put of
        # the same name lands at flush, after this delete).
        batch = self._active_batch()
        if batch is not None:
            batch.forget(name)
        self.stats.meta_requests += 1
        self.backend.delete(self.META + name)

    def list_meta(self, prefix: str = "") -> List[str]:
        self.stats.meta_requests += 1
        plen = len(self.META)
        names = [k[plen:] for k in self.backend.list_keys(self.META + prefix)]
        batch = self._active_batch()
        if batch is not None:
            names = batch.merge_listing(prefix, names)
        return names

    # -- garbage collection ---------------------------------------------------

    def reachable_from(self, blob_digests: Iterable[str]) -> Set[str]:
        """Expand top-level blob digests to the full set of live keys
        (grouped manifest reads — GC over a remote backend pays one round
        trip per batch, not two per root)."""
        live: Set[str] = set()
        digests = list(blob_digests)
        man_keys = [self._BLOBMAN + d for d in digests]
        for digest, man_key, raw in zip(
                digests, man_keys, self.backend.get_many(man_keys)):
            if raw is not None:
                live.add(man_key)
                man = json.loads(raw)
                for d in man["chunks"]:
                    live.add(self._CHUNK + d)
            else:
                live.add(self._CHUNK + digest)
        return live

    def gc(self, roots: Iterable[str]) -> int:
        """Mark-and-sweep: delete every chunk/manifest not reachable from roots.

        ``roots`` are top-level blob digests (commit blobs, manifests, graph
        heads...).  Returns the number of keys deleted.  ``meta/`` keys are
        never collected.
        """
        live = self.reachable_from(roots)
        dead = [
            k
            for k in self.backend.list_keys()
            if not k.startswith(self.META) and k not in live
        ]
        for k in dead:
            if k.startswith(self._CHUNK):
                self._cache_evict(k[len(self._CHUNK):])
        self.backend.delete_many(dead)
        return len(dead)


# Marks a staged ref whose pre-image was never observed inside the scope;
# the flush resolves it with one grouped read before the CAS pass.
_UNOBSERVED = object()


def _decode_meta(raw):
    """Best-effort decode of a raw meta value for error reporting."""
    if raw is None or raw is _UNOBSERVED:
        return None
    try:
        return json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError, AttributeError):
        return raw


class MetaBatch:
    """Commit-scoped grouping layer over ``meta/`` (and the commit's
    content-addressed writes).  Obtain via :meth:`ObjectStore.meta_batch`.

    A *pure grouping* layer: it changes when round trips happen, never
    what lands in the backend.

    - **Reads** are served staged-first (read-your-writes), then from raw
      bytes already observed this scope, then read-through — one grouped
      ``get_many`` per miss group.  Values are parsed fresh per read so
      callers that mutate returned objects never alias the cache.
    - **Writes** stage: write-once keys (commit bodies, lineage/audit
      segments, index pointers) flush as ONE grouped put; mutable
      ``refs/`` flush LAST, each through the ``put_if`` compare-and-swap
      guard with the pre-image observed in-scope as the expected value —
      a concurrent writer makes the CAS fail cleanly (counted in
      ``ref_cas_retries``) instead of being silently overwritten.
    - **Blobs** stage too (content addresses are computable locally), so
      a whole commit flushes as: one existence probe + one grouped blob
      put → one grouped meta put → refs.  Memory is bounded: past
      ``_SPILL_BYTES`` of staged payload the blob portion flushes early.
    - Scopes **nest** (an inner scope joins the outer); only the
      outermost exit flushes.  If the body raises, staged state is
      discarded and nothing is written — strictly cleaner than the
      unbatched path's partial prefix.  A flush failure propagates like
      the first failing single write would have.
    """

    _REFS = "refs/"
    _CAS_MAX_RETRIES = 16
    _SPILL_BYTES = 48 * 1024 * 1024

    def __init__(self, store: ObjectStore, prefetch: Sequence[str] = ()):
        self.store = store
        self._prefetch = [str(n) for n in prefetch]
        self._owner = False
        # Raw bytes observed from the backend this scope (None = absent).
        self._cache: Dict[str, Optional[bytes]] = {}
        self._staged: "OrderedDict[str, bytes]" = OrderedDict()
        self._staged_refs: "OrderedDict[str, bytes]" = OrderedDict()
        self._expected: Dict[str, object] = {}
        # Keys escalated to strict CAS (conflict ⇒ CommitConflictError,
        # never last-writer-wins) and the subset that must land AFTER the
        # refs/ pass (pointers that must never precede the head they name).
        self._strict: Set[str] = set()
        self._cas_after: Set[str] = set()
        # Registered conflict-merge callbacks: on a lost CAS the key's
        # mutation is re-applied onto the winner's value instead of
        # clobbering it (append-shaped indexes) or aborting (the head).
        self._merge: Dict[str, Callable] = {}
        self._chunks: "OrderedDict[str, None]" = OrderedDict()
        self._manifests: "OrderedDict[str, None]" = OrderedDict()
        self._chunk_stages = 0      # occurrences, for dedup accounting
        self._staged_bytes = 0

    # -- scope lifecycle ----------------------------------------------------

    def __enter__(self) -> "MetaBatch":
        store = self.store
        if not store.meta_batching:
            return self          # disabled: a null scope, nothing routes here
        active = getattr(store._batch_tls, "batch", None)
        if active is None:
            store._batch_tls.batch = self
            self._owner = True
            active = self
        if self._prefetch:
            active.fetch_raw(self._prefetch)
        return active

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._owner:
            return False
        self.store._batch_tls.batch = None
        try:
            if exc_type is None:
                self._flush()
        finally:
            self._discard()
        return False

    # -- meta staging / reads ----------------------------------------------

    def fetch_raw(self, names: Sequence[str]) -> Dict[str, Optional[bytes]]:
        """Raw bytes for each name: staged > observed > ONE grouped read."""
        store = self.store
        out: Dict[str, Optional[bytes]] = {}
        missing: List[str] = []
        for name in names:
            if name in self._staged_refs:
                out[name] = self._staged_refs[name]
            elif name in self._staged:
                out[name] = self._staged[name]
            elif name in self._cache:
                out[name] = self._cache[name]
            elif name not in missing:
                missing.append(name)
        if missing:
            store.stats.meta_requests += 1
            raws = store.backend.get_many(
                [store.META + n for n in missing])
            for name, raw in zip(missing, raws):
                self._cache[name] = raw
                out[name] = raw
        return out

    def stage_meta(self, name: str, data: bytes) -> None:
        store = self.store
        store.stats.meta_batched += 1
        if name.startswith(self._REFS) or name in self._strict:
            if name not in self._expected:
                # CAS pre-image: what this scope observed (absence included);
                # never-observed refs get one grouped read at flush time.
                self._expected[name] = self._cache.get(name, _UNOBSERVED)
            self._staged_refs[name] = data
        else:
            self._staged[name] = data

    def require_cas(self, name: str, merge: Optional[Callable] = None,
                    after_refs: bool = False) -> None:
        """See :meth:`ObjectStore.require_meta_cas`.  Safe to call before
        or after the key was staged; a value already staged on the
        unconditional path is promoted into the CAS pass."""
        self._strict.add(name)
        if merge is not None:
            self._merge[name] = merge
        if after_refs:
            self._cas_after.add(name)
        if name in self._staged:
            data = self._staged.pop(name)
            if name not in self._expected:
                self._expected[name] = self._cache.get(name, _UNOBSERVED)
            self._staged_refs[name] = data

    def forget(self, name: str) -> None:
        """A write-through delete ran: drop staged state, remember absence."""
        self._staged.pop(name, None)
        self._staged_refs.pop(name, None)
        self._expected.pop(name, None)
        self._strict.discard(name)
        self._cas_after.discard(name)
        self._merge.pop(name, None)
        self._cache[name] = None

    def merge_listing(self, prefix: str, names: Iterable[str]) -> List[str]:
        out = set(names)
        for table in (self._staged, self._staged_refs):
            out.update(n for n in table if n.startswith(prefix))
        return sorted(out)

    # -- blob staging --------------------------------------------------------

    def stage_chunk(self, digest: str, raw: bytes) -> None:
        self._chunk_stages += 1
        if digest not in self._chunks:
            self._chunks[digest] = None
            self._staged_bytes += len(raw)
            self.store._pending_add(self.store._pending_chunks, digest, raw)

    def stage_manifest(self, digest: str, raw: bytes) -> None:
        if digest not in self._manifests:
            self._manifests[digest] = None
            self.store._pending_add(
                self.store._pending_manifests, digest, raw)

    def stage_blob(self, data: bytes) -> BlobRef:
        store = self.store
        if len(data) <= store.chunk_size:
            digest = sha256_hex(data)
            self.stage_chunk(digest, data)
            ref = BlobRef(digest, len(data), 1)
        else:
            chunk_digests: List[str] = []
            for off in range(0, len(data), store.chunk_size):
                piece = data[off:off + store.chunk_size]
                digest = sha256_hex(piece)
                chunk_digests.append(digest)
                self.stage_chunk(digest, piece)
            manifest = store._blob_manifest(chunk_digests, len(data))
            top = sha256_hex(manifest)
            self.stage_manifest(top, manifest)
            ref = BlobRef(top, len(data), len(chunk_digests))
        self.maybe_spill()
        return ref

    def maybe_spill(self) -> None:
        if self._staged_bytes >= self._SPILL_BYTES:
            self._flush_blobs()

    # -- flush ---------------------------------------------------------------

    def _flush_blobs(self) -> None:
        """One grouped existence probe + one grouped write for every blob
        staged so far, then release the pending bytes."""
        store = self.store
        if not self._chunks and not self._manifests:
            return
        with store._pending_lock:
            chunk_items = [(d, store._pending_chunks[d][0])
                           for d in self._chunks
                           if d in store._pending_chunks]
            man_items = [(d, store._pending_manifests[d][0])
                         for d in self._manifests
                         if d in store._pending_manifests]
        keys = [store._CHUNK + d for d, _ in chunk_items]
        keys.extend(store._BLOBMAN + d for d, _ in man_items)
        present = store.backend.exists_many(keys) if keys else []
        store.stats.exists_probes += 1
        n_chunks = len(chunk_items)
        missing = [(d, raw) for (d, raw), hit
                   in zip(chunk_items, present[:n_chunks]) if not hit]
        encoded = store._encode_chunks([raw for _, raw in missing])
        items: List[Tuple[str, bytes]] = [
            (store._CHUNK + d, enc)
            for (d, _), enc in zip(missing, encoded)]
        items.extend(
            (store._BLOBMAN + d, raw)
            for (d, raw), hit in zip(man_items, present[n_chunks:])
            if not hit)
        if items:
            store.backend.put_many(items)
        n_written = len(missing)
        store.stats.puts += n_written
        store.stats.chunks_written += n_written
        store.stats.bytes_stored += sum(len(enc) for enc in encoded)
        dups = self._chunk_stages - n_written
        store.stats.chunks_deduped += dups
        store.stats.dedup_hits += dups
        store._pending_release(self._chunks, self._manifests)
        self._chunks = OrderedDict()
        self._manifests = OrderedDict()
        self._chunk_stages = 0
        self._staged_bytes = 0

    def _flush(self) -> None:
        store = self.store
        store._killpoint("flush:pre_blobs")
        # 1. Data blobs land first — meta must never name missing content.
        self._flush_blobs()
        store._killpoint("flush:post_blobs")
        # 2. Write-once + non-ref mutable keys: ONE grouped unconditional
        #    put (same lost-update semantics those keys have unbatched).
        if self._staged:
            store.stats.meta_requests += 1
            store.backend.put_many(
                [(store.META + n, raw) for n, raw in self._staged.items()])
        store._killpoint("flush:post_meta")
        # 3. The CAS pass.  Never-observed pre-images resolve with one
        #    grouped read first; observed pre-images are deliberately NOT
        #    refreshed — a stale one is exactly how an interleaved writer
        #    shows up as a counted ``ref_cas_retries`` conflict.  Order:
        #    strict non-ref keys (commit/record indexes — GC roots, so
        #    they must land before anything points at them) → mutable
        #    ``refs/`` → after-ref pointers (e.g. the derivation cache
        #    slot, which must never precede the head it names).  Stable
        #    within each group (insertion order).
        unknown = [n for n in self._staged_refs
                   if self._expected.get(n, _UNOBSERVED) is _UNOBSERVED]
        if unknown:
            store.stats.meta_requests += 1
            for name, raw in zip(unknown, store.backend.get_many(
                    [store.META + n for n in unknown])):
                self._expected[name] = raw
        order = sorted((n for n in self._staged_refs
                        if n not in self._cas_after),
                       key=lambda n: n.startswith(self._REFS))
        order.extend(n for n in self._staged_refs if n in self._cas_after)
        for name in order:
            store._killpoint(f"flush:pre_ref:{name}")
            self._cas_put(name, self._expected[name], self._staged_refs[name])
            store._killpoint(f"flush:post_ref:{name}")
        store._killpoint("flush:post_refs")

    def _cas_put(self, name: str, expected, data: bytes) -> None:
        store = self.store
        key = store.META + name
        strict = name in self._strict
        merge = self._merge.get(name)
        first_expected = expected
        current = None
        attempts = 0
        for _ in range(self._CAS_MAX_RETRIES + 1):
            attempts += 1
            store.stats.meta_requests += 1
            if store.backend.put_if(key, expected, data):
                return
            store.stats.meta_requests += 1
            current = store.backend.get_many([key])[0]
            if current == data:
                # Already landed — our own replayed put_if whose first
                # response was lost, or an identical concurrent write.
                return
            store.stats.ref_cas_retries += 1
            if merge is not None:
                # Conflict self-heals: re-apply this batch's mutation onto
                # the winner's value (the key's registered merge) instead
                # of clobbering it or aborting — zero lost updates on
                # append-shaped keys.
                data = store._meta_bytes(merge(_decode_meta(current)))
                expected = current
                continue
            if strict:
                raise CommitConflictError(
                    name, expected=_decode_meta(expected),
                    current=_decode_meta(current), attempts=attempts)
            expected = current      # last-writer-wins, now with a re-read
        raise CommitConflictError(
            name, expected=_decode_meta(first_expected),
            current=_decode_meta(current), attempts=attempts)

    def _discard(self) -> None:
        self.store._pending_release(self._chunks, self._manifests)
        self._chunks.clear()
        self._manifests.clear()
        self._chunk_stages = 0
        self._staged_bytes = 0
        self._staged.clear()
        self._staged_refs.clear()
        self._cache.clear()
        self._expected.clear()
        self._strict.clear()
        self._cas_after.clear()
        self._merge.clear()

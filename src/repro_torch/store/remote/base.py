"""RemoteBackend: raw KV primitives -> scheduled, counted capabilities.

A remote backend author implements five ``_raw_*`` primitives (one
physical request each); this base class turns them into the full
:class:`repro_torch.core.store.StorageBackend` contract:

- single-key calls run through :meth:`GroupedScheduler.call` (retry +
  exponential backoff on transient failures, no hedging — a lone caller
  is already blocked on that one answer);
- grouped capabilities (``exists_many`` / ``get_many`` / ``put_many`` /
  ``delete_many``) run through :meth:`GroupedScheduler.map` — bounded
  concurrent windows, dispatcher-scheduled backoff, request hedging.
  Side-effecting batches drain losing hedge copies before returning so a
  late duplicate PUT can never race a subsequent delete.

Every *physical* request (including retries and hedge duplicates) bumps
``remote_requests``; the scheduler reports ``retries`` /
``hedges_issued`` / ``hedge_wins`` through the same sink.  When an
:class:`~repro_torch.core.store.ObjectStore` wraps the backend it calls
:meth:`bind_store_stats` so the counters land in its ``StoreStats``;
binding *replaces* any previous sink (many short-lived stores over one
backend must not accumulate sinks), and the counters stay readable on
the backend itself via :attr:`remote_counters` for standalone use.
"""

from __future__ import annotations

import threading
from abc import abstractmethod
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ...core.store import NotFoundError, StorageBackend
from .scheduler import GroupedScheduler

__all__ = ["RemoteBackend"]

#: Counter names a remote backend can emit.
_COUNTERS = ("remote_requests", "retries", "hedges_issued", "hedge_wins")


class RemoteBackend(StorageBackend):
    """Base class for high-latency backends driven by a GroupedScheduler."""

    def __init__(self, scheduler: Optional[GroupedScheduler] = None,
                 **scheduler_kwargs) -> None:
        if scheduler is not None and scheduler_kwargs:
            raise ValueError("pass a scheduler or scheduler kwargs, not both")
        self._counter_lock = threading.Lock()
        self._counters: Dict[str, int] = {name: 0 for name in _COUNTERS}
        self._stats_sink = None  # bound StoreStats, if any
        if scheduler is None:
            scheduler = GroupedScheduler(bump=self._bump, **scheduler_kwargs)
        else:
            scheduler._bump = self._bump
        self.scheduler = scheduler

    # -- stats --------------------------------------------------------------

    def bind_store_stats(self, stats) -> None:
        """Route counters into ``stats`` (a ``StoreStats``).  Replaces any
        previously bound sink."""
        self._stats_sink = stats

    def _bump(self, name: str, k: int = 1) -> None:
        with self._counter_lock:
            self._counters[name] = self._counters.get(name, 0) + k
            sink = self._stats_sink
            if sink is not None:
                setattr(sink, name, getattr(sink, name, 0) + k)

    @property
    def remote_counters(self) -> Dict[str, int]:
        with self._counter_lock:
            return dict(self._counters)

    # -- raw primitives: exactly one physical request each ------------------

    @abstractmethod
    def _raw_put(self, key: str, data: bytes) -> None: ...

    @abstractmethod
    def _raw_get(self, key: str) -> Optional[bytes]:
        """Return the value, or ``None`` when the key is absent."""

    @abstractmethod
    def _raw_exists(self, key: str) -> bool: ...

    @abstractmethod
    def _raw_delete(self, key: str) -> None:
        """Delete; a missing key is a no-op (idempotent for retry replay)."""

    @abstractmethod
    def _raw_list_keys(self, prefix: str = "") -> List[str]: ...

    # -- counted per-request wrappers (each invocation = 1 request) ---------

    def _req_put(self, kv: Tuple[str, bytes]) -> None:
        self._bump("remote_requests")
        self._raw_put(kv[0], kv[1])

    def _req_get(self, key: str) -> Optional[bytes]:
        self._bump("remote_requests")
        return self._raw_get(key)

    def _req_exists(self, key: str) -> bool:
        self._bump("remote_requests")
        return self._raw_exists(key)

    def _req_delete(self, key: str) -> None:
        self._bump("remote_requests")
        self._raw_delete(key)

    def _req_list(self, prefix: str) -> List[str]:
        self._bump("remote_requests")
        return self._raw_list_keys(prefix)

    # -- StorageBackend contract --------------------------------------------

    def put(self, key: str, data: bytes) -> None:
        self.scheduler.call(self._req_put, (key, data))

    def get(self, key: str) -> bytes:
        raw = self.scheduler.call(self._req_get, key)
        if raw is None:
            raise NotFoundError(key)
        return raw

    def exists(self, key: str) -> bool:
        return self.scheduler.call(self._req_exists, key)

    def delete(self, key: str) -> None:
        self.scheduler.call(self._req_delete, key)

    def list_keys(self, prefix: str = "") -> Iterator[str]:
        return iter(self.scheduler.call(self._req_list, prefix))

    def put_if(self, key: str, expected: Optional[bytes],
               data: bytes) -> bool:
        # Native conditional write when the transport has one (a subclass
        # defines ``_raw_put_if``: one physical request, e.g. HTTP
        # If-Match); otherwise the base-class get-compare-put fallback.
        # Retries replay the conditional atomically either way — a lost
        # response makes the retry return False, which the store's CAS
        # loop resolves by re-reading and seeing its own value landed.
        raw = getattr(self, "_raw_put_if", None)
        if raw is None:
            return super().put_if(key, expected, data)

        def req(_item) -> bool:
            self._bump("remote_requests")
            return raw(key, expected, data)

        return self.scheduler.call(req, None)

    # -- grouped capabilities: pipelined, hedged, retried -------------------

    def exists_many(self, keys: Sequence[str]) -> List[bool]:
        return self.scheduler.map(self._req_exists, list(keys))

    def get_many(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        return self.scheduler.map(self._req_get, list(keys))

    def put_many(self, items: Sequence[Tuple[str, bytes]]) -> None:
        self.scheduler.map(self._req_put, list(items), drain=True)

    def delete_many(self, keys: Sequence[str]) -> None:
        self.scheduler.map(self._req_delete, list(keys), drain=True)

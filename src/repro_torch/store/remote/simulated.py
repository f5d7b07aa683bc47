"""SimulatedRemoteBackend: any backend + configurable network physics.

The testbed for the whole remote subsystem: wraps an in-process backend
(Memory/File) and charges every physical request a configurable cost —
round-trip latency, payload transfer time against a bandwidth cap,
uniform jitter, deterministic latency tails, and injected transient
faults.  Because the wrapped backend is real, every correctness
property of the store holds under simulation; only the clock changes.

Fault/tail injection is *counter-based* (``fault_every`` /
``tail_every``: every Nth physical request) rather than probabilistic:
under a concurrent window the thread arrival order would make seeded-rng
draws nondeterministic, and the tests/benches want exact, reproducible
fault placement.  A seeded ``fault_rate`` is still available for chaos
runs where exact placement does not matter.

``fault_mode`` decides whether the fault fires *before* the side effect
(request never reached the server) or *after* it (server acted, response
lost) — the latter is what makes retry replay exercise the idempotency
contract: the retried PUT/DELETE re-applies an operation that already
happened.

``grouped=False`` turns the backend into the naive baseline: grouped
capabilities degrade to a sequential per-request loop (still retried,
never pipelined or hedged) — the thing benchmarks compare against.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Sequence, Tuple

from ...core.store import NotFoundError, StorageBackend
from .base import RemoteBackend
from .scheduler import TransientError

__all__ = ["SimulatedRemoteBackend"]


class SimulatedRemoteBackend(RemoteBackend):
    """Wrap ``inner`` with per-request RTT, bandwidth, jitter and faults.

    Parameters
    ----------
    rtt:
        Fixed per-request latency floor, seconds.
    bandwidth:
        Payload bytes/second; ``None`` = infinite (payload is free).
    jitter:
        Adds ``uniform(0, jitter)`` seconds per request (seeded).
    tail_every / tail:
        Every ``tail_every``-th physical request takes ``tail`` extra
        seconds — a deterministic straggler for hedging to beat.
    fault_every / fault_rate / fault_mode:
        Inject :class:`TransientError` every Nth request and/or with a
        seeded probability, before (``"before"``) or after (``"after"``,
        i.e. lost response) the side effect.
    fault_ops:
        Restrict fault arming to specific physical operations (subset of
        ``put / get / exists / delete / list / put_if``); empty = every
        request is eligible (the original behaviour).  The counter
        behind ``fault_every`` then ticks only on eligible requests, so
        e.g. ``fault_ops=("put_if",), fault_mode="after"`` deterministically
        loses every Nth conditional-write *response* — the CAS replay
        case the multi-writer commit path must absorb.
    grouped:
        ``False`` degrades grouped capabilities to sequential loops —
        the naive baseline for benchmarks.
    """

    _FAULT_OPS = ("put", "get", "exists", "delete", "list", "put_if")

    def __init__(
        self,
        inner: StorageBackend,
        rtt: float = 0.05,
        bandwidth: Optional[float] = None,
        jitter: float = 0.0,
        tail_every: int = 0,
        tail: float = 0.0,
        fault_every: int = 0,
        fault_rate: float = 0.0,
        fault_mode: str = "before",
        fault_ops: Sequence[str] = (),
        seed: int = 0,
        grouped: bool = True,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)
        if fault_mode not in ("before", "after"):
            raise ValueError("fault_mode must be 'before' or 'after'")
        unknown = set(fault_ops) - set(self._FAULT_OPS)
        if unknown:
            raise ValueError(f"unknown fault_ops: {sorted(unknown)}")
        self.inner = inner
        self.rtt = rtt
        self.bandwidth = bandwidth
        self.jitter = jitter
        self.tail_every = tail_every
        self.tail = tail
        self.fault_every = fault_every
        self.fault_rate = fault_rate
        self.fault_mode = fault_mode
        self.fault_ops = tuple(fault_ops)
        self.grouped = grouped
        self._rng = random.Random(seed)
        self._seq_lock = threading.Lock()
        self._seq = 0
        # Separate tick for fault placement: with ``fault_ops`` set only
        # eligible requests advance it, so "every Nth" means every Nth
        # *conditional write*, not every Nth request of any kind.  With no
        # restriction it advances in lockstep with ``_seq``, preserving
        # the original deterministic placement.
        self._fault_seq = 0

    # -- network physics ----------------------------------------------------

    def _plan_request(self, op: str) -> Tuple[float, bool]:
        """Return (extra latency beyond rtt, fault?) for the next request."""
        eligible = not self.fault_ops or op in self.fault_ops
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
            extra = self._rng.uniform(0.0, self.jitter) if self.jitter else 0.0
            fault = False
            if eligible:
                self._fault_seq += 1
                fault = (bool(self.fault_every)
                         and self._fault_seq % self.fault_every == 0)
                if not fault and self.fault_rate:
                    fault = self._rng.random() < self.fault_rate
        if self.tail_every and seq % self.tail_every == 0:
            extra += self.tail
        return extra, fault

    def _transfer(self, nbytes: int) -> float:
        if not self.bandwidth or nbytes <= 0:
            return 0.0
        return nbytes / self.bandwidth

    def _simulate(self, op_name: str, op, send_bytes: int = 0):
        """Charge the wire cost around ``op()``; maybe inject a fault."""
        extra, fault = self._plan_request(op_name)
        time.sleep(self.rtt + extra + self._transfer(send_bytes))
        if fault and self.fault_mode == "before":
            raise TransientError("injected fault (request dropped)")
        value = op()
        if fault:  # mode == "after": the server acted, the response is lost
            raise TransientError("injected fault (response lost)")
        if isinstance(value, bytes):
            time.sleep(self._transfer(len(value)))
        return value

    # -- raw primitives -----------------------------------------------------

    def _raw_put(self, key: str, data: bytes) -> None:
        self._simulate("put", lambda: self.inner.put(key, data),
                       send_bytes=len(data))

    def _raw_get(self, key: str) -> Optional[bytes]:
        def op() -> Optional[bytes]:
            try:
                return self.inner.get(key)
            except NotFoundError:
                return None
        return self._simulate("get", op)

    def _raw_exists(self, key: str) -> bool:
        return self._simulate("exists", lambda: self.inner.exists(key))

    def _raw_delete(self, key: str) -> None:
        def op() -> None:
            try:
                self.inner.delete(key)
            except NotFoundError:
                pass  # absence-tolerant, like every real object store
        self._simulate("delete", op)

    def _raw_list_keys(self, prefix: str = "") -> List[str]:
        return self._simulate("list",
                              lambda: list(self.inner.list_keys(prefix)))

    def _raw_put_if(self, key: str, expected: Optional[bytes],
                    data: bytes) -> bool:
        # Native conditional write: compare-and-swap runs inside the inner
        # backend (one physical request), so a "response lost" fault
        # leaves the swap applied — exactly the replay case the store's
        # CAS loop must absorb.
        return self._simulate("put_if",
                              lambda: self.inner.put_if(key, expected, data),
                              send_bytes=len(data))

    # -- naive-mode degradation --------------------------------------------

    def exists_many(self, keys: Sequence[str]) -> List[bool]:
        if not self.grouped:
            return [self.exists(k) for k in keys]
        return super().exists_many(keys)

    def get_many(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        if not self.grouped:
            return [self.scheduler.call(self._req_get, k) for k in keys]
        return super().get_many(keys)

    def put_many(self, items: Sequence[Tuple[str, bytes]]) -> None:
        if not self.grouped:
            for key, data in items:
                self.put(key, data)
            return
        super().put_many(items)

    def delete_many(self, keys: Sequence[str]) -> None:
        if not self.grouped:
            for k in keys:
                self.delete(k)
            return
        super().delete_many(keys)

"""Grouped-I/O scheduler for high-latency backends.

An S3/GCS-shaped object store has two defining properties the in-process
backends never exposed: a large per-request latency floor (tens of
milliseconds) and effectively unbounded parallelism.  The right shape for
grouped operations against such a store is therefore *pipelined windows of
concurrent single-key requests*, not a loop:

- **Bounded concurrency**: up to ``max_in_flight`` requests run at once;
  a batch of N keys costs ~``ceil(N / window)`` round trips of wall time
  instead of N.
- **Retry + exponential backoff**: transient failures
  (:class:`TransientError`, dropped connections, timeouts) are retried
  with exponential backoff.  Backoff waits are scheduled by the
  dispatcher, not slept inside a worker, so a backing-off request never
  occupies a window slot.
- **Request hedging** (tail-latency control): once enough latency samples
  exist, any in-flight request older than ``hedge_factor`` times the
  ``hedge_quantile`` latency gets a duplicate issued; the first response
  wins and the loser's response is discarded.  Because every operation
  the store issues is idempotent (content-addressed puts, absence-
  tolerant deletes, reads), duplicates are always safe.

The scheduler is deliberately transport-agnostic: it runs *any*
``fn(item)`` over a sequence of items.  :class:`~repro_torch.store.remote.base.
RemoteBackend` uses it to turn the five raw KV primitives into the
grouped capabilities ``ObjectStore`` consumes.

Counters (``remote_requests`` is counted by the backend per physical
request; this module counts ``hedges_issued`` / ``hedge_wins`` /
``retries``) are delivered through a ``bump(name)`` callback so they can
land directly in a bound :class:`repro_torch.core.store.StoreStats`.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = ["TransientError", "GroupedScheduler"]


class TransientError(RuntimeError):
    """A request failed in a way that is expected to heal on retry
    (connection reset, 5xx, injected fault, lost response)."""


# One shared worker pool for every scheduler in the process (mirrors the
# hashing pool in ``core.store``): windows are enforced per-``map`` call by
# the dispatcher, so the pool only needs to be "big enough"; requests are
# latency-bound sleeps/socket waits, so threads are cheap.
_POOL_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None
_POOL_WORKERS = max(64, (os.cpu_count() or 4) * 8)

_UNSET = object()


def _io_pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=_POOL_WORKERS,
                                       thread_name_prefix="repro-remote")
        return _POOL


def _drop_pool_after_fork() -> None:
    global _POOL
    _POOL = None


if hasattr(os, "register_at_fork"):  # pragma: no branch - POSIX
    os.register_at_fork(after_in_child=_drop_pool_after_fork)


class GroupedScheduler:
    """Runs ``fn`` over item batches in bounded, hedged, retried windows."""

    #: Exception types worth retrying.  Everything else propagates.
    RETRYABLE = (TransientError, ConnectionError, TimeoutError)

    def __init__(
        self,
        max_in_flight: int = 32,
        retries: int = 3,
        backoff_base: float = 0.05,
        backoff_mult: float = 4.0,
        backoff_max: float = 2.0,
        hedge: bool = True,
        hedge_quantile: float = 0.95,
        hedge_factor: float = 1.5,
        hedge_min_samples: int = 8,
        poll_interval: float = 0.005,
        bump: Optional[Callable[[str], None]] = None,
    ) -> None:
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.max_in_flight = max_in_flight
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_mult = backoff_mult
        self.backoff_max = backoff_max
        self.hedge = hedge
        self.hedge_quantile = hedge_quantile
        self.hedge_factor = hedge_factor
        self.hedge_min_samples = hedge_min_samples
        self.poll_interval = poll_interval
        self._bump = bump if bump is not None else (lambda name, k=1: None)
        # Recent successful-request latencies (seconds), shared across
        # calls so hedging thresholds survive between batches.
        self._lat_lock = threading.Lock()
        self._latencies: List[float] = []
        self._LAT_CAP = 512

    # -- latency samples ----------------------------------------------------

    def _record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self._latencies.append(seconds)
            if len(self._latencies) > self._LAT_CAP:
                del self._latencies[: self._LAT_CAP // 2]

    def _hedge_threshold(self) -> Optional[float]:
        """Age beyond which an in-flight request gets a duplicate, or
        ``None`` while there are not enough samples to judge."""
        with self._lat_lock:
            if len(self._latencies) < self.hedge_min_samples:
                return None
            ordered = sorted(self._latencies)
        q = ordered[min(len(ordered) - 1,
                        int(len(ordered) * self.hedge_quantile))]
        # Floor: never hedge on scheduling noise around the poll interval.
        return max(q * self.hedge_factor, 4 * self.poll_interval)

    def _backoff(self, failure_count: int) -> float:
        return min(self.backoff_max,
                   self.backoff_base * self.backoff_mult ** (failure_count - 1))

    # -- single calls (retry only; used for ungrouped primitives) -----------

    def call(self, fn: Callable, item):
        """Run one request inline with retry + backoff (no hedging — a
        single caller is already blocked on this one answer)."""
        failures = 0
        while True:
            try:
                return fn(item)
            except self.RETRYABLE:
                failures += 1
                if failures > self.retries:
                    raise
                self._bump("retries")
                time.sleep(self._backoff(failures))

    # -- grouped calls ------------------------------------------------------

    def map(self, fn: Callable, items: Sequence, drain: bool = False) -> List:
        """Run ``fn`` over every item; returns results in item order.

        Work is dispatched into the shared pool up to ``max_in_flight`` at
        once (hedge duplicates get a little extra headroom so a saturated
        window can still protect its own tail).  Transient failures are
        re-queued with exponential backoff without occupying a slot; the
        first non-transient failure (or an item exhausting its retries)
        aborts the batch.

        ``drain=True`` additionally waits for *losing* hedge copies to
        finish before returning.  Read batches skip that wait (a late GET
        response is simply discarded), but side-effecting batches must
        drain: a hedged PUT's loser landing after the caller moved on
        could race a subsequent delete of the same key.
        """
        items = list(items)
        n = len(items)
        if n == 0:
            return []
        if n == 1:
            return [self.call(fn, items[0])]

        cv = threading.Condition()
        results = [_UNSET] * n
        done = [False] * n          # result set OR permanently failed
        inflight = [0] * n          # copies of this item currently running
        hedged = [False] * n
        failures = [0] * n          # transient failures so far
        errors: List[Optional[BaseException]] = [None] * n
        started_at = [0.0] * n      # latest primary launch (hedge clock)
        retry_q: List[Tuple[float, int]] = []   # (due time, idx)
        state = {"done": 0, "inflight": 0, "fatal": None}
        hedge_slack = max(1, self.max_in_flight // 4)

        def finish(idx: int) -> None:
            # caller holds cv
            if not done[idx]:
                done[idx] = True
                state["done"] += 1

        def run_copy(idx: int, is_hedge: bool) -> None:
            t0 = time.monotonic()
            try:
                value = fn(items[idx])
            except BaseException as exc:  # noqa: BLE001 - dispatched below
                with cv:
                    inflight[idx] -= 1
                    state["inflight"] -= 1
                    if not done[idx]:
                        if isinstance(exc, self.RETRYABLE):
                            failures[idx] += 1
                            errors[idx] = exc
                            if failures[idx] <= self.retries:
                                self._bump("retries")
                                heapq.heappush(
                                    retry_q,
                                    (time.monotonic()
                                     + self._backoff(failures[idx]), idx))
                            elif inflight[idx] == 0:
                                finish(idx)   # exhausted; error kept
                        else:
                            errors[idx] = exc
                            if state["fatal"] is None:
                                state["fatal"] = exc
                            finish(idx)
                    cv.notify()
                return
            latency = time.monotonic() - t0
            self._record_latency(latency)
            with cv:
                inflight[idx] -= 1
                state["inflight"] -= 1
                if not done[idx]:
                    results[idx] = value
                    finish(idx)
                    if is_hedge:
                        self._bump("hedge_wins")
                cv.notify()

        pool = _io_pool()

        def launch(idx: int, is_hedge: bool) -> None:
            # caller holds cv
            inflight[idx] += 1
            state["inflight"] += 1
            if is_hedge:
                hedged[idx] = True
                self._bump("hedges_issued")
            else:
                started_at[idx] = time.monotonic()
            pool.submit(run_copy, idx, is_hedge)

        next_idx = 0
        with cv:
            # Exit as soon as every item is resolved (or a fatal error
            # surfaced) — NOT when in-flight copies drain (unless asked):
            # a hedged item's losing copy may still be running, and
            # waiting for losers would forfeit exactly the tail latency
            # hedging bought.  Late loser responses are discarded by the
            # done[] check.
            def _finished() -> bool:
                if state["fatal"] is None and state["done"] < n:
                    return False
                return not drain or state["inflight"] == 0

            while not _finished():
                now = time.monotonic()
                # 1. Promote retries whose backoff elapsed.
                while retry_q and retry_q[0][0] <= now:
                    _, idx = heapq.heappop(retry_q)
                    if not done[idx] and state["fatal"] is None:
                        launch(idx, is_hedge=False)
                # 2. Fill the window with fresh items.
                while (state["fatal"] is None and next_idx < n
                       and state["inflight"] < self.max_in_flight):
                    idx = next_idx
                    next_idx += 1
                    if not done[idx]:
                        launch(idx, is_hedge=False)
                # 3. Hedge the stragglers (duplicate the slowest in-flight
                #    requests past the latency-quantile threshold).
                if self.hedge and state["fatal"] is None:
                    thr = self._hedge_threshold()
                    if thr is not None:
                        cap = self.max_in_flight + hedge_slack
                        for idx in range(min(next_idx, n)):
                            if state["inflight"] >= cap:
                                break
                            if (inflight[idx] > 0 and not hedged[idx]
                                    and not done[idx]
                                    and now - started_at[idx] > thr):
                                launch(idx, is_hedge=True)
                if _finished():
                    break
                # Wake early on any completion; poll for hedges/backoffs.
                cv.wait(self.poll_interval)

        if state["fatal"] is not None:
            raise state["fatal"]
        for idx in range(n):
            if results[idx] is _UNSET:
                err = errors[idx]
                if err is not None:
                    raise err
                raise RuntimeError(  # pragma: no cover - invariant
                    f"scheduler lost item {idx}")
        return results

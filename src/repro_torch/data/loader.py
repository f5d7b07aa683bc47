"""Sharded, deterministic, resumable loader: platform checkout -> device
batches.

Port of ``repro.data.loader``.  :class:`ShardedSnapshotLoader` is the
reference's, line for line (its determinism contract is the checkpoint's),
with ``device_batch`` laying a batch onto a DeviceMesh as DTensors and with
``wait_fraction`` counting the consumer's time as its docstring says (see
``__iter__``); :class:`DeviceFeed` is rewritten for torch.

Feed it a materialized :class:`~repro_torch.core.dataset.Snapshot` or — the
preferred, allocation-free path — a lazy
:class:`~repro_torch.core.dataset.CheckoutPlan` straight from
``Platform.open(...).dataset(name).plan(where=...)``: the loader only needs
the Snapshot-like read surface, which a plan streams from the manifest
without materializing a snapshot or registering lineage for every restart.

This is the handoff between the paper's data plane and the trainer:

- **Deterministic order**: the batch stream is a pure function of
  (snapshot digest, epoch, seed, step) — the property that makes
  checkpoint/restart exact (no skipped/duplicated data after preemption).
  Two shuffle modes share that contract:

  * ``shuffle="global"`` — the legacy full permutation: every record id is
    hashed with (seed, epoch) and the whole epoch is sorted at once.
    Exact, but O(N) resident ids and an O(N log N) sort per epoch — the
    measurable baseline, and the default for small snapshots.
  * ``shuffle="page_window"`` — page-window streaming: the commit's
    manifest *pages* are deterministically permuted per (epoch, seed),
    consecutive permuted pages are grouped into windows of
    ``window_pages`` pages, and records are shuffled (same seeded-hash
    sort) *within* each window.  The full permutation is never
    materialized: peak resident ids are O(window_pages · page_size)
    regardless of snapshot size, and a window with ``window_pages >=
    n_pages`` degenerates to exactly the global order.  Requires the
    page-granular feed surface (``page_count`` / ``page_sizes`` /
    ``page_entries`` / ``read_entries`` / ``pages_digest``), which
    CheckoutPlan serves straight from the page directory for pure plans.

- **Sharded**: shard ``i`` of ``n`` reads records where
  ``order_index % n == i`` — in a multi-host job each host feeds only its
  slice; single-process here, the whole batch goes to one device.
- **Resumable**: ``state()`` is a tiny dict (snapshot digest, shuffle mode,
  epoch, step, window cursor) stored inside checkpoints; ``restore()``
  seeks exactly there — in page-window mode the seek costs O(window), not
  a replay of the epoch.
- **Pipelined host stage**: iteration decodes/stacks batches on a small
  worker pool feeding a bounded in-order queue; ``stats()`` reports
  ``wait_fraction`` — the share of consumer wall time spent blocked on the
  queue — so a feed that can't keep a device busy is measurable, not a
  mystery.  A stuck shard surfaces as a descriptive ``TimeoutError``
  (snapshot digest, shard, epoch, step), never a raw ``queue.Empty``.
- **Double-buffered device transfer**: :class:`DeviceFeed` wraps the
  iterator with a depth-2 device-side buffer — the next batch's copy from
  pinned host memory is issued on a side stream while the current
  ``train_step`` runs, so the step loop never blocks on host work.
"""

from __future__ import annotations

import bisect
import collections
import concurrent.futures as cf
import hashlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.dataset import CheckoutPlan, Snapshot
from .components import decode_packed

__all__ = ["ShardedSnapshotLoader", "DeviceFeed", "LoaderState"]

SnapshotLike = Union[Snapshot, CheckoutPlan]

LoaderState = Dict[str, Any]

# Feed-surface methods a snapshot must expose for page-window mode.
_PAGE_SURFACE = ("page_count", "page_sizes", "read_pages", "read_entries",
                 "pages_digest", "count")


def _order(record_ids: List[str], epoch: int, seed: int) -> List[str]:
    """Reference epoch ordering — records sorted by seeded per-record hash.

    Kept as the executable spec: :func:`_order_fast` must stay bit-identical
    to this (the golden determinism suite pins it), or existing checkpoints
    would silently restore onto different batch streams.
    """
    def key(rid: str) -> str:
        return hashlib.sha256(f"{seed}:{epoch}:{rid}".encode()).hexdigest()

    return sorted(record_ids, key=key)


def _order_fast(record_ids: List[str], epoch: int, seed: int) -> List[str]:
    """Same permutation as :func:`_order`, computed vectorized.

    Hashes every id in one pass (the sha256 per record is load-bearing —
    it IS the ordering key), then argsorts the packed digest matrix with
    ``np.lexsort``.  Sorting by raw digest bytes equals sorting by
    ``hexdigest()`` because hex encoding is monotone bytewise; lexsort over
    the four big-endian u64 columns equals bytewise comparison of the
    32-byte digests, and both sorts are stable, so ties (impossible for
    distinct ids in practice) break identically.
    """
    if not record_ids:
        return []
    prefix = f"{seed}:{epoch}:".encode()
    sha = hashlib.sha256
    digests = b"".join(sha(prefix + rid.encode()).digest()
                       for rid in record_ids)
    cols = np.frombuffer(digests, dtype=">u8").reshape(-1, 4)
    perm = np.lexsort((cols[:, 3], cols[:, 2], cols[:, 1], cols[:, 0]))
    return [record_ids[i] for i in perm]


def _page_perm(n_pages: int, epoch: int, seed: int) -> List[int]:
    """Deterministic page permutation — same seeded-hash sort as
    :func:`_order`, keyed on the page's position in the directory (pages
    are content-addressed, so position is stable for a fixed snapshot)."""
    sha = hashlib.sha256
    prefix = f"{seed}:{epoch}:page:".encode()
    return sorted(range(n_pages),
                  key=lambda pi: sha(prefix + str(pi).encode()).digest())


class ShardedSnapshotLoader:
    # How many (epoch, group) windows stay resident: the active window, its
    # neighbor (a batch may straddle a group boundary), and headroom for
    # decode workers prefetching the next batch.  This bound IS the
    # page-window memory contract: peak resident ids <=
    # _GROUP_CACHE_CAP * window_pages * page_size.
    _GROUP_CACHE_CAP = 3

    def __init__(
        self,
        snapshot: SnapshotLike,
        batch_size: int,
        seq_len: int,
        shard_id: int = 0,
        n_shards: int = 1,
        seed: int = 0,
        prefetch: int = 2,
        timeout_s: float = 60.0,
        cache_epoch_orders: bool = True,
        shuffle: str = "auto",
        window_pages: int = 8,
        decode_workers: int = 2,
        auto_page_window_min: int = 100_000,
    ):
        assert batch_size % n_shards == 0
        if shuffle not in ("auto", "global", "page_window"):
            raise ValueError(f"unknown shuffle mode {shuffle!r}")
        self.snapshot = snapshot
        self.batch = batch_size
        self.local_batch = batch_size // n_shards
        self.seq_len = seq_len
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.seed = seed
        self.prefetch = prefetch
        self.timeout_s = timeout_s
        self.window_pages = int(window_pages)
        self.decode_workers = max(1, int(decode_workers))
        self.epoch = 0
        self.step = 0
        # ``cache_epoch_orders=False`` restores the pre-cache behaviour
        # (recompute the permutation every batch) — benchmark baseline only.
        self.cache_epoch_orders = cache_epoch_orders
        self._ids: Optional[List[str]] = None
        self._n: Optional[int] = None
        self._order_cache: Dict[tuple, List[str]] = {}
        # page-window state: per-(epoch, seed) page plan + resident windows
        self._page_plan_cache: Dict[tuple, Tuple[List[List[int]], List[int]]] = {}
        self._groups: "collections.OrderedDict[tuple, Tuple[List[str], Dict[str, Any]]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._stats: Dict[str, float] = {
            "batches": 0, "wait_time_s": 0.0, "run_time_s": 0.0,
            "read_time_s": 0.0, "decode_time_s": 0.0,
            "pages_streamed": 0, "resident_ids": 0, "peak_resident_ids": 0,
        }
        has_pages = all(hasattr(snapshot, m) for m in _PAGE_SURFACE)
        if shuffle == "page_window":
            if not has_pages:
                raise ValueError(
                    "shuffle='page_window' needs the page-granular feed "
                    "surface (CheckoutPlan / Snapshot); this snapshot lacks "
                    f"{[m for m in _PAGE_SURFACE if not hasattr(snapshot, m)]}")
            self._mode = "page_window"
        elif shuffle == "global" or not has_pages:
            self._mode = "global"
        else:  # auto: stream only when the full permutation would hurt
            self._mode = ("page_window"
                          if int(snapshot.count()) >= auto_page_window_min
                          else "global")
        # Content identity: page-window feeds hash the page directory rows
        # (O(pages), no record materialization); global mode keeps the exact
        # legacy per-record digest so existing checkpoints keep restoring.
        self._content = (snapshot.pages_digest() if self._mode == "page_window"
                         else snapshot.content_digest())

    # ---------------------------------------------------------------- state

    def state(self) -> LoaderState:
        st: LoaderState = {"snapshot_content": self._content,
                           "epoch": self.epoch, "step": self.step,
                           "seed": self.seed, "shuffle": self._mode}
        if self._mode == "page_window":
            st["window_pages"] = self.window_pages
            per = self._per_epoch()
            pos = (self.step % per) * self.batch if per else 0
            groups, cum = self._page_plan(self.step // per if per else 0)
            g = min(bisect.bisect_right(cum, pos) - 1, len(groups) - 1)
            st["cursor"] = {"group": g, "offset": pos - cum[g]}
        return st

    def restore(self, state: LoaderState) -> None:
        mode = state.get("shuffle", "global")
        if mode != self._mode:
            raise ValueError(
                f"loader restore across shuffle modes: checkpoint was "
                f"{mode!r}, this loader is {self._mode!r} — the batch "
                "streams differ (refusing silent data drift)")
        if self._mode == "page_window" and \
                int(state.get("window_pages", -1)) != self.window_pages:
            raise ValueError(
                "loader restore with a different window_pages "
                f"({state.get('window_pages')} != {self.window_pages}) — "
                "the in-window shuffle differs (refusing silent data drift)")
        if state["snapshot_content"] != self._content:
            raise ValueError(
                "loader restore onto a different snapshot: "
                f"{state['snapshot_content'][:12]} != {self._content[:12]} "
                "(lineage mismatch — refusing silent data drift)")
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    # ---------------------------------------------------------------- order

    def _record_ids(self) -> List[str]:
        if self._ids is None:
            self._ids = list(self.snapshot.record_ids())
        return self._ids

    def _count(self) -> int:
        if self._n is None:
            if self._mode == "page_window":
                self._n = int(self.snapshot.count())
            else:
                self._n = len(self._record_ids())
        return self._n

    def _per_epoch(self) -> int:
        return self._count() // self.batch     # drop ragged tail

    def _epoch_order(self, epoch: int) -> List[str]:
        """Deterministic epoch permutation, computed once per (epoch, seed).

        The per-batch cost drops from O(N) hashing + O(N log N) sorting to
        a dict hit; ordering stays bit-identical to :func:`_order` (golden
        tests), so checkpoints restore onto identical batch streams.
        """
        if not self.cache_epoch_orders:
            return _order(self._record_ids(), epoch, self.seed)
        key = (epoch, self.seed)
        with self._lock:
            order = self._order_cache.get(key)
            if order is None:
                order = _order_fast(self._record_ids(), epoch, self.seed)
                # keep the current and previous epoch only (restore() can
                # step back); anything older is dead weight
                self._order_cache = {
                    k: v for k, v in self._order_cache.items()
                    if k[0] >= epoch - 1 and k[1] == self.seed}
                self._order_cache[key] = order
        return order

    # -------------------------------------------------------- page windows

    def _page_plan(self, epoch: int) -> Tuple[List[List[int]], List[int]]:
        """(window groups, cumulative record offsets) for one epoch.

        Pure directory metadata — page counts come from ``page_sizes()``,
        so seeking to any stream position never reads a page.  Groups are
        consecutive runs of ``window_pages`` pages of the per-epoch page
        permutation; ``cum[g]`` is the global stream position of group
        ``g``'s first record.
        """
        key = (epoch, self.seed)
        with self._lock:
            hit = self._page_plan_cache.get(key)
            if hit is not None:
                return hit
            sizes = list(self.snapshot.page_sizes())
            perm = _page_perm(len(sizes), epoch, self.seed)
            W = max(1, self.window_pages)
            groups = [perm[i:i + W] for i in range(0, len(perm), W)]
            cum = [0]
            for grp in groups:
                cum.append(cum[-1] + sum(sizes[pi] for pi in grp))
            self._page_plan_cache = {
                k: v for k, v in self._page_plan_cache.items()
                if k[0] >= epoch - 1 and k[1] == self.seed}
            self._page_plan_cache[key] = (groups, cum)
            return groups, cum

    def _window(self, epoch: int, g: int) -> Tuple[List[str], Dict[str, Any]]:
        """One resident window: (in-window record order, id -> entry map).

        Loads the group's pages through the feed surface (grouped CAS
        reads under the hood) and shuffles records *within* the window with
        the same seeded-hash sort as global mode — so a window covering
        every page IS the global permutation.  Bounded LRU keeps peak
        resident ids at O(window_pages · page_size).
        """
        key = (epoch, self.seed, g)
        with self._lock:
            hit = self._groups.get(key)
            if hit is not None:
                self._groups.move_to_end(key)
                return hit
        groups, _ = self._page_plan(epoch)
        entries: Dict[str, Any] = {}
        for page in self.snapshot.read_pages(groups[g]):
            for e in page:
                entries[e.record_id] = e
        order = _order_fast(list(entries), epoch, self.seed)
        with self._lock:
            self._groups[key] = (order, entries)
            self._groups.move_to_end(key)
            while len(self._groups) > self._GROUP_CACHE_CAP:
                self._groups.popitem(last=False)
            resident = sum(len(o) for o, _ in self._groups.values())
            self._stats["pages_streamed"] += len(groups[g])
            self._stats["resident_ids"] = resident
            self._stats["peak_resident_ids"] = max(
                self._stats["peak_resident_ids"], resident)
        return order, entries

    def _stream_entries(self, epoch: int, positions: List[int]) -> List[Any]:
        """Entries at the given global stream positions (page-window mode)."""
        groups, cum = self._page_plan(epoch)
        out = []
        for pos in positions:
            g = min(bisect.bisect_right(cum, pos) - 1, len(groups) - 1)
            order, entries = self._window(epoch, g)
            out.append(entries[order[pos - cum[g]]])
        return out

    # ---------------------------------------------------------------- batches

    def _decode_row(self, payload: bytes) -> Dict[str, np.ndarray]:
        tokens, segments, positions = decode_packed(payload)
        L = self.seq_len
        return {
            "tokens": tokens[:L], "labels": tokens[1:L + 1],
            "segments": segments[:L], "positions": positions[:L],
        }

    def _read(self, rid: str) -> Dict[str, np.ndarray]:
        return self._decode_row(self.snapshot.read(rid))

    def _read_rows(self, rids: List[str]) -> List[Dict[str, np.ndarray]]:
        reader = getattr(self.snapshot, "read_batch", None)
        if reader is not None:
            return [self._decode_row(buf) for buf in reader(rids)]
        return [self._read(rid) for rid in rids]

    def _batch_at(self, gstep: int) -> Dict[str, np.ndarray]:
        """The local (per-shard) slice of global batch ``gstep`` — a pure
        function of (snapshot, seed, gstep), safe to compute on any worker
        thread in any order."""
        per_epoch = self._per_epoch()
        if per_epoch == 0:
            raise ValueError("snapshot smaller than one global batch")
        epoch, step_in_epoch = divmod(gstep, per_epoch)
        base = step_in_epoch * self.batch
        positions = [base + self.shard_id + j * self.n_shards
                     for j in range(self.local_batch)]
        t0 = time.perf_counter()
        if self._mode == "page_window":
            entries = self._stream_entries(epoch, positions)
            payloads = self.snapshot.read_entries(entries)
            t1 = time.perf_counter()
            rows = [self._decode_row(buf) for buf in payloads]
        else:
            order = self._epoch_order(epoch)
            rids = [order[p] for p in positions]
            t1 = time.perf_counter()
            rows = self._read_rows(rids)
        t2 = time.perf_counter()
        out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        # mask labels at padding (segment -1)
        out["labels"] = np.where(out["segments"] >= 0, out["labels"], -1)
        t3 = time.perf_counter()
        with self._lock:
            self._stats["read_time_s"] += t1 - t0
            self._stats["decode_time_s"] += (t2 - t1) + (t3 - t2)
        return out

    def _note_delivered(self, gstep: int) -> None:
        self.step = gstep + 1
        self.epoch = gstep // self._per_epoch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        """The local (per-shard) slice of global batch ``self.step``."""
        gstep = self.step
        out = self._batch_at(gstep)
        self._note_delivered(gstep)
        with self._lock:
            self._stats["batches"] += 1
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Pipelined iteration: batches are computed on a decode worker
        pool, delivered strictly in order through a bounded queue of
        in-flight futures.  Consumer blocked-time is accounted as
        ``wait_time_s`` (vs ``run_time_s`` spent in the consumer's own
        code), which :meth:`stats` turns into ``wait_fraction``.
        """
        pool = cf.ThreadPoolExecutor(max_workers=self.decode_workers,
                                     thread_name_prefix="loader-decode")
        depth = max(1, self.prefetch)
        pending: "collections.deque" = collections.deque()
        next_step = self.step
        timed_out = False
        t_last = time.perf_counter()
        try:
            while True:
                while len(pending) < depth:
                    pending.append(
                        (next_step, pool.submit(self._batch_at, next_step)))
                    next_step += 1
                gstep, fut = pending.popleft()
                t0 = time.perf_counter()
                try:
                    batch = fut.result(timeout=self.timeout_s)
                except (TimeoutError, cf.TimeoutError):
                    if fut.done():   # the batch itself raised TimeoutError
                        raise
                    timed_out = True
                    per = max(1, self._per_epoch())
                    raise TimeoutError(
                        f"loader shard stuck: no batch within "
                        f"{self.timeout_s:.1f}s (snapshot "
                        f"{self._content[:12]}, shard {self.shard_id}/"
                        f"{self.n_shards}, epoch {gstep // per}, "
                        f"step {gstep})") from None
                t1 = time.perf_counter()
                self._note_delivered(gstep)
                with self._lock:
                    self._stats["batches"] += 1
                    self._stats["wait_time_s"] += t1 - t0
                    self._stats["run_time_s"] += t0 - t_last
                # The consumer's own code runs while this generator waits at
                # the yield, so its clock starts before it.  (The reference
                # starts it after the yield, so its run time counts only the
                # submits above and its wait_fraction is wait / (wait + ~0).)
                t_last = time.perf_counter()
                yield batch
        finally:
            for _, fut in pending:
                fut.cancel()
            # A genuinely stuck read can't be joined — leave it to the
            # daemon-less pool thread and don't hang the consumer's exit.
            pool.shutdown(wait=not timed_out, cancel_futures=True)

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """Feed health counters.

        ``wait_fraction`` is the share of consumer wall time spent blocked
        on the prefetch queue during iteration (0.0 == the device never
        waited on host work); ``pages_streamed`` / ``peak_resident_ids``
        expose the page-window accounting the memory contract is tested
        against."""
        with self._lock:
            s: Dict[str, Any] = dict(self._stats)
        busy = s["wait_time_s"] + s["run_time_s"]
        s["wait_fraction"] = (s["wait_time_s"] / busy) if busy > 0 else 0.0
        s["mode"] = self._mode
        s["window_pages"] = self.window_pages if self._mode == "page_window" \
            else None
        return s

    # ---------------------------------------------------------------- device

    def device_batch(self, batch: Dict[str, np.ndarray], mesh, specs
                     ) -> Dict[str, Any]:
        """Lay a host batch (the same on every rank) onto the mesh per the
        given specs (:func:`~repro_torch.train.sharding.batch_specs`), as
        DTensors of which each rank holds its own piece."""
        from ..train.sharding import from_global, named

        return {k: from_global(torch.from_numpy(np.ascontiguousarray(v)),
                               named(mesh, specs[k]))
                for k, v in batch.items()}


class DeviceFeed:
    """Depth-``depth`` double-buffered host→device feed over a loader.

    Pulls host batches from the loader's pipelined iterator and keeps
    ``depth`` of them in flight to ``device``.  On CUDA each batch is
    copied into pinned host buffers (a ring of ``depth + 1`` sets, one
    tensor a key) and from there with ``non_blocking`` copies on a side
    stream, so the next batch's transfer overlaps the current
    ``train_step``.  A buffer set is refilled only after the copy that last
    read it has finished (its event), the consumer's stream waits for a
    batch's copy before the batch is handed out, and each device tensor is
    recorded on that stream, so the allocator does not reuse its memory
    while the consumer's kernels may still read it.  On the CPU the host
    arrays are wrapped as tensors.

    Yields ``(device_batch, loader_state)`` pairs: the paired state is taken
    exactly when the host batch was consumed, so checkpointing it restores
    onto a bit-identical stream even while later batches are already
    buffered on the device.

    ``sharding_fn(host_batch)`` builds, from the first batch, a dict of
    :class:`~repro_torch.train.sharding.Sharding` matching the batch (the
    usual route is ``named(mesh, batch_specs(...))``).  Then every rank
    reads the same global host batch, copies only its own piece to
    ``device`` and gets DTensors of the global shape; without it, the whole
    batch lands on ``device`` as plain tensors.
    """

    def __init__(self, loader: ShardedSnapshotLoader,
                 device: Union[str, torch.device], depth: int = 2,
                 sharding_fn=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceFeed: device 'cuda' requested but no "
                               "CUDA device is available")
        self.loader = loader
        self.device = device
        self.depth = max(1, int(depth))
        self._stream = None
        self._slots: List[Tuple[Dict[str, torch.Tensor], Any]] = []
        self._next_slot = 0
        self._shardings: Optional[Dict[str, Any]] = None
        self._sharding_fn = sharding_fn
        self._stats = {"transfers": 0, "put_dispatch_s": 0.0}

    def _pinned_slot(self, host: Dict[str, torch.Tensor]):
        """The next ring entry's pinned tensors, once the copy that last
        read them has finished; (re)allocated when the batch's shapes
        change."""
        n_slots = self.depth + 1
        if len(self._slots) < n_slots:
            self._slots.append(({}, None))
        i = self._next_slot
        self._next_slot = (i + 1) % n_slots
        bufs, event = self._slots[i]
        if event is not None:
            event.synchronize()
        for k, v in host.items():
            b = bufs.get(k)
            if b is None or b.shape != v.shape or b.dtype != v.dtype:
                bufs[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            bufs[k].copy_(v)
        return i, bufs

    def _put(self, host_batch: Dict[str, np.ndarray]):
        t0 = time.perf_counter()
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in host_batch.items()}
        if self._shardings is None and self._sharding_fn is not None:
            self._shardings = self._sharding_fn(host_batch)
        shapes = {k: v.shape for k, v in host.items()}
        if self._shardings is not None:
            from ..train.sharding import local_shard
            host = {k: local_shard(v, self._shardings[k]).contiguous()
                    for k, v in host.items()}
        if self.device.type != "cuda":
            out = ({k: v.to(self.device) for k, v in host.items()}, None, shapes)
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            i, bufs = self._pinned_slot(host)
            with torch.cuda.stream(self._stream):
                dev = {k: b.to(self.device, non_blocking=True)
                       for k, b in bufs.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
            self._slots[i] = (bufs, event)
            out = (dev, event, shapes)
        self._stats["transfers"] += 1
        self._stats["put_dispatch_s"] += time.perf_counter() - t0
        return out

    def _hand_out(self, put) -> Dict[str, Any]:
        batch, event, shapes = put
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        if self._shardings is not None:
            from ..train.sharding import from_local
            batch = {k: from_local(t, self._shardings[k], shapes[k])
                     for k, t in batch.items()}
        return batch

    def __iter__(self):
        it = iter(self.loader)
        buf: "collections.deque" = collections.deque()
        try:
            while True:
                while len(buf) < self.depth:
                    host = next(it)
                    state = self.loader.state()   # state paired to `host`
                    buf.append((self._put(host), state))
                put, state = buf.popleft()
                yield self._hand_out(put), state
        finally:
            it.close()

    def stats(self) -> Dict[str, Any]:
        return dict(self._stats)

"""Content-addressed derivation engine — checkout → transform → check_in
as one cached, incremental, streaming layer.

The paper: "the dataset transformation mechanism is a key part to generate
a dataset (snapshot) to serve different purposes."  A *derivation* is the
deterministic identity of one such generation step::

    (input commit id, query fingerprint, pipeline fingerprint)

hashed into a **derivation key**.  Because components are deterministic
given (config, seed, record) — the :mod:`repro_torch.core.transforms` contract —
the key fully determines the output, which buys three things:

- **Caching**: a :class:`DerivationCache` (persisted through the store, a
  gc root like the attribute index) maps key → output commit id, so an
  identical derivation — in this process or another one over the same
  backend — short-circuits to the cached output version with zero
  component executions.
- **Incremental recompute**: per-record stages (``per_record = True``:
  Map/Filter/FlatMap and friends) re-run only for records whose content
  signature (payload digest + attrs) changed since a prior derivation of
  the same (query, pipeline); unchanged records reuse their recorded
  outputs verbatim.  The first non-per-record stage (Batch/Human/stream)
  starts the *suffix*, which is always recomputed in full over the
  combined per-record outputs.
- **Streaming execution**: shards iterate manifest entries and fetch
  payloads via batched CAS reads (:meth:`ObjectStore.get_blobs`) in
  bounded windows instead of materializing every payload up front.

Output records are assembled in *input order* (each input record's output
group is contiguous), so the result is bit-identical regardless of shard
count, speculation, or whether records were reused or recomputed.

The sharded executor here is the one the workflow manager runs on: shard
failures retry with backoff, stragglers get speculative duplicates, and a
shard that exhausts its retries cancels all still-queued work instead of
letting doomed shards burn worker slots.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from .dataset import CheckoutPlan, DatasetManager, Record, version_node_id
from .lineage import EdgeKind, NodeKind
from .store import BlobRef, CommitConflictError, NotFoundError, ObjectStore
from .transforms import Component, Pipeline, RunContext
from .versioning import RecordEntry, raw_entry_matches

__all__ = [
    "Derivation",
    "DerivationCache",
    "DerivationEngine",
    "DerivationResult",
    "ExecPolicy",
    "ShardReport",
    "register_pipeline",
    "get_pipeline",
    "registered_pipelines",
]

_CACHE_VERSION = 1


# ---------------------------------------------------------------------------
# Pipeline registry (CLI / config surface: pipelines addressable by name)
# ---------------------------------------------------------------------------

_PIPELINES: Dict[str, Union[Pipeline, Callable[[], Pipeline]]] = {}


def register_pipeline(name: str,
                      pipeline: Union[Pipeline, Callable[[], Pipeline]]
                      ) -> None:
    """Register a pipeline (or zero-arg factory) under a CLI-addressable
    name; ``repro-cli derive --pipeline <name>`` resolves here."""
    _PIPELINES[name] = pipeline


def get_pipeline(name: str) -> Pipeline:
    try:
        obj = _PIPELINES[name]
    except KeyError:
        raise NotFoundError(
            f"unknown pipeline {name!r}; registered: "
            f"{registered_pipelines() or '(none)'} — register via "
            f"repro_torch.core.derive.register_pipeline") from None
    return obj() if callable(obj) and not isinstance(obj, Pipeline) else obj


def registered_pipelines() -> List[str]:
    return sorted(_PIPELINES)


# ---------------------------------------------------------------------------
# Identity
# ---------------------------------------------------------------------------


def derivation_node_id(key: str) -> str:
    """Lineage node id of a derivation key (single source of the format)."""
    return f"derivation:{key}"


@dataclass(frozen=True)
class Derivation:
    """The deterministic triple identifying one derivation."""

    input_commit: str
    query: str          # CheckoutPlan.query_digest() (query + limit + shard)
    pipeline: str       # Pipeline.fingerprint()

    @property
    def key(self) -> str:
        body = json.dumps(
            {"commit": self.input_commit, "query": self.query,
             "pipeline": self.pipeline, "v": _CACHE_VERSION},
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(body.encode()).hexdigest()[:32]

    @property
    def node_id(self) -> str:
        return derivation_node_id(self.key)


@dataclass
class ShardReport:
    """Per-shard execution report (attempts, speculation, timing)."""

    shard: int
    attempts: int = 0
    speculative: bool = False
    duration_s: float = 0.0
    n_in: int = 0
    n_out: int = 0
    error: str = ""


@dataclass
class ExecPolicy:
    """Resource/retry policy for the sharded streaming executor."""

    n_shards: int = 4
    max_retries: int = 2
    speculative_factor: float = 3.0
    min_speculative_wait_s: float = 0.05
    # Payload window: how many records a shard fetches per batched CAS read.
    batch_records: int = 64


@dataclass
class DerivationResult:
    """What one :meth:`DerivationEngine.derive` call did and produced."""

    key: Optional[str]          # None ⇔ opaque query (uncacheable)
    input_commit: str
    pipeline: str
    output_dataset: Optional[str] = None
    output_commit: Optional[str] = None
    cache_hit: bool = False
    incremental: bool = False
    n_inputs: int = 0
    n_outputs: int = 0
    n_executed: int = 0         # input records pushed through the prefix
    n_reused: int = 0           # input records whose outputs were reused
    content_digest: Optional[str] = None
    shard_reports: List[ShardReport] = field(default_factory=list)
    # Present when the run held every output in memory (fully executed
    # paths); reused outputs are fetched on demand via the output commit
    # (:meth:`DerivationEngine.load_output_records`).
    output_records: Optional[List[Record]] = None

    @property
    def node_id(self) -> Optional[str]:
        """Lineage node id of this derivation (``None`` if uncacheable)."""
        return derivation_node_id(self.key) if self.key else None

    def report(self) -> dict:
        return {
            "key": self.key,
            "input_commit": self.input_commit,
            "pipeline": self.pipeline,
            "output_dataset": self.output_dataset,
            "output_commit": self.output_commit,
            "cache_hit": self.cache_hit,
            "incremental": self.incremental,
            "n_inputs": self.n_inputs,
            "n_outputs": self.n_outputs,
            "n_executed": self.n_executed,
            "n_reused": self.n_reused,
        }


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------


class DerivationCache:
    """Persistent derivation → output-version map.

    Slots are keyed by ``<derivation key>:<output dataset>`` — the key is
    the identity of the computation, the slot also spans where its result
    was checked in.

    The entries live in one content-addressed blob; a mutable meta pointer
    (``derive/cache``) names the current blob, so any process over the same
    backend sees the latest map.  The blob, every provenance blob it names,
    and every prefix-output payload those reference are **gc roots**
    (:meth:`gc_roots`) — like the attribute index, cached derivations must
    survive :meth:`DatasetManager.gc`.

    Writes are read-modify-write of the whole map.  Inside a meta batch
    the pointer swap is CAS-guarded with a re-apply merge (and ordered
    after the output head it names), so concurrent derivations keep each
    other's entries; unbatched writers keep the old last-writer-wins
    semantics, which only costs a future recompute (the cache is an
    accelerator, never a correctness dependency).
    """

    _PTR = "derive/cache"

    def __init__(self, store: ObjectStore) -> None:
        self.store = store
        self._memo: Tuple[Optional[str], Dict[str, dict]] = (None, {})

    def _load(self) -> Dict[str, dict]:
        ptr = self.store.get_meta(self._PTR)
        if ptr is None:
            return {}
        digest = ptr.get("blob")
        if self._memo[0] == digest:
            return self._memo[1]
        try:
            doc = self.store.get_json(digest)
        except NotFoundError:
            return {}
        entries = doc.get("entries", {})
        self._memo = (digest, entries)
        return entries

    def get(self, key: str) -> Optional[dict]:
        return self._load().get(key)

    def entries(self) -> Dict[str, dict]:
        return dict(self._load())

    def put(self, key: str, entry: dict) -> None:
        entries = dict(self._load())
        entries[key] = entry
        self._write(entries)

        def merge(cur_ptr):
            # A concurrent derivation moved the pointer while our batch
            # flushed: reload the winner's entries (direct backend reads —
            # the batch is quiesced during flush) and re-apply just this
            # slot, so neither derivation's cache entry is lost.
            base: Dict[str, dict] = {}
            if cur_ptr and cur_ptr.get("blob"):
                try:
                    doc = self.store.get_json(cur_ptr["blob"])
                    base = dict(doc.get("entries", {}))
                except NotFoundError:
                    base = {}
            base[key] = entry
            ref = self.store.put_json({"v": _CACHE_VERSION, "entries": base})
            self._memo = (ref.digest, base)
            return {"blob": ref.digest}

        # after_refs: the slot must never land before the output head it
        # names — a crash in between must leave "head moved, cache cold",
        # never "cache warm, head stale".
        self.store.require_meta_cas(self._PTR, merge=merge, after_refs=True)

    def _write(self, entries: Dict[str, dict]) -> None:
        ref = self.store.put_json({"v": _CACHE_VERSION, "entries": entries})
        self.store.put_meta(self._PTR, {"blob": ref.digest})
        self._memo = (ref.digest, entries)

    def remove(self, keys: Sequence[str]) -> int:
        """Drop slots by key; returns how many existed.  The slots' prov
        blobs stop being gc roots — the next :meth:`DatasetManager.gc`
        sweeps them (and any prefix-output payloads only they referenced)."""
        entries = dict(self._load())
        n = 0
        for key in keys:
            if entries.pop(key, None) is not None:
                n += 1
        if n:
            self._write(entries)
        return n

    def prune(self, keep_latest: int = 1) -> List[str]:
        """Drop superseded slots, keeping the ``keep_latest`` most recent
        per (query, pipeline, output dataset) group.

        Slots in one group describe the *same* derivation against older
        input commits — once a newer one exists, the old output commits
        remain valid history but their cache/prov entries only pin dead
        prefix outputs in the CAS.  Returns the removed slot keys; callers
        normally follow with :meth:`DatasetManager.gc`.
        """
        if keep_latest < 1:
            raise ValueError("keep_latest must be >= 1")
        groups: Dict[tuple, List[Tuple[float, str]]] = {}
        for key, entry in self._load().items():
            group = (entry.get("query"), entry.get("pipeline"),
                     entry.get("output_dataset"))
            groups.setdefault(group, []).append(
                (entry.get("created_at", 0.0), key))
        doomed: List[str] = []
        for slots in groups.values():
            slots.sort(reverse=True)
            doomed.extend(key for _, key in slots[keep_latest:])
        self.remove(doomed)
        return doomed

    def gc_roots(self) -> List[str]:
        """Digests this cache keeps alive: the map blob, each provenance
        blob, and every prefix-output payload a provenance blob names."""
        roots: List[str] = []
        ptr = self.store.get_meta(self._PTR)
        if ptr is None:
            return roots
        roots.append(ptr["blob"])
        for entry in self._load().values():
            prov = entry.get("prov")
            if not prov:
                continue
            roots.append(prov)
            try:
                doc = self.store.get_json(prov)
            except NotFoundError:
                continue
            for _rid, outs in doc.get("groups", []):
                roots.extend(o["blob"]["digest"] for o in outs)
        return roots


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclass
class _Group:
    """Output group of one input record, in input order.

    ``outs`` holds :class:`Record` objects when the group was executed this
    run (payload bytes in memory) and :class:`RecordEntry` refs when it was
    reused from a prior derivation (payload bytes in the CAS)."""

    pos: int
    rid: str
    outs: List[Union[Record, RecordEntry]]
    reused: bool


def _components_fingerprint(components: Sequence[Component]) -> str:
    h = hashlib.sha256()
    for c in components:
        h.update(c.fingerprint().encode())
    return h.hexdigest()[:16]


class DerivationEngine:
    """Executes derivations: cache → incremental reuse → streaming shards.

    One engine per :class:`DatasetManager` (shared via
    :meth:`for_manager`, like the workflow manager) so the in-memory prefix
    memo that makes park/resume cheap is not split across facades.
    """

    def __init__(self, dm: DatasetManager, worker_slots: int = 8) -> None:
        self.dm = dm
        self.worker_slots = worker_slots
        self.cache = DerivationCache(dm.store)
        self._lock = threading.Lock()
        # (input commit, query digest, prefix fingerprint) -> groups; lets a
        # run parked on a human task resume without re-running the prefix.
        self._prefix_memo: "OrderedDict[tuple, List[_Group]]" = OrderedDict()
        self._memo_cap = 4
        # (prov blob digest, input commit) -> parsed reuse map (blobs
        # validated at build).  Keyed by the *current* input commit too:
        # the page-shared "unchanged by construction" markers are only
        # valid against the tree they were computed for.
        self._reuse_memo: "OrderedDict[tuple, dict]" = OrderedDict()
        # output tree digest -> content digest (trees are immutable).
        self._tree_digest_memo: "OrderedDict[str, str]" = OrderedDict()
        dm._derivation_engine = self

    @classmethod
    def for_manager(cls, dm: DatasetManager,
                    worker_slots: int = 8) -> "DerivationEngine":
        existing = getattr(dm, "_derivation_engine", None)
        return existing if existing is not None else cls(
            dm, worker_slots=worker_slots)

    # ------------------------------------------------------------------ derive

    def derive(
        self,
        plan: CheckoutPlan,
        pipeline: Pipeline,
        output_dataset: Optional[str] = None,
        actor: str = "derive",
        message: str = "",
        policy: Optional[ExecPolicy] = None,
        use_cache: bool = True,
        incremental: bool = True,
        update_cache: bool = True,
        derived_from: Sequence[str] = (),
        produced_by: Optional[str] = None,
        commit_meta: Optional[Mapping[str, object]] = None,
        run_id: Optional[str] = None,
    ) -> DerivationResult:
        """Run ``pipeline`` over ``plan``'s record stream.

        With ``output_dataset`` set and a serializable query, the result is
        cached under the derivation key: an identical call short-circuits
        to the cached output commit (``use_cache``), a call on a *new*
        input commit reuses per-record outputs for unchanged records
        (``incremental``), and a successful run records itself for future
        reuse (``update_cache``).  Opaque (callable) queries always execute
        in full and are never cached.
        """
        policy = policy or ExecPolicy()
        run_id = run_id or f"derive-{uuid.uuid4().hex[:12]}"
        qd = plan.query_digest()
        pfp = pipeline.fingerprint()
        deriv = (Derivation(plan.commit_id, qd, pfp)
                 if qd is not None else None)
        res = DerivationResult(
            key=deriv.key if deriv else None,
            input_commit=plan.commit_id, pipeline=pfp,
            output_dataset=output_dataset)
        cacheable = deriv is not None and output_dataset is not None
        # The derivation *key* is the triple; the cache *slot* also spans
        # the output dataset, so one triple derived into two datasets
        # caches both instead of evicting each other.
        cache_key = f"{res.key}:{output_dataset}" if cacheable else None

        if cacheable and use_cache:
            hit = self.cache.get(cache_key)
            if (hit is not None
                    and hit.get("output_dataset") == output_dataset
                    and self._commit_exists(hit.get("output_commit"))
                    # A hit is only valid while the cached commit is still
                    # the materialized view: if anything else moved the
                    # output head, recompute (a fresh commit, with
                    # triggers) exactly as the uncached path would.
                    and self.dm.versions.get_branch(output_dataset, "main")
                    == hit.get("output_commit")):
                res.cache_hit = True
                res.output_commit = hit["output_commit"]
                res.n_inputs = int(hit.get("n_inputs", 0))
                res.n_outputs = int(hit.get("n_outputs", 0))
                res.n_reused = res.n_inputs
                res.content_digest = hit.get("content")
                self._ensure_lineage(deriv, plan, derived_from)
                return res

        prefix, suffix = pipeline.split_incremental()
        entries = plan.entries()
        res.n_inputs = len(entries)

        reuse = None
        if cacheable and incremental and prefix:
            reuse = self._load_reuse(deriv, output_dataset)

        memo_key = ((plan.commit_id, qd, _components_fingerprint(prefix))
                    if qd is not None else None)
        # The prefix memo serves park/resume and in-process repeats; like
        # the key cache it is bypassed when the caller forces a cold run.
        groups = self._memo_get(memo_key) if use_cache else None
        if groups is None:
            groups = self._build_groups(entries, prefix, reuse, policy,
                                        run_id, res)
            res.incremental = reuse is not None and res.n_reused > 0
            self._memo_put(memo_key, groups)
        else:
            # Resuming a parked run: the per-record prefix already ran in
            # this process — zero component executions on the way back in.
            res.n_reused = len(groups)

        commit_meta = dict(commit_meta or {})
        if res.key is not None:
            commit_meta.setdefault("derivation", res.key)
        all_derived_from = list(derived_from)
        if deriv is not None:
            self._ensure_lineage(deriv, plan, derived_from)
            all_derived_from.append(deriv.node_id)

        if suffix:
            # Suffix stages (batch / human / stream) see one global stream
            # over the per-record outputs, in input order — deterministic
            # irrespective of shard count.  May raise WaitingForHuman; the
            # prefix memo above makes the eventual resume cheap.
            ctx = RunContext(run_id=run_id)
            stream: Iterator[Record] = self._record_stream(groups, policy)
            for comp in suffix:
                stream = comp.process(stream, ctx)
            final = list(stream)
            res.output_records = final
            res.n_outputs = len(final)
            out_for_checkin: Sequence[Union[Record, RecordEntry]] = final
        else:
            flat: List[Union[Record, RecordEntry]] = []
            for g in groups:
                flat.extend(g.outs)
            res.n_outputs = len(flat)
            if all(isinstance(x, Record) for x in flat):
                res.output_records = flat  # fully executed: all in memory
            out_for_checkin = flat

        prov_digest = None
        prov_bytes = 0
        if cacheable and update_cache:
            prov_digest, prov_bytes, prov_entries = self._write_prov(groups)
            if not suffix:
                # The prov step already content-addressed every output
                # payload; check in refs so blobs are not re-hashed.
                out_for_checkin = prov_entries

        if output_dataset is None:
            return res

        # Transactional publish: the output head (via check_in), the
        # PRODUCED_BY lineage edge, and the cache slot all ride ONE outer
        # meta-batch flush — an all-or-nothing multi-ref swap.  The cache
        # pointer goes through a CAS ordered AFTER the refs pass
        # (``DerivationCache.put`` registers it), so at every kill point
        # the invariant holds: a cache slot that names a commit implies
        # that commit's head already landed — a crash can no longer leave
        # the slot pointing at an unpublished commit.  A concurrent writer
        # on the output head surfaces as CommitConflictError at flush (the
        # joined check_in cannot retry internally), so the bounded rebase
        # loop lives here.
        store = self.dm.store
        commit = None
        attempt = 0
        while True:
            try:
                with store.meta_batch(prefetch=[
                        DerivationCache._PTR,
                        self.dm.lineage.pending_seg_key()]):
                    # replace=True: the derived version's manifest is
                    # exactly the pipeline output (materialized-view
                    # semantics) — outputs of records since
                    # deleted/changed in the input must not linger from
                    # the previous head.
                    commit = self.dm.check_in(
                        output_dataset, out_for_checkin, actor,
                        message=message or f"derive {pipeline.name} "
                                           f"@ {plan.commit_id[:12]}",
                        replace=True,
                        derived_from=all_derived_from,
                        produced_by=produced_by,
                        meta=commit_meta,
                        notify=False,
                    )
                    res.output_commit = commit.commit_id
                    res.content_digest = self._manifest_digest(commit.tree)
                    if deriv is not None:
                        lin = self.dm.lineage
                        lin.add_edge(version_node_id(output_dataset,
                                                     res.output_commit),
                                     deriv.node_id, EdgeKind.PRODUCED_BY)
                        lin.flush()
                    if cacheable and update_cache:
                        with self._lock:
                            self.cache.put(cache_key, {
                                "input_commit": plan.commit_id,
                                "input_dataset": plan.dataset,
                                "query": qd,
                                "pipeline": pfp,
                                "output_dataset": output_dataset,
                                "output_commit": res.output_commit,
                                "content": res.content_digest,
                                "prov": prov_digest,
                                "prov_bytes": prov_bytes,
                                "n_inputs": res.n_inputs,
                                "n_outputs": res.n_outputs,
                                "created_at": time.time(),
                            })
                break
            except CommitConflictError as err:
                if err.records \
                        or attempt >= DatasetManager._REBASE_MAX_RETRIES:
                    raise
                attempt += 1
                store.stats.commit_rebases += 1
                time.sleep(random.uniform(0.0, min(
                    DatasetManager._REBASE_BACKOFF_CAP_S,
                    DatasetManager._REBASE_BACKOFF_S * (2 ** (attempt - 1)))))
        # Listeners fire only after the whole publish landed, so a
        # triggered workflow's own check_ins build on fully-landed state
        # (head, lineage, and cache slot all visible).
        self.dm.notify_commit(output_dataset, commit)
        return res

    # ------------------------------------------------------------------ pieces

    def load_output_records(self, result: DerivationResult,
                            window: int = 64) -> List[Record]:
        """Materialize a result's output records.

        Fully-executed runs already hold them; incremental runs (mixed
        reused/executed outputs) fetch payloads from the output commit in
        bounded batched windows.  Cache-hit results load the same way."""
        if result.output_records is not None:
            return list(result.output_records)
        if result.output_commit is None:
            return []
        entries = self.dm.versions.get_manifest(
            self.dm.versions.get_commit(result.output_commit).tree).entries()
        out: List[Record] = []
        for off in range(0, len(entries), max(1, window)):
            chunk = entries[off:off + max(1, window)]
            for e, data in zip(chunk,
                               self.dm.store.get_blobs(
                                   [e.blob for e in chunk])):
                out.append(Record(e.record_id, data, dict(e.attrs)))
        return out

    def _commit_exists(self, commit_id: Optional[str]) -> bool:
        if not commit_id:
            return False
        try:
            self.dm.versions.get_commit(commit_id)
            return True
        except NotFoundError:
            return False

    def _manifest_digest(self, tree: str) -> str:
        with self._lock:
            hit = self._tree_digest_memo.get(tree)
        if hit is not None:
            return hit
        h = hashlib.sha256()
        for e in self.dm.versions.get_manifest(tree).iter_entries():
            h.update(e.record_id.encode())
            h.update(e.blob.digest.encode())
        digest = h.hexdigest()
        with self._lock:
            self._tree_digest_memo[tree] = digest
            while len(self._tree_digest_memo) > 16:
                self._tree_digest_memo.popitem(last=False)
        return digest

    def _ensure_lineage(self, deriv: Derivation, plan: CheckoutPlan,
                        derived_from: Sequence[str]) -> None:
        """Idempotently record the derivation-key node and its provenance
        edges, so ``ancestors(output version)`` names exactly which
        snapshot + pipeline produced it."""
        lin = self.dm.lineage
        if lin.node(deriv.node_id) is not None:
            return
        lin.add_node(deriv.node_id, NodeKind.DERIVATION,
                     input_dataset=plan.dataset,
                     input_commit=deriv.input_commit,
                     query=deriv.query, pipeline=deriv.pipeline)
        lin.add_edge(deriv.node_id,
                     version_node_id(plan.dataset, plan.commit_id),
                     EdgeKind.DERIVED_FROM)
        for src in derived_from:
            lin.add_edge(deriv.node_id, src, EdgeKind.DERIVED_FROM)
        lin.flush()

    def _memo_get(self, key) -> Optional[List[_Group]]:
        if key is None:
            return None
        with self._lock:
            groups = self._prefix_memo.get(key)
            if groups is not None:
                self._prefix_memo.move_to_end(key)
            return groups

    def _memo_put(self, key, groups: List[_Group]) -> None:
        if key is None:
            return
        with self._lock:
            self._prefix_memo[key] = groups
            self._prefix_memo.move_to_end(key)
            while len(self._prefix_memo) > self._memo_cap:
                self._prefix_memo.popitem(last=False)

    def _load_reuse(
        self, deriv: Derivation, output_dataset: str
    ) -> Optional[Dict[str, Tuple[Optional[dict], List[RecordEntry]]]]:
        """Per-record reuse map from the latest prior derivation of the
        same (query, pipeline) on a different input commit.

        Maps input record id → (prior raw manifest record, prior output
        entries); a new input entry may reuse the outputs iff it matches
        the prior raw record on payload digest AND attrs
        (:func:`~repro_torch.core.versioning.raw_entry_matches`).

        Page-granular fast path: when both input trees are paged, a prior
        record living in a page the two trees *share* is unchanged by
        construction — its raw slot is ``None`` ("no compare needed"), and
        only the unshared prior pages are ever deserialized, so an
        incremental re-run reads O(changed pages) of the prior manifest
        instead of all of it."""
        best: Optional[dict] = None
        for entry in self.cache.entries().values():
            if (entry.get("query") == deriv.query
                    and entry.get("pipeline") == deriv.pipeline
                    and entry.get("output_dataset") == output_dataset
                    and entry.get("input_commit") != deriv.input_commit
                    and entry.get("prov")):
                if (best is None
                        or entry.get("created_at", 0)
                        > best.get("created_at", 0)):
                    best = entry
        if best is None:
            return None
        prov = best["prov"]
        versions = self.dm.versions
        with self._lock:
            hit = self._reuse_memo.get((prov, deriv.input_commit))
            if hit is not None:
                self._reuse_memo.move_to_end((prov, deriv.input_commit))
                return hit
        try:
            doc = self.dm.store.get_json(prov)
            prev_tree = versions.get_commit(best["input_commit"]).tree
            cur_tree = versions.get_commit(deriv.input_commit).tree
            prev_dir = versions.get_page_directory(prev_tree)
            cur_dir = versions.get_page_directory(cur_tree)
            if prev_dir is not None and cur_dir is not None:
                shared = cur_dir.page_digests()
                unshared = [i for i, p in enumerate(prev_dir.pages)
                            if p.digest not in shared]
                prev_raw = {
                    o["id"]: o
                    for raw in versions.iter_page_records(prev_dir, unshared)
                    for o in raw}

                def prior_raw(rid: str) -> Tuple[Optional[dict], bool]:
                    pi = prev_dir.page_for(rid)
                    if pi >= 0 and prev_dir.pages[pi].digest in shared:
                        return None, True  # page shared ⇒ entry unchanged
                    raw = prev_raw.get(rid)
                    return raw, raw is not None
            else:
                prev_all = {o["id"]: o
                            for o in versions.get_raw_records(prev_tree)}

                def prior_raw(rid: str) -> Tuple[Optional[dict], bool]:
                    raw = prev_all.get(rid)
                    return raw, raw is not None
        except NotFoundError:
            return None
        store = self.dm.store
        reuse = {}
        for rid, outs in doc.get("groups", []):
            raw, known = prior_raw(rid)
            if not known:
                continue
            entries = [RecordEntry.from_json(o) for o in outs]
            # Validate once at parse time: a revoked/collected output
            # payload disqualifies its group (it recomputes instead).
            # Prov blobs are content-addressed, so the memo never stales.
            if all(store.has_blob(e.blob.digest) for e in entries):
                reuse[rid] = (raw, entries)
        with self._lock:
            self._reuse_memo[(prov, deriv.input_commit)] = reuse
            while len(self._reuse_memo) > 4:
                self._reuse_memo.popitem(last=False)
        return reuse

    def _build_groups(
        self,
        entries: Sequence[RecordEntry],
        prefix: Sequence[Component],
        reuse: Optional[Dict[str, Tuple[Optional[dict],
                                        List[RecordEntry]]]],
        policy: ExecPolicy,
        run_id: str,
        res: DerivationResult,
    ) -> List[_Group]:
        """Partition inputs into reused vs to-execute, run the sharded
        streaming prefix over the latter, and reassemble in input order."""
        groups: Dict[int, _Group] = {}
        tasks: List[Tuple[int, RecordEntry]] = []
        for pos, e in enumerate(entries):
            prior = reuse.get(e.record_id) if reuse else None
            # A ``None`` raw slot is the page-granular witness: the record
            # sits in a manifest page shared by both input trees, so it is
            # unchanged by construction and skips the per-record compare.
            if prior is not None and (prior[0] is None
                                      or raw_entry_matches(prior[0], e)):
                groups[pos] = _Group(pos, e.record_id, list(prior[1]),
                                     reused=True)
            elif not prefix:
                # No per-record stages: the input record itself is the
                # group's output, streamed to the suffix from the CAS.
                groups[pos] = _Group(pos, e.record_id, [e], reused=False)
            else:
                tasks.append((pos, e))
        res.n_reused = sum(1 for g in groups.values() if g.reused)
        res.n_executed = len(tasks)
        if tasks:
            shard_out, reports = self._execute_prefix(tasks, prefix, policy,
                                                      run_id)
            res.shard_reports = reports
            for pos, outs in shard_out:
                rid = entries[pos].record_id
                groups[pos] = _Group(pos, rid, outs, reused=False)
        return [groups[pos] for pos in sorted(groups)]

    def _execute_prefix(
        self,
        tasks: Sequence[Tuple[int, RecordEntry]],
        prefix: Sequence[Component],
        policy: ExecPolicy,
        run_id: str,
    ) -> Tuple[List[Tuple[int, List[Record]]], List[ShardReport]]:
        """Sharded, fault-tolerant, straggler-mitigated prefix execution.

        Shards stream payloads in bounded ``batch_records`` windows via
        batched CAS reads.  Failed shards retry with backoff; stragglers
        get speculative duplicates (first finisher wins — sound because
        components are deterministic).  A shard that exhausts its retries
        cancels every still-queued future so a poisoned run fails fast
        instead of finishing doomed work.
        """
        store = self.dm.store
        # A task set that fits one payload window gains nothing from a
        # worker pool (thread spin-up costs more than the work) — run it
        # inline as a single shard.  Incremental re-runs almost always
        # take this path.
        inline = len(tasks) <= max(1, policy.batch_records)
        n_shards = 1 if inline else max(1, min(policy.n_shards, len(tasks)))
        shard_tasks = [list(tasks[i::n_shards]) for i in range(n_shards)]
        reports = {i: ShardReport(shard=i, n_in=len(shard_tasks[i]))
                   for i in range(n_shards)}
        results: Dict[int, List[Tuple[int, List[Record]]]] = {}
        durations: List[float] = []

        def work(shard_idx: int, speculative: bool):
            t0 = time.time()
            ctx = RunContext(run_id=run_id, shard_index=shard_idx,
                             n_shards=n_shards)
            out: List[Tuple[int, List[Record]]] = []
            mine = shard_tasks[shard_idx]
            window = max(1, policy.batch_records)
            for off in range(0, len(mine), window):
                batch = mine[off:off + window]
                payloads = store.get_blobs([e.blob for _, e in batch])
                for (pos, e), data in zip(batch, payloads):
                    outs: List[Record] = [Record(e.record_id, data,
                                                 dict(e.attrs))]
                    for comp in prefix:
                        outs = list(comp.process(iter(outs), ctx))
                        if not outs:
                            break
                    out.append((pos, outs))
            return shard_idx, out, time.time() - t0, speculative

        if inline:
            attempt = 0
            while True:
                attempt += 1
                reports[0].attempts = attempt
                try:
                    _, out, dt, _ = work(0, False)
                    break
                except Exception as e:  # noqa: BLE001 - retry policy
                    reports[0].error = f"{type(e).__name__}: {e}"
                    if attempt > policy.max_retries:
                        raise RuntimeError(
                            f"shard 0 failed after {attempt} attempts: "
                            f"{reports[0].error}") from e
                    time.sleep(0.01 * (2 ** (attempt - 1)))
            reports[0].duration_s = dt
            reports[0].n_out = sum(len(o) for _, o in out)
            return out, [reports[0]]

        pool = ThreadPoolExecutor(max_workers=self.worker_slots)
        try:
            pending: Dict[Future, Tuple[int, bool]] = {}
            attempts = {i: 0 for i in range(n_shards)}
            launched_spec: set = set()
            launch_times: Dict[int, float] = {}

            def launch(i: int, speculative: bool = False) -> None:
                attempts[i] += 1
                reports[i].attempts += 1
                launch_times.setdefault(i, time.time())
                fut = pool.submit(work, i, speculative)
                pending[fut] = (i, speculative)

            for i in range(n_shards):
                launch(i)

            while pending:
                done, _ = wait(list(pending),
                               timeout=policy.min_speculative_wait_s,
                               return_when=FIRST_COMPLETED)
                for fut in done:
                    i, speculative = pending.pop(fut)
                    if i in results:
                        continue  # a duplicate already won
                    try:
                        idx, out, dt, spec = fut.result()
                    except Exception as e:  # noqa: BLE001 - retry policy
                        reports[i].error = f"{type(e).__name__}: {e}"
                        if attempts[i] <= policy.max_retries:
                            time.sleep(0.01 * (2 ** (attempts[i] - 1)))
                            launch(i)
                            continue
                        # Poisoned shard: drop every queued future so
                        # sibling shards stop consuming worker slots on
                        # work whose run is already doomed.
                        pool.shutdown(wait=False, cancel_futures=True)
                        raise RuntimeError(
                            f"shard {i} failed after {attempts[i]} "
                            f"attempts: {reports[i].error}") from e
                    results[idx] = out
                    durations.append(dt)
                    reports[idx].duration_s = dt
                    reports[idx].n_out = sum(len(o) for _, o in out)
                    reports[idx].speculative = spec

                # Straggler mitigation: speculative duplicates.
                if durations and len(results) < n_shards:
                    med = sorted(durations)[len(durations) // 2]
                    now = time.time()
                    for i in range(n_shards):
                        if (i not in results and i not in launched_spec
                                and attempts[i] > 0
                                and now - launch_times.get(i, now)
                                > max(policy.speculative_factor * med,
                                      policy.min_speculative_wait_s)):
                            launched_spec.add(i)
                            launch(i, speculative=True)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

        out: List[Tuple[int, List[Record]]] = []
        for i in range(n_shards):
            out.extend(results[i])
        return out, [reports[i] for i in range(n_shards)]

    def _record_stream(self, groups: Sequence[_Group],
                       policy: ExecPolicy) -> Iterator[Record]:
        """Stream every group's outputs in input order; reused outputs are
        fetched from the CAS in bounded batched windows."""
        store = self.dm.store
        flat: List[Union[Record, RecordEntry]] = []
        for g in groups:
            flat.extend(g.outs)
        window = max(1, policy.batch_records)
        for off in range(0, len(flat), window):
            chunk = flat[off:off + window]
            fetched = iter(store.get_blobs(
                [x.blob for x in chunk if isinstance(x, RecordEntry)]))
            for x in chunk:
                if isinstance(x, RecordEntry):
                    yield Record(x.record_id, next(fetched), dict(x.attrs))
                else:
                    yield x

    # Executed shard outputs per grouped CAS write — bounded by count AND
    # bytes (encoding copies every missing chunk before the grouped write,
    # so an unbounded window of large outputs would spike peak memory).
    _PROV_PUT_WINDOW = 1024
    _PROV_PUT_WINDOW_BYTES = 32 * 1024 * 1024

    def _write_prov(
        self, groups: Sequence[_Group]
    ) -> Tuple[str, int, List[RecordEntry]]:
        """Persist the provenance blob: input record → output entries, in
        input order.  Executed outputs are content-addressed into the CAS
        here (dedups with the output commit's own blobs) through the
        batched ``put_blobs`` writer in bounded windows — one grouped
        dedup probe per window instead of one round trip per shard
        output.  Returns (digest, size, entries) — the size is recorded
        on the cache slot so ``repro-cli cache ls`` never has to read
        prov blobs."""
        store = self.dm.store
        executed: List[Record] = [x for g in groups for x in g.outs
                                  if not isinstance(x, RecordEntry)]
        refs: List[BlobRef] = []
        window: List[bytes] = []
        window_bytes = 0
        for rec in executed:
            window.append(rec.data)
            window_bytes += len(rec.data)
            if (len(window) >= self._PROV_PUT_WINDOW
                    or window_bytes >= self._PROV_PUT_WINDOW_BYTES):
                refs.extend(store.put_blobs(window))
                window, window_bytes = [], 0
        if window:
            refs.extend(store.put_blobs(window))
        resolved = iter(refs)
        body: List[list] = []
        flat_entries: List[RecordEntry] = []
        for g in groups:
            outs: List[RecordEntry] = []
            for x in g.outs:
                if isinstance(x, RecordEntry):
                    outs.append(x)
                else:
                    outs.append(RecordEntry(x.record_id, next(resolved),
                                            dict(x.attrs)))
            body.append([g.rid, [e.to_json() for e in outs]])
            flat_entries.extend(outs)
        ref = store.put_json({"v": _CACHE_VERSION, "groups": body})
        return ref.digest, ref.size, flat_entries


def derivation_gc_roots(store: ObjectStore) -> List[str]:
    """GC roots owned by the derivation cache (see
    :meth:`DerivationCache.gc_roots`)."""
    return DerivationCache(store).gc_roots()

"""Data lineage — "tracking the data lineage by version, derivation, and
workflow" (paper, Key Features).

The lineage graph is a DAG whose nodes are *things that exist* (dataset
versions, snapshots, workflow runs, model checkpoints, external sources) and
whose edges are *how they came to exist* (derived-from, produced-by,
input-to, contains-record).  It is persisted through the store's meta
namespace as an append-only edge log, so provenance survives process
restarts and can be reconstructed cheaply.

Supported queries (all used elsewhere in the platform):
- ``ancestors(node)``     — full provenance of a snapshot/checkpoint.
- ``descendants(node)``   — downstream impact of a version (drives
  revocation: "which snapshots/checkpoints ingested record X?").
- ``paths_between(a, b)`` — audit-grade derivation chains.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple

from .store import ObjectStore

__all__ = ["NodeKind", "EdgeKind", "LineageNode", "LineageEdge", "LineageGraph"]


class NodeKind:
    DATASET_VERSION = "dataset_version"
    SNAPSHOT = "snapshot"
    WORKFLOW_RUN = "workflow_run"
    COMPONENT_RUN = "component_run"
    DERIVATION = "derivation"
    CHECKPOINT = "checkpoint"
    EXTERNAL = "external"
    RECORD = "record"


class EdgeKind:
    DERIVED_FROM = "derived_from"    # data -> data it came from
    PRODUCED_BY = "produced_by"      # data -> run that made it
    INPUT_TO = "input_to"            # data -> run that consumed it
    CONTAINS = "contains"            # version/snapshot -> record


@dataclass(frozen=True)
class LineageNode:
    node_id: str
    kind: str
    meta: Mapping[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"id": self.node_id, "kind": self.kind, "meta": dict(self.meta)}


@dataclass(frozen=True)
class LineageEdge:
    src: str
    dst: str
    kind: str
    timestamp: float = 0.0
    meta: Mapping[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"src": self.src, "dst": self.dst, "kind": self.kind,
               "ts": self.timestamp}
        if self.meta:
            out["meta"] = dict(self.meta)
        return out


class LineageGraph:
    """In-memory adjacency with write-through persistence.

    Persistence is a *segmented* append-only log: each :meth:`flush`
    writes only the dirty delta as a new ``lineage/seg/<n>`` metadata
    entry — O(new nodes/edges), not O(graph) — and :meth:`_load` replays
    the base log plus every segment, compacting them back into the base
    once enough accumulate.  (The pre-segment format — everything under
    ``lineage/log`` — still loads and becomes the compaction base.)
    """

    _KEY = "lineage/log"
    _SEG_PREFIX = "lineage/seg/"
    _COMPACT_AT = 64

    def __init__(self, store: Optional[ObjectStore] = None):
        self.store = store
        self._nodes: Dict[str, LineageNode] = {}
        self._out: Dict[str, List[LineageEdge]] = {}
        self._in: Dict[str, List[LineageEdge]] = {}
        self._log: List[dict] = []
        self._next_seg = 0
        self._load()

    # -- persistence -------------------------------------------------------------

    def _index_item(self, item: dict) -> None:
        if item["t"] == "node":
            self._index_node(
                LineageNode(item["id"], item["kind"], item.get("meta", {})))
        else:
            self._index_edge(
                LineageEdge(item["src"], item["dst"], item["kind"],
                            item.get("ts", 0.0), item.get("meta", {})))

    def _seg_key(self, seq: int) -> str:
        return f"{self._SEG_PREFIX}{seq:08d}"

    def pending_seg_key(self) -> str:
        """The segment key the next flush will (most likely) claim — lets
        a commit's meta-batch prefetch cover the flush's probe read."""
        return self._seg_key(self._next_seg)

    def _load(self) -> None:
        if self.store is None:
            return
        items = list(self.store.get_meta(self._KEY, default=[]))
        seg_names = sorted(self.store.list_meta(self._SEG_PREFIX))
        for seg_items in self.store.get_metas(seg_names):
            items.extend(seg_items or [])
        for item in items:
            self._index_item(item)
        if len(seg_names) >= self._COMPACT_AT:
            # Compact: fold every segment into the base log so the replay
            # list stays bounded; the delta-append invariant is per-flush.
            self.store.put_meta(self._KEY, items)
            for name in seg_names:
                self.store.delete_meta(name)
            seg_names = []
        self._next_seg = (
            int(seg_names[-1][len(self._SEG_PREFIX):]) + 1 if seg_names
            else 0)

    def flush(self) -> None:
        """Persist pending mutations as one delta segment (O(delta))."""
        if self.store is None or not self._log:
            return
        seq = self._next_seg
        # Another process may have appended since we loaded; probe forward
        # so we extend the log instead of overwriting their segment.
        while self.store.get_meta(self._seg_key(seq)) is not None:
            seq += 1
        self.store.put_meta(self._seg_key(seq), self._log)
        self._next_seg = seq + 1
        self._log.clear()

    # -- mutation -------------------------------------------------------------------

    def _index_node(self, node: LineageNode) -> None:
        self._nodes[node.node_id] = node

    def _index_edge(self, edge: LineageEdge) -> None:
        self._out.setdefault(edge.src, []).append(edge)
        self._in.setdefault(edge.dst, []).append(edge)

    def add_node(self, node_id: str, kind: str, **meta) -> LineageNode:
        node = LineageNode(node_id, kind, meta)
        self._index_node(node)
        self._log.append({"t": "node", **node.to_json()})
        return node

    def add_edge(self, src: str, dst: str, kind: str, **meta) -> LineageEdge:
        edge = LineageEdge(src, dst, kind, time.time(), meta)
        self._index_edge(edge)
        self._log.append({"t": "edge", **edge.to_json()})
        return edge

    # -- queries ------------------------------------------------------------------------

    def node(self, node_id: str) -> Optional[LineageNode]:
        return self._nodes.get(node_id)

    def nodes(self, kind: Optional[str] = None) -> List[LineageNode]:
        out = list(self._nodes.values())
        if kind is not None:
            out = [n for n in out if n.kind == kind]
        return out

    def edges_out(self, node_id: str, kind: Optional[str] = None) -> List[LineageEdge]:
        es = self._out.get(node_id, [])
        return [e for e in es if kind is None or e.kind == kind]

    def edges_in(self, node_id: str, kind: Optional[str] = None) -> List[LineageEdge]:
        es = self._in.get(node_id, [])
        return [e for e in es if kind is None or e.kind == kind]

    def _walk(self, start: str, direction: str,
              edge_kinds: Optional[Set[str]] = None) -> List[str]:
        seen: Set[str] = set()
        order: List[str] = []
        frontier = [start]
        while frontier:
            cur = frontier.pop()
            edges = self._out.get(cur, []) if direction == "out" else self._in.get(cur, [])
            for e in edges:
                if edge_kinds is not None and e.kind not in edge_kinds:
                    continue
                nxt = e.dst if direction == "out" else e.src
                if nxt not in seen:
                    seen.add(nxt)
                    order.append(nxt)
                    frontier.append(nxt)
        return order

    def ancestors(self, node_id: str) -> List[str]:
        """Everything this node was derived from / produced by / consumed.

        Convention: provenance edges point *from* the artifact *to* its
        origins (derived_from, produced_by, input_to inverse) — we walk OUT
        along derived_from/produced_by and IN along input_to.
        """
        up = set(self._walk(node_id, "out",
                            {EdgeKind.DERIVED_FROM, EdgeKind.PRODUCED_BY}))
        return sorted(up)

    def descendants(self, node_id: str) -> List[str]:
        """Everything that (transitively) came from this node."""
        down = set(self._walk(node_id, "in",
                              {EdgeKind.DERIVED_FROM, EdgeKind.PRODUCED_BY,
                               EdgeKind.CONTAINS}))
        down |= set(
            e.dst for e in self.edges_out(node_id, EdgeKind.INPUT_TO)
        )
        # input_to: artifact -> run; run's products are reached via produced_by
        frontier = list(down)
        while frontier:
            cur = frontier.pop()
            for e in self._in.get(cur, []):
                if e.kind == EdgeKind.PRODUCED_BY and e.src not in down:
                    down.add(e.src)
                    frontier.append(e.src)
            for e in self._out.get(cur, []):
                if e.kind == EdgeKind.INPUT_TO and e.dst not in down:
                    down.add(e.dst)
                    frontier.append(e.dst)
        down.discard(node_id)
        return sorted(down)

    def paths_between(self, src: str, dst: str, limit: int = 16) -> List[List[str]]:
        """Up to ``limit`` simple derivation paths src -> ... -> dst."""
        results: List[List[str]] = []

        def dfs(cur: str, path: List[str]) -> None:
            if len(results) >= limit:
                return
            if cur == dst:
                results.append(list(path))
                return
            for e in self._in.get(cur, []):
                if e.src not in path:
                    path.append(e.src)
                    dfs(e.src, path)
                    path.pop()

        dfs(src, [src])
        return results

    def versions_containing(self, record_id: str) -> List[str]:
        """All dataset versions/snapshots that CONTAIN a record (revocation)."""
        rec_node = f"record:{record_id}"
        return sorted(
            e.src for e in self._in.get(rec_node, []) if e.kind == EdgeKind.CONTAINS
        )

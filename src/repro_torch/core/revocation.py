"""Data revocation — remove a record everywhere it propagated.

Paper, Key Features / use-cases: "Data revocation".

Revoking a record (GDPR-delete style) must do three things:

1. **Logical removal going forward** — every branch head whose manifest
   contains the record gets a new commit without it.
2. **Physical removal** — the record's blob chunks are tombstoned in the CAS
   (old versions become *partially unreadable by design* for that record;
   history is preserved, the payload is not).  A blob shared byte-identically
   by another record id is retained and reported instead of deleted.
3. **Impact report** — the lineage graph is consulted for every downstream
   snapshot / derived version / checkpoint that ingested the record, because
   those artifacts may need re-materialization or retraining.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .dataset import DatasetManager, version_node_id
from .lineage import EdgeKind, NodeKind
from .store import NotFoundError

__all__ = ["RevocationReport", "RevocationEngine", "RevokedError"]


class RevokedError(NotFoundError):
    """Payload was revoked; manifests still name the record, bytes are gone."""


@dataclass
class RevocationReport:
    record_id: str
    actor: str
    reason: str
    timestamp: float
    affected_versions: List[Tuple[str, str]] = field(default_factory=list)
    new_head_commits: Dict[str, str] = field(default_factory=dict)
    blobs_deleted: List[str] = field(default_factory=list)
    blobs_retained_shared: List[str] = field(default_factory=list)
    downstream_snapshots: List[str] = field(default_factory=list)
    downstream_checkpoints: List[str] = field(default_factory=list)
    downstream_other: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "record_id": self.record_id,
            "actor": self.actor,
            "reason": self.reason,
            "ts": self.timestamp,
            "affected_versions": self.affected_versions,
            "new_head_commits": self.new_head_commits,
            "blobs_deleted": self.blobs_deleted,
            "blobs_retained_shared": self.blobs_retained_shared,
            "downstream_snapshots": self.downstream_snapshots,
            "downstream_checkpoints": self.downstream_checkpoints,
            "downstream_other": self.downstream_other,
        }


class RevocationEngine:
    _TOMBSTONES = "revocation/tombstones"
    _LOG = "revocation/log"

    def __init__(self, dm: DatasetManager):
        self.dm = dm

    # -- tombstone bookkeeping -------------------------------------------------

    def tombstones(self) -> Dict[str, dict]:
        return self.dm.store.get_meta(self._TOMBSTONES, default={})

    def is_revoked(self, record_id: str) -> bool:
        return record_id in self.tombstones()

    # -- the main entry point ------------------------------------------------------

    def revoke(self, record_id: str, actor: str, reason: str = "") -> RevocationReport:
        dm = self.dm
        report = RevocationReport(record_id, actor, reason, time.time())

        affected = dm.versions_with_record(record_id)
        report.affected_versions = affected
        datasets = sorted({ds for ds, _ in affected})

        # ACL: revocation is an ADMIN action on every affected dataset.
        for ds in datasets:
            dm.acl.check(actor, "ADMIN", ds, note=f"revoke:{record_id}")

        # Collect the digests this record maps to anywhere, and whether any
        # *other* record id shares those bytes.
        digests: Set[str] = set()
        shared: Set[str] = set()
        for ds, cid in affected:
            man = dm.versions.get_manifest(dm.versions.get_commit(cid).tree)
            entry = man.get(record_id)
            if entry is not None:
                digests.add(entry.blob.digest)
        for ds in dm.list_datasets():
            for cid in dm.versions.list_commits(ds):
                man = dm.versions.get_manifest(dm.versions.get_commit(cid).tree)
                for e in man.entries():
                    if e.record_id != record_id and e.blob.digest in digests:
                        shared.add(e.blob.digest)

        # 1. Logical removal on every branch head that still contains it.
        for ds in datasets:
            for branch in dm.versions.list_branches(ds):
                head = dm.versions.get_branch(ds, branch)
                if head is None:
                    continue
                man = dm.versions.get_manifest(dm.versions.get_commit(head).tree)
                if record_id in man:
                    commit = dm.check_in(
                        ds, [], actor,
                        message=f"revoke {record_id}: {reason}",
                        branch=branch, remove_ids=[record_id],
                        meta={"revocation": record_id},
                    )
                    report.new_head_commits[f"{ds}@{branch}"] = commit.commit_id

        # 2. Physical removal (respect byte-identical sharing).  All doomed
        # payloads drop in one grouped backend delete instead of one
        # round trip per digest.
        report.blobs_retained_shared = sorted(digests & shared)
        report.blobs_deleted = sorted(digests - shared)
        dm.store.delete_blobs(report.blobs_deleted)

        # 3. Downstream impact via lineage.
        impacted: Set[str] = set()
        for ds, cid in affected:
            impacted.update(dm.lineage.descendants(version_node_id(ds, cid)))
        for node_id in sorted(impacted):
            node = dm.lineage.node(node_id)
            kind = node.kind if node else "unknown"
            if kind == NodeKind.SNAPSHOT:
                report.downstream_snapshots.append(node_id)
            elif kind == NodeKind.CHECKPOINT:
                report.downstream_checkpoints.append(node_id)
            else:
                report.downstream_other.append(node_id)

        # Bookkeeping: tombstone + persistent revocation log + lineage event,
        # batched into one meta flush.  The check_ins and the physical
        # delete_blobs above stay OUTSIDE the scope: payload deletion must
        # not be deferrable or replayed from a staged buffer.
        with dm.store.meta_batch(prefetch=[
                self._TOMBSTONES, self._LOG,
                dm.lineage.pending_seg_key()]):
            stones = self.tombstones()
            stones[record_id] = {
                "ts": report.timestamp, "actor": actor, "reason": reason,
                "digests": sorted(digests),
            }
            dm.store.put_meta(self._TOMBSTONES, stones)
            log = dm.store.get_meta(self._LOG, default=[])
            log.append(report.to_json())
            dm.store.put_meta(self._LOG, log)
            ev = f"revocation:{record_id}:{int(report.timestamp)}"
            dm.lineage.add_node(ev, NodeKind.EXTERNAL,
                                kind_detail="revocation",
                                record=record_id, actor=actor)
            dm.lineage.flush()
        return report

    # -- read-side integration ------------------------------------------------------

    def read_or_raise(self, dataset: str, record_id: str, actor: str,
                      rev: str = "main") -> bytes:
        """Read a record, raising :class:`RevokedError` if it was revoked."""
        if self.is_revoked(record_id):
            raise RevokedError(f"record {record_id!r} was revoked")
        return self.dm.read_record(dataset, record_id, actor, rev=rev)

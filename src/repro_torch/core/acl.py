"""Access control & security — enforced at check-in / checkout time.

Paper: "The dataset manager enforces access control and permissions at the
time of data check-in/checkout."

Model
-----
- Principals are user ids (or service accounts — automated triggers act as
  principals too, per Fig. 2's "actor" box).
- Groups own sets of principals.
- Permissions are grants ``(principal-or-group, dataset-pattern, action)``
  where actions form a lattice: ADMIN > WRITE > READ.  Dataset patterns are
  glob-ish (``*`` suffix wildcard) so namespaces like ``speech/*`` work.
- Every allow/deny decision is appended to an audit log (persisted via the
  store's meta namespace so it survives restarts).  The log is stored as
  *delta segments* (``audit/seg/NNNNNNNN``) like the lineage log: a flush
  writes only the buffered events as one new write-once segment — O(new),
  never O(history) — and rides the commit meta batch; ``audit_log()``
  folds the segments onto the legacy ``acl/audit`` base list and compacts
  once enough segments pile up.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Set

from .store import ObjectStore

__all__ = ["Action", "PermissionError_", "AccessController", "AuditEvent"]


class Action(IntEnum):
    READ = 1
    WRITE = 2
    ADMIN = 3

    @staticmethod
    def parse(name) -> "Action":
        if isinstance(name, Action):
            return name
        return Action[str(name).upper()]


class PermissionError_(PermissionError):
    """Raised when an actor lacks permission (distinct from builtins name)."""


@dataclass
class AuditEvent:
    timestamp: float
    actor: str
    action: str
    dataset: str
    allowed: bool
    note: str = ""

    def to_json(self) -> dict:
        return {
            "ts": self.timestamp,
            "actor": self.actor,
            "action": self.action,
            "dataset": self.dataset,
            "allowed": self.allowed,
            "note": self.note,
        }


@dataclass
class _Grant:
    subject: str          # principal or "group:<name>"
    pattern: str          # dataset name pattern
    action: Action

    def to_json(self) -> dict:
        return {"subject": self.subject, "pattern": self.pattern,
                "action": int(self.action)}

    @staticmethod
    def from_json(o: dict) -> "_Grant":
        return _Grant(o["subject"], o["pattern"], Action(o["action"]))


class AccessController:
    """Grant store + decision point + audit log.

    ``open_world=True`` (default for library embedding) means datasets with
    *no grants at all* are readable/writable by anyone — convenient for
    tests and single-user use.  Production configs set ``open_world=False``.
    """

    _GRANTS_KEY = "acl/grants"
    _GROUPS_KEY = "acl/groups"
    _AUDIT_KEY = "acl/audit"              # legacy full list = compaction base
    _AUDIT_SEG_PREFIX = "audit/seg/"
    _COMPACT_AT = 64                      # fold segments into the base list

    def __init__(self, store: Optional[ObjectStore] = None, open_world: bool = True):
        self.store = store
        self.open_world = open_world
        self._grants: List[_Grant] = []
        self._groups: Dict[str, Set[str]] = {}
        self._audit: List[AuditEvent] = []
        self._next_audit_seg = 0
        self._load()

    # -- persistence -----------------------------------------------------------

    def _load(self) -> None:
        if self.store is None:
            return
        grants, groups = self.store.get_metas(
            [self._GRANTS_KEY, self._GROUPS_KEY])
        for g in grants or []:
            self._grants.append(_Grant.from_json(g))
        for name, members in (groups or {}).items():
            self._groups[name] = set(members)
        # Seed the next segment sequence once at load; flush still probes
        # forward from here (another process may append concurrently).
        seg_names = sorted(self.store.list_meta(self._AUDIT_SEG_PREFIX))
        if seg_names:
            self._next_audit_seg = \
                int(seg_names[-1][len(self._AUDIT_SEG_PREFIX):]) + 1

    def _save(self) -> None:
        if self.store is None:
            return
        self.store.put_meta(self._GRANTS_KEY, [g.to_json() for g in self._grants])
        self.store.put_meta(
            self._GROUPS_KEY, {k: sorted(v) for k, v in self._groups.items()}
        )

    # -- administration ----------------------------------------------------------

    def grant(self, subject: str, pattern: str, action) -> None:
        self._grants.append(_Grant(subject, pattern, Action.parse(action)))
        self._save()

    def revoke_grant(self, subject: str, pattern: str) -> None:
        self._grants = [
            g for g in self._grants
            if not (g.subject == subject and g.pattern == pattern)
        ]
        self._save()

    def add_to_group(self, group: str, principal: str) -> None:
        self._groups.setdefault(group, set()).add(principal)
        self._save()

    def remove_from_group(self, group: str, principal: str) -> None:
        self._groups.get(group, set()).discard(principal)
        self._save()

    # -- decisions ------------------------------------------------------------------

    def _subjects_for(self, actor: str) -> Set[str]:
        subjects = {actor, "*"}
        for group, members in self._groups.items():
            if actor in members:
                subjects.add(f"group:{group}")
        return subjects

    def _has_any_grant(self, dataset: str) -> bool:
        return any(fnmatch.fnmatch(dataset, g.pattern) for g in self._grants)

    def is_allowed(self, actor: str, action, dataset: str) -> bool:
        action = Action.parse(action)
        if not self._has_any_grant(dataset):
            return self.open_world
        subjects = self._subjects_for(actor)
        for g in self._grants:
            if g.subject in subjects and fnmatch.fnmatch(dataset, g.pattern):
                if g.action >= action:
                    return True
        return False

    def check(self, actor: str, action, dataset: str, note: str = "") -> None:
        """Decision point — raises on deny, records audit either way."""
        action = Action.parse(action)
        allowed = self.is_allowed(actor, action, dataset)
        ev = AuditEvent(time.time(), actor, action.name, dataset, allowed, note)
        self._audit.append(ev)
        if self.store is not None and len(self._audit) >= 64:
            self.flush_audit()
        if not allowed:
            raise PermissionError_(
                f"actor {actor!r} denied {action.name} on dataset {dataset!r}"
            )

    # -- audit ---------------------------------------------------------------------

    def _audit_seg_key(self, seq: int) -> str:
        return f"{self._AUDIT_SEG_PREFIX}{seq:08d}"

    def pending_seg_key(self) -> str:
        """The segment key the next flush will (most likely) claim — lets
        a commit's meta-batch prefetch cover the flush's probe read."""
        return self._audit_seg_key(self._next_audit_seg)

    def flush_audit(self) -> None:
        """Persist buffered events as ONE new delta segment — O(new), not
        O(history).  Write-once: the segment key is claimed by probing
        forward, so concurrent appenders never overwrite each other, and
        the write batches freely inside a commit meta batch."""
        if self.store is None or not self._audit:
            return
        seq = self._next_audit_seg
        while self.store.get_meta(self._audit_seg_key(seq)) is not None:
            seq += 1
        self.store.put_meta(self._audit_seg_key(seq),
                            [e.to_json() for e in self._audit])
        self._next_audit_seg = seq + 1
        self._audit.clear()

    def audit_log(self) -> List[dict]:
        """Full decision history: legacy base list + every delta segment +
        the not-yet-flushed buffer.  Reading is also when segments compact
        (fold into the base, delete the segment keys) once ``_COMPACT_AT``
        pile up — the lineage log's pattern."""
        if self.store is None:
            return [e.to_json() for e in self._audit]
        events: List[dict] = list(
            self.store.get_meta(self._AUDIT_KEY, default=[]))
        seg_names = sorted(self.store.list_meta(self._AUDIT_SEG_PREFIX))
        for items in self.store.get_metas(seg_names):
            events.extend(items or [])
        if len(seg_names) >= self._COMPACT_AT:
            self.store.put_meta(self._AUDIT_KEY, events)
            for name in seg_names:
                self.store.delete_meta(name)
            self._next_audit_seg = 0
        return events + [e.to_json() for e in self._audit]

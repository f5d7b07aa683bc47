"""repro_torch.core — the paper's contribution: a dataset management platform.

The supported public entry point is :class:`repro_torch.platform.Platform`
(``Platform.open(...)`` + dataset/version handles).  The pieces below are
its engine, importable directly for embedding and tests:

- Storage engine (source of truth): :class:`ObjectStore` over pluggable
  :class:`StorageBackend`s (memory / filesystem).
- Versioning: :class:`VersionStore` (commits, branches, tags, diff, merge).
- Dataset manager: :class:`DatasetManager` (check-in/checkout, tags, query,
  ACL enforcement).
- Access control: :class:`AccessController`.
- Transformation: :class:`Component` / :class:`Pipeline` (+ human tasks).
- Derivation engine: :class:`DerivationEngine` (content-addressed
  derivation cache, incremental recompute, streaming sharded execution).
- Workflow manager: :class:`WorkflowManager` (triggers, scheduling,
  straggler-tolerant sharded runs on the derivation engine).
- Lineage: :class:`LineageGraph`; revocation: :class:`RevocationEngine`.
"""

from .acl import AccessController, Action, PermissionError_
from .dataset import CheckoutPlan, DatasetManager, Record, Snapshot
from .derive import (Derivation, DerivationCache, DerivationEngine,
                     DerivationResult, ExecPolicy, get_pipeline,
                     register_pipeline, registered_pipelines)
from .index import AttributeIndex, PagedAttributeIndex
from .lineage import EdgeKind, LineageGraph, NodeKind
from .query import (ALL, And, Cmp, Not, Or, Query, QueryParseError, attr,
                    parse_where, record_id_in, tag_in)
from .revocation import RevocationEngine, RevocationReport, RevokedError
from .store import (BlobRef, CommitConflictError, FileBackend,
                    IntegrityError, MemoryBackend, NotFoundError,
                    ObjectStore, StorageBackend)
from .transforms import (BatchComponent, Component, FilterComponent,
                         FlatMapComponent, HumanTask, HumanTaskQueue,
                         MapComponent, Pipeline, ProgramComponent,
                         WaitingForHuman, code_fingerprint, component)
from .versioning import (Commit, Manifest, MergeConflict, PageDirectory,
                         PagedManifest, RecordEntry, VersionDiff,
                         VersionStore)
from .workflow import (RunState, ShardReport, Workflow, WorkflowManager,
                       WorkflowRun)

__all__ = [
    "AccessController", "Action", "PermissionError_",
    "CheckoutPlan", "DatasetManager", "Record", "Snapshot",
    "Derivation", "DerivationCache", "DerivationEngine", "DerivationResult",
    "ExecPolicy", "get_pipeline", "register_pipeline",
    "registered_pipelines",
    "ALL", "And", "Cmp", "Not", "Or", "Query", "QueryParseError", "attr",
    "parse_where", "record_id_in", "tag_in",
    "EdgeKind", "LineageGraph", "NodeKind",
    "RevocationEngine", "RevocationReport", "RevokedError",
    "AttributeIndex", "PagedAttributeIndex",
    "BlobRef", "CommitConflictError", "FileBackend", "IntegrityError",
    "MemoryBackend", "NotFoundError", "ObjectStore", "StorageBackend",
    "BatchComponent", "Component", "FilterComponent", "FlatMapComponent",
    "HumanTask", "HumanTaskQueue", "MapComponent", "Pipeline",
    "ProgramComponent", "WaitingForHuman", "code_fingerprint", "component",
    "Commit", "Manifest", "MergeConflict", "PageDirectory", "PagedManifest",
    "RecordEntry", "VersionDiff", "VersionStore",
    "RunState", "ShardReport", "Workflow", "WorkflowManager", "WorkflowRun",
]

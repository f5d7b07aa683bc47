"""Workflow manager — registration, resource allocation, scheduling, runs.

Paper: "A user that uses the data management platform can register their
workflow to the workflow manager.  The workflow manager allocates resources,
schedules runs, and reports results. ... The workflow manager allocates
computing resources to the computing components of a workflow to support
large scale data processing.  The lineage of data is also tracked."

Triggers (paper, Key Features): manual, by event (new dataset version), and
by time schedule.

Execution model
---------------
A run builds the workflow's input :class:`~repro_torch.core.dataset.CheckoutPlan`
and hands it to the :class:`~repro_torch.core.derive.DerivationEngine`, which
owns sharded streaming execution (bounded batched payload reads), retries
with exponential backoff, speculative duplicates for stragglers (MapReduce
backup tasks — first finisher wins, sound because components are
deterministic), and the derivation cache: a re-run on an identical
(commit, query, pipeline) triple succeeds instantly with the cached output
commit, and a re-run on changed input recomputes only the changed records
for per-record stages.  Runs that hit a
:class:`~repro_torch.core.transforms.WaitingForHuman` park in ``WAITING_HUMAN``
and resume via :meth:`WorkflowManager.resume` (completed per-record work
is reused from the engine's prefix memo, not re-run).
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from .dataset import DatasetManager, Record
from .derive import DerivationEngine, ExecPolicy, ShardReport
from .lineage import EdgeKind, NodeKind
from .transforms import Pipeline, WaitingForHuman
from .versioning import Commit

__all__ = ["Workflow", "WorkflowRun", "RunState", "WorkflowManager",
           "ShardReport"]


class RunState:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    WAITING_HUMAN = "WAITING_HUMAN"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"


@dataclass
class Workflow:
    """A registered workflow: input query -> pipeline -> output spec.

    ``input_where`` is a declarative :class:`~repro_torch.core.query.Query` (a
    CLI-style string or query-JSON dict also works — same algebra the CLI
    uses, so a workflow's input query can be logged, fingerprinted, and
    reproduced from the command line verbatim).  ``input_attrs_equal`` is
    the legacy exact-match shorthand; both are ANDed if given.
    """

    name: str
    pipeline: Pipeline
    input_dataset: str
    input_rev: str = "main"
    input_where: Optional[object] = None
    input_attrs_equal: Optional[Mapping[str, object]] = None
    # If set, output records are checked in as a new version of this dataset
    # ("the new version of data in snapshot 3 is committed to the data
    # repository for future use" — Fig. 1 pipeline Y).  If None the output
    # snapshot is only materialized (Fig. 1 pipelines X and Z).
    output_dataset: Optional[str] = None
    output_message: str = ""
    n_shards: int = 4
    max_retries: int = 2
    speculative_factor: float = 3.0
    min_speculative_wait_s: float = 0.05
    actor: str = "workflow-manager"

    # triggers
    trigger_on_commit_to: Optional[str] = None
    trigger_every_s: Optional[float] = None


@dataclass
class WorkflowRun:
    run_id: str
    workflow: str
    state: str = RunState.PENDING
    started_at: float = 0.0
    finished_at: float = 0.0
    input_commit: str = ""
    input_snapshot: str = ""
    output_commit: Optional[str] = None
    output_records: List[Record] = field(default_factory=list)
    shard_reports: List[ShardReport] = field(default_factory=list)
    waiting_task: Optional[str] = None
    error: str = ""
    trigger: str = "manual"
    derivation_key: Optional[str] = None
    cache_hit: bool = False
    n_outputs: int = 0

    def report(self) -> dict:
        """The paper's "reports results"."""
        return {
            "run_id": self.run_id,
            "workflow": self.workflow,
            "state": self.state,
            "trigger": self.trigger,
            "duration_s": max(0.0, self.finished_at - self.started_at),
            "input_commit": self.input_commit,
            "output_commit": self.output_commit,
            "derivation_key": self.derivation_key,
            "cache_hit": self.cache_hit,
            "n_output_records": max(self.n_outputs, len(self.output_records)),
            "shards": [
                {"shard": s.shard, "attempts": s.attempts,
                 "speculative": s.speculative, "duration_s": round(s.duration_s, 6),
                 "in": s.n_in, "out": s.n_out, "error": s.error}
                for s in self.shard_reports
            ],
            "error": self.error,
        }


class WorkflowManager:
    """Core module #2 of the platform (Fig. 2)."""

    def __init__(self, dm: DatasetManager, worker_slots: int = 8):
        self.dm = dm
        self.worker_slots = worker_slots
        # Runs execute on the shared derivation engine (cache + incremental
        # recompute + streaming shards); one per manager, like this class.
        self.engine = DerivationEngine.for_manager(dm,
                                                   worker_slots=worker_slots)
        self._workflows: Dict[str, Workflow] = {}
        self._runs: Dict[str, WorkflowRun] = {}
        self._parked: Dict[str, Tuple[Workflow, WorkflowRun]] = {}
        self._timers: List[dict] = []
        self._lock = threading.Lock()
        dm.on_commit(self._on_commit)
        # Backref so facades over the same manager reuse one WorkflowManager
        # instead of stacking commit listeners (double-firing triggers).
        dm._workflow_manager = self

    # ------------------------------------------------------------ registration

    def register(self, workflow: Workflow) -> None:
        self._workflows[workflow.name] = workflow

    def workflows(self) -> List[str]:
        return sorted(self._workflows)

    def runs(self, workflow: Optional[str] = None) -> List[WorkflowRun]:
        out = list(self._runs.values())
        if workflow is not None:
            out = [r for r in out if r.workflow == workflow]
        return sorted(out, key=lambda r: r.started_at)

    def get_run(self, run_id: str) -> WorkflowRun:
        return self._runs[run_id]

    # ------------------------------------------------------------ triggers

    def _on_commit(self, dataset: str, commit: Commit) -> None:
        """Event trigger: new dataset version."""
        if commit.meta.get("_workflow_output"):
            return  # don't let a workflow's own output re-trigger it (loops)
        for wf in list(self._workflows.values()):
            if wf.trigger_on_commit_to == dataset:
                self.run(wf.name, trigger=f"event:commit:{dataset}")

    def tick(self, now: Optional[float] = None) -> List[str]:
        """Advance time-based schedules; returns run ids started.

        Deterministic/manual clock for tests; a daemon thread can call this
        periodically in production (see :meth:`start_clock`).
        """
        now = time.time() if now is None else now
        started = []
        for wf in self._workflows.values():
            if wf.trigger_every_s is None:
                continue
            entry = next((t for t in self._timers if t["wf"] == wf.name), None)
            if entry is None:
                entry = {"wf": wf.name, "last": now}
                self._timers.append(entry)
                continue
            if now - entry["last"] >= wf.trigger_every_s:
                entry["last"] = now
                run = self.run(wf.name, trigger="schedule")
                started.append(run.run_id)
        return started

    def start_clock(self, period_s: float = 1.0) -> threading.Thread:
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                self.tick()
                stop.wait(period_s)

        t = threading.Thread(target=loop, daemon=True)
        t.stop = stop  # type: ignore[attr-defined]
        t.start()
        return t

    # ------------------------------------------------------------ execution

    def run(self, workflow_name: str, trigger: str = "manual") -> WorkflowRun:
        wf = self._workflows[workflow_name]
        run = WorkflowRun(run_id=f"run-{uuid.uuid4().hex[:12]}",
                          workflow=wf.name, trigger=trigger)
        self._runs[run.run_id] = run
        self._execute(wf, run)
        return run

    def resume(self, run_id: str) -> WorkflowRun:
        """Resume a run parked on a human task (after completion)."""
        wf, run = self._parked.pop(run_id)
        self._execute(wf, run)
        return run

    def _policy(self, wf: Workflow) -> ExecPolicy:
        return ExecPolicy(
            n_shards=wf.n_shards,
            max_retries=wf.max_retries,
            speculative_factor=wf.speculative_factor,
            min_speculative_wait_s=wf.min_speculative_wait_s,
        )

    def _execute(self, wf: Workflow, run: WorkflowRun) -> None:
        run.state = RunState.RUNNING
        run.started_at = time.time()
        lineage = self.dm.lineage
        try:
            plan = self.dm.plan_checkout(
                wf.input_dataset, wf.actor, rev=wf.input_rev,
                where=wf.input_where, attrs_equal=wf.input_attrs_equal,
            )
            snap = plan.snapshot()
            run.input_commit = snap.commit_id
            run.input_snapshot = snap.snapshot_id

            run_node = f"workflow_run:{run.run_id}"
            lineage.add_node(run_node, NodeKind.WORKFLOW_RUN,
                             workflow=wf.name,
                             pipeline=wf.pipeline.fingerprint(),
                             input_query=plan.query_digest(),
                             trigger=run.trigger)
            lineage.add_edge(snap.snapshot_id, run_node, EdgeKind.INPUT_TO)
            lineage.flush()

            result = self.engine.derive(
                plan, wf.pipeline,
                output_dataset=wf.output_dataset,
                actor=wf.actor,
                message=wf.output_message or f"output of {wf.name}",
                policy=self._policy(wf),
                derived_from=[snap.snapshot_id],
                produced_by=run_node,
                commit_meta={"_workflow_output": wf.name,
                             "run_id": run.run_id},
                run_id=run.run_id,
            )
            run.derivation_key = result.key
            run.cache_hit = result.cache_hit
            run.n_outputs = result.n_outputs
            run.shard_reports = result.shard_reports
            # Keep the WorkflowRun contract: every executed run exposes
            # its output records (incremental runs fetch reused payloads
            # from the output commit).  Cache-hit runs did no work and
            # stay lazy — read the cached version via checkout instead.
            run.output_records = ([] if result.cache_hit
                                  else self.engine.load_output_records(result))
            run.output_commit = result.output_commit
            if result.cache_hit:
                # The run did no work: its result *is* the cached
                # derivation.  Annotate provenance accordingly.
                lineage.add_edge(run_node, result.node_id,
                                 EdgeKind.DERIVED_FROM, cache_hit=True)
                lineage.flush()
            run.state = RunState.SUCCEEDED
        except WaitingForHuman as wfh:
            run.state = RunState.WAITING_HUMAN
            run.waiting_task = wfh.task_id
            self._parked[run.run_id] = (wf, run)
        except Exception as e:  # noqa: BLE001 - run isolation is the point
            run.state = RunState.FAILED
            run.error = f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=4)}"
        finally:
            run.finished_at = time.time()

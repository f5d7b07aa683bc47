"""Dataset transformation components and pipelines.

Paper: "Individual modules in a pipeline are shareable, reusable, and
chainable.  A pipeline operates similar to the extract-transform-load (ETL)
pipelines common in big data applications but is more specific to machine
learning use cases.  A pipeline is lightweight to implement (e.g., is
implemented via a few lines of Python code), enables quick iteration, and is
easy to run."  and: "There are two types of components: program based data
processing unit and human work based data processing unit."

The contract: a :class:`Component` maps a stream of :class:`Record`s to a
stream of :class:`Record`s.  Components are deterministic given (config,
seed, input) so a pipeline re-run on the same snapshot produces the same
output digest — which is what makes speculative/straggler re-execution and
caching sound in the workflow manager.
"""

from __future__ import annotations

import hashlib
import json
import time
import types
import uuid
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

from .dataset import Record, Snapshot

__all__ = [
    "Component",
    "ProgramComponent",
    "MapComponent",
    "FilterComponent",
    "FlatMapComponent",
    "BatchComponent",
    "HumanTask",
    "HumanTaskQueue",
    "WaitingForHuman",
    "Pipeline",
    "component",
    "code_fingerprint",
]


def _feed_code(h, code: types.CodeType, seen: set) -> None:
    """Hash a code object's behavior-bearing parts (bytecode, names,
    consts — nested code objects recursively)."""
    if id(code) in seen:
        return
    seen.add(id(code))
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr(code.co_varnames).encode())
    for const in code.co_consts:
        _feed_value(h, const, seen)


def _feed_value(h, value, seen: set) -> None:
    if isinstance(value, types.CodeType):
        _feed_code(h, value, seen)
    elif isinstance(value, types.FunctionType):
        _feed_function(h, value, seen)
    elif isinstance(value, (str, bytes, int, float, bool, complex,
                            type(None))):
        h.update(repr(value).encode())
    elif isinstance(value, tuple):
        for v in value:
            _feed_value(h, v, seen)
    elif isinstance(value, frozenset):
        # Iteration order varies with per-process string-hash
        # randomization, so hash the *sorted element digests* — stable
        # across processes, order-free.
        h.update(b"{" + b"".join(sorted(_value_digest(v, seen)
                                        for v in value)) + b"}")
    else:
        # Mutable containers (dict/list/set) and arbitrary objects hash by
        # type only — deliberately.  Components routinely capture mutable
        # state that changes *while the pipeline runs* (stats counters,
        # caches); folding its contents into the identity would give the
        # same pipeline a new fingerprint after every execution and defeat
        # the derivation cache.  The cost: editing a value inside a
        # captured mutable container is invisible to the fingerprint —
        # capture immutable values (or pass them as component config) for
        # cache-busting edits.
        h.update(type(value).__qualname__.encode())


def _value_digest(value, seen: set) -> bytes:
    sub = hashlib.sha256()
    _feed_value(sub, value, seen)
    return sub.digest()


def _feed_function(h, fn, seen: set) -> None:
    code = getattr(fn, "__code__", None)
    if code is None:
        # builtins / callables without code: identity is their name
        h.update(getattr(fn, "__qualname__", repr(type(fn))).encode())
        return
    _feed_code(h, code, seen)
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            _feed_value(h, cell.cell_contents, seen)
        except ValueError:  # pragma: no cover — unfilled cell
            pass
    for default in (getattr(fn, "__defaults__", None) or ()):
        _feed_value(h, default, seen)


def code_fingerprint(fn: Callable) -> str:
    """Deterministic digest of a callable's bytecode, consts, names,
    closure values and defaults — stable across processes for identical
    source (same interpreter version), different whenever the body is
    edited in place."""
    h = hashlib.sha256()
    _feed_function(h, fn, set())
    return h.hexdigest()[:16]


class Component(ABC):
    """One processing unit in a pipeline (a gray block in Fig. 1).

    ``per_record`` declares that :meth:`process` maps each input record to
    its outputs independently of every other record (no cross-record
    state).  The derivation engine may then recompute only changed records
    on a re-run, reusing prior outputs for the rest; stages that batch,
    dedup, or wait on humans must leave it ``False``.
    """

    name: str = "component"
    per_record: bool = False
    # Wrapped-callable attributes whose code objects join the fingerprint.
    _CODE_ATTRS = ("fn", "pred")

    def __init__(self, name: Optional[str] = None, **config) -> None:
        if name is not None:
            self.name = name
        self.config: Dict[str, object] = config

    @abstractmethod
    def process(self, records: Iterable[Record], ctx: "RunContext"
                ) -> Iterator[Record]: ...

    def fingerprint(self) -> str:
        """Digest of (type, name, config, wrapped code) — cache / lineage
        identity.

        Components that wrap a user callable (``fn`` / ``pred``) also hash
        its bytecode and consts, so a transform edited *in place* — same
        name, new body — changes the pipeline fingerprint and forces a
        recompute instead of silently reusing a stale derivation cache.
        Library components (their behavior is their type + config) hash
        nothing extra and keep their historical fingerprints.
        """
        body = {"type": type(self).__name__, "name": self.name,
                "config": {k: repr(v)
                           for k, v in sorted(self.config.items())}}
        code = {attr: code_fingerprint(getattr(self, attr))
                for attr in self._CODE_ATTRS
                if callable(getattr(self, attr, None))}
        if code:
            body["code"] = code
        blob = json.dumps(body, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # Chaining sugar: ``a | b | c`` builds a Pipeline.
    def __or__(self, other: Union["Component", "Pipeline"]) -> "Pipeline":
        if isinstance(other, Pipeline):
            return Pipeline([self, *other.components])
        return Pipeline([self, other])


@dataclass
class RunContext:
    """Carries run-scoped state into components."""

    run_id: str = "interactive"
    seed: int = 0
    shard_index: int = 0
    n_shards: int = 1
    stats: Dict[str, float] = field(default_factory=dict)

    def bump(self, key: str, amount: float = 1.0) -> None:
        self.stats[key] = self.stats.get(key, 0.0) + amount


# ---------------------------------------------------------------------------
# Program-based processing units
# ---------------------------------------------------------------------------


class ProgramComponent(Component):
    """Wraps a user function over the whole stream."""

    def __init__(self, fn: Callable[[Iterable[Record], RunContext], Iterator[Record]],
                 name: Optional[str] = None, **config) -> None:
        super().__init__(name=name or fn.__name__, **config)
        self.fn = fn

    def process(self, records, ctx):
        return self.fn(records, ctx)


class MapComponent(Component):
    """record -> record."""

    per_record = True

    def __init__(self, fn: Callable[[Record], Record], name: Optional[str] = None,
                 **config) -> None:
        super().__init__(name=name or f"map:{fn.__name__}", **config)
        self.fn = fn

    def process(self, records, ctx):
        for rec in records:
            ctx.bump(f"{self.name}.in")
            out = self.fn(rec)
            ctx.bump(f"{self.name}.out")
            yield out


class FilterComponent(Component):
    """record -> keep?"""

    per_record = True

    def __init__(self, pred: Callable[[Record], bool], name: Optional[str] = None,
                 **config) -> None:
        super().__init__(name=name or f"filter:{pred.__name__}", **config)
        self.pred = pred

    def process(self, records, ctx):
        for rec in records:
            ctx.bump(f"{self.name}.in")
            if self.pred(rec):
                ctx.bump(f"{self.name}.kept")
                yield rec


class FlatMapComponent(Component):
    """record -> 0..n records (splitting documents, augmentation...)."""

    per_record = True

    def __init__(self, fn: Callable[[Record], Iterable[Record]],
                 name: Optional[str] = None, **config) -> None:
        super().__init__(name=name or f"flatmap:{fn.__name__}", **config)
        self.fn = fn

    def process(self, records, ctx):
        for rec in records:
            ctx.bump(f"{self.name}.in")
            for out in self.fn(rec):
                ctx.bump(f"{self.name}.out")
                yield out


class BatchComponent(Component):
    """batch(list[record]) -> list[record]; for vectorized transforms."""

    def __init__(self, fn: Callable[[List[Record]], List[Record]],
                 batch_size: int = 256, name: Optional[str] = None,
                 **config) -> None:
        super().__init__(name=name or f"batch:{fn.__name__}",
                         batch_size=batch_size, **config)
        self.fn = fn
        self.batch_size = batch_size

    def process(self, records, ctx):
        buf: List[Record] = []
        for rec in records:
            buf.append(rec)
            if len(buf) >= self.batch_size:
                for out in self.fn(buf):
                    yield out
                buf = []
        if buf:
            for out in self.fn(buf):
                yield out


def component(fn=None, *, kind: str = "map", **config):
    """Decorator: turn a plain function into a Component ("a few lines of
    Python code" — paper)."""

    def wrap(f):
        if kind == "map":
            return MapComponent(f, **config)
        if kind == "filter":
            return FilterComponent(f, **config)
        if kind == "flatmap":
            return FlatMapComponent(f, **config)
        if kind == "stream":
            return ProgramComponent(f, **config)
        raise ValueError(f"unknown component kind {kind!r}")

    return wrap if fn is None else wrap(fn)


# ---------------------------------------------------------------------------
# Human-work-based processing units
# ---------------------------------------------------------------------------


class WaitingForHuman(Exception):
    """Raised by a pipeline run that reached a HumanTask with pending items;
    the workflow manager parks the run and resumes it on completion."""

    def __init__(self, task_id: str, pending: int):
        super().__init__(f"human task {task_id} waiting on {pending} item(s)")
        self.task_id = task_id
        self.pending = pending


class HumanTaskQueue:
    """Persistent queue of items awaiting human action (labeling etc.)."""

    def __init__(self) -> None:
        self._pending: Dict[str, Dict[str, Record]] = {}
        self._done: Dict[str, Dict[str, Record]] = {}

    def submit(self, task_id: str, records: Sequence[Record]) -> None:
        pend = self._pending.setdefault(task_id, {})
        done = self._done.setdefault(task_id, {})
        for r in records:
            if r.record_id not in done:
                pend.setdefault(r.record_id, r)

    def pending(self, task_id: str) -> List[Record]:
        return list(self._pending.get(task_id, {}).values())

    def complete(self, task_id: str, record_id: str, data: bytes,
                 **attrs) -> None:
        pend = self._pending.setdefault(task_id, {})
        src = pend.pop(record_id, None)
        base_attrs = dict(src.attrs) if src else {}
        base_attrs.update(attrs)
        self._done.setdefault(task_id, {})[record_id] = Record(
            record_id, data, base_attrs)

    def results(self, task_id: str) -> List[Record]:
        return list(self._done.get(task_id, {}).values())

    def is_complete(self, task_id: str) -> bool:
        return not self._pending.get(task_id)


class HumanTask(Component):
    """A "human work based data processing unit".

    First pass: submits every incoming record to the queue and raises
    :class:`WaitingForHuman`.  Once humans complete all items the pipeline
    re-runs and this component yields the human-produced records.
    """

    def __init__(self, queue: HumanTaskQueue, task_id: Optional[str] = None,
                 name: str = "human_task", **config) -> None:
        super().__init__(name=name, **config)
        self.queue = queue
        self.task_id = task_id or f"task-{uuid.uuid4().hex[:8]}"

    def process(self, records, ctx):
        incoming = list(records)
        self.queue.submit(self.task_id, incoming)
        if not self.queue.is_complete(self.task_id):
            raise WaitingForHuman(self.task_id,
                                  len(self.queue.pending(self.task_id)))
        for rec in self.queue.results(self.task_id):
            ctx.bump(f"{self.name}.out")
            yield rec


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class Pipeline:
    """A chain of components — the paper's user-defined workflow body."""

    def __init__(self, components: Sequence[Component], name: str = "pipeline"):
        self.components = list(components)
        self.name = name

    def __or__(self, other: Union[Component, "Pipeline"]) -> "Pipeline":
        if isinstance(other, Pipeline):
            return Pipeline([*self.components, *other.components], self.name)
        return Pipeline([*self.components, other], self.name)

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for c in self.components:
            h.update(c.fingerprint().encode())
        return h.hexdigest()[:16]

    def split_incremental(self) -> Tuple[List[Component], List[Component]]:
        """Split into (per-record prefix, suffix).

        The prefix is the maximal leading run of ``per_record`` components
        — safe for record-level incremental recompute and sharded
        streaming.  The first stateful stage (batch / human / stream)
        starts the suffix, which the derivation engine always recomputes
        in full over the combined prefix outputs.
        """
        n = 0
        for c in self.components:
            if not c.per_record:
                break
            n += 1
        return list(self.components[:n]), list(self.components[n:])

    def run(self, records: Union[Snapshot, Iterable[Record]],
            ctx: Optional[RunContext] = None) -> List[Record]:
        """Run the full chain eagerly; returns the output records."""
        ctx = ctx or RunContext()
        stream: Iterable[Record] = iter(records)
        for comp in self.components:
            stream = comp.process(stream, ctx)
        return list(stream)

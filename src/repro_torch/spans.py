"""Spans and counters of the port's serving path, on torch.profiler's clock.

``with span("engine.prefill"):`` names a stretch of the program.  With no
profiler running it costs one check of the profiler's own flag (set by
``torch.profiler.profile`` and every operator's profiler) and enters
nothing.  Under the profiler it is a ``record_function`` range, which the
profiler stamps on the clock of its device timeline.  A timed span
(``timed=True``) inside an open :func:`recording` also marks the device at
its entry and exit: a CUDA timing event on the card, the host clock on the
CPU, where the work is synchronous.  :func:`count` adds to a counter of the
open recording, and only under the profiler; device tensors are summed on
the device and read in :meth:`Recorder.totals`.

The serving engine opens one recording a wave.  It reads the marks of each
step once the device has finished them, while the device runs the next
step (:meth:`Recorder.read`), and after the wave's last sync keeps the
totals in ``wave_stats``: device seconds by timed span for the prefill and
for the decode, and the counters.  There is no other switch: run the engine
under ``torch.profiler.profile`` to fill them.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "count", "recording", "Recorder"]

_NULL = contextlib.nullcontext()
_OPEN: contextvars.ContextVar = contextvars.ContextVar("repro_torch_recording",
                                                       default=None)
_POOL: List[torch.cuda.Event] = []      # timing events no recording holds


def span(name: str, timed: bool = False):
    """A context that names ``name`` on the profiler's timeline (see the
    module docstring); with the profiler off, a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, _OPEN.get() if timed else None)


def count(name: str, n) -> None:
    """Adds ``n`` (an int, a 0-dim tensor, or a function giving either,
    called only here) to the open recording's counter ``name``."""
    if not _profiler._is_profiler_enabled:
        return
    rec = _OPEN.get()
    if rec is not None:
        rec.add(name, n() if callable(n) else n)


@contextlib.contextmanager
def recording(device) -> Iterator["Recorder"]:
    """The recorder of the timed spans and counters inside; it records only
    when the profiler runs as it opens."""
    rec = Recorder(device, _profiler._is_profiler_enabled)
    token = _OPEN.set(rec if rec.on else None)
    try:
        yield rec
    finally:
        _OPEN.reset(token)
        if rec._cuda:
            _POOL.extend(e for m in rec._marks for e in m[2:])


class _Span:
    __slots__ = ("_name", "_rec", "_range", "_start")

    def __init__(self, name: str, rec):
        self._name, self._rec = name, rec
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        if self._rec is not None:
            self._start = self._rec.mark()

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._marks.append(
                (self._rec.phase, self._name, self._start, self._rec.mark()))
        self._range.__exit__(*exc)


class Recorder:
    """One recording: the timed spans' device seconds by phase (``phase`` is
    ``"prefill"`` until the engine sets ``"decode"``) and the counters."""

    def __init__(self, device, on: bool):
        self.on = on
        self.phase = "prefill"
        self.seconds: Dict[str, Dict[str, float]] = {"prefill": {}, "decode": {}}
        self._cuda = torch.device(device).type == "cuda"
        self._marks: List = []              # (phase, span, start, end) not yet read
        self._counts: Dict[str, object] = {}

    def mark(self):
        if not self._cuda:
            return time.perf_counter()
        event = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def marked(self) -> int:
        """The number of timed spans ended and not yet read."""
        return len(self._marks)

    def read(self, n: Optional[int] = None) -> None:
        """Adds the first ``n`` unread timed spans (all by default) to
        ``seconds``; the device must have finished their work."""
        n = len(self._marks) if n is None else n
        for phase, name, start, end in self._marks[:n]:
            if self._cuda:
                s = start.elapsed_time(end) / 1e3
                _POOL.extend((start, end))
            else:
                s = end - start
            seconds = self.seconds[phase]
            seconds[name] = seconds.get(name, 0.0) + s
        del self._marks[:n]

    def add(self, name: str, n) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    def totals(self) -> Dict:
        """``{"prefill_device_s": {span: s}, "decode_device_s": {span: s}}``
        and each counter as an int under its name with ``_`` for ``.``;
        ``{}`` where nothing was recorded.  Call it once the device has
        finished the recorded work."""
        if not self.on:
            return {}
        self.read()
        out = {f"{phase}_device_s": dict(seconds) for phase, seconds in self.seconds.items()}
        # tolist(), not item(): item() copies through a pinned host buffer,
        # whose allocation (cudaHostAlloc) can hold the host for milliseconds
        out.update({name.replace(".", "_"): int(n.tolist() if torch.is_tensor(n) else n)
                    for name, n in self._counts.items()})
        return out

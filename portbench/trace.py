"""Reading a torch.profiler trace of the measured window.

The window is the span of the ``portbench.window`` record the harness opens
around it.  Device time is the union of the CUDA activities' intervals
(kernels, copies, fills) inside it; an idle gap is a stretch of the window
with none, named after the innermost host operation running at its middle.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["WINDOW", "summarize", "kernel_seconds", "idle_share"]

WINDOW = "portbench.window"
TOP = 10
NAME = 200         # characters of a name kept in the breakdown


def _events(prof, device: str):
    """(name, is_device, start_us, end_us) of every event of the trace; on
    the CPU (the tests' runs) the host's operations stand for the device's."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        on_device = (e.device_type() == DeviceType.CUDA if device == "cuda"
                     else e.name() != WINDOW)
        if on_device and e.is_user_annotation():
            continue        # a record's span drawn on the device's timeline
        start = e.start_ns() / 1e3
        yield e.name(), on_device, start, start + e.duration_ns() / 1e3


def summarize(prof, device: str = "cuda") -> Dict:
    """{"kernels": {name: [launches, seconds]}, "busy_s", "window_s",
    "device_ops": top device operations [[name, seconds]], "idle_gaps":
    longest idle gaps [[host operation, seconds]]}."""
    window = None
    dev: List[Tuple[str, float, float]] = []
    host_names, host_start, host_end = [], [], []
    for name, on_device, start, end in _events(prof, device):
        if on_device:
            dev.append((name, start, end))
        elif name == WINDOW:
            window = (start, end)
        else:
            host_names.append(name)
            host_start.append(start)
            host_end.append(end)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} record")
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in the window")
    kernels: Dict[str, List] = {}
    for name, s, e in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e6
    busy, gaps, edge = 0.0, [], w0
    for _, s, e in sorted(dev, key=lambda d: d[1]):
        if s > edge:
            gaps.append((edge, s))
        if e > edge:
            busy += e - max(s, edge)
            edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    starts, ends = np.asarray(host_start), np.asarray(host_end)
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (g0 + g1) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0] if len(starts) else []
        label = ("host, no operation" if len(inside) == 0 else
                 host_names[inside[np.argmin(ends[inside] - starts[inside])]])
        named.append([label, (g1 - g0) / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"kernels": kernels, "busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n[:NAME], s] for n, (_, s) in top],
            "idle_gaps": [[n[:NAME], s] for n, s in named]}


def kernel_seconds(trace: Dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(s for name, (_, s) in trace["kernels"].items() if fragment in name)


def idle_share(rec: Dict):
    """Percent of the traced window in which no operation ran on the device."""
    trace = rec.get("trace")
    if not trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])

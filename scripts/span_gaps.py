"""Run one cell of the port's benchmark and put its traced window's idle
device time down to the program's spans.

    python3 scripts/span_gaps.py --out gaps.json --workload <cell> --seed <n> \
        --seconds <s> --trace 1

Takes ``portbench/run.py``'s arguments and prints its result lines as it
does.  For each traced window it appends to ``--out`` (a JSON list): the ten
longest idle gaps of the device, each with its seconds, the chain of the
program's spans (``engine.*`` and ``model.*``, ``repro_torch.spans``) open
at its middle, outermost first, and the innermost host operation there, as
``portbench/trace.py`` names it; and the idle seconds summed by the
innermost span at each gap's middle.  A gap that no span holds is
"outside engine.wave": the harness's loop, between the engine's waves.
The spans are read from a trace of the card (on the CPU the trace's host
operations stand for the device's, and the spans are left out).  For every
run it also appends the window's waves summed: the timed spans' device
seconds for the prefills and the decodes, the decode steps, the unpadded
prompt tokens and the 95th percentile over the rows of their wave's
prefill seconds; and for an untraced run (``--trace 0``) the cell's
per-layer metrics that read the host clock alone, as they read with the
profiler off.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUTSIDE = "outside engine.wave"
PREFIXES = ("engine.", "model.")
TOP = 10


def _chains(points, spans):
    """The chain of ``spans`` (name, start, end; properly nested, as one
    thread's ranges are) open at each of the sorted ``points``, outermost
    first."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(list(stack))
    return out


def gaps_by_span(prof, device: str) -> dict:
    from portbench import trace

    events = list(trace._events(prof, device))
    [(w0, w1)] = [(s, e) for n, d, s, e in events if n == trace.WINDOW and not d]
    busy = sorted((max(s, w0), min(e, w1)) for _, d, s, e in events
                  if d and e > w0 and s < w1)
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    mids = [(a + b) / 2 for a, b in gaps]
    chains = _chains(mids, [(n, s, e) for n, d, s, e in events
                            if not d and n.startswith(PREFIXES)])
    by_span: dict = {}
    for (a, b), chain in zip(gaps, chains):
        name = chain[-1][0] if chain else OUTSIDE
        by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e6
    longest = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])[:TOP]
    host = [(n, s, e) for n, d, s, e in events
            if not d and n != trace.WINDOW and not n.startswith(PREFIXES)]
    top = []
    for i in longest:
        inner = [(e - s, n) for n, s, e in host if s <= mids[i] <= e]
        chain = chains[i]
        top.append({"seconds": (gaps[i][1] - gaps[i][0]) / 1e6,
                    "spans": " > ".join(c[0] for c in chain) or OUTSIDE,
                    "host_op": min(inner)[1] if inner else "host, no operation",
                    # where the gap starts in its innermost span, of how long
                    "into_span_ms": (gaps[i][0] - chain[-1][1]) / 1e3 if chain else None,
                    "span_ms": (chain[-1][2] - chain[-1][1]) / 1e3 if chain else None})
    return {"window_s": (w1 - w0) / 1e6, "idle_s": sum(by_span.values()),
            "top": top, "idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def waves_summed(waves) -> dict:
    out = {"waves": len(waves), "decode_steps": sum(w["decode_steps"] for w in waves),
           "prompt_tokens": sum(sum(w["prompt_lens"]) for w in waves)}
    rows = [w["prefill_s"] for w in waves for _ in w["prompt_lens"]]
    if len(rows) > 1:
        out["prefill_s_p95_rows"] = statistics.quantiles(rows, n=100, method="inclusive")[94]
    for key in ("prefill_device_s", "decode_device_s"):
        seconds: dict = {}
        for w in waves:
            for name, v in w.get(key, {}).items():
                seconds[name] = seconds.get(name, 0.0) + v
        out[key] = seconds
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    known, args = ap.parse_known_args(argv)
    out = known.out
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from portbench import harness, run, trace

    summarize, read_metrics = trace.summarize, harness.read_metrics

    def keep(entry):
        found = json.loads(out.read_text()) if out.exists() else []
        found.append(dict(argv=args, **entry))
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(found, indent=1))

    def summarize_and_split(prof, device="cuda"):
        keep(gaps_by_span(prof, device))
        return summarize(prof, device)

    def read_untraced_too(metrics, rec):
        keep({"waves_summed": waves_summed(rec["waves"])})
        if rec.get("trace") is None:
            cell = harness.load_cell(args[args.index("--workload") + 1])
            keep({"untraced_per_layer": read_metrics(cell.per_layer, rec)})
        return read_metrics(metrics, rec)

    trace.summarize = summarize_and_split
    harness.read_metrics = read_untraced_too
    return run.main(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

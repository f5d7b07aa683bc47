"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic and limits (``BENCHMARK.json`` and
the files under ``portbench/``), builds the program (``repro_torch``, from
``src/``) with weights drawn from the seed, warms up one cycle of the
cell's waves, measures the closed loop for ``--seconds`` (until the traffic's cycle
is whole and the engine has drained its queue), frees the program, and
judges a sample of the finished requests against the plain float32
reference.  Prints the numbers compared with their limits as the last lines
of standard error, and the result as one JSON line, last on standard output.
With ``--trace 1`` the window runs under torch.profiler and the line carries
the per-layer metrics, the device's busy seconds and a breakdown; with
``--trace 0`` the end-to-end metrics.  Exits non-zero, printing no result,
where no CUDA device is present or fewer than the cell asks for, and where
JAX or the JAX package is loaded once the window has closed.

The readings that a cell's limits are set from: ``--seed`` takes several
seeds, run one after another in this process (one result line each), and
``--control 1`` adds the float8 control's readings on the same prompts and
served tokens (``control``) to each line.  The benchmark's runs give one
seed and no ``--control``.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    for p in (_ROOT / "src", _ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # kernel caches at fixed paths inside the checkout (the program's own
    # nvcc builds go to build/torch_ext there)
    os.environ["TRITON_CACHE_DIR"] = str(_ROOT / "build" / "triton")
    # the allocator grows segments in place rather than leaving freed blocks
    # of other sizes unused: mixtral's largest eval wave fits only so
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             base_config=None, start: float = PROCESS_START, control: bool = False) -> dict:
    """The result of one run of ``cell`` (see the module docstring)."""
    import torch

    from portbench import harness
    from portbench.trace import summarize

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = harness.build_program(cell.config, seed, device, base_config)
    _log(f"program built with the seed's weights in {time.perf_counter() - t:.2f} s")
    run = harness.Run(cell, model, seed)
    t = time.perf_counter()
    run.warm_up()
    setup_s = time.perf_counter() - start
    _log(f"warm-up wave {time.perf_counter() - t:.2f} s; setup {setup_s:.2f} s")
    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            rec = run.window(seconds, traced=True)
        t = time.perf_counter()
        summary = summarize(prof, torch.device(device).type)
        del prof
        _log(f"trace read in {time.perf_counter() - t:.2f} s")
    else:
        rec = run.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {', '.join(found)}")
    requests, prefills = rec["requests"], run.model.prefills
    _log(f"window {rec['window_s']:.2f} s, {len(rec['waves'])} waves, "
         f"{len(requests)} requests, peak {peak / 2**30:.2f} GiB")
    records = dict(rec, setup_s=setup_s, trace=summary, config=cell.config,
                   clients=cell.spec["clients"])
    metrics = harness.read_metrics(cell.per_layer if trace else cell.end_to_end, records)
    # the judge needs only the prefills' tokens and last-position logits
    del run, model, rec, records
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    failed = sum(r["failed"] for r in requests)
    t = time.perf_counter()
    verdict, low = harness.judge(cell, [r for r in requests if not r["failed"]], prefills,
                                 seed, device, control)
    _log(f"reference over {verdict['judged_requests']} requests "
         f"({verdict['judged_tokens']} tokens) in {time.perf_counter() - t:.2f} s")
    compared = harness.checks(cell, failed, verdict)
    result = {
        "correct": harness.passes(compared),
        "attempted": len(requests), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["seed"] = seed
    result["judged"] = {k: v for k, v in verdict.items() if k not in compared}
    if low is not None:
        low_compared = harness.checks(cell, 0, low)
        result["control"] = {"correct": harness.passes(low_compared), "readings": low}
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from portbench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f"card: {_power_limit()}; torch {torch.__version__}", file=sys.stderr)
    start = PROCESS_START
    for seed in args.seed:
        result = run_cell(cell, seed, args.seconds, bool(args.trace), start=start,
                          control=bool(args.control))
        start = time.perf_counter()
        found = harness.forbidden_modules()
        if found:
            print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
            return 3
        print(json.dumps({"judged": result["judged"]}), file=sys.stderr)
        for name, c in result["checks"].items():
            print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero before the last line is printed):

1. device: the card's name and power limit from nvidia-smi;
2. kernels: builds every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
   (one nvcc per source, in parallel), holds each against its plain PyTorch
   version computed in float64 on the card, and times both with CUDA events;
3. serve: mamba2-1.3b at full width and depth (48 layers, d_model 2048,
   random weights from a seed, fp32 params, bf16 compute) through
   ``ServeEngine(max_batch=4)``: after a cold-start wave, a wave of
   4 x 512-token prompts and a wave of 4 x 256-token prompts, 32 greedy
   tokens each.  The SSD kernel's launch count is set to 0 before each of
   these two waves and must read 48 after it;
4. reference: the smoke-size model on the card, kernel path against the
   plain path, prefill and decode logits within fp32 tolerance.

With ``--profile``, phase 3 also traces one prefill of wave 1's prompts and
8 decode steps under ``torch.profiler`` and prints where the device time goes
and the device's idle share (see ``profile_serve``).

Then one JSON line describing each kernel, the nvidia-smi line again, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,      # CUDA cores, no tensor cores
              "bfloat16": 989e12}    # dense bf16 tensor cores
TOL = {"float32": 3e-4, "bfloat16": 5e-2}   # tests/test_kernels.py::_tol
KERNEL_CHUNK = 64                    # ssd_fwd.cu's internal chunk length


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ssd_bound(B, S, H, P, N, dtype: str, with_s0: bool):
    """Least time for ssd_fwd's work: (ms, "bytes" | "operations").

    Bytes: x, B, C read and y written in their dtype, a read in fp32, the
    initial state read (when given) and the final state written in fp32.
    Operations: per (batch, head, chunk of c = 64 steps), c^2 N (scores) +
    c^2 P (intra-chunk output) + 2 c N P (state read-out and update) FMAs,
    two operations each, at the peak rate of the input dtype.
    """
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * S * H * P * elt + 2 * B * S * N * elt + B * S * H * 4
              + B * H * P * N * 4 * (2 if with_s0 else 1))
    c = KERNEL_CHUNK
    flops = (2 * (c * c * N + c * c * P + 2 * c * N * P)
             * B * H * math.ceil(S / c))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_ssd(torch, case, gen):
    """Kernel vs plain version on one input set; returns a result dict."""
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ops import _ssd_chunked
    label, B, S, H, P, N, dtype, with_s0, chunk = case
    tdt = getattr(torch, dtype)
    dev = "cuda"
    x = torch.randn(B, S, H, P, device=dev, generator=gen).to(tdt)
    a = torch.sigmoid(torch.randn(B, S, H, device=dev, generator=gen)) * 0.5 + 0.5
    Bm = (torch.randn(B, S, N, device=dev, generator=gen) * 0.3).to(tdt)
    Cm = (torch.randn(B, S, N, device=dev, generator=gen) * 0.3).to(tdt)
    s0 = (torch.randn(B, H, P, N, device=dev, generator=gen) * 0.1
          if with_s0 else None)

    y, sf = ssd_cuda(x, a, Bm, Cm, s0)
    torch.cuda.synchronize()
    y_ref, sf_ref = _ssd_chunked(
        x.double(), a.double(), Bm.double(), Cm.double(),
        s0.double() if s0 is not None else None, chunk=chunk)
    tol = TOL[dtype]
    ok = True
    errs = {}
    for name, got, want in (("y", y, y_ref), ("state", sf, sf_ref)):
        diff = (got.double() - want).abs()
        errs[name] = diff.max().item()
        ok &= bool((diff <= tol + tol * want.abs()).all().item())
        ok &= bool(torch.isfinite(got).all().item())
    ms = time_ms(torch, lambda: ssd_cuda(x, a, Bm, Cm, s0))
    plain_ms = time_ms(torch, lambda: _ssd_chunked(x, a, Bm, Cm, s0, chunk=chunk),
                       reps=21)
    bound_ms, bound_by = ssd_bound(B, S, H, P, N, dtype, with_s0)
    res = {"case": label, "shape": [B, S, H, P, N], "dtype": dtype,
           "s0": with_s0, "err_y": errs["y"], "err_state": errs["state"],
           "tol": tol, "ok": ok, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log("ssd_fwd check " + json.dumps(res))
    return res


def profile_serve(torch, model, tokens, decode_steps: int = 8) -> None:
    """Where one wave's time goes: a profiled prefill and decode window.

    Per phase, prints the host-clock window, the device-busy time (the sum of
    the CUDA kernels' durations: one stream, so they do not overlap), the
    device's idle share of the window, and the top kernels by device time.
    The full per-operator tables go to ``chiprun_out/profile_<phase>.txt``.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    logits, cache, pos = model.prefill(tokens)          # warm the path once
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()

    def prefill():
        model.prefill(tokens)

    def decode():
        step_cache, step_tok = cache, tok
        for i in range(decode_steps):
            step_logits, step_cache = model.decode_step(step_cache, step_tok, pos + i)
            step_tok = step_logits[:, -1].argmax(-1)[:, None]

    for phase, fn in (("prefill", prefill), ("decode", decode)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        by_kernel = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                n, us = by_kernel.get(evt.name, (0, 0.0))
                by_kernel[evt.name] = (n + 1, us + evt.time_range.elapsed_us())
        if not by_kernel:
            fail(f"the profiler recorded no CUDA kernel in the {phase} window")
        busy_us = sum(us for _, us in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
        log("profile " + json.dumps({
            "phase": phase, "batch": tokens.shape[0], "prompt_len": tokens.shape[1],
            "decode_steps": decode_steps if phase == "decode" else 0,
            "window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / window_us,
            "kernel_launches": sum(n for n, _ in by_kernel.values()),
            "top_kernels": [{"name": name[:80], "launches": n, "ms": us / 1e3}
                            for name, (n, us) in top]}))
        (out_dir / f"profile_{phase}.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's sources are missing: no {SRC / 'repro_torch'}")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device --------------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"count {torch.cuda.device_count()})")

    # 2. kernels --------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        for line in Path(str(path) + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # label, B, S, H, P, N, dtype, initial state, chunk
        ("full-width fp32", 2, 1024, 64, 64, 128, "float32", True, 256),
        ("full-width bf16", 2, 1024, 64, 64, 128, "bfloat16", True, 256),
        ("serve wave 1", 4, 512, 64, 64, 128, "bfloat16", False, 256),
        ("serve wave 2", 4, 256, 64, 64, 128, "bfloat16", False, 256),
    ]
    checks = [check_ssd(torch, case, gen) for case in cases]
    bad = [c["case"] for c in checks if not c["ok"]]
    if bad:
        fail(f"ssd_fwd disagrees with its plain version: {bad}")

    # 3. serve mamba2-1.3b at full width and depth ------------------------------
    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    model = build_model(cfg, RuntimeConfig(), device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} params, built in {time.perf_counter() - t0:.1f} s")
    engine = ServeEngine(model, max_batch=4)
    # A first wave pays one-time costs (cuBLAS handles and heuristics, the
    # caching allocator's first blocks); it is timed apart as the cold start.
    for p in torch.randint(3, cfg.vocab_size, (4, 512),
                           generator=torch.Generator().manual_seed(2)).numpy():
        engine.submit(p, max_new_tokens=2)
    engine.run()
    log(f"cold-start wave (4 x 512 prompts, 2 tokens): prefill "
        f"{engine.wave_stats[-1]['prefill_s'] * 1e3:.1f} ms")
    prompt_gen = torch.Generator().manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    launches = 0
    waves = []
    wave_prompts = []
    for prompt_len in (512, 256):
        prompts = torch.randint(3, cfg.vocab_size, (4, prompt_len),
                                generator=prompt_gen).numpy()
        wave_prompts.append(prompts)
        ids = [engine.submit(p, max_new_tokens=32) for p in prompts]
        ssd_cuda.launches = 0
        engine.run()
        wave_launches = ssd_cuda.launches
        if wave_launches != cfg.n_layers:
            fail(f"wave of {prompt_len}-token prompts launched ssd_fwd "
                 f"{wave_launches} times, expected {cfg.n_layers}")
        launches += wave_launches
        for rid in ids:
            req = engine.result(rid)
            if not req.done or len(req.output) != 32:
                fail(f"request {rid} did not finish: {len(req.output)} tokens")
        stats = engine.wave_stats[-1]
        waves.append(dict(stats, ssd_launches=wave_launches,
                          decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"]))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("serve " + json.dumps({
        "waves": [{k: w[k] for k in ("batch", "prompt_len", "ssd_launches",
                                     "decode_steps", "decode_tokens")}
                  | {"prefill_ms": w["prefill_s"] * 1e3,
                     "decode_tok_per_s": w["decode_tok_per_s"]} for w in waves],
        "peak_mem_gib": peak_gib}))

    if "--profile" in sys.argv[1:]:
        profile_serve(torch, model, torch.as_tensor(wave_prompts[0], device="cuda"))
    tokens = torch.as_tensor(prompts, device="cuda")
    logits, cache, pos = model.prefill(tokens)
    if tuple(logits.shape) != (4, 1, cfg.padded_vocab):
        fail(f"prefill logits have shape {tuple(logits.shape)}")
    step_logits, _ = model.decode_step(cache, logits[:, -1].argmax(-1)[:, None], pos)
    for name, t in (("prefill", logits[..., :cfg.vocab_size]),
                    ("decode", step_logits[..., :cfg.vocab_size])):
        if not torch.isfinite(t).all():
            fail(f"full-width {name} logits are not finite")
    model.rt = model.rt.with_(ssd_impl="chunked")
    plain_logits, _, _ = model.prefill(tokens)
    model.rt = model.rt.with_(ssd_impl="auto")
    agree = (plain_logits.argmax(-1) == logits.argmax(-1)).sum().item()
    log(f"full-width prefill logits, kernel path vs plain path (bf16 compute, "
        f"information only): max abs diff "
        f"{(plain_logits - logits)[..., :cfg.vocab_size].abs().max().item()}, "
        f"greedy tokens agree {agree}/4")
    del model, engine, cache, logits, plain_logits

    # 4. reference: smoke-size model, kernel path vs plain path in fp32 ---------
    small = build_model(get_smoke_config("mamba2-1.3b"),
                        RuntimeConfig(compute_dtype=torch.float32),
                        device="cuda", seed=3)
    toks = torch.randint(3, 512, (2, 48), generator=prompt_gen).to("cuda")
    got, got_cache, pos = small.prefill(toks)
    nxt = got[:, -1].argmax(-1)[:, None]
    got_step, _ = small.decode_step(got_cache, nxt, pos)
    small.rt = small.rt.with_(ssd_impl="chunked")
    want, want_cache, _ = small.prefill(toks)
    want_step, _ = small.decode_step(want_cache, nxt, pos)
    tol = TOL["float32"]
    for name, g, w in (("prefill", got, want), ("decode", got_step, want_step)):
        diff = (g - w).abs()
        log(f"smoke model {name} logits, kernel vs plain: max abs diff "
            f"{diff.max().item()}")
        if not (diff <= tol + tol * w.abs()).all():
            fail(f"smoke model {name} logits disagree beyond {tol}")

    main_path = checks[2]      # serve wave 1: the main path's largest call
    log(json.dumps({"kernels": [{
        "name": "ssd_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_fwd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:91",
        "launches": launches,
        "max_abs_err": max(max(c["err_y"], c["err_state"]) for c in checks),
        "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
        "library_ms": None,
        "shape": main_path["shape"], "dtype": main_path["dtype"],
        "checks": {c["case"]: c["ok"] for c in checks},
    }]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

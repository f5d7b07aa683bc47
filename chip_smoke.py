#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero before the last line is printed):

1. device: the card's name and power limit from nvidia-smi;
2. kernels: builds every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
   (one nvcc per source, in parallel) and prints ptxas's register report,
   holds each against its plain PyTorch version computed in float64 on the
   card (bf16 RG-LRU outputs within one bf16 ulp, with lam drawn so that a
   lies in about (1e-8, 0.9) and, where the carry between the kernel's
   chunks weighs as much as the chunk itself, in (0.99, 1); bf16 flash-attention
   outputs within ``bf16_flash_limit``, one ulp plus what rounding P to bf16
   for the tensor cores can add; bf16 SSD outputs within ``bf16_ssd_limit``,
   one ulp plus what its three bf16 operand roundings can add, with decays
   drawn from (0.5, 1) and, where the terms across chunks weigh as much as
   those inside one, from (0.99, 1)), and times
   both with CUDA events (a kernel over runs of 10 back-to-back calls, and
   one call alone as ``call_ms``; flash attention also against
   ``scaled_dot_product_attention`` as a yardstick the port never calls:
   SDPA has no softcap, so at gemma2's shapes it runs the same masks without
   one).  The flash cases include gemma2's wave A, global and local (window
   4096): q 4 x 4500 x 16 x 256, 8 KV heads, softcap 50, left-padded segments
   for rows of 4500, 3100, 2049 and 700 tokens, whose pads share segment 0
   with the keys past Sk that the kernel pads its last tile with; mixtral's
   wave A (48 q on 8 KV heads of 128, window 4096, the same pads), and
   seamless's non-causal encoder (4 x 1024 x 16 x 64) and cross-attention
   (Sq 256, Sk 1024), with SDPA on the same masks; phase 4e's gemma3-12b
   local layer (16 q on 8 KV heads of 256, window 1024) and stablelm-1.6b's
   multi-head attention (32 on 32 heads of 64, causal) on the same padded
   rows, with SDPA; and a query-rows split
   at qwen2.5-32b prefill_32k's per-rank shape on the dry-run's 16 "model"
   ranks (q 2 x 2048 of 32768 keys, 40 q on 8 KV heads of 128, causal):
   the first and busiest rank (q_offset 0 and 30720) as two of those cases,
   with SDPA, and all 16 chunks through the kernel at their q_offsets, their
   concatenation held to ``bf16_flash_limit`` against the whole attention.
   Flash attention has two kernels, chosen by dtype and head_dim:
   ``flash_fwd_wgmma`` (bf16 tensor cores, the serving path) and
   ``flash_fwd`` (fp32 and small head_dims); so has SSD, by dtype and
   (P, N): ``ssd_fwd_wgmma`` (bf16 at P 64, N 128, the serving path) and
   ``ssd_fwd`` (fp32 and other shapes);
3. serve mamba2-1.3b at full width and depth (48 layers, d_model 2048,
   random weights from a seed, fp32 params, bf16 compute) through
   ``ServeEngine(max_batch=4)``: after a cold-start wave, a wave of
   4 x 512-token prompts and a wave of 4 x 256-token prompts, 32 greedy
   tokens each.  The SSD launch counts are set to 0 before each of these two
   waves and must read 48 after it (all 48 on ``ssd_fwd_wgmma``);
4. serve recurrentgemma-9b at full width and depth (38 layers: 26 RG-LRU
   and 12 local-attention layers, d_model 4096, 9.4 B parameters) the same
   way: after a cold-start wave (4 x 1024, 2 tokens), wave A (4 x 3072-token
   prompts: longer than the 2048 window, so window masking, tile skipping and
   the ring write all run) and wave B (4 x 1024), 32 greedy tokens each.
   Every count is set to 0 before each wave; after it the RG-LRU kernel
   must read 26, flash attention 12 (all 12 on ``flash_fwd_wgmma``) and
   both SSD counts 0;
4b. serve gemma2-9b at full width and depth (42 layers: 21 local with a
   4096-token window and 21 global, d_model 3584, GQA 16 q / 8 KV heads of
   256, attention softcap 50 and final softcap 30, post-norms; 9.24 B
   parameters, fp32, bf16 compute; ``max_cache_len`` 4500 + 32) the same
   way, through padded waves: after a cold-start wave (4 x 1024, 2 tokens),
   wave A (one wave of 4500-, 3100-, 2049- and 700-token prompts, LEFT-padded
   to 4500: pad masking, ragged tiles, window masking and the local rings'
   shifted write all run) and wave B (4 x 1024, no pads), 32 greedy tokens
   each.  After each wave ``flash_fwd_wgmma`` must read 42 and every other
   count 0;
4c. serve mixtral-8x22b at full width (d_model 6144, 48 q / 8 KV heads of
   128, a 4096-token window on every layer, 8 experts top 2 of width 16384,
   vocab 32768) but depth 4 of 56: 10.42 B parameters, 41.7 GB in fp32
   (full depth holds 141 B, more than one card), bf16 compute, the same
   waves as phase 4b; after each wave ``flash_fwd_wgmma`` must read 4 and
   every other count 0.  Then one MoE layer's time at wave A's shape, split
   into its parts (CUDA events);
4d. seamless-m4t-medium at full width and depth (12 encoder and 12 decoder
   layers, d_model 1024, 16 heads of 64, layernorm, GeGLU, vocab 256206):
   ``prefill`` of 4 x 1024 seeded frames and a 64-token decoder prompt, then
   32 greedy ``decode_step``s (``flash_fwd_wgmma`` must read 24 after the
   prefill: 12 non-causal encoder and 12 causal decoder layers), then one
   ``forward`` of 4 x 1024 frames and 4 x 256 tokens (36: the 12
   cross-attentions at Sq 256, Sk 1024 too); logits finite, of the right
   shape, the padded vocab at -1e30;
4e. serve stablelm-1.6b (24 layers, multi-head at head_dim 64, layernorm
   with bias), internvl2-2b (24), gemma3-12b (48: 40 local with a 1024-token
   window and 8 global, head_dim 256, tied 262,144-token vocabulary) and
   qwen2.5-32b (64, QKV bias, GQA 5) at full width and depth, and
   arctic-480b (128 experts top 2 beside a dense MLP, GQA 7) at full width
   and depth 2 of 35, random weights from a seed, bf16 compute, fp32 params
   but bf16 for qwen2.5-32b and arctic-480b, as ``runtime_for`` gives them
   (their fp32 params do not fit one card), through phase 4b's waves; after
   each wave ``flash_fwd_wgmma`` must read the model's depth and every
   other count 0.  internvl2 is served text-only, as the engine serves it,
   then prefills 4 rows of 1,024 seeded patch embeddings x 0.1 and 1,024
   tokens and decodes 32 greedy steps; arctic also splits one MoE layer's
   time, as 4c.  Their launches are counted apart (``serve_4e`` in the
   kernels line);
5. reference: smoke-size models on the card in fp32, kernel path against the
   plain path: mamba2 (prefill and one decode step), recurrentgemma with
   5 layers (two unscanned tail layers; 48- and 80-token prompts against a
   32-token window in a 64-slot ring; prefill and 8 decode steps), and
   gemma2 on one padded wave (31-, 150- and 97-token prompts against a
   32-token window in 128-slot rings; prefill and 8 decode steps), whose
   greedy tokens and logits (within 3e-4) through ``ServeEngine`` must also
   equal each prompt's decoded alone; mixtral on one padded wave (groups of
   16, so tokens drop; the engine's kernel path against its plain path) and,
   at capacity_factor = n_experts where nothing drops, against each prompt
   decoded alone; arctic (the dense residual MLP; prefill and 8 decode
   steps); seamless (``prefill``, 8 ``decode_step``s and ``forward``);
6. training: ``repro_torch.launch.train.main`` trains mamba2-1.3b at full
   width and depth (AdamW, batch 8 x 128, fp32, deterministic) for 8 steps
   with a platform checkpoint at the last, then again with a checkpoint
   every 4 and ``--kill-at 4``.  The
   restarted run's losses of steps 5-8, the records of its final checkpoint
   (params, m, v) and its loader state must equal the uninterrupted run's bit
   for bit; every loss must be finite and the last three's mean below the
   first three's; every kernel launch count must read 0 across the phase
   (training runs the plain paths, as the reference's driver does: no kernel
   has a backward pass).  Then the loss and every gradient of smoke-size
   mamba2 and recurrentgemma on the card against the same step on the CPU,
   in fp32, within 3e-4.  Prints a ``{"train": ...}`` line;
7. training at the production policies, in a one-rank NCCL process group:
   (a) gemma2-9b at full width and depth (42 layers, 9.24 B parameters) on
   the one-card "data" mesh under ``resolve_layout(cfg, SHAPES["train_4k"],
   mesh, "auto")``, which must give ZeRO-3 (``remat="dots"``, 1
   microbatch) and, through ``runtime_for``, bf16 params and compute;
   Adafactor, since ``train_config_for``'s AdamW keeps fp32 moments (74 GB)
   that do not fit one card beside bf16 params and gradients (37 GB); 6
   steps of 1 x 4096 tokens (train_4k's 256 rows cut to 1) from the
   platform's Fig. 1 flow through the sharded ``DeviceFeed``: losses finite,
   the last three's mean below the first three's; (b) the same with 8-bit
   AdamW; no kernel launches (the plain paths); (c) one step of each new
   optimizer on smoke mamba2 and gemma2 on the card against the CPU
   (params and Adafactor's state within 3e-4, 8-bit moments within one
   quantum of their block); (d) ``remat="dots"`` against ``"none"`` on smoke
   gemma2 (3e-4) and the peak memory of each remat mode at one full-width
   layer group; (e) ``moe_apply_shardmap`` against ``moe_apply`` on one
   mixtral-8x22b MoE layer at full width, fp32, on the (1, 1) mesh, within
   1e-5.  Prints ``train7``, ``optimizers``, ``remat`` and ``moe_shardmap``
   lines;
8. the dry-run (``repro_torch.launch.dryrun``) in a subprocess of its own,
   since phase 7's process has held an NCCL group: (a) ``run_cell_roofline``
   of gemma2-9b at train_4k on the fake 16 x 16 production mesh (a fake
   process group of 256 ranks, the mesh claiming ``cuda``) under
   ``resolve_layout(..., "auto")``, at full width; (b) ``run_cell`` of phase
   7's own layout: gemma2-9b at full width and depth on the one-rank "data"
   mesh, 1 x 4096 tokens, Adafactor.  The traces run on ``meta`` shards and
   launch no kernel.  Prints (a)'s roofline terms and, beside phase 7's
   Adafactor run, (b)'s peak estimate against the measured
   ``max_memory_allocated`` (which it must match within 15 %), its per-device
   FLOPs over the measured ``step_ms`` as TFLOP/s, and its bound against
   ``step_ms``, each line with the card's name and power limit; fails if a
   cell's status is not "ok".  (c) the whole 40-cell grid under ``auto``:
   the statuses of tests/test_torch_dryrun_grid_auto.py, every term
   positive, every ``ok`` cell's ``hlo_flops`` at most the reference's
   (``GRID_REFERENCE_FLOPS``) and the one-row long_500k cells' equal to the
   CPU trace's (``GRID_SANDBOX_LONG_FLOPS``), and every ``ok`` cell's
   ``wire_bytes`` at most the reference's (``GRID_REFERENCE_WIRE``) and
   equal to the CPU trace's with torch 2.13 (``GRID_SANDBOX_WIRE``): no
   layout of the traced steps is left to DTensor's choice, which differs
   between torch versions.  (d) the 40-cell grid on the fake multi-pod
   (2, 16, 16) ("pod", "data", "model") mesh (512 ranks) under ``auto``, in
   a subprocess of its own (``--dryrun-multi-child``) with its own timeout:
   the statuses of tests/test_torch_dryrun_multipod_grid_auto.py, every
   term positive, every ``ok`` cell's FLOPs and wire bytes, in all and a
   superblock, at most the reference's (``GRID_MULTI_REFERENCE``) and its
   ``wire_bytes`` equal to the CPU trace's (``GRID_MULTI_SANDBOX_WIRE``);
   prints (d)'s time beside the card's name and power limit.

After the measured waves, phases 3 to 4e run one more untimed pass of one
wave each (mamba2's wave 1, recurrentgemma's, gemma2's, mixtral's and each
4e family's wave A, seamless's prefill, internvl2's prefix prefill) with
each kernel wrapper swapped for one that holds every call's output to its
plain version in float64 on the same inputs (``held_calls``): flash
attention to ``bf16_flash_limit``, SSD to ``bf16_ssd_limit``, RG-LRU to
``ROUNDED_TOL``.  The calls checked must equal the launches counted and the
wave's launch count, and a call outside its limit fails the run; a
``hold`` line a pass prints the calls and the largest error as a share of
the limit.

With ``--profile``, phases 3, 4, 4b, 4c and 4e also trace one prefill of their
first measured wave and 8 decode steps under ``torch.profiler`` and print
where the device time goes and the device's idle share (see
``profile_serve``), phase 4d its prefill, 8 decode steps and its forward,
phase 6 traces one full-width training step (see ``profile_train``), and
phase 7 one more step with each optimizer.

Then one JSON line describing each kernel, the nvidia-smi line again, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,      # CUDA cores, no tensor cores
              "bfloat16": 989e12}    # dense bf16 tensor cores
FP32_TOL = 3e-4                      # tests/test_kernels.py::_tol, fp32
# rglru_fwd computes in fp32 and rounds a bf16 output once, so it is held to
# one bf16 ulp of the float64 result (2^-7 relative) plus fp32 slack, as
# (atol, rtol); fp32 outputs of every kernel to 3e-4.  bf16 flash attention
# rounds P to bf16 for the tensor cores as well, so it is held to
# ``bf16_flash_limit`` (one ulp plus 2^-8 of the float64 result on |v|), and
# bf16 SSD to ``bf16_ssd_limit`` (one ulp plus 2^-8 of what each of its three
# operand roundings can move a term by).  _tol's bf16
# 5e-2 exceeds a typical |attention output| at the serving shape and would
# pass a wrong kernel.
ROUNDED_TOL = {"float32": (3e-4, 3e-4), "bfloat16": (1e-4, 2 ** -7)}


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


def time_ms(torch, fn, reps: int = 25, warmup: int = 3, per: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``per`` back-to-back calls
    of ``fn``, per call, after ``warmup`` calls.

    A kernel's time (``KERNEL_BATCH`` calls a timing) is the card's: the host
    enqueues ahead, so the wrapper's host work before the first launch falls
    outside the events.  ``per=1`` gives the time of one call from the host's
    start, that work included (``call_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


KERNEL_BATCH = 10


def ssd_bound(B, S, H, P, N, dtype: str, with_s0: bool, chunk: int):
    """Least time for the SSD's work: (ms, "bytes" | "operations"), the same
    whatever kernel computes it.

    Bytes: x, B, C read and y written in their dtype, a read in fp32, the
    initial state read (when given) and the final state written in fp32.
    Operations: the chunked algorithm at the caller's chunk (the reference's
    256), for chunks of L = min(chunk, S - start) steps: per (batch, chunk)
    the causal half of C B^T, L (L + 1) / 2 N multiply-adds (B and C are
    shared across heads); per (batch, head, chunk) the causal half of
    (C B^T ⊙ M) x, L (L + 1) / 2 P, the state update, L N P, and the state
    read-out, L N P, except in the first chunk when there is no initial
    state.  Two operations per multiply-add, at the peak rate of the input
    dtype.  At mamba2's wave 1 (4, 512, 64, 64, 128, bf16, chunk 256, no
    initial state, so no read-out in the first chunk) this is bytes:
    43.5 MB, 0.0130 ms, against 5.44 GFLOP, 0.0055 ms.
    """
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * S * H * P * elt + 2 * B * S * N * elt + B * S * H * 4
              + B * H * P * N * 4 * (2 if with_s0 else 1))
    macs = 0
    for g, start in enumerate(range(0, S, chunk)):
        L = min(chunk, S - start)
        causal = L * (L + 1) // 2
        readout = L * N * P if (g > 0 or with_s0) else 0
        macs += B * causal * N + B * H * (causal * P + L * N * P + readout)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(torch, q, k, mask, dtype: str):
    """Least time for flash_fwd's work: (ms, "bytes" | "operations").

    Bytes: q read and the output written in their dtype, k and v read for
    the keys that some query of their row may attend (``mask``: (B, Sq, Sk)
    bool, counted on the card; a causal chunk of rows at a q_offset needs
    none past its last row), segments read (int32, when given).  Operations:
    for every valid (query, key) pair of these inputs, the QK^T and PV dot
    products, 2 D multiply-adds, 4 D operations, per q head; at the peak
    rate of the input dtype.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    elt = q.element_size()
    keys = int(mask.any(dim=1).sum().item())          # (row, key) pairs reached
    nbytes = (2 * B * Sq * Hq * D + 2 * keys * Hkv * D) * elt + 4 * (B * Sq + keys)
    pairs = int(mask.sum().item())
    flops = 4 * D * pairs * Hq
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# gemma2-9b's wave A: one padded wave whose longest prompt passes the local
# layers' 4096-token window and whose shortest is mostly pads.
GEMMA2_WAVE_A = (4500, 3100, 2049, 700)

RGLRU_OPS_PER_ELEMENT = 20   # two sigmoids, exp, sqrt, clamp and the update


def rglru_bound(B, S, W, dtype: str, with_h0: bool):
    """Least time for rglru_fwd's work: (ms, "bytes" | "operations").

    Bytes: x, r, i read and y written in their dtype, lam read and the final
    h written in fp32, h0 read (when given) in fp32.  Operations: ~20 fp32
    operations per element (gates and update) at the CUDA-core fp32 rate
    (no tensor-core work here, whatever the input dtype).
    """
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * B * S * W * elt + 4 * W + B * W * 4 * (2 if with_h0 else 1)
    flops = RGLRU_OPS_PER_ELEMENT * B * S * W
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def within(torch, got, want, limit):
    """(ok, max |got - want|, max |got - want| / limit): within the
    per-element ``limit`` and finite."""
    diff = (got.double() - want).abs()
    ok = bool((diff <= limit).all().item()) and bool(torch.isfinite(got).all().item())
    return ok, diff.max().item(), (diff / limit).max().item()


def check_flash(torch, case, gen):
    """Kernel vs plain version on one input set; returns a result dict."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS, flash_cuda
    from repro_torch.kernels.flash_attention.ops import _flash_chunked
    from repro_torch.kernels.flash_attention.ref import bf16_flash_limit
    (label, B, Sq, Sk, Hq, Hkv, D, dtype, causal, window, cap, q_offset,
     seg_kind, block) = case
    tdt = getattr(torch, dtype)
    dev = "cuda"
    q, k, v = (torch.randn(shape, device=dev, generator=gen).to(tdt)
               for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    qs = ks = None
    if seg_kind == "ones":               # the serving path's segments
        qs = torch.ones((B, Sq), dtype=torch.int32, device=dev)
        ks = torch.ones((B, Sk), dtype=torch.int32, device=dev)
    elif seg_kind == "packed":           # two sequences; some rows see no key
        ks = (torch.arange(Sk, device=dev) >= Sk // 2).int().expand(B, Sk) + 1
        qs = (torch.arange(Sq, device=dev) + q_offset >= Sk // 2).int().expand(B, Sq) + 1
        qs = qs.clone()
        qs[:, :5] = 9
        ks = ks.contiguous()
    elif isinstance(seg_kind, tuple):    # a padded wave: rows LEFT-padded to Sk
        ks = left_pad_segments(torch, seg_kind, Sk)
        qs = ks[:, Sk - Sq:].contiguous()
    opts = dict(causal=causal, window=window, softcap=cap, q_segments=qs,
                kv_segments=ks, q_offset=q_offset)
    plain = dict(opts, scale=None, block_q=block[0], block_k=block[1])

    kernel = ("flash_fwd_wgmma" if dtype == "bfloat16" and D in WGMMA_HEAD_DIMS
              else "flash_fwd")
    out = flash_cuda(q, k, v, **opts)
    torch.cuda.synchronize()
    want = _flash_chunked(q.double(), k.double(), v.double(), **plain)
    if dtype == "bfloat16":
        # sum_s p_s |v_s| / l: what rounding P to bf16 can move the output by.
        want_absv = _flash_chunked(q.double(), k.double(), v.double().abs(), **plain)
        tol = "bf16_flash_limit"
        limit = bf16_flash_limit(want, want_absv)
        median_absv = want_absv.float().median().item()
        del want_absv
    else:
        tol = ROUNDED_TOL[dtype]
        limit = tol[0] + tol[1] * want.abs()
        median_absv = None
    ok, err, ratio = within(torch, out, want, limit)
    del limit
    typical = want.abs().float().median().item()
    ms = time_ms(torch, lambda: flash_cuda(q, k, v, **opts), per=KERNEL_BATCH)
    call_ms = time_ms(torch, lambda: flash_cuda(q, k, v, **opts))
    plain_ms = time_ms(torch, lambda: _flash_chunked(q, k, v, **plain), reps=11)

    qp = torch.arange(Sq, device=dev)[:, None] + q_offset
    kp = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    mask = mask[None].expand(B, Sq, Sk)
    if qs is not None:
        mask = mask & (qs[:, :, None] == ks[:, None, :])
    bound_ms, bound_by = flash_bound(torch, q, k, mask, dtype)
    library_ms = library_call = None
    if label.startswith(("serve wave A", "gemma2 wave A", "mixtral", "seamless",
                         "qwen rows", "gemma3 wave A", "stablelm wave A")):
        # One PyTorch call for the same function: SDPA with the boolean
        # causal, window and segment mask.  SDPA has no softcap: where the
        # case has one, SDPA computes the same masks without it.
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        attn_mask = mask[:, None]
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask, enable_gqa=True), reps=11)
        library_call = ("SDPA, boolean mask, enable_gqa"
                        + (", without softcap (SDPA has none)" if cap else ""))
        del qt, kt, vt, attn_mask
    res = {"case": label, "kernel": kernel, "shape": [B, Sq, Sk, Hq, Hkv, D],
           "dtype": dtype, "causal": causal, "window": window, "softcap": cap,
           "q_offset": q_offset, "segments": seg_kind, "valid_pairs": int(mask.sum().item()),
           "err": err,
           "err_over_limit": ratio, "median_abs_out": typical,
           "median_absv": median_absv, "tol": tol, "ok": ok, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "library_call": library_call}
    log(f"{kernel} check " + json.dumps(res))
    return res


def check_rglru(torch, case, gen):
    """Kernel vs plain version on one input set; returns a result dict.

    ``decay`` "fast" draws lam from N(1, 0.5), so a lies in about (1e-8,
    0.9) and a chunk's product of a underflows: the kernel's carry between
    chunks weighs nothing.  "slow" draws lam from U(-12, -7), so a lies in
    (0.99, 1) and the carry carries the result (trained RecurrentGemma's
    gates decay as slowly)."""
    from repro_torch.kernels.rglru.kernel import rglru_cuda
    from repro_torch.kernels.rglru.ops import _rglru_scan
    label, B, S, W, dtype, with_h0, decay = case
    tdt = getattr(torch, dtype)
    dev = "cuda"
    x, r, i = (torch.randn(B, S, W, device=dev, generator=gen).to(tdt)
               for _ in range(3))
    if decay == "slow":
        lam = torch.rand(W, device=dev, generator=gen) * 5.0 - 12.0
    else:
        lam = torch.randn(W, device=dev, generator=gen) * 0.5 + 1.0
    h0 = torch.randn(B, W, device=dev, generator=gen) * 0.2 if with_h0 else None

    y, h = rglru_cuda(x, r, i, lam, h0)
    torch.cuda.synchronize()
    y_ref, h_ref = _rglru_scan(x.double(), r.double(), i.double(), lam.double(),
                               h0.double() if h0 is not None else None)
    tol_y, tol_h = ROUNDED_TOL[dtype], ROUNDED_TOL["float32"]   # h is fp32
    ok_y, err_y, ratio_y = within(torch, y, y_ref, tol_y[0] + tol_y[1] * y_ref.abs())
    ok_h, err_h, ratio_h = within(torch, h, h_ref, tol_h[0] + tol_h[1] * h_ref.abs())
    typical = y_ref.abs().float().median().item()
    del y_ref
    ms = time_ms(torch, lambda: rglru_cuda(x, r, i, lam, h0), per=KERNEL_BATCH)
    call_ms = time_ms(torch, lambda: rglru_cuda(x, r, i, lam, h0))
    plain_ms = time_ms(torch, lambda: _rglru_scan(x, r, i, lam, h0), reps=11)
    # the kernel is deterministic: a call after the timed ones gives the same bits
    y2, h2 = rglru_cuda(x, r, i, lam, h0)
    same = bool(torch.equal(y, y2) and torch.equal(h, h2))
    bound_ms, bound_by = rglru_bound(B, S, W, dtype, with_h0)
    res = {"case": label, "shape": [B, S, W], "dtype": dtype, "h0": with_h0,
           "decay": decay, "err_y": err_y, "err_h": err_h,
           "err_over_limit_y": ratio_y, "err_over_limit_h": ratio_h,
           "median_abs_y": typical, "tol_y": tol_y, "tol_h": tol_h,
           "same_bits_again": same, "ok": ok_y and ok_h and same, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log("rglru_fwd check " + json.dumps(res))
    return res


def check_ssd(torch, case, gen):
    """Kernel vs plain version on one input set; returns a result dict."""
    from repro_torch.kernels.ssd.kernel import WGMMA_SHAPE, kernel_chunk, ssd_cuda
    from repro_torch.kernels.ssd.ops import _ssd_chunked
    from repro_torch.kernels.ssd.ref import bf16_ssd_limit
    label, B, S, H, P, N, dtype, with_s0, chunk, decay = case
    tdt = getattr(torch, dtype)
    dev = "cuda"
    x = torch.randn(B, S, H, P, device=dev, generator=gen).to(tdt)
    if decay == "slow":
        # a in (0.99, 1): a chunk's carry and its first rows weigh on the next.
        a = 0.99 + 0.01 * torch.rand(B, S, H, device=dev, generator=gen)
    else:
        a = torch.sigmoid(torch.randn(B, S, H, device=dev, generator=gen)) * 0.5 + 0.5
    Bm = (torch.randn(B, S, N, device=dev, generator=gen) * 0.3).to(tdt)
    Cm = (torch.randn(B, S, N, device=dev, generator=gen) * 0.3).to(tdt)
    s0 = (torch.randn(B, H, P, N, device=dev, generator=gen) * 0.1
          if with_s0 else None)

    kernel = ("ssd_fwd_wgmma" if dtype == "bfloat16" and (P, N) == WGMMA_SHAPE
              else "ssd_fwd")
    y, sf = ssd_cuda(x, a, Bm, Cm, s0, chunk=chunk)
    torch.cuda.synchronize()

    def f64(t):
        return None if t is None else t.double()

    y_ref, sf_ref = _ssd_chunked(f64(x), f64(a), f64(Bm), f64(Cm), f64(s0), chunk=chunk)
    if dtype == "bfloat16":
        tol = "bf16_ssd_limit"
        lim_y, lim_s = bf16_ssd_limit(y_ref, x, a, Bm, Cm, s0, chunk=kernel_chunk(chunk, S))
    else:
        tol = ROUNDED_TOL[dtype]
        lim_y, lim_s = tol[0] + tol[1] * y_ref.abs(), tol[0] + tol[1] * sf_ref.abs()
    median_limit = lim_y.float().median().item()
    ok_y, err_y, ratio_y = within(torch, y, y_ref, lim_y)
    ok_s, err_s, ratio_s = within(torch, sf, sf_ref, lim_s)
    del lim_y, lim_s
    typical = y_ref.abs().float().median().item()
    ms = time_ms(torch, lambda: ssd_cuda(x, a, Bm, Cm, s0, chunk=chunk), per=KERNEL_BATCH)
    call_ms = time_ms(torch, lambda: ssd_cuda(x, a, Bm, Cm, s0, chunk=chunk))
    plain_ms = time_ms(torch, lambda: _ssd_chunked(x, a, Bm, Cm, s0, chunk=chunk),
                       reps=21)
    bound_ms, bound_by = ssd_bound(B, S, H, P, N, dtype, with_s0, chunk)
    res = {"case": label, "kernel": kernel, "shape": [B, S, H, P, N], "dtype": dtype,
           "s0": with_s0, "chunk": chunk, "decay": decay, "err_y": err_y,
           "err_state": err_s, "err_over_limit_y": ratio_y,
           "err_over_limit_state": ratio_s, "median_abs_y": typical,
           "median_limit_y": median_limit,
           "tol": tol, "ok": ok_y and ok_s, "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"{kernel} check " + json.dumps(res))
    return res


def left_pad_segments(torch, lengths, S):
    """(B, S) int32 on the card: 0 for a row's left pads, 1 for its prompt."""
    return (torch.arange(S, device="cuda")[None, :]
            >= S - torch.tensor(lengths, device="cuda")[:, None]).int()


def wave_inputs(torch, rows):
    """A wave's prompts (a list of 1-d int arrays) as the serving engine
    passes them: (tokens, prefill keywords, context_start), LEFT-padded to the
    longest with the engine's default pad id 0, segment 0 for pads, positions
    the wave's padded coordinates, and each row's first valid position for
    decode."""
    lens = [len(r) for r in rows]
    B, S = len(rows), max(lens)
    tokens = torch.zeros((B, S), dtype=torch.int64)
    for i, r in enumerate(rows):
        tokens[i, S - lens[i]:] = torch.as_tensor(r)
    kw = dict(positions=torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S),
              segments=left_pad_segments(torch, lens, S))
    context_start = torch.tensor([S - n for n in lens], dtype=torch.int32, device="cuda")
    return tokens.cuda(), kw, context_start


def profile_table(torch, prof, window_us: float, top: int = 10):
    """(device-busy ms, idle share, launches, top kernels) of a profiled
    window: the CUDA kernels' durations summed by name (one stream, so they
    do not overlap)."""
    from torch.autograd import DeviceType
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n, us = by_kernel.get(evt.name, (0, 0.0))
            by_kernel[evt.name] = (n + 1, us + evt.time_range.elapsed_us())
    if not by_kernel:
        fail("the profiler recorded no CUDA kernel in the window")
    busy_us = sum(us for _, us in by_kernel.values())
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    return (busy_us / 1e3, 1 - busy_us / window_us,
            sum(n for n, _ in by_kernel.values()),
            [{"name": name[:80], "launches": n, "ms": us / 1e3}
             for name, (n, us) in ranked])


def profile_serve(torch, model, rows, decode_steps: int = 8, phases=None) -> None:
    """Where one wave's time goes: a profiled prefill and decode window.

    Per phase, prints the host-clock window, the device-busy time (the sum of
    the CUDA kernels' durations: one stream, so they do not overlap), the
    device's idle share of the window, and the top kernels by device time.
    The full per-operator tables go to
    ``chiprun_out/profile_<model>_<phase>.txt``.
    ``phases``, a list of (name, function, fields to print), takes the place
    of the wave's prefill and decode (the encoder-decoder's passes).
    """
    from torch.profiler import ProfilerActivity, profile

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if phases is None:
        tokens, kw, context_start = wave_inputs(torch, rows)
        logits, cache, pos = model.prefill(tokens, **kw)    # warm the path once
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()

        def prefill():
            model.prefill(tokens, **kw)

        def decode():
            step_cache, step_tok = cache, tok
            for i in range(decode_steps):
                step_logits, step_cache = model.decode_step(step_cache, step_tok, pos + i,
                                                            context_start)
                step_tok = step_logits[:, -1].argmax(-1)[:, None]

        info = {"batch": tokens.shape[0], "prompt_len": tokens.shape[1],
                "prompt_lens": [len(r) for r in rows]}
        phases = [("prefill", prefill, dict(info, decode_steps=0)),
                  ("decode", decode, dict(info, decode_steps=decode_steps))]

    for phase, fn, info in phases:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        busy_ms, idle, launches, top = profile_table(torch, prof, window_us, top=8)
        log("profile " + json.dumps({
            "model": model.cfg.name, "phase": phase, **info,
            "window_ms": window_us / 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": idle, "kernel_launches": launches,
            "top_kernels": top}))
        (out_dir / f"profile_{model.cfg.name}_{phase}.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))


def counters():
    """The launch counters, as (wrapper, attribute).  ``flash_fwd`` counts
    every flash-attention launch, of either kernel; ``flash_fwd_wgmma`` the
    tensor-core kernel's alone; ``ssd_fwd`` and ``ssd_fwd_wgmma`` likewise
    for SSD."""
    from repro_torch.kernels.flash_attention.kernel import flash_cuda
    from repro_torch.kernels.rglru.kernel import rglru_cuda
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    return {"ssd_fwd": (ssd_cuda, "launches"),
            "ssd_fwd_wgmma": (ssd_cuda, "wgmma_launches"),
            "rglru_fwd": (rglru_cuda, "launches"),
            "flash_fwd": (flash_cuda, "launches"),
            "flash_fwd_wgmma": (flash_cuda, "wgmma_launches")}


# ---- every kernel call of one pass held to its plain version ----------------

# The float64 scores of one chunk of the flash reference (256 MiB): a whole
# wave's would not fit beside the model (arctic-480b's 56 heads at wave A:
# 36 GB).
HOLD_ELEMENTS = 1 << 25
# Which calls each launch counter of ``counters()`` counts.
COUNTED = {"flash_fwd": ("flash_fwd", "flash_fwd_wgmma"),
           "flash_fwd_wgmma": ("flash_fwd_wgmma",),
           "ssd_fwd": ("ssd_fwd", "ssd_fwd_wgmma"), "ssd_fwd_wgmma": ("ssd_fwd_wgmma",),
           "rglru_fwd": ("rglru_fwd",)}


def worst_share(torch, got, want, limit, worst):
    """max(worst, max |got - want| / limit) as a 0-d float64 tensor (no sync)."""
    return torch.maximum(worst, ((got.double() - want).abs() / limit).max())


def flash_share(torch, out, q, k, v, opts) -> float:
    """The largest |out - want| / limit of one flash-attention call: want is
    ``attention_reference`` in float64 on the same q, k, v and options, the
    limit ``bf16_flash_limit`` for a bf16 output (``ROUNDED_TOL`` for fp32);
    inf where out is not finite.  Computed per batch row and KV head (with
    its group of q heads), over chunks of q rows whose scores hold at most
    ``HOLD_ELEMENTS``; the plain result on |v|, which the limit needs, rides
    along as D more value columns."""
    from repro_torch.kernels.flash_attention.ref import attention_reference, bf16_flash_limit
    if not torch.isfinite(out).all():
        return math.inf
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    rows = max(1, HOLD_ELEMENTS // (group * Sk))
    qs, ks = opts.get("q_segments"), opts.get("kv_segments")
    kw = {name: opts.get(name, default) for name, default in (
        ("causal", True), ("window", None), ("softcap", None), ("scale", None))}
    worst = torch.zeros((), dtype=torch.float64, device=q.device)
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * group, (h + 1) * group)
            vh = v[b:b + 1, :, h:h + 1].double()
            kh, v2 = k[b:b + 1, :, h:h + 1].double(), torch.cat([vh, vh.abs()], dim=-1)
            for r0 in range(0, Sq, rows):
                r = slice(r0, min(Sq, r0 + rows))
                both = attention_reference(
                    q[b:b + 1, r, heads].double(), kh, v2,
                    q_segments=None if qs is None else qs[b:b + 1, r],
                    kv_segments=None if ks is None else ks[b:b + 1],
                    q_offset=opts.get("q_offset", 0) + r0, **kw)
                want = both[..., :D]
                limit = (bf16_flash_limit(want, both[..., D:]) if out.dtype == torch.bfloat16
                         else ROUNDED_TOL["float32"][0]
                         + ROUNDED_TOL["float32"][1] * want.abs())
                worst = worst_share(torch, out[b:b + 1, r, heads], want, limit, worst)
    return worst.item()


def ssd_share(torch, y, state, x, a, Bm, Cm, s0, chunk: int) -> float:
    """As :func:`flash_share` for one SSD call (y and the final state):
    ``_ssd_chunked`` in float64, ``bf16_ssd_limit`` at the kernel's chunk for
    bf16 (``ROUNDED_TOL`` for fp32)."""
    from repro_torch.kernels.ssd.kernel import kernel_chunk
    from repro_torch.kernels.ssd.ops import _ssd_chunked
    from repro_torch.kernels.ssd.ref import bf16_ssd_limit
    if not (torch.isfinite(y).all() and torch.isfinite(state).all()):
        return math.inf
    f64 = [None if t is None else t.double() for t in (x, a, Bm, Cm, s0)]
    y_ref, s_ref = _ssd_chunked(*f64, chunk=chunk)
    if x.dtype == torch.bfloat16:
        lim_y, lim_s = bf16_ssd_limit(y_ref, x, a, Bm, Cm, s0,
                                      chunk=kernel_chunk(chunk, x.shape[1]))
    else:
        atol, rtol = ROUNDED_TOL["float32"]
        lim_y, lim_s = atol + rtol * y_ref.abs(), atol + rtol * s_ref.abs()
    worst = torch.zeros((), dtype=torch.float64, device=x.device)
    return worst_share(torch, state, s_ref, lim_s,
                       worst_share(torch, y, y_ref, lim_y, worst)).item()


def rglru_share(torch, y, h, x, r, i, lam, h0) -> float:
    """As :func:`flash_share` for one RG-LRU call (y and the final h):
    ``_rglru_scan`` in float64, y held to ``ROUNDED_TOL`` of its dtype and
    the fp32 h to fp32's."""
    from repro_torch.kernels.rglru.ops import _rglru_scan
    if not (torch.isfinite(y).all() and torch.isfinite(h).all()):
        return math.inf
    y_ref, h_ref = _rglru_scan(*[None if t is None else t.double()
                                 for t in (x, r, i, lam, h0)])
    worst = torch.zeros((), dtype=torch.float64, device=x.device)
    for got, want, dtype in ((y, y_ref, str(y.dtype).split(".")[-1]), (h, h_ref, "float32")):
        atol, rtol = ROUNDED_TOL[dtype]
        worst = worst_share(torch, got, want, atol + rtol * want.abs(), worst)
    return worst.item()


@contextlib.contextmanager
def held_calls(torch):
    """For the ``with`` block, each kernel wrapper that the models call (the
    ``*_cuda`` attribute of its ``kernel`` module, which the ops import at
    each call) is swapped for one that calls it and then holds the call's
    output to its plain version in float64 on the same inputs.  Yields the
    list of records, one a call: the kernel, its shapes and options, and
    ``share``, the largest error as a share of the limit (<= 1 within it).
    The wrappers are put back on exit.  A wrapper counts its launches on
    its module's attribute of its name, which is the swapped one in the
    block: the swapped one starts from the wrapper's counts, and what it
    counted is added to them on exit."""
    import importlib
    from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS
    from repro_torch.kernels.ssd.kernel import WGMMA_SHAPE
    mods = {name: importlib.import_module(f"repro_torch.kernels.{name}.kernel")
            for name in ("flash_attention", "ssd", "rglru")}
    flash_cuda = mods["flash_attention"].flash_cuda
    ssd_cuda, rglru_cuda = mods["ssd"].ssd_cuda, mods["rglru"].rglru_cuda
    records = []
    bf16 = torch.bfloat16

    def flash(q, k, v, **opts):
        out = flash_cuda(q, k, v, **opts)
        D = q.shape[-1]
        records.append({
            "kernel": ("flash_fwd_wgmma" if q.dtype == bf16 and D in WGMMA_HEAD_DIMS
                       else "flash_fwd"),
            "q": list(q.shape), "kv": list(k.shape), "causal": opts.get("causal", True),
            "window": opts.get("window"), "softcap": opts.get("softcap"),
            "q_offset": opts.get("q_offset", 0),
            "segments": opts.get("q_segments") is not None,
            "share": flash_share(torch, out, q, k, v, opts)})
        return out

    def ssd(x, a, Bm, Cm, s0=None, *, chunk=256):
        y, state = ssd_cuda(x, a, Bm, Cm, s0, chunk=chunk)
        records.append({
            "kernel": ("ssd_fwd_wgmma" if x.dtype == bf16 and tuple(x.shape[3:]) + (
                Bm.shape[-1],) == WGMMA_SHAPE else "ssd_fwd"),
            "x": list(x.shape), "N": Bm.shape[-1], "chunk": chunk, "s0": s0 is not None,
            "share": ssd_share(torch, y, state, x, a, Bm, Cm, s0, chunk)})
        return y, state

    def rglru(x, r, i, lam, h0=None):
        y, h = rglru_cuda(x, r, i, lam, h0)
        records.append({"kernel": "rglru_fwd", "x": list(x.shape), "h0": h0 is not None,
                        "share": rglru_share(torch, y, h, x, r, i, lam, h0)})
        return y, h

    swaps = ((mods["flash_attention"], "flash_cuda", flash_cuda, flash),
             (mods["ssd"], "ssd_cuda", ssd_cuda, ssd),
             (mods["rglru"], "rglru_cuda", rglru_cuda, rglru))
    start = [{c: getattr(wrapper, c) for c in ("launches", "wgmma_launches")
              if hasattr(wrapper, c)} for _, _, wrapper, _ in swaps]
    for (mod, name, _, held), counts in zip(swaps, start):
        held.__dict__.update(counts)
        setattr(mod, name, held)
    try:
        yield records
    finally:
        for (mod, name, wrapper, held), counts in zip(swaps, start):
            setattr(mod, name, wrapper)
            for c, n in counts.items():
                setattr(wrapper, c, getattr(wrapper, c) + getattr(held, c) - n)


def hold_calls(torch, run, expect: dict, tag: str) -> dict:
    """Runs ``run()`` (one pass, untimed) under :func:`held_calls` and fails
    unless every call lies within its limit and, for each launch counter in
    ``expect``, the calls checked and the launches counted both equal its
    value.  Prints and returns, per kernel, the calls checked and the
    largest share of the limit."""
    before = {name: getattr(fn, attr, 0) for name, (fn, attr) in counters().items()}
    t0 = time.perf_counter()
    with held_calls(torch) as records:
        run()
    launched = {name: getattr(fn, attr, 0) - before[name]
                for name, (fn, attr) in counters().items()}
    for name, want in expect.items():
        checked = sum(r["kernel"] in COUNTED[name] for r in records)
        if checked != want or launched[name] != want:
            fail(f"{tag}: {checked} {name} calls checked and {launched[name]} launched, "
                 f"expected {want}")
    bad = [r for r in records if not r["share"] <= 1.0]
    if bad:
        fail(f"{tag}: {len(bad)} of {len(records)} kernel calls lie outside their limit, "
             f"first {json.dumps(bad[:3])}")
    summary = {}
    for r in records:
        s = summary.setdefault(r["kernel"], {"calls": 0, "max_share_of_limit": 0.0})
        s["calls"] += 1
        s["max_share_of_limit"] = max(s["max_share_of_limit"], r["share"])
    log(f"hold {tag} " + json.dumps({"kernels": summary, "windows": sorted(
        {str(r["window"]) for r in records if "window" in r}),
        "seconds": time.perf_counter() - t0}))
    return summary


def hold_wave(torch, model, rows, expect: dict, tag: str) -> dict:
    """One more prefill of a served wave's rows, untimed, with every kernel
    call held to its plain version (:func:`hold_calls`), then one decode
    step: logits finite, of the right shape, the padded vocab at -1e30."""
    cfg = model.cfg
    tokens, kw, context_start = wave_inputs(torch, rows)
    out = {}
    summary = hold_calls(torch, lambda: out.update(prefill=model.prefill(tokens, **kw)),
                         expect, tag)
    logits, cache, pos = out.pop("prefill")
    step, _ = model.decode_step(cache, logits[:, -1].argmax(-1)[:, None], pos, context_start)
    for name, t in (("prefill", logits), ("decode", step)):
        check_logits(torch, cfg, t, (len(rows), 1, cfg.padded_vocab), f"{tag} {name}")
    return summary


def flash_expect(n: int) -> dict:
    """A pass whose every launch is ``n`` on ``flash_fwd_wgmma``."""
    return {"ssd_fwd": 0, "ssd_fwd_wgmma": 0, "rglru_fwd": 0, "flash_fwd": n,
            "flash_fwd_wgmma": n}


def serve_waves(torch, model, cold_len: int, wave_lens, expect: dict, tag: str,
                prompt_gen):
    """A cold-start wave, then the measured waves through
    ``ServeEngine(max_batch=4)``, 32 greedy tokens each.  A wave's entry in
    ``wave_lens`` is a prompt length (4 prompts of it) or a tuple of 4
    lengths (one padded wave).  Every launch count is set to 0 just before
    each measured wave and must read ``expect`` (kernel name -> launches)
    just after it.  Returns (each wave's prompts, total launches by
    kernel)."""
    from repro_torch.serve import ServeEngine
    cfg = model.cfg
    engine = ServeEngine(model, max_batch=4)
    # A first wave pays one-time costs (cuBLAS handles and heuristics, the
    # caching allocator's first blocks); it is timed apart as the cold start.
    for p in torch.randint(3, cfg.vocab_size, (4, cold_len),
                           generator=torch.Generator().manual_seed(2)).numpy():
        engine.submit(p, max_new_tokens=2)
    engine.run()
    log(f"{tag} cold-start wave (4 x {cold_len} prompts, 2 tokens): prefill "
        f"{engine.wave_stats[-1]['prefill_s'] * 1e3:.1f} ms")
    waves, wave_prompts = [], []
    total = {name: 0 for name in expect}
    for prompt_len in wave_lens:
        lens = prompt_len if isinstance(prompt_len, tuple) else (prompt_len,) * 4
        prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=prompt_gen).numpy()
                   for n in lens]
        wave_prompts.append(prompts)
        ids = [engine.submit(p, max_new_tokens=32) for p in prompts]
        for fn, attr in counters().values():
            setattr(fn, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        engine.run()
        wave_peak = torch.cuda.max_memory_allocated() / 2**30
        got = {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}
        for name, want in expect.items():
            if got[name] != want:
                fail(f"{tag} wave of {prompt_len}-token prompts launched {name} "
                     f"{got[name]} times, expected {want}")
            total[name] += got[name]
        for rid in ids:
            req = engine.result(rid)
            if not req.done or len(req.output) != 32:
                fail(f"{tag} request {rid} did not finish: {len(req.output)} tokens")
        stats = engine.wave_stats[-1]
        waves.append(dict(stats, launches=got, peak_mem_gib=wave_peak,
                          decode_tok_per_s=stats["decode_tokens"] / stats["decode_s"]))
    log(f"serve {tag} " + json.dumps({
        "waves": [{k: w[k] for k in ("batch", "prompt_len", "prompt_lens", "launches",
                                     "decode_steps", "decode_tokens", "peak_mem_gib")}
                  | {"prefill_ms": w["prefill_s"] * 1e3,
                     "decode_tok_per_s": w["decode_tok_per_s"]} for w in waves],
        "peak_mem_gib": max(w["peak_mem_gib"] for w in waves)}))
    return wave_prompts, total


def full_width_logits(torch, model, rows, plain: dict, tag: str) -> None:
    """Prefill and one decode step of a wave: finite logits of the right
    shape; then the kernel path against the plain path (bf16 compute,
    information only)."""
    cfg = model.cfg
    tokens, kw, context_start = wave_inputs(torch, rows)
    logits, cache, pos = model.prefill(tokens, **kw)
    if tuple(logits.shape) != (tokens.shape[0], 1, cfg.padded_vocab):
        fail(f"{tag} prefill logits have shape {tuple(logits.shape)}")
    step_logits, _ = model.decode_step(cache, logits[:, -1].argmax(-1)[:, None], pos,
                                       context_start)
    for name, t in (("prefill", logits[..., :cfg.vocab_size]),
                    ("decode", step_logits[..., :cfg.vocab_size])):
        if not torch.isfinite(t).all():
            fail(f"{tag} full-width {name} logits are not finite")
    del cache
    rt = model.rt
    model.rt = rt.with_(**plain)
    plain_logits, _, _ = model.prefill(tokens, **kw)
    model.rt = rt
    agree = (plain_logits.argmax(-1) == logits.argmax(-1)).sum().item()
    log(f"{tag} full-width prefill logits at S = {tokens.shape[1]}, kernel path vs "
        f"plain path (bf16 compute, information only): max abs diff "
        f"{(plain_logits - logits)[..., :cfg.vocab_size].abs().max().item()}, "
        f"greedy tokens agree {agree}/{tokens.shape[0]}")


def smoke_reference(torch, cfg, plain: dict, prompt_lens, steps: int, seed: int,
                    **rt_kw) -> None:
    """Smoke-size model in fp32 on the card: kernel path against the plain
    path, prefill and ``steps`` decode steps, logits within fp32 tolerance."""
    from repro_torch.models import RuntimeConfig, build_model
    small = build_model(cfg, RuntimeConfig(compute_dtype=torch.float32, **rt_kw),
                        device="cuda", seed=seed)
    tol = FP32_TOL
    gen = torch.Generator().manual_seed(seed)
    base = small.rt
    for prompt_len in prompt_lens:
        toks, kw, _ = wave_inputs(torch, torch.randint(3, cfg.vocab_size, (2, prompt_len),
                                                       generator=gen).numpy())
        runs = []
        for rt in (base, base.with_(**plain)):
            small.rt = rt
            logits, cache, pos = small.prefill(toks, **kw)
            out = [logits]
            tok = logits[:, -1].argmax(-1)[:, None]
            for i in range(steps):
                logits, cache = small.decode_step(cache, tok, pos + i)
                out.append(logits)
                tok = logits[:, -1].argmax(-1)[:, None]
            runs.append(out)
        small.rt = base
        for i, (g, w) in enumerate(zip(*runs)):
            diff = (g - w).abs()
            name = "prefill" if i == 0 else f"decode {i}"
            if i in (0, 1, steps):
                log(f"smoke {cfg.name} ({cfg.n_layers} layers) prompt {prompt_len} "
                    f"{name} logits, kernel vs plain: max abs diff {diff.max().item()}")
            if not (diff <= tol + tol * w.abs()).all():
                fail(f"smoke {cfg.name} prompt {prompt_len} {name} logits "
                     f"disagree beyond {tol}")
    del small


# qwen2.5-32b prefill_32k's attention (B, S, Hq, Hkv, D) and the dry-run's
# "model" ranks that split its query rows
QWEN_ROWS, QWEN_RANKS = (2, 32768, 40, 8, 128), 16

FLASH_CASES = [
    # label, B, Sq, Sk, Hq, Hkv, D, dtype, causal, window, softcap,
    # q_offset, segments, plain (block_q, block_k)
    ("serve wave A", 4, 3072, 3072, 16, 1, 256, "bfloat16", True, 2048, None,
     0, "ones", (512, 1024)),
    ("serve wave A fp32", 4, 3072, 3072, 16, 1, 256, "float32", True, 2048, None,
     0, "ones", (512, 1024)),
    ("ragged fp32", 2, 300, 300, 8, 2, 64, "float32", True, 100, None, 0, None,
     (300, 300)),
    ("gqa 2, softcap 50", 2, 512, 512, 8, 4, 128, "bfloat16", True, None, 50.0,
     0, None, (256, 256)),
    ("non-causal", 2, 256, 256, 4, 4, 64, "float32", False, None, None, 0, None,
     (128, 128)),
    ("q_offset, Sq < Sk", 2, 64, 320, 4, 1, 128, "float32", True, 128, None,
     256, None, (64, 64)),
    ("masked rows", 2, 256, 256, 8, 1, 64, "bfloat16", True, None, None, 0,
     "packed", (128, 128)),
    ("head_dim 256 fp32", 1, 200, 200, 4, 1, 256, "float32", True, 64, None, 0,
     "packed", (200, 200)),
    # gemma2-9b's wave A: left-padded rows, a ragged Sk (4500 = 70 x 64 +
    # 20), GQA 2 at head_dim 256, softcap 50; its global and local layers.
    ("gemma2 wave A global", 4, 4500, 4500, 16, 8, 256, "bfloat16", True, None,
     50.0, 0, GEMMA2_WAVE_A, (512, 1024)),
    ("gemma2 wave A local", 4, 4500, 4500, 16, 8, 256, "bfloat16", True, 4096,
     50.0, 0, GEMMA2_WAVE_A, (512, 1024)),
    # mixtral-8x22b's wave A: GQA 6 at head_dim 128, window 4096 on every
    # layer, the same left-padded rows.
    ("mixtral wave A", 4, 4500, 4500, 48, 8, 128, "bfloat16", True, 4096, None,
     0, GEMMA2_WAVE_A, (512, 1024)),
    # seamless-m4t-medium: the encoder's non-causal self-attention, and the
    # forward's cross-attention (Sq != Sk), both at head_dim 64.
    ("seamless encoder", 4, 1024, 1024, 16, 16, 64, "bfloat16", False, None, None,
     0, None, (512, 1024)),
    ("seamless cross", 4, 256, 1024, 16, 16, 64, "bfloat16", False, None, None,
     0, None, (256, 1024)),
    # phase 4e's wave-A shapes that no case above covers: gemma3-12b's local
    # layers (window 1024, shorter than three of the four prompts) and
    # stablelm-1.6b's multi-head attention at head_dim 64, both left-padded.
    ("gemma3 wave A local", 4, 4500, 4500, 16, 8, 256, "bfloat16", True, 1024, None,
     0, GEMMA2_WAVE_A, (512, 1024)),
    ("stablelm wave A", 4, 4500, 4500, 32, 32, 64, "bfloat16", True, None, None,
     0, GEMMA2_WAVE_A, (512, 1024)),
    # qwen2.5-32b's prefill_32k on the dry-run's 16 "model" ranks: its 40 q
    # heads do not divide 16, so the attention splits each row's 32768
    # queries into 16 chunks of 2048 (B 2: 32 rows over 16 "data" ranks),
    # rank r attending from q_offset 2048 r; the first and the busiest rank.
    *((f"qwen rows rank {r} of {QWEN_RANKS}", QWEN_ROWS[0],
       QWEN_ROWS[1] // QWEN_RANKS, *QWEN_ROWS[1:], "bfloat16", True, None, None,
       r * QWEN_ROWS[1] // QWEN_RANKS, None, (512, 1024)) for r in (0, QWEN_RANKS - 1)),
]


def check_flash_rows(torch, gen) -> dict:
    """The query-rows split of the "qwen rows" cases (``FLASH_CASES``): the
    16 ranks' chunks of one input set through ``flash_fwd_wgmma`` at their
    q_offsets, their concatenation held to ``bf16_flash_limit`` against the
    plain version of the whole attention in float64, and compared with the
    kernel's one call on the whole."""
    from repro_torch.kernels.flash_attention.kernel import flash_cuda
    from repro_torch.kernels.flash_attention.ops import _flash_chunked
    from repro_torch.kernels.flash_attention.ref import bf16_flash_limit
    (B, S, Hq, Hkv, D), n = QWEN_ROWS, QWEN_RANKS
    rows = S // n
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    wide = dict(causal=True, window=None, softcap=None, q_segments=None,
                kv_segments=None, q_offset=0, scale=None, block_q=1024, block_k=1024)
    want = _flash_chunked(q.double(), k.double(), v.double(), **wide)
    limit = bf16_flash_limit(want, _flash_chunked(q.double(), k.double(),
                                                  v.double().abs(), **wide))
    cat = torch.cat([flash_cuda(q[:, r * rows:(r + 1) * rows], k, v, causal=True,
                                q_offset=r * rows) for r in range(n)], dim=1)
    ok, err, ratio = within(torch, cat, want, limit)
    whole = flash_cuda(q, k, v, causal=True)
    res = {"case": f"qwen rows: {n} chunks concatenated vs the whole attention",
           "kernel": "flash_fwd_wgmma", "shape": [B, S, S, Hq, Hkv, D],
           "dtype": "bfloat16", "err": err, "err_over_limit": ratio,
           "tol": "bf16_flash_limit", "ok": ok,
           "max_abs_diff_vs_kernel_whole": (cat.float() - whole.float()).abs().max().item()}
    log("flash_fwd_wgmma check " + json.dumps(res))
    return res


def serve_gemma2(torch, prompt_gen, profiling: bool) -> dict:
    """Phase 4b (see the module docstring); returns its launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeConfig, build_model
    cfg = get_config("gemma2-9b")
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    t0 = time.perf_counter()
    model = build_model(cfg, RuntimeConfig(max_cache_len=max(GEMMA2_WAVE_A) + 32),
                        device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"model {cfg.name}: {cfg.n_layers} layers ({kinds.count('local')} local, "
        f"{kinds.count('global')} global), d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in model.parameters())} params (n_params() "
        f"{cfg.n_params()}), built in {time.perf_counter() - t0:.1f} s")
    prompts, launches = serve_waves(
        torch, model, 1024, (GEMMA2_WAVE_A, 1024),
        flash_expect(cfg.n_layers), "gemma2", prompt_gen)
    if profiling:
        profile_serve(torch, model, prompts[0])
    full_width_logits(torch, model, prompts[0], {"attn_impl": "chunked"}, "gemma2")
    hold_wave(torch, model, prompts[0], flash_expect(cfg.n_layers), "gemma2 wave A")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# mixtral-8x22b's depth on one card: 4 of its 56 layers hold 10.42 B
# parameters, 41.7 GB in fp32; each layer's prefill also casts its 2.42 B
# expert weights to bf16, a transient of about 4.8 GB.
MIXTRAL_DEPTH = 4


def moe_breakdown(torch, model, B: int, S: int) -> dict:
    """Where one MoE layer's time goes at a (B, S) wave: CUDA-event medians
    of ``moe_apply`` on layer 0's weights and of its parts at the same shapes
    (the three fp32 -> bf16 expert weight casts, the dispatch einsum, the
    expert einsums with the SiLU gate, the combine einsum); the rest of
    ``moe_apply`` is the router, the one-hot dispatch and combine build and
    the aux loss.  The times do not depend on the routing: every einsum
    computes all (group, expert, slot) rows."""
    import torch.nn.functional as F
    from repro_torch.models.moe import moe_apply, moe_groups
    cfg, rt = model.cfg, model.rt
    cd = rt.compute_dtype
    G, g, C = moe_groups(B * S, cfg, rt)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    with torch.inference_mode():
        p = model.blocks[0]["moe"]
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((B, S, D), device="cuda", generator=gen).to(cd)
        xg = x.reshape(G, g, D)
        onehot = torch.zeros((G, g, E, C), device="cuda", dtype=cd)
        w = {k: p[k].to(cd) for k in ("wi", "wg", "wo")}
        xd = torch.einsum("gtec,gtd->gecd", onehot, xg)

        def experts():
            h = torch.einsum("gecd,edf->gecf", xd, w["wi"])
            gt = torch.einsum("gecd,edf->gecf", xd, w["wg"])
            return torch.einsum("gecf,efd->gecd", h * F.silu(gt), w["wo"])

        ye = experts()
        parts = {
            "moe_apply": lambda: moe_apply(p, x, cfg, rt),
            "expert weight casts": lambda: [p[k].to(cd) for k in ("wi", "wg", "wo")],
            "dispatch einsum": lambda: torch.einsum("gtec,gtd->gecd", onehot, xg),
            "expert einsums": experts,
            "combine einsum": lambda: torch.einsum("gtec,gecd->gtd", onehot, ye),
        }
        ms = {name: time_ms(torch, fn, reps=11, warmup=2) for name, fn in parts.items()}
        del w, xd, ye, onehot
    whole = ms["moe_apply"]
    ms["router, one-hots, aux (the rest)"] = whole - sum(
        v for k, v in ms.items() if k != "moe_apply")
    expert_flop = 2 * 3 * G * E * C * D * Fd
    res = {"shape": [B, S], "groups": G, "group": g, "capacity": C, "ms": ms,
           "share_of_moe_apply": {k: v / whole for k, v in ms.items() if k != "moe_apply"},
           "expert_einsum_tflops": expert_flop / ms["expert einsums"] / 1e9,
           "dispatched_over_routed": G * E * C / (B * S * cfg.experts_per_token)}
    log(f"moe breakdown {cfg.name} layer 0 " + json.dumps(res))
    return res


def serve_mixtral(torch, prompt_gen, profiling: bool) -> dict:
    """Phase 4c (see the module docstring); returns its launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeConfig, build_model
    full = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_DEPTH)
    t0 = time.perf_counter()
    model = build_model(cfg, RuntimeConfig(max_cache_len=max(GEMMA2_WAVE_A) + 32),
                        device="cuda", seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.name}: depth cut to {cfg.n_layers} of {full.n_layers} layers "
        f"(full depth: n_params() {full.n_params()}, {full.n_params() * 4 / 1e9:.1f} GB "
        f"in fp32, more than one card holds), d_model {cfg.d_model}, {cfg.n_experts} "
        f"experts top {cfg.experts_per_token} of width {cfg.moe_d_ff}, window "
        f"{cfg.sliding_window}; {n} params ({n * 4 / 1e9:.2f} GB in fp32; n_params() "
        f"{cfg.n_params()}), built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompts, launches = serve_waves(
        torch, model, 1024, (GEMMA2_WAVE_A, 1024),
        flash_expect(cfg.n_layers), "mixtral", prompt_gen)
    moe_breakdown(torch, model, len(GEMMA2_WAVE_A), max(GEMMA2_WAVE_A))
    if profiling:
        profile_serve(torch, model, prompts[0])
    full_width_logits(torch, model, prompts[0], {"attn_impl": "chunked"}, "mixtral")
    hold_wave(torch, model, prompts[0], flash_expect(cfg.n_layers), "mixtral wave A")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SEAMLESS_BATCH, SEAMLESS_FRAMES, SEAMLESS_PROMPT, SEAMLESS_FORWARD = 4, 1024, 64, 256


def check_logits(torch, cfg, logits, shape, tag: str) -> None:
    if tuple(logits.shape) != shape:
        fail(f"{tag} logits have shape {tuple(logits.shape)}, expected {shape}")
    if not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        fail(f"{tag} logits are not finite")
    if not (logits[..., cfg.vocab_size:] == -1e30).all():
        fail(f"{tag} logits of the padded vocab are not -1e30")


def serve_seamless(torch, profiling: bool) -> dict:
    """Phase 4d (see the module docstring); returns its launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeConfig, build_model
    cfg = get_config("seamless-m4t-medium")
    B, steps = SEAMLESS_BATCH, 32
    t0 = time.perf_counter()
    model = build_model(cfg, RuntimeConfig(max_cache_len=SEAMLESS_PROMPT + steps),
                        device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"model {cfg.name}: {cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
        f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {sum(p.numel() for p in model.parameters())} params "
        f"(n_params() {cfg.n_params()}), built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(8)
    frames = torch.randn((B, SEAMLESS_FRAMES, cfg.d_model), device="cuda",
                         generator=gen) * 0.1
    tokens = torch.randint(3, cfg.vocab_size, (B, SEAMLESS_PROMPT), device="cuda",
                           generator=gen)
    fwd_batch = {"frontend_embeds": frames,
                 "tokens": torch.randint(3, cfg.vocab_size, (B, SEAMLESS_FORWARD),
                                         device="cuda", generator=gen)}

    def zero():
        for fn, attr in counters().values():
            setattr(fn, attr, 0)

    def expect(want_wgmma: int, what: str) -> dict:
        got = {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}
        want = {"ssd_fwd": 0, "ssd_fwd_wgmma": 0, "rglru_fwd": 0,
                "flash_fwd": want_wgmma, "flash_fwd_wgmma": want_wgmma}
        if got != want:
            fail(f"seamless {what} launched {got}, expected {want}")
        return got

    def serve(n_steps):
        """prefill, then greedy decode steps, each waiting for its tokens on
        the host as the serving engine does: (first logits, prefill s,
        decode s)."""
        t0 = time.perf_counter()
        logits, cache, pos = model.prefill(frames, tokens)
        first = logits
        tok = logits[:, -1].argmax(-1)[:, None]
        tok.tolist()
        t1 = time.perf_counter()
        for i in range(n_steps):
            logits, cache = model.decode_step(cache, tok, pos + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            tok.tolist()
        decode_s = time.perf_counter() - t1
        if n_steps:
            check_logits(torch, cfg, logits, (B, 1, cfg.padded_vocab),
                         f"seamless decode step {n_steps}")
        return first, t1 - t0, decode_s

    serve(2)                                     # cold start, and a cold forward
    with torch.inference_mode():
        model(fwd_batch)
    torch.cuda.reset_peak_memory_stats()
    zero()
    logits, prefill_s, _ = serve(0)
    launches = expect(2 * cfg.n_layers, "prefill")
    check_logits(torch, cfg, logits, (B, 1, cfg.padded_vocab), "seamless prefill")
    _, _, decode_s = serve(steps)
    zero()
    with torch.inference_mode():
        t0 = time.perf_counter()
        fwd_logits = model(fwd_batch)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
    fwd_launches = expect(cfg.n_encoder_layers + 2 * cfg.n_layers, "forward")
    check_logits(torch, cfg, fwd_logits, (B, SEAMLESS_FORWARD, cfg.padded_vocab),
                 "seamless forward")
    log("serve seamless " + json.dumps({
        "batch": B, "frames": SEAMLESS_FRAMES, "prompt_len": SEAMLESS_PROMPT,
        "forward_tokens": SEAMLESS_FORWARD, "prefill_ms": prefill_s * 1e3,
        "decode_steps": steps, "decode_tok_per_s": B * steps / decode_s,
        "forward_ms": forward_s * 1e3, "launches_prefill": launches,
        "launches_forward": fwd_launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))
    # the plain path for information (bf16 compute): prefill and forward
    rt = model.rt
    model.rt = rt.with_(attn_impl="chunked")
    plain_logits, _, _ = model.prefill(frames, tokens)
    with torch.inference_mode():
        plain_fwd = model(fwd_batch)
    model.rt = rt
    V = cfg.vocab_size
    log(f"seamless full-width logits, kernel path vs plain path (bf16 compute, "
        f"information only): prefill max abs diff "
        f"{(plain_logits - logits)[..., :V].abs().max().item()}, greedy tokens agree "
        f"{(plain_logits.argmax(-1) == logits.argmax(-1)).sum().item()}/{B}; forward max "
        f"abs diff {(plain_fwd - fwd_logits)[..., :V].abs().max().item()}, greedy tokens "
        f"agree {(plain_fwd.argmax(-1) == fwd_logits.argmax(-1)).float().mean().item()}")
    del plain_logits, plain_fwd, fwd_logits
    hold_calls(torch, lambda: model.prefill(frames, tokens), flash_expect(2 * cfg.n_layers),
               "seamless prefill")
    if profiling:
        info = {"batch": B, "frames": SEAMLESS_FRAMES, "prompt_len": SEAMLESS_PROMPT}

        def forward():
            with torch.inference_mode():
                model(fwd_batch)

        profile_serve(torch, model, None, phases=[
            ("prefill", lambda: serve(0), info),
            ("decode", lambda: serve(8),
             dict(info, decode_steps=8, note="the window holds the prefill too")),
            ("forward", forward, dict(info, forward_tokens=SEAMLESS_FORWARD))])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {name: launches[name] + fwd_launches[name] for name in launches}


# Phase 4e: (arch, depth or None for every layer, param dtype).  stablelm,
# internvl2 and gemma3 keep fp32 params, as phases 3-4d do; qwen2.5-32b's and
# arctic-480b's take ``runtime_for``'s dtype (bf16 above 5e9 parameters), as
# their fp32 params (131 GB; 110.7 GB for arctic's two layers) do not fit.
ARCTIC_DEPTH = 2
SERVE_4E = (("stablelm-1.6b", None, "float32"), ("internvl2-2b", None, "float32"),
            ("gemma3-12b", None, "float32"), ("qwen2.5-32b", None, "runtime_for"),
            ("arctic-480b", ARCTIC_DEPTH, "runtime_for"))
VLM_BATCH, VLM_TEXT, VLM_STEPS = 4, 1024, 32


def serve_vision_prefix(torch, model) -> dict:
    """internvl2's vision prefix, which no engine request carries: one
    ``prefill`` of 4 rows of 1,024 seeded patch embeddings x 0.1 and 1,024
    tokens, every kernel call held, then 32 greedy ``decode_step``s; logits
    finite, of the right shape, the padded vocab at -1e30."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(9)
    embeds = torch.randn((VLM_BATCH, cfg.frontend_tokens, cfg.d_model), device="cuda",
                         generator=gen) * 0.1
    tokens = torch.randint(3, cfg.vocab_size, (VLM_BATCH, VLM_TEXT), device="cuda",
                           generator=gen)
    out = {}
    summary = hold_calls(
        torch, lambda: out.update(prefill=model.prefill(tokens, frontend_embeds=embeds)),
        flash_expect(cfg.n_layers), f"{cfg.name} vision prefix")
    logits, cache, pos = out.pop("prefill")
    if pos != cfg.frontend_tokens + VLM_TEXT:
        fail(f"{cfg.name} vision prefix prefill returned length {pos}")
    shape = (VLM_BATCH, 1, cfg.padded_vocab)
    check_logits(torch, cfg, logits, shape, f"{cfg.name} vision prefix prefill")
    t0 = time.perf_counter()
    for i in range(VLM_STEPS):
        logits, cache = model.decode_step(cache, logits[:, -1].argmax(-1)[:, None], pos + i)
        check_logits(torch, cfg, logits, shape, f"{cfg.name} vision prefix decode step {i}")
    log(f"serve {cfg.name} vision prefix " + json.dumps({
        "batch": VLM_BATCH, "patch_embeds": cfg.frontend_tokens, "tokens": VLM_TEXT,
        "decode_steps": VLM_STEPS,
        "decode_tok_per_s": VLM_BATCH * VLM_STEPS / (time.perf_counter() - t0)}))
    return summary


def serve_family(torch, arch: str, depth, dtype: str, prompt_gen, profiling: bool) -> dict:
    """One family of phase 4e (see the module docstring); returns its
    launches by kernel."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.specs import runtime_for
    from repro_torch.models import RuntimeConfig, build_model
    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
    param_dtype = (torch.float32 if dtype == "float32"
                   else runtime_for(cfg, SHAPES["decode_32k"]).param_dtype)
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, RuntimeConfig(param_dtype=param_dtype,
                                           max_cache_len=max(GEMMA2_WAVE_A) + 32),
                        device="cuda", seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    cut = ("" if depth is None else
           f" (depth cut to {depth} of {full.n_layers}: n_params() {full.n_params()}, "
           f"{full.n_params() * 2 / 1e9:.1f} GB in bf16, more than one card holds)")
    log(f"model {cfg.name}: {cfg.n_layers} layers{cut} "
        f"({', '.join(f'{kinds.count(k)} {k}' for k in dict.fromkeys(kinds))}), "
        f"d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}; {n} params in {str(param_dtype).split('.')[-1]} "
        f"({n * model.embed.element_size() / 1e9:.2f} GB; n_params() {cfg.n_params()}), "
        f"built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (build peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    expect = flash_expect(cfg.n_layers)
    prompts, launches = serve_waves(torch, model, 1024, (GEMMA2_WAVE_A, 1024), expect,
                                    cfg.name, prompt_gen)
    if cfg.n_experts:
        moe_breakdown(torch, model, len(GEMMA2_WAVE_A), max(GEMMA2_WAVE_A))
    if profiling:
        profile_serve(torch, model, prompts[0])
    hold_wave(torch, model, prompts[0], expect, f"{cfg.name} wave A")
    if cfg.frontend == "vision":
        serve_vision_prefix(torch, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def smoke_seamless(torch, steps: int, seed: int) -> None:
    """The smoke seamless in fp32 on the card: the kernel path against the
    plain path on ``prefill``, ``steps`` ``decode_step``s and ``forward``,
    logits within fp32 tolerance."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    cfg = get_smoke_config("seamless-m4t-medium")
    small = build_model(cfg, RuntimeConfig(compute_dtype=torch.float32, max_cache_len=48),
                        device="cuda", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    frames = (torch.randn((2, 40, cfg.d_model), generator=gen) * 0.1).cuda()
    tokens = torch.randint(3, cfg.vocab_size, (2, 24), generator=gen).cuda()

    def run():
        logits, cache, pos = small.prefill(frames, tokens[:, :12])
        out = [logits]
        for i in range(steps):
            logits, cache = small.decode_step(cache, out[-1][:, -1].argmax(-1)[:, None],
                                              pos + i)
            out.append(logits)
        with torch.inference_mode():
            out.append(small({"frontend_embeds": frames, "tokens": tokens}))
        return out

    base = small.rt
    kernel = run()
    small.rt = base.with_(attn_impl="chunked")
    plain = run()
    small.rt = base
    worst = 0.0
    for i, (g, w) in enumerate(zip(kernel, plain)):
        diff = (g - w).abs()
        worst = max(worst, diff.max().item())
        if not (diff <= FP32_TOL + FP32_TOL * w.abs()).all():
            fail(f"smoke {cfg.name} output {i} (prefill, {steps} decode steps, forward): "
                 f"kernel vs plain beyond {FP32_TOL}: max abs diff {diff.max().item()}")
    log(f"smoke {cfg.name} ({cfg.n_encoder_layers} + {cfg.n_layers} layers): kernel vs "
        f"plain max abs diff {worst} over prefill, {steps} decode steps and forward")
    del small


def smoke_padded_wave(torch, cfg, lengths, steps: int, seed: int, alone: bool = True,
                      **rt_kw) -> None:
    """A smoke-size attention model in fp32 on the card, on one padded wave
    of prompts of ``lengths``: the kernel path against the plain path
    (prefill and ``steps`` decode steps, logits within fp32 tolerance); then
    the wave through ``ServeEngine`` against each prompt decoded alone:
    greedy tokens equal, and each step's logits within fp32 tolerance (the
    smoke gemma2 repeats one greedy token, so its tokens alone would not see
    a pad attended).  With ``alone=False`` (an MoE model whose tokens drop,
    so that a row depends on its wave), the engine's wave on the kernel path
    is held to the same wave on the plain path instead."""
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.serve import ServeEngine
    small = build_model(cfg, RuntimeConfig(compute_dtype=torch.float32,
                                           max_cache_len=max(lengths) + steps + 16,
                                           **rt_kw),
                        device="cuda", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    rows = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).numpy() for n in lengths]
    tokens, kw, context_start = wave_inputs(torch, rows)

    def run(model):
        logits, cache, pos = model.prefill(tokens, **kw)
        out = [logits[:, -1]]
        for i in range(steps):
            tok = out[-1].argmax(-1)[:, None]
            logits, cache = model.decode_step(cache, tok, pos + i, context_start)
            out.append(logits[:, -1])
        return out

    def check(got, want, what):
        diff = (got - want).abs()
        if not (diff <= FP32_TOL + FP32_TOL * want.abs()).all():
            fail(f"smoke {cfg.name} padded wave {lengths}: {what} disagree beyond "
                 f"{FP32_TOL}: max abs diff {diff.max().item()}")
        return diff.max().item()

    base = small.rt
    kernel = run(small)
    small.rt = base.with_(attn_impl="chunked")
    plain = run(small)
    small.rt = base
    worst = max(check(g, w, f"kernel vs plain step {i}")
                for i, (g, w) in enumerate(zip(kernel, plain)))

    class Recorded:                      # the logits the engine samples from
        def __init__(self):
            self.logits = []

        def __getattr__(self, name):
            return getattr(small, name)

        def prefill(self, *a, **k):
            out = small.prefill(*a, **k)
            self.logits.append(out[0][:, -1])
            return out

        def decode_step(self, *a, **k):
            out = small.decode_step(*a, **k)
            self.logits.append(out[0][:, -1])
            return out

    def serve():
        recorded = Recorded()
        engine = ServeEngine(recorded, max_batch=len(rows))
        ids = [engine.submit(r, max_new_tokens=steps) for r in rows]
        engine.run()
        return recorded, engine, ids

    recorded, engine, ids = serve()
    if not alone:
        small.rt = base.with_(attn_impl="chunked")
        plain_recorded, plain_engine, _ = serve()
        small.rt = base
        worst_engine = max(check(g, w, f"engine step {i}, kernel vs plain")
                           for i, (g, w) in enumerate(zip(recorded.logits,
                                                          plain_recorded.logits)))
        got = [engine.result(i).output for i in ids]
        want = [plain_engine.result(i).output for i in ids]
        if got != want:
            fail(f"smoke {cfg.name} padded wave: the engine's greedy tokens on the "
                 f"kernel path {got} differ from the plain path's {want}")
        log(f"smoke {cfg.name} ({cfg.n_layers} layers) padded wave {list(lengths)} "
            f"{rt_kw}: kernel vs plain max abs diff {worst} over prefill and {steps} "
            f"decode steps; through ServeEngine, greedy tokens equal, logits max abs "
            f"diff {worst_engine}")
        del small, recorded, engine, plain_recorded, plain_engine
        return
    worst_alone = 0.0
    for row, (rid, prompt) in enumerate(zip(ids, rows)):
        toks, _, _ = wave_inputs(torch, [prompt])
        logits, cache, pos = small.prefill(toks)
        alone = []
        for i in range(steps):
            worst_alone = max(worst_alone, check(recorded.logits[i][row], logits[0, -1],
                                                 f"row {row} step {i} logits vs alone"))
            alone.append(int(logits[0, -1].argmax()))
            if i + 1 < steps:
                logits, cache = small.decode_step(cache, logits[:, -1].argmax(-1)[:, None],
                                                  pos + i)
        if engine.result(rid).output != alone:
            fail(f"smoke {cfg.name} padded wave row {row}: greedy tokens "
                 f"{engine.result(rid).output} differ from its prompt decoded alone {alone}")
    log(f"smoke {cfg.name} ({cfg.n_layers} layers) padded wave {list(lengths)}: kernel vs "
        f"plain max abs diff {worst} over prefill and {steps} decode steps; through "
        f"ServeEngine, greedy tokens equal each prompt's decoded alone, logits max abs "
        f"diff {worst_alone}")
    del small, recorded, engine


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 8
# lr 3e-4: at the driver's default 3e-3 the full-width loss rises again after
# step 4, as the warmup lifts the rate (PERF.md, PR 16).
TRAIN_ARGS = ["--arch", "mamba2-1.3b", "--batch", str(TRAIN_BATCH),
              "--seq-len", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
              "--log-every", "1", "--lr", "3e-4"]
# The uninterrupted run checkpoints once, at its last step; the killed run
# at step 4 (which it restores) and at its last step.  Each save of the
# 16 GB state takes ~2 minutes of host zlib.
FULL_ARGS = TRAIN_ARGS + ["--checkpoint-every", str(TRAIN_STEPS)]
KILLED_ARGS = TRAIN_ARGS + ["--checkpoint-every", "4", "--kill-at", "4"]


def checkpoint_records(run):
    """(record id -> content digest of every params/opt record of a run's
    final checkpoint, the number of parameters it holds).  The blob digests
    are sha256 of the raw bytes."""
    plan = run["dm"].plan_checkout("checkpoints/mamba2-1.3b", "trainer",
                                   rev=run["checkpoint"])
    entries = [e for e in plan.entries() if e.record_id.startswith(("params/", "opt/"))]
    n_params = sum(math.prod(e.attrs["shape"]) for e in entries
                   if e.record_id.startswith("params/"))
    return {e.record_id: e.blob.digest for e in entries}, n_params


def host_peak_rss_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20   # KiB


def train_grads_card_vs_cpu(torch, arch: str, n_layers: int, seed: int) -> float:
    """Loss and every parameter gradient of one smoke-size training step on
    the card against the same step on the CPU (same weights and batch, fp32,
    the training driver's plain paths).  Returns the largest |diff|."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import TRAIN_RUNTIME
    from repro_torch.models import RuntimeConfig, build_model
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=n_layers)
    rt = RuntimeConfig(**TRAIN_RUNTIME)
    cpu = build_model(cfg, rt, device="cpu", seed=seed)
    card = build_model(cfg, rt, device="cuda", seed=seed)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    B, S = 4, 48
    tokens = rng.integers(3, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    segments = (np.arange(S)[None, :] >= rng.integers(8, 40, size=(B, 1))).astype(np.int32)
    segments[1, -6:] = -1                       # padding, labels masked
    positions = np.where(segments == 0, np.arange(S),
                         np.arange(S) - np.argmax(segments == 1, axis=1)[:, None])
    labels = np.where(segments >= 0, tokens[:, 1:], -1)
    batch = {"tokens": tokens[:, :S], "labels": labels.astype(np.int32),
             "segments": segments, "positions": positions.astype(np.int32)}
    out = []
    for model in (cpu, card):
        tb = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
        params = dict(model.named_parameters())
        loss, _ = model.loss(tb)
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append([loss.detach()] + list(grads))
    worst = 0.0
    for name, want, got in zip(["loss"] + list(dict(cpu.named_parameters())),
                               out[0], out[1]):
        got = got.cpu()
        diff = (got - want).abs()
        worst = max(worst, diff.max().item())
        if not (torch.isfinite(got).all() and (diff <= FP32_TOL + FP32_TOL * want.abs()).all()):
            fail(f"smoke {arch} training {name} on the card disagrees with the CPU "
                 f"beyond {FP32_TOL}: max abs diff {diff.max().item()}")
    return worst


def profile_train(torch) -> None:
    """Where one full-width training step's time goes: a warm step, then one
    step under ``torch.profiler`` (the step as the driver runs it: its batch
    from ``DeviceFeed``, loss, backward, clipping, AdamW, the loss on the
    host).  The per-operator table goes to
    ``chiprun_out/profile_mamba2-1.3b_train.txt``.

    Then the cost of determinism: steps on the host clock with deterministic
    algorithms on and off, in turns (on, off, on, off, 2 steps each; their
    medians).  cuBLAS's workspace setting is fixed when CUDA starts, so this
    measures the algorithm choices and the filling of uninitialised memory,
    not the workspace."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DeviceFeed, ShardedSnapshotLoader
    from repro_torch.launch.train import TRAIN_RUNTIME, build_platform, deterministic
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with deterministic():
        plat, _ = build_platform(TRAIN_SEQ, n_docs=128)
        loader = ShardedSnapshotLoader(plat.dataset("corpus/packed").plan(), TRAIN_BATCH,
                                       TRAIN_SEQ)
        model = build_model(get_config("mamba2-1.3b"), RuntimeConfig(**TRAIN_RUNTIME),
                            device="cuda", seed=0)
        train_cfg = TrainConfig(optimizer=OptimizerConfig(lr=3e-4, warmup_steps=10,
                                                          total_steps=TRAIN_STEPS))
        step_fn = make_train_step(model, train_cfg)
        params = dict(model.named_parameters())
        opt_state = make_optimizer(train_cfg.optimizer).init(params)
        feed = iter(DeviceFeed(loader, "cuda"))

        def step():
            nonlocal params, opt_state
            batch, _ = next(feed)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            return float(metrics["loss"])

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            window_us = (time.perf_counter() - t0) * 1e6
        step_ms = {True: [], False: []}
        for mode in (True, False, True, False):
            torch.use_deterministic_algorithms(mode)
            for _ in range(2):
                t0 = time.perf_counter()
                step()
                step_ms[mode].append((time.perf_counter() - t0) * 1e3)
        feed.close()
    busy_ms, idle, launches, top = profile_table(torch, prof, window_us, top=12)
    log("profile " + json.dumps({
        "model": "mamba2-1.3b", "phase": "train step", "batch": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ,
        "window_ms": window_us / 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": idle, "kernel_launches": launches, "top_kernels": top,
        "step_ms_deterministic": step_ms[True], "step_ms_not_deterministic": step_ms[False],
        "determinism_cost": statistics.median(step_ms[True])
        / statistics.median(step_ms[False]) - 1}))
    (out_dir / "profile_mamba2-1.3b_train.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=50))


def train_phase(torch, profiling: bool) -> None:
    """Phase 6 (see the module docstring)."""
    from repro_torch.launch.train import main as train_main
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = train_main(FULL_ARGS)
    full_s = time.perf_counter() - t0
    full_records, n_params = checkpoint_records(full)
    full_state = full["loader"].state()
    summary = {k: full[k] for k in ("losses", "step_s", "ckpt_save_s", "loader_stats")}
    del full
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    killed = train_main(KILLED_ARGS)
    killed_s = time.perf_counter() - t0
    killed_records, _ = checkpoint_records(killed)
    killed_state = killed["loader"].state()
    got = {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    losses, step_s, ld = summary["losses"], summary["step_s"], summary["loader_stats"]
    records_digest = hashlib.sha256(json.dumps(sorted(full_records.items())).encode()
                                    ).hexdigest()
    # Printed before the checks, so that a failed run still shows its numbers.
    log("train " + json.dumps({"train": {
        "arch": "mamba2-1.3b", "params": n_params, "batch": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "args": FULL_ARGS,
        "killed_args": KILLED_ARGS,
        "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * (len(step_s) - 1) / sum(step_s[1:]),
        "step_ms": statistics.median(step_s[1:]) * 1e3,
        "step_ms_each": [s * 1e3 for s in step_s],
        "step_ms_each_killed": [s * 1e3 for s in killed["step_s"]],
        "loader_mode": ld["mode"], "loader_wait_fraction": ld["wait_fraction"],
        "pages_streamed": ld["pages_streamed"],
        "peak_resident_ids": ld["peak_resident_ids"],
        "ckpt_save_s": summary["ckpt_save_s"], "ckpt_save_s_killed": killed["ckpt_save_s"],
        "ckpt_load_s": killed["ckpt_load_s"],
        "peak_mem_gib": peak_mem_gib, "host_peak_rss_gib": host_peak_rss_gib(),
        "run_s": full_s, "killed_run_s": killed_s,
        "losses": losses, "losses_killed": killed["losses"],
        "final_records_sha256": records_digest, "launches": got}}))
    if any(n != 0 for n in got.values()):
        fail(f"training launched a kernel: {got} (the training path is the plain one)")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"training losses are not {TRAIN_STEPS} finite values: {losses}")
    if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        fail(f"the loss did not fall: first three {losses[:3]}, last three {losses[-3:]}")
    if killed["losses"][4:] != losses[4:]:
        fail(f"the restarted run's losses differ: {killed['losses'][4:]} vs {losses[4:]}")
    if killed_records != full_records or len(full_records) < 3:
        diff = sorted(k for k in full_records if killed_records.get(k) != full_records[k])
        fail(f"the restarted run's final params/opt records differ: {diff[:8]}")
    if killed_state != full_state:
        fail(f"the restarted run's loader state differs: {killed_state} vs {full_state}")
    del killed
    gc.collect()
    torch.cuda.empty_cache()
    worst = {arch: train_grads_card_vs_cpu(torch, arch, n, seed)
             for arch, n, seed in (("mamba2-1.3b", 2, 5), ("recurrentgemma-9b", 5, 6))}
    log(f"smoke training step, card vs CPU (fp32, tolerance {FP32_TOL}): max abs diff "
        + json.dumps(worst))
    if profiling:
        profile_train(torch)
        gc.collect()
        torch.cuda.empty_cache()

# Phase 7: gemma2-9b trained at train_4k's sequence under the launch
# policies.  The global batch is cut from 256 rows to one (what one card
# holds next to the weights, gradients and saved activations).
PROD_ARCH, PROD_SHAPE, PROD_BATCH, PROD_STEPS = "gemma2-9b", "train_4k", 1, 6
# warmup 0: train_config_for's default warmup of 100 steps keeps the first
# six updates (lr <= 2.1e-5) below a bf16 parameter's last digit.
PROD_OPT_OVERRIDES = {"warmup_steps": 0}


def tensors_bytes(tree) -> int:
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    return sum(tensors_bytes(v) for v in tree.values())


def train_production(torch, opt_name: str, profiling: bool = False) -> dict:
    """Phase 7 (a)/(b): the launch policies' run of gemma2-9b on the
    one-card "data" mesh, batches from the platform's Fig. 1 flow packed to
    train_4k's 4096 tokens, through ``DeviceFeed``'s sharded feed.  With
    ``profiling``, one more step under ``torch.profiler`` (its table goes to
    ``chiprun_out/profile_gemma2-9b_train_<optimizer>.txt``)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import DeviceFeed, ShardedSnapshotLoader
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.presets import resolve_layout
    from repro_torch.launch.specs import runtime_for, train_config_for
    from repro_torch.launch.train import build_platform
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train.sharding import ActivationSharding, batch_specs, named

    cfg = get_config(PROD_ARCH)
    shape = SHAPES[PROD_SHAPE]
    mesh = make_local_mesh("cuda")
    rules, rt_over, tc_over = resolve_layout(cfg, shape, mesh, "auto")
    rt = runtime_for(cfg, shape, **rt_over).with_(act_sharding=ActivationSharding(rules))
    policy = train_config_for(cfg, shape, mesh.size(), **PROD_OPT_OVERRIDES)
    if (rt_over.get("remat"), tc_over.get("microbatches"), rt.param_dtype) != (
            "dots", 1, torch.bfloat16):
        fail(f"{PROD_ARCH} at {PROD_SHAPE}: the auto layout gave {rt_over}, {tc_over}, "
             f"{rt.param_dtype}, not zero3's remat='dots', 1 microbatch, bf16 params")
    train_cfg = TrainConfig(optimizer=dataclasses.replace(policy.optimizer, name=opt_name),
                            microbatches=tc_over["microbatches"])
    plat, _ = build_platform(shape.seq_len, n_docs=256)
    loader = ShardedSnapshotLoader(plat.dataset("corpus/packed").plan(), PROD_BATCH,
                                   shape.seq_len)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, rt, device="cuda", seed=0)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    why = (f"train_config_for picks {policy.optimizer.name} below 1e11 parameters; its "
           f"fp32 m and v ({8 * n_params / 1e9:.1f} GB) beside bf16 params and grads "
           f"({4 * n_params / 1e9:.1f} GB) exceed the card's {card_gb:.1f} GB, so "
           f"{opt_name}")
    step_fn = make_train_step(model, train_cfg)
    opt_state = make_optimizer(train_cfg.optimizer, period=len(cfg.pattern)).init(params)
    state_bytes = tensors_bytes({k: v for k, v in opt_state.items() if k != "step"})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    feed = iter(DeviceFeed(loader, "cuda",
                           sharding_fn=lambda hb: named(mesh, batch_specs(hb, rules))))
    losses, step_s = [], []

    def step():
        nonlocal params, opt_state
        t0 = time.perf_counter()
        batch, _ = next(feed)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)

    for _ in range(PROD_STEPS):
        step()
    peak = torch.cuda.max_memory_allocated()
    if profiling:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
        busy_ms, idle, launches, top = profile_table(torch, prof, step_s[-1] * 1e6, top=12)
        log("profile " + json.dumps({
            "model": cfg.name, "phase": f"train step, {opt_name}", "batch": PROD_BATCH,
            "seq_len": shape.seq_len, "window_ms": step_s[-1] * 1e3,
            "device_busy_ms": busy_ms, "device_idle_share": idle,
            "kernel_launches": launches, "top_kernels": top}))
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"profile_{cfg.name}_train_{opt_name}.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=50))
        losses.pop()
        step_s.pop()
    feed.close()
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "optimizer": opt_name, "policy_optimizer":
           policy.optimizer.name, "why": why, "layout": "zero3", "remat": rt.remat,
           "microbatches": train_cfg.microbatches, "param_dtype": str(rt.param_dtype),
           "compute_dtype": str(rt.compute_dtype), "attn_impl": rt.attn_impl,
           "lr": train_cfg.optimizer.lr, "warmup_steps": train_cfg.optimizer.warmup_steps,
           "batch": PROD_BATCH, "seq_len": shape.seq_len, "steps": PROD_STEPS,
           "losses": losses, "step_ms_each": [x * 1e3 for x in step_s],
           "step_ms": statistics.median(step_s[1:]) * 1e3,
           "tokens_per_s": PROD_BATCH * shape.seq_len * (len(step_s) - 1) / sum(step_s[1:]),
           "peak_mem_gib": peak / 2**30, "peak_bytes": peak,
           "opt_state_bytes": state_bytes,
           "param_bytes": tensors_bytes(params), "build_s": build_s}
    log("train7 " + json.dumps({"train_production": out}))
    del model, params, opt_state, step_fn, feed
    gc.collect()
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses)):
        fail(f"{PROD_ARCH} with {opt_name}: losses not finite: {losses}")
    if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        fail(f"{PROD_ARCH} with {opt_name}: the loss did not fall: {losses}")
    return out


def optimizers_card_vs_cpu(torch) -> dict:
    """Phase 7 (c): one step of Adafactor and of 8-bit AdamW on smoke mamba2
    (its vectors' quant blocks span its two layers) and smoke gemma2, on the
    card against the same step on the CPU: params and Adafactor's state
    within 3e-4, 8-bit moments within one quantum of their block."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train import make_optimizer
    from repro_torch.train.optimizer import OptimizerConfig

    report = {}
    for arch in ("mamba2-1.3b", "gemma2-9b"):
        model = build_model(get_smoke_config(arch), RuntimeConfig(), device="cpu", seed=9)
        period = len(model.pattern)
        rng = np.random.default_rng(11)
        grads = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
                 for k, p in model.named_parameters()}
        for name in ("adafactor", "adamw8bit"):
            opt = make_optimizer(OptimizerConfig(name=name, lr=1e-2, warmup_steps=0,
                                                 factored_min_dim=16), period=period)
            runs = {}
            for dev in ("cpu", "cuda"):
                params = {k: p.detach().clone().to(dev) for k, p in model.named_parameters()}
                state = opt.init(params)
                params, state = opt.update({k: g.to(dev) for k, g in grads.items()},
                                           state, params)
                runs[dev] = (params, state)
            (p_cpu, s_cpu), (p_gpu, s_gpu) = runs["cpu"], runs["cuda"]
            worst = max((p_gpu[k].cpu() - v).abs().max().item() for k, v in p_cpu.items())
            bad = [k for k, v in p_cpu.items()
                   if not torch.allclose(p_gpu[k].cpu(), v, atol=FP32_TOL, rtol=FP32_TOL)]
            entry = {"params_max_abs_diff": worst}
            if name == "adafactor":
                pairs = [(f"{path}/{f}", t.cpu(), s_cpu["v"][path][f])
                         for path, leaf in s_gpu["v"].items() for f, t in leaf.items()]
                bad += [k for k, got, want in pairs
                        if not torch.allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)]
                entry["state_max_abs_diff"] = max((got - want).abs().max().item()
                                                  for _, got, want in pairs)
            else:
                blocks = q_differ = 0
                for moment in ("m", "v"):
                    for path, q in s_cpu[moment].items():
                        g = {f: t.cpu() for f, t in s_gpu[moment][path].items()}
                        deq_c, deq_g = q["q"].float() * q["scale"], g["q"].float() * g["scale"]
                        quantum = torch.maximum(q["scale"], g["scale"]) * (1 + 1e-6)
                        if ((deq_g - deq_c).abs() > quantum).any():
                            bad.append(f"{moment}/{path}")
                        blocks += q["q"].shape[0]
                        q_differ += int((q["q"] != g["q"]).any(dim=1).sum())
                entry.update(blocks=blocks, blocks_whose_q_differ=q_differ)
            report[f"{arch} {name}"] = entry
            if bad:
                fail(f"smoke {arch} {name} step on the card disagrees with the CPU: {bad[:8]}")
    log("optimizers card vs CPU (one step; params and Adafactor state within "
        f"{FP32_TOL}, 8-bit moments within one quantum) " + json.dumps(report))
    return report


def remat_checks(torch) -> dict:
    """Phase 7 (d): remat="dots" against "none" on smoke gemma2 on the card
    (fp32: the loss and every gradient within 3e-4), then the peak memory of
    a loss and backward pass under each mode at one full-width gemma2 layer
    group (a local and a global layer, bf16, train_4k's 4096 tokens)."""
    import numpy as np
    from repro_torch.configs import SHAPES, get_config, get_smoke_config
    from repro_torch.launch.specs import runtime_for
    from repro_torch.models import RuntimeConfig, build_model

    rt = RuntimeConfig(compute_dtype=torch.float32, attn_impl="chunked")
    cfg = get_smoke_config(PROD_ARCH)
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, 65))).cuda()
    batch = {"tokens": tokens[:, :64], "labels": tokens[:, 1:]}
    out = {}
    for mode in ("none", "dots"):
        model = build_model(cfg, rt.with_(remat=mode), device="cuda", seed=13)
        params = dict(model.named_parameters())
        loss, _ = model.loss(batch)
        out[mode] = [loss.detach()] + list(torch.autograd.grad(loss, list(params.values())))
    worst = max((a - b).abs().max().item() for a, b in zip(out["none"], out["dots"]))
    if not all(torch.allclose(a, b, atol=FP32_TOL, rtol=FP32_TOL)
               for a, b in zip(out["none"], out["dots"])):
        fail(f"remat='dots' changes smoke gemma2's loss or gradients: max abs diff {worst}")
    del out
    shape = SHAPES[PROD_SHAPE]
    wide = dataclasses.replace(get_config(PROD_ARCH), n_layers=len(cfg.pattern))
    model = build_model(wide, runtime_for(wide, shape), device="cuda", seed=0)
    params = dict(model.named_parameters())
    tokens = torch.from_numpy(rng.integers(3, wide.vocab_size,
                                           size=(1, shape.seq_len + 1))).cuda()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    peaks = {}
    for mode in ("none", "full", "dots"):
        model.rt = model.rt.with_(remat=mode)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        peaks[mode] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del loss, grads
    report = {"smoke_max_abs_diff": worst, "layer_group_peak_gib_above_params": peaks,
              "layers": wide.n_layers, "seq_len": shape.seq_len, "param_dtype": "bfloat16"}
    log("remat " + json.dumps(report))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return report


def moe_shardmap_check(torch) -> dict:
    """Phase 7 (e): moe_apply_shardmap against moe_apply on one
    mixtral-8x22b MoE layer at full width, fp32, on the one-rank (1, 1)
    ("data", "model") mesh under NCCL, within 1e-5 (the reference test's)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeConfig
    from repro_torch.models.common import Initializer
    from repro_torch.models.moe import moe_apply, moe_apply_shardmap, moe_init
    from repro_torch.train.sharding import ActivationSharding, ShardingRules

    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config("mixtral-8x22b")
    rt = RuntimeConfig(compute_dtype=torch.float32, moe_group_size=512,
                       act_sharding=ActivationSharding(ShardingRules(mesh)))
    p = moe_init(Initializer(0, "cuda"), cfg, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        y_ref, aux_ref = moe_apply(p, x, cfg, rt)
        y, aux = moe_apply_shardmap(p, x, cfg, rt)
    err = (y - y_ref).abs().max().item()
    report = {"backend": torch.distributed.get_backend(), "mesh": [1, 1],
              "shape": list(x.shape), "y_max_abs_diff": err,
              "aux": aux.item(), "aux_ref": aux_ref.item()}
    log("moe_shardmap " + json.dumps(report))
    ok = (torch.allclose(y, y_ref, atol=1e-5, rtol=1e-5)
          and math.isclose(aux.item(), aux_ref.item(), rel_tol=1e-5))
    del p, x, y, y_ref
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        fail(f"moe_apply_shardmap disagrees with moe_apply at mixtral's width: {report}")
    return report


def sharded_step_check(torch) -> dict:
    """Phase 7 (f): one train step of smoke gemma2 and smoke mamba2 with
    their params made DTensors by ``shard_model`` on the one-rank (1, 1)
    ("data", "model") mesh of cuda tensors under NCCL, against the plain
    step on the same card: the loss, the gradient norm and every
    parameter's change within 3e-4; then the vocab-parallel loss on logits
    sharded over the one-rank "model" dim against the plain loss (fp32,
    plain paths: no kernel is launched)."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.models.decoder import xent_loss
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.sharding import (ActivationSharding, ShardingRules,
                                            batch_specs, opt_state_specs,
                                            param_specs, shard_model, shard_tree)

    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    rules = ShardingRules(mesh)
    train = TrainConfig(optimizer=OptimizerConfig(name="adamw", lr=1e-2, warmup_steps=0,
                                                  total_steps=10))
    rt = RuntimeConfig(compute_dtype=torch.float32, attn_impl="chunked",
                       ssd_impl="chunked", rglru_impl="scan")
    rng = np.random.default_rng(15)
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    report = {"backend": torch.distributed.get_backend(), "mesh": [1, 1], "tol": FP32_TOL}
    bad = []
    for arch in ("gemma2-9b", "mamba2-1.3b"):
        cfg = get_smoke_config(arch)
        period = len(cfg.pattern)
        tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(4, 65))).cuda()
        batch = {"tokens": tokens[:, :64], "labels": tokens[:, 1:]}
        runs = {}
        for sharded in (False, True):
            model = build_model(cfg, rt.with_(act_sharding=ActivationSharding(rules))
                                if sharded else rt, device="cuda", seed=16)
            opt = make_optimizer(train.optimizer, period=period)
            params = dict(model.named_parameters())
            old = {k: p.detach().clone() for k, p in params.items()}
            state = opt.init(params)
            feed = batch
            if sharded:
                ospecs = opt_state_specs(state, params, param_specs(params, rules, period),
                                         rules, period)
                shard_model(model, rules)
                params = dict(model.named_parameters())
                state = shard_tree(state, ospecs, mesh)
                feed = shard_tree(batch, batch_specs(batch, rules), mesh)
            params, state, metrics = make_train_step(model, train)(params, state, feed)
            new = {k: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
                   for k, p in params.items()}
            runs[sharded] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                             {k: new[k] - old[k] for k in old})
            if sharded:
                report[f"{arch} dtensor params"] = sum(isinstance(p, DTensor)
                                                       for p in params.values())
        (loss, gnorm, delta), (s_loss, s_gnorm, s_delta) = runs[False], runs[True]
        worst = max((s_delta[k] - d).abs().max().item() for k, d in delta.items())
        report[arch] = {"loss": s_loss, "plain_loss": loss, "grad_norm": s_gnorm,
                        "plain_grad_norm": gnorm, "param_change_max_abs_diff": worst,
                        "param_change_max_abs": max(d.abs().max().item()
                                                    for d in delta.values())}
        if not (math.isclose(s_loss, loss, rel_tol=FP32_TOL, abs_tol=FP32_TOL)
                and math.isclose(s_gnorm, gnorm, rel_tol=FP32_TOL, abs_tol=FP32_TOL)
                and worst <= FP32_TOL):
            bad.append(arch)
    logits = torch.from_numpy(rng.standard_normal((4, 64, 512)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(-1, 512, size=(4, 64))).cuda()
    plain, _ = xent_loss(logits, labels)
    vocab, _ = xent_loss(
        DTensor.from_local(logits, mesh, [Replicate(), Shard(2)], run_check=False),
        DTensor.from_local(labels, mesh, [Replicate(), Replicate()], run_check=False))
    vocab = vocab.full_tensor().item()
    report["vocab_parallel_loss"] = {"loss": vocab, "plain_loss": plain.item()}
    if not math.isclose(vocab, plain.item(), rel_tol=FP32_TOL, abs_tol=FP32_TOL):
        bad.append("vocab-parallel loss")
    launched = {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}
    log("sharded_step " + json.dumps(report))
    if any(launched.values()):
        fail(f"phase 7 (f) launched a kernel: {launched} (the plain paths)")
    if bad:
        fail(f"phase 7 (f): the sharded step disagrees with the plain step: {bad}: {report}")
    return report


def production_phase(torch, profiling: bool) -> dict:
    """Phase 7 (see the module docstring).  Runs in a one-rank NCCL process
    group (made on a FileStore, as the training driver makes one)."""
    from repro_torch.launch.train import process_group

    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    with process_group(torch.device("cuda")):
        runs = {name: train_production(torch, name, profiling)
                for name in ("adafactor", "adamw8bit")}
        got = {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}
        if any(n != 0 for n in got.values()):
            fail(f"phase 7 launched a kernel: {got} (training runs the plain paths)")
        optimizers_card_vs_cpu(torch)
        remat_checks(torch)
        moe_shardmap_check(torch)
        sharded_step_check(torch)
    return runs


# Phase 8: the dry-run of phase 7's model, in a subprocess.
DRYRUN_TIMEOUT_S = 600
PEAK_ESTIMATE_TOL = 0.15
# (c)'s one expected failure under "auto": moe_ep puts mixtral's 8 experts
# on the 16-rank "data" axis; the reference's shard_map refuses the same cell.
GRID_ERRORS = {("mixtral-8x22b", "train_4k"): "moe_apply_shardmap needs the batch split"}
GRID_MAX_USEFUL_RATIO = 1.05
# (c) holds every ok cell's hlo_flops at or under the reference's record of
# the same cell, from
#   python -m repro.launch.dryrun --all --mesh single --roofline --layout auto
# (jax 0.9.0 on the CPU; copied here: this script imports nothing of it).
GRID_REFERENCE_FLOPS = {
    ("arctic-480b", "decode_32k"): 943350112256.0,
    ("arctic-480b", "prefill_32k"): 364208360259584.0,
    ("arctic-480b", "train_4k"): 652283027128320.0,
    ("gemma2-9b", "decode_32k"): 559963194624.0,
    ("gemma2-9b", "prefill_32k"): 161610098278400.0,
    ("gemma2-9b", "train_4k"): 283103570427904.0,
    ("gemma3-12b", "decode_32k"): 211380489216.0,
    ("gemma3-12b", "prefill_32k"): 194612278853632.0,
    ("gemma3-12b", "train_4k"): 355335780958208.0,
    ("internvl2-2b", "decode_32k"): 282731733312.0,
    ("internvl2-2b", "prefill_32k"): 39157362327552.0,
    ("internvl2-2b", "train_4k"): 70361437700096.0,
    ("mamba2-1.3b", "decode_32k"): 1919593296.0,
    ("mamba2-1.3b", "long_500k"): 73411150.0,
    ("mamba2-1.3b", "prefill_32k"): 12603389935616.0,
    ("mamba2-1.3b", "train_4k"): 48780744327168.0,
    ("mixtral-8x22b", "decode_32k"): 241804347392.0,
    ("mixtral-8x22b", "long_500k"): 7774843304.0,
    ("mixtral-8x22b", "prefill_32k"): 690704665804800.0,
    ("qwen2.5-32b", "decode_32k"): 850242167808.0,
    ("qwen2.5-32b", "prefill_32k"): 434269394567168.0,
    ("qwen2.5-32b", "train_4k"): 891474308759552.0,
    ("recurrentgemma-9b", "decode_32k"): 11007387221.333332,
    ("recurrentgemma-9b", "long_500k"): 185163174.66666666,
    ("recurrentgemma-9b", "prefill_32k"): 96506341927594.66,
    ("recurrentgemma-9b", "train_4k"): 252808242659328.0,
    ("seamless-m4t-medium", "decode_32k"): 28917731456.0,
    ("seamless-m4t-medium", "prefill_32k"): 24113965957120.0,
    ("seamless-m4t-medium", "train_4k"): 32744482537472.0,
    ("stablelm-1.6b", "decode_32k"): 23605524736.0,
    ("stablelm-1.6b", "prefill_32k"): 37247571722240.0,
    ("stablelm-1.6b", "train_4k"): 61814605873152.0,
}
# ... and the one-row long_500k cells' hlo_flops equal to the port's trace
# of them with torch 2.13 on the CPU (python -m repro_torch.launch.dryrun
# --device cpu --all --mesh single --roofline --layout auto): no layout of
# that step is left to DTensor's choice, which differed between versions.
GRID_SANDBOX_LONG_FLOPS = {
    ("mamba2-1.3b", "long_500k"): 13635584.0,
    ("mixtral-8x22b", "long_500k"): 1450082304.0,
    ("recurrentgemma-9b", "long_500k"): 99713024.0,
}

# ... and its wire_bytes at most the reference's record of the same cell
# (the same command; the bytes a device moves in collectives, by the
# reference's formulas) ...
GRID_REFERENCE_WIRE = {
    ("arctic-480b", "decode_32k"): 110587333632.0,
    ("arctic-480b", "prefill_32k"): 653656392719.0,
    ("arctic-480b", "train_4k"): 456204011644.6875,
    ("gemma2-9b", "decode_32k"): 146044152320.0,
    ("gemma2-9b", "prefill_32k"): 121111708175.0,
    ("gemma2-9b", "train_4k"): 126432243719.53125,
    ("gemma3-12b", "decode_32k"): 56052123136.0,
    ("gemma3-12b", "prefill_32k"): 142888163599.0,
    ("gemma3-12b", "train_4k"): 160937687230.78125,
    ("internvl2-2b", "decode_32k"): 73608528384.0,
    ("internvl2-2b", "prefill_32k"): 31199164431.0,
    ("internvl2-2b", "train_4k"): 90958563230.5,
    ("mamba2-1.3b", "decode_32k"): 341849408.0,
    ("mamba2-1.3b", "long_500k"): 1627663.5,
    ("mamba2-1.3b", "prefill_32k"): 84127768576.0,
    ("mamba2-1.3b", "train_4k"): 178533969182.0,
    ("mixtral-8x22b", "decode_32k"): 44320289536.0,
    ("mixtral-8x22b", "long_500k"): 3373598127.5,
    ("mixtral-8x22b", "prefill_32k"): 733078497295.0,
    ("qwen2.5-32b", "decode_32k"): 204968149504.0,
    ("qwen2.5-32b", "prefill_32k"): 288099544079.0,
    ("qwen2.5-32b", "train_4k"): 434459289671.71875,
    ("recurrentgemma-9b", "decode_32k"): 2428304725.333333,
    ("recurrentgemma-9b", "long_500k"): 4498636.166666666,
    ("recurrentgemma-9b", "prefill_32k"): 72390247780.33333,
    ("recurrentgemma-9b", "train_4k"): 125531340258.28125,
    ("seamless-m4t-medium", "decode_32k"): 404827712.0,
    ("seamless-m4t-medium", "prefill_32k"): 94643894432.0,
    ("seamless-m4t-medium", "train_4k"): 100949889988.0,
    ("stablelm-1.6b", "decode_32k"): 1098179072.0,
    ("stablelm-1.6b", "prefill_32k"): 30131468333.0,
    ("stablelm-1.6b", "train_4k"): 129545867279.0,
}
# ... and equal to the port's trace of it with torch 2.13 on the CPU
# (python -m repro_torch.launch.dryrun --device cpu --all --mesh single
# --roofline --layout auto): every layout of the traced steps is pinned.
GRID_SANDBOX_WIRE = {
    ("arctic-480b", "decode_32k"): 4174971360.0,
    ("arctic-480b", "prefill_32k"): 141887033280.0,
    ("arctic-480b", "train_4k"): 242300137545.0,
    ("gemma2-9b", "decode_32k"): 809971680.0,
    ("gemma2-9b", "prefill_32k"): 49922966400.0,
    ("gemma2-9b", "train_4k"): 114124792380.0,
    ("gemma3-12b", "decode_32k"): 371082720.0,
    ("gemma3-12b", "prefill_32k"): 67694143680.0,
    ("gemma3-12b", "train_4k"): 144650707260.0,
    ("internvl2-2b", "decode_32k"): 776532960.0,
    ("internvl2-2b", "prefill_32k"): 9521358720.0,
    ("internvl2-2b", "train_4k"): 65225579557.5,
    ("mamba2-1.3b", "decode_32k"): 25377120.0,
    ("mamba2-1.3b", "long_500k"): 1321627.5,
    ("mamba2-1.3b", "prefill_32k"): 23628684480.0,
    ("mamba2-1.3b", "train_4k"): 69127776045.0,
    ("mixtral-8x22b", "decode_32k"): 1294034400.0,
    ("mixtral-8x22b", "long_500k"): 86634127.5,
    ("mixtral-8x22b", "prefill_32k"): 122093268480.0,
    ("qwen2.5-32b", "decode_32k"): 5197955040.0,
    ("qwen2.5-32b", "prefill_32k"): 82742736000.0,
    ("qwen2.5-32b", "train_4k"): 385429908540.0,
    ("recurrentgemma-9b", "decode_32k"): 90033120.0,
    ("recurrentgemma-9b", "long_500k"): 3996817.5,
    ("recurrentgemma-9b", "prefill_32k"): 23866923520.0,
    ("recurrentgemma-9b", "train_4k"): 116110110780.0,
    ("seamless-m4t-medium", "decode_32k"): 9988320.0,
    ("seamless-m4t-medium", "prefill_32k"): 10404054720.0,
    ("seamless-m4t-medium", "train_4k"): 41588221477.5,
    ("stablelm-1.6b", "decode_32k"): 18770400.0,
    ("stablelm-1.6b", "prefill_32k"): 14980945920.0,
    ("stablelm-1.6b", "train_4k"): 62467307557.5,
}

# (d) holds every ok cell of the multi-pod (2, 16, 16) grid under "auto" at
# or under the reference's record of the same cell, from
#   python -m repro.launch.dryrun --all --mesh multi --roofline --layout auto
# (jax 0.9.0 on the CPU): (per-superblock FLOPs, FLOPs, wire bytes,
# per-superblock wire bytes).  arctic-480b x train_4k's wire bytes add the
# tuple-shaped collectives that the reference's parser skips (its expert
# all-to-alls and combined gradient all-reduces; derived in
# tests/test_torch_dryrun_multipod_grid_auto.py::reference_with_tuples).
GRID_MULTI_REFERENCE = {
    ("arctic-480b", "decode_32k"): (13855176704.0, 478538926080.0, 56239957504.0, 1634416384.0),
    ("arctic-480b", "prefill_32k"): (4040932982784.0, 141434011254784.0, 1979514962439.5, 56529227776.0),
    ("arctic-480b", "train_4k"): (77131790942208.0, 2702440281407488.0, 1375255086092.1875, 38976159104.0),
    ("gemma2-9b", "decode_32k"): (13975655552.0, 280602252672.0, 74105074928.0, 3632754688.0),
    ("gemma2-9b", "prefill_32k"): (3848024096768.0, 80811093917696.0, 77032415495.5, 3626074112.0),
    ("gemma2-9b", "train_4k"): (6029214482432.0, 138043250966528.0, 336716048647.75, 13845381120.0),
    ("gemma3-12b", "decode_32k"): (14960204544.0, 106477801984.0, 29404836592.0, 3954104320.0),
    ("gemma3-12b", "prefill_32k"): (12163852795904.0, 97313584316416.0, 92772478087.5, 11476623360.0),
    ("gemma3-12b", "train_4k"): (20112163733504.0, 173295458582528.0, 388541182087.75, 42551377920.0),
    ("internvl2-2b", "decode_32k"): (6139489088.0, 141480877952.0, 37003485424.0, 1584035840.0),
    ("internvl2-2b", "prefill_32k"): (815777841152.0, 19581751656448.0, 18428709895.5, 753991680.0),
    ("internvl2-2b", "train_4k"): (1279507824640.0, 33024771096576.0, 43929647062.75, 1565574697.25),
    ("mamba2-1.3b", "decode_32k"): (20578360.0, 1054199936.0, 328305296.0, 6333406.0),
    ("mamba2-1.3b", "long_500k"): (1481823.0, 73411195.0, 1627663.5, 33237.0),
    ("mamba2-1.3b", "prefill_32k"): (131268149248.0, 6301793533952.0, 42234142720.0, 873592832.0),
    ("mamba2-1.3b", "train_4k"): (481643069440.0, 24391150206976.0, 89640324924.5, 1859092912.0),
    ("mixtral-8x22b", "decode_32k"): (2305482496.0, 128454827008.0, 33334917504.0, 596654192.0),
    ("mixtral-8x22b", "long_500k"): (141423692.0, 7827017000.0, 3344410031.5, 60777867.0),
    ("mixtral-8x22b", "prefill_32k"): (5197497630720.0, 291061517778944.0, 646939841543.5, 11537272832.0),
    ("qwen2.5-32b", "decode_32k"): (6764187776.0, 427251992320.0, 106232303856.0, 1673226240.0),
    ("qwen2.5-32b", "prefill_32k"): (3393193246720.0, 217165842612224.0, 205871859207.5, 3201024000.0),
    ("qwen2.5-32b", "train_4k"): (6708113965056.0, 438971481980928.0, 642160581127.75, 9547914240.0),
    ("recurrentgemma-9b", "decode_32k"): (431200256.0, 6131452245.333333, 2311454362.6666665, 163066240.0),
    ("recurrentgemma-9b", "long_500k"): (29137528.0, 392796762.6666666, 205064054.8333333, 16178429.0),
    ("recurrentgemma-9b", "prefill_32k"): (3809749499904.0, 48256604700672.0, 51758707378.166664, 3629142016.0),
    ("recurrentgemma-9b", "train_4k"): (8716239765504.0, 123415186898944.0, 177792317447.75, 10296729600.0),
    ("seamless-m4t-medium", "decode_32k"): (1278752224.0, 14462209728.0, 202413856.0, 16224480.0),
    ("seamless-m4t-medium", "prefill_32k"): (996970463232.0, 11964878290944.0, 13100002838.5, 1019412480.0),
    ("seamless-m4t-medium", "train_4k"): (1045422669824.0, 15765658927104.0, 38619309658.75, 2775045686.25),
    ("stablelm-1.6b", "decode_32k"): (504304064.0, 11900427840.0, 717713648.0, 27893760.0),
    ("stablelm-1.6b", "prefill_32k"): (775975272448.0, 18624142508032.0, 17344060438.5, 708034560.0),
    ("stablelm-1.6b", "train_4k"): (1112402034688.0, 29213333651456.0, 62798778988.25, 2442660984.25),
}
# ... and its wire_bytes equal to the port's trace of it with torch 2.13 on
# the CPU (python -m repro_torch.launch.dryrun --device cpu --all --mesh
# multi --roofline --layout auto).
GRID_MULTI_SANDBOX_WIRE = {
    ("arctic-480b", "decode_32k"): 2204144880.0,
    ("arctic-480b", "prefill_32k"): 152456579040.0,
    ("arctic-480b", "train_4k"): 355150287435.5,
    ("gemma2-9b", "decode_32k"): 404985840.0,
    ("gemma2-9b", "prefill_32k"): 33847796160.0,
    ("gemma2-9b", "train_4k"): 184096381489.5,
    ("gemma3-12b", "decode_32k"): 185541360.0,
    ("gemma3-12b", "prefill_32k"): 45311775840.0,
    ("gemma3-12b", "train_4k"): 221025066289.5,
    ("internvl2-2b", "decode_32k"): 388266480.0,
    ("internvl2-2b", "prefill_32k"): 6375445440.0,
    ("internvl2-2b", "train_4k"): 33262898225.5,
    ("mamba2-1.3b", "decode_32k"): 12688560.0,
    ("mamba2-1.3b", "long_500k"): 1321627.5,
    ("mamba2-1.3b", "prefill_32k"): 12756156000.0,
    ("mamba2-1.3b", "train_4k"): 35075802937.0,
    ("mixtral-8x22b", "decode_32k"): 935293680.0,
    ("mixtral-8x22b", "long_500k"): 86634127.5,
    ("mixtral-8x22b", "prefill_32k"): 128762115840.0,
    ("qwen2.5-32b", "decode_32k"): 2598977520.0,
    ("qwen2.5-32b", "prefill_32k"): 74374785600.0,
    ("qwen2.5-32b", "train_4k"): 440795061297.5,
    ("recurrentgemma-9b", "decode_32k"): 45016560.0,
    ("recurrentgemma-9b", "long_500k"): 3996817.5,
    ("recurrentgemma-9b", "prefill_32k"): 20825550080.0,
    ("recurrentgemma-9b", "train_4k"): 159790420017.5,
    ("seamless-m4t-medium", "decode_32k"): 4994160.0,
    ("seamless-m4t-medium", "prefill_32k"): 5716433760.0,
    ("seamless-m4t-medium", "train_4k"): 21092632113.5,
    ("stablelm-1.6b", "decode_32k"): 9385200.0,
    ("stablelm-1.6b", "prefill_32k"): 8815119360.0,
    ("stablelm-1.6b", "train_4k"): 31790757937.5,
}
DRYRUN_MULTI_TIMEOUT_S = 600


def dryrun_child() -> None:
    """Phase 8's subprocess: (a) and (b) of the module docstring, printed as
    one JSON line."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ARCHS, SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.launch.presets import resolve_layout
    from repro_torch.launch.specs import train_config_for

    if not torch.cuda.is_available():
        fail("the dry-run's mesh claims cuda: no CUDA runtime")
    cfg, shape = get_config(PROD_ARCH), SHAPES[PROD_SHAPE]
    out = {}
    t0 = time.perf_counter()
    with dryrun.fake_process_group(256):
        mesh = make_production_mesh(device_type="cuda")
        rules, rt_over, _ = resolve_layout(cfg, shape, mesh, "auto")
        out["a"] = dryrun.run_cell_roofline(PROD_ARCH, PROD_SHAPE, mesh, rules=rules,
                                            rt_overrides=rt_over)
    out["a"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with dryrun.fake_process_group(1):
        mesh = make_local_mesh("cuda")
        rules, rt_over, tc_over = resolve_layout(cfg, shape, mesh, "auto")
        policy = train_config_for(cfg, shape, mesh.size(), **PROD_OPT_OVERRIDES)
        tc_over = dict(tc_over, optimizer=dataclasses.replace(policy.optimizer,
                                                              name="adafactor"))
        out["b"] = dryrun.run_cell(
            PROD_ARCH, PROD_SHAPE, mesh, rules=rules, rt_overrides=rt_over,
            tc_overrides=tc_over,
            shape=dataclasses.replace(shape, global_batch=PROD_BATCH))
    out["b"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["c"] = []
    with dryrun.fake_process_group(256):
        mesh = make_production_mesh(device_type="cuda")
        for arch in ARCHS:
            for name, cell_shape in SHAPES.items():
                rules, rt_over, _ = resolve_layout(get_config(arch), cell_shape, mesh, "auto")
                rec = dryrun.run_cell_roofline(arch, name, mesh, rules=rules,
                                               rt_overrides=rt_over)
                out["c"].append(grid_cell(rec))
    out["c_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def dryrun_multi_child() -> None:
    """Phase 8 (d)'s subprocess: the multi-pod grid under ``auto``, printed
    as one JSON line."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ARCHS, SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.presets import resolve_layout

    if not torch.cuda.is_available():
        fail("the dry-run's mesh claims cuda: no CUDA runtime")
    t0 = time.perf_counter()
    cells = []
    with dryrun.fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cuda")
        for arch in ARCHS:
            for name, cell_shape in SHAPES.items():
                rules, rt_over, _ = resolve_layout(get_config(arch), cell_shape, mesh, "auto")
                cells.append(grid_cell(dryrun.run_cell_roofline(
                    arch, name, mesh, rules=rules, rt_overrides=rt_over)))
    print(json.dumps({"d": cells, "d_s": time.perf_counter() - t0}), flush=True)


def grid_cell(rec: dict) -> dict:
    """Phase 8 (c)'s record of one cell: its status and terms."""
    cell = {k: rec.get(k) for k in ("arch", "shape", "status", "hlo_flops", "hlo_bytes",
                                    "wire_bytes", "per_superblock", "useful_flops_ratio")}
    if rec["status"] == "error":
        cell["error"] = rec["error"][:300]
    if rec["status"] == "ok":
        cell["roofline"] = {k: rec["roofline"][k] for k in (
            "compute_s", "memory_s", "collective_s", "memory_model_s", "dominant")}
        cell["trace_s"] = sum(p["compile_s"] for p in rec["points"])
    return cell


def cell_faults(c: dict, faults: list) -> bool:
    """The checks of a grid cell that (c) and (d) share: its status is the
    expected one (``skipped`` where ``cell_runnable`` says so, the error of
    ``GRID_ERRORS``, else ``ok``), and an ``ok`` cell's per-superblock
    counts and roofline terms are positive and its useful-FLOPs ratio in
    (0, 1.05].  Appends the faults; True for an ``ok`` cell."""
    from repro_torch.configs import cell_runnable

    key = (c["arch"], c["shape"])
    want = ("skipped" if not cell_runnable(*key).runnable
            else "error" if key in GRID_ERRORS else "ok")
    if c["status"] != want:
        faults.append(f"{key}: {c['status']}, not {want}: {c.get('error')}")
    elif want == "error" and GRID_ERRORS[key] not in c["error"]:
        faults.append(f"{key}: another error: {c['error']}")
    elif want == "ok":
        terms = list(c["per_superblock"].values()) + [
            v for k, v in c["roofline"].items() if k != "dominant"]
        ratio = c["useful_flops_ratio"]
        if min(terms) <= 0 or not (ratio and 0 < ratio <= GRID_MAX_USEFUL_RATIO):
            faults.append(f"{key}: a term <= 0 or the useful-FLOPs ratio {ratio} "
                          f"out of (0, {GRID_MAX_USEFUL_RATIO}]: {c}")
        return True
    return False


def grid_faults(cells: list) -> list:
    """Phase 8 (c)'s checks: :func:`cell_faults`, and an ``ok`` cell's
    ``hlo_flops`` at most ``GRID_REFERENCE_FLOPS``' and, at long_500k,
    equal to ``GRID_SANDBOX_LONG_FLOPS``', its ``wire_bytes`` at most
    ``GRID_REFERENCE_WIRE``'s and equal to ``GRID_SANDBOX_WIRE``'s."""
    faults = []
    for c in cells:
        key = (c["arch"], c["shape"])
        if cell_faults(c, faults):
            if c["hlo_flops"] > GRID_REFERENCE_FLOPS[key]:
                faults.append(f"{key}: hlo_flops {c['hlo_flops']} over the reference's "
                              f"{GRID_REFERENCE_FLOPS[key]}")
            if key in GRID_SANDBOX_LONG_FLOPS and c["hlo_flops"] != GRID_SANDBOX_LONG_FLOPS[key]:
                faults.append(f"{key}: hlo_flops {c['hlo_flops']}, not the CPU trace's "
                              f"{GRID_SANDBOX_LONG_FLOPS[key]}")
            if c["wire_bytes"] > GRID_REFERENCE_WIRE[key]:
                faults.append(f"{key}: wire_bytes {c['wire_bytes']} over the reference's "
                              f"{GRID_REFERENCE_WIRE[key]}")
            if c["wire_bytes"] != GRID_SANDBOX_WIRE[key]:
                faults.append(f"{key}: wire_bytes {c['wire_bytes']}, not the CPU trace's "
                              f"{GRID_SANDBOX_WIRE[key]}")
    return faults


def multi_grid_faults(cells: list) -> list:
    """Phase 8 (d)'s checks: :func:`cell_faults`, and an ``ok`` cell's
    FLOPs and wire bytes, in all and a superblock, at most
    ``GRID_MULTI_REFERENCE``'s and its ``wire_bytes`` equal to
    ``GRID_MULTI_SANDBOX_WIRE``'s."""
    faults = []
    for c in cells:
        key = (c["arch"], c["shape"])
        if not cell_faults(c, faults):
            continue
        per = c["per_superblock"]
        for what, got, ref in zip(
                ("per-superblock FLOPs", "hlo_flops", "wire_bytes", "per-superblock wire"),
                (per["flops"], c["hlo_flops"], c["wire_bytes"], per["wire"]),
                GRID_MULTI_REFERENCE[key]):
            if got > ref:
                faults.append(f"{key}: {what} {got} over the reference's {ref}")
        if c["wire_bytes"] != GRID_MULTI_SANDBOX_WIRE[key]:
            faults.append(f"{key}: wire_bytes {c['wire_bytes']}, not the CPU trace's "
                          f"{GRID_MULTI_SANDBOX_WIRE[key]}")
    return faults


def dryrun_phase(card: str, prod: dict) -> dict:
    """Phase 8 (see the module docstring); ``prod`` is phase 7's Adafactor
    run."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--dryrun-child"], capture_output=True, text=True,
                              timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"phase 8's dry-run did not finish in {DRYRUN_TIMEOUT_S} s")
    elapsed = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 8's dry-run exited {proc.returncode}: {proc.stderr[-3000:]}")
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("a", "b"):
        rec = recs[key]
        if rec["status"] != "ok":
            fail(f"phase 8 ({key}) {rec['arch']} x {rec['shape']} on {rec['mesh']}: "
                 f"{rec['status']}: {rec.get('error')}\n{rec.get('traceback', '')}")
    a, b = recs["a"], recs["b"]
    log("dryrun8a " + json.dumps({
        "card": card, "cell": f"{a['arch']} x {a['shape']} on {a['mesh']}",
        "layout": "auto", "method": a["method"], "hlo_flops": a["hlo_flops"],
        "hlo_bytes": a["hlo_bytes"], "wire_bytes": a["wire_bytes"],
        "roofline": a["roofline"], "useful_flops_ratio": a.get("useful_flops_ratio"),
        "roofline_fraction": a.get("roofline_fraction"),
        "coll_counts": a["points"][-1]["coll_counts"], "s": a["s"]}))
    step_s = prod["step_ms"] / 1e3
    measured = prod["peak_bytes"]
    estimate = b["memory"]["peak_estimate_bytes"]
    report = {
        "card": card, "cell": f"{b['arch']} x {b['shape']} on the one-rank 'data' mesh, "
                              f"{PROD_BATCH} x 4096 tokens, {b['optimizer']}",
        "memory": b["memory"], "peak_estimate_bytes": estimate,
        "measured_max_memory_allocated": measured,
        "peak_estimate_over_measured": estimate / measured,
        "hlo_flops": b["hlo_flops"], "model_flops_per_device": b["model_flops_per_device"],
        "measured_step_ms": prod["step_ms"],
        "achieved_tflops": b["hlo_flops"] / step_s / 1e12,
        "achieved_model_tflops": b["model_flops_per_device"] / step_s / 1e12,
        "bound_s": b["roofline"]["bound_s"], "bound_over_step": b["roofline"]["bound_s"] / step_s,
        "roofline": b["roofline"], "collectives": b["collectives"],
        "lower_s": b["lower_s"], "trace_s": b["compile_s"], "s": b["s"],
        "phase_s": elapsed}
    log("dryrun8b " + json.dumps(report))
    if abs(estimate - measured) > PEAK_ESTIMATE_TOL * measured:
        fail(f"phase 8 (b): the peak estimate {estimate} is not within "
             f"{PEAK_ESTIMATE_TOL:.0%} of phase 7's max_memory_allocated {measured}")
    grid = recs["c"]
    log("dryrun8c " + json.dumps({
        "card": card, "mesh": "16x16", "layout": "auto", "cells": grid,
        "statuses": {s: sum(c["status"] == s for c in grid)
                     for s in ("ok", "error", "skipped")}, "s": recs["c_s"]}))
    faults = grid_faults(grid)
    if faults:
        fail("phase 8 (c): " + "; ".join(faults))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--dryrun-multi-child"], capture_output=True, text=True,
                              timeout=DRYRUN_MULTI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"phase 8 (d)'s dry-run did not finish in {DRYRUN_MULTI_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"phase 8 (d)'s dry-run exited {proc.returncode}: {proc.stderr[-3000:]}")
    multi = json.loads(proc.stdout.strip().splitlines()[-1])
    grid = multi["d"]
    log("dryrun8d " + json.dumps({
        "card": card, "mesh": "2x16x16", "layout": "auto", "cells": grid,
        "statuses": {s: sum(c["status"] == s for c in grid)
                     for s in ("ok", "error", "skipped")},
        "s": multi["d_s"], "phase_s": time.perf_counter() - t0}))
    faults = multi_grid_faults(grid)
    if faults:
        fail("phase 8 (d): " + "; ".join(faults))
    return report


def main() -> None:
    if "--dryrun-child" in sys.argv[1:]:
        dryrun_child()
        return
    if "--dryrun-multi-child" in sys.argv[1:]:
        dryrun_multi_child()
        return
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's sources are missing: no {SRC / 'repro_torch'}")
    # Phase 6 trains with deterministic algorithms, and cuBLAS reads its
    # workspace setting when CUDA starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru.kernel import kernel_chunk
    from repro_torch.models import RuntimeConfig, build_model

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    profiling = "--profile" in sys.argv[1:]

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
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                log(f"  {name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ssd_cases = [
        # label, B, S, H, P, N, dtype, initial state, chunk, decay
        ("full-width fp32", 2, 1024, 64, 64, 128, "float32", True, 256, "fast"),
        ("full-width bf16", 2, 1024, 64, 64, 128, "bfloat16", True, 256, "fast"),
        ("serve wave 1", 4, 512, 64, 64, 128, "bfloat16", False, 256, "fast"),
        ("serve wave 2", 4, 256, 64, 64, 128, "bfloat16", False, 256, "fast"),
        ("serve wave 1 fp32", 4, 512, 64, 64, 128, "float32", False, 256, "fast"),
        ("ragged bf16, chunk 125", 2, 1000, 16, 64, 128, "bfloat16", True, 125, "fast"),
        ("bf16 P 32", 2, 512, 32, 32, 128, "bfloat16", True, 256, "fast"),
        ("serve wave 1, slow decay", 4, 512, 64, 64, 128, "bfloat16", False, 256, "slow"),
        ("full-width bf16, slow decay", 2, 1024, 64, 64, 128, "bfloat16", True, 256,
         "slow"),
        ("ragged fp32, slow decay", 2, 1000, 16, 64, 128, "float32", True, 125, "slow"),
    ]
    T = kernel_chunk()
    rglru_cases = [
        # label, B, S, W, dtype, initial h, decay
        ("serve wave A", 4, 3072, 4096, "bfloat16", False, "fast"),
        ("fp32 with h0", 2, 1024, 4096, "float32", True, "fast"),
        ("ragged S", 3, 1001, 1000, "bfloat16", True, "fast"),
        ("serve wave A, slow decay", 4, 3072, 4096, "bfloat16", False, "slow"),
        ("serve wave B", 4, 1024, 4096, "bfloat16", False, "fast"),
        ("fp32 with h0, slow decay", 2, 1024, 4096, "float32", True, "slow"),
        ("S = 4 chunks, h0, slow decay", 2, 4 * T, 1000, "bfloat16", True, "slow"),
        ("S = chunk - 1, h0, slow decay", 2, T - 1, 1000, "bfloat16", True, "slow"),
        ("S = chunk + 1, h0, slow decay", 2, T + 1, 1000, "float32", True, "slow"),
    ]
    flash = [check_flash(torch, c, gen) for c in FLASH_CASES]
    flash.append(check_flash_rows(torch, gen))
    gc.collect()
    torch.cuda.empty_cache()
    ssd = [check_ssd(torch, c, gen) for c in ssd_cases]
    checks = {"ssd_fwd_wgmma": [c for c in ssd if c["kernel"] == "ssd_fwd_wgmma"],
              "ssd_fwd": [c for c in ssd if c["kernel"] == "ssd_fwd"],
              "flash_fwd_wgmma": [c for c in flash if c["kernel"] == "flash_fwd_wgmma"],
              "flash_fwd": [c for c in flash if c["kernel"] == "flash_fwd"],
              "rglru_fwd": [check_rglru(torch, c, gen) for c in rglru_cases]}
    for name, results in checks.items():
        bad = [c["case"] for c in results if not c["ok"]]
        if bad:
            fail(f"{name} disagrees with its plain version: {bad}")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")
    # 3. serve mamba2-1.3b at full width and depth ------------------------------
    prompt_gen = torch.Generator().manual_seed(1)
    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    model = build_model(cfg, RuntimeConfig(), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in model.parameters())} params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts, launches = serve_waves(
        torch, model, 512, (512, 256),
        {"ssd_fwd": cfg.n_layers, "ssd_fwd_wgmma": cfg.n_layers, "rglru_fwd": 0,
         "flash_fwd": 0, "flash_fwd_wgmma": 0},
        "mamba2", prompt_gen)
    if profiling:
        profile_serve(torch, model, prompts[0])
    full_width_logits(torch, model, prompts[-1], {"ssd_impl": "chunked"}, "mamba2")
    hold_wave(torch, model, prompts[0], {"ssd_fwd": cfg.n_layers, "ssd_fwd_wgmma": cfg.n_layers,
                                         "rglru_fwd": 0, "flash_fwd": 0, "flash_fwd_wgmma": 0},
              "mamba2 wave 1")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    # 4. serve recurrentgemma-9b at full width and depth ------------------------
    cfg = get_config("recurrentgemma-9b")
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    n_rec, n_local = kinds.count("rec"), kinds.count("local")
    t0 = time.perf_counter()
    model = build_model(cfg, RuntimeConfig(max_cache_len=3072 + 32), device="cuda",
                        seed=0)
    torch.cuda.synchronize()
    log(f"model {cfg.name}: {cfg.n_layers} layers ({n_rec} rec, {n_local} local), "
        f"d_model {cfg.d_model}, {sum(p.numel() for p in model.parameters())} "
        f"params, built in {time.perf_counter() - t0:.1f} s")
    prompts, rg_launches = serve_waves(
        torch, model, 1024, (3072, 1024),
        {"ssd_fwd": 0, "ssd_fwd_wgmma": 0, "rglru_fwd": n_rec, "flash_fwd": n_local,
         "flash_fwd_wgmma": n_local}, "recurrentgemma", prompt_gen)
    for name, n in rg_launches.items():
        launches[name] += n
    if profiling:
        profile_serve(torch, model, prompts[0])
    full_width_logits(torch, model, prompts[0],
                      {"attn_impl": "chunked", "rglru_impl": "scan"}, "recurrentgemma")
    hold_wave(torch, model, prompts[0],
              {"ssd_fwd": 0, "ssd_fwd_wgmma": 0, "rglru_fwd": n_rec, "flash_fwd": n_local,
               "flash_fwd_wgmma": n_local}, "recurrentgemma wave A")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    # 4b. serve gemma2-9b at full width and depth, through padded waves ---------
    for name, n in serve_gemma2(torch, prompt_gen, profiling).items():
        launches[name] += n

    log(f"phase 4b done at {time.perf_counter() - t_start:.1f} s")
    # 4c. serve mixtral-8x22b at full width, depth 4 ------------------------------
    for name, n in serve_mixtral(torch, prompt_gen, profiling).items():
        launches[name] += n

    log(f"phase 4c done at {time.perf_counter() - t_start:.1f} s")
    # 4d. seamless-m4t-medium at full width and depth ----------------------------
    for name, n in serve_seamless(torch, profiling).items():
        launches[name] += n

    log(f"phase 4d done at {time.perf_counter() - t_start:.1f} s")
    # 4e. stablelm, internvl2, gemma3, qwen2.5 and arctic (depth 2) ---------------
    serve_4e = {name: 0 for name in launches}
    for arch, depth, dtype in SERVE_4E:
        for name, n in serve_family(torch, arch, depth, dtype, prompt_gen,
                                    profiling).items():
            serve_4e[name] += n
        log(f"phase 4e {arch} done at {time.perf_counter() - t_start:.1f} s")
    # 5. reference: smoke-size models, kernel path vs plain path in fp32 ---------
    smoke_reference(torch, get_smoke_config("mamba2-1.3b"), {"ssd_impl": "chunked"},
                    (48,), 1, seed=3)
    rg_small = dataclasses.replace(get_smoke_config("recurrentgemma-9b"), n_layers=5)
    smoke_reference(torch, rg_small, {"attn_impl": "chunked", "rglru_impl": "scan"},
                    (48, 80), 8, seed=4, max_cache_len=64)
    smoke_padded_wave(torch, get_smoke_config("gemma2-9b"), (31, 150, 97), 8, seed=5)
    mixtral_small = get_smoke_config("mixtral-8x22b")
    smoke_padded_wave(torch, mixtral_small, (31, 150, 97), 8, seed=6, alone=False,
                      moe_group_size=16)
    smoke_padded_wave(torch, dataclasses.replace(
        mixtral_small, capacity_factor=float(mixtral_small.n_experts)), (31, 150, 97), 8,
        seed=6)
    smoke_reference(torch, get_smoke_config("arctic-480b"), {"attn_impl": "chunked"},
                    (48,), 8, seed=7, max_cache_len=64, moe_group_size=16)
    smoke_seamless(torch, 8, seed=8)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    # 6. train mamba2-1.3b at full width and depth -------------------------------
    train_phase(torch, profiling)

    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")
    # 7. train gemma2-9b at full width and depth under the launch policies -------
    prod = production_phase(torch, profiling)
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")
    # 8. the dry-run of phase 7's cell and of its 16 x 16 production mesh -------
    dryrun_phase(card, prod["adafactor"])
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # The main path's largest call of each kernel (flash_fwd and ssd_fwd,
    # off the main path, at the serving shape in fp32).  flash_fwd's and
    # ssd_fwd's own launches are those that did not take the tensor-core
    # route; ``launches`` counts phases 3-4d, ``serve_4e`` phase 4e.
    main_case = {"ssd_fwd_wgmma": "serve wave 1", "ssd_fwd": "serve wave 1 fp32",
                 "flash_fwd_wgmma": "gemma2 wave A global",
                 "flash_fwd": "serve wave A fp32", "rglru_fwd": "serve wave A"}
    for counts in (launches, serve_4e):
        counts["flash_fwd"] -= counts["flash_fwd_wgmma"]
        counts["ssd_fwd"] -= counts["ssd_fwd_wgmma"]
    meta = {
        "ssd_fwd_wgmma": ("src/repro_torch/kernels/ssd/csrc/ssd_fwd_wgmma.cu",
                          "src/repro/kernels/ssd/kernel.py:91"),
        "ssd_fwd": ("src/repro_torch/kernels/ssd/csrc/ssd_fwd.cu",
                    "src/repro/kernels/ssd/kernel.py:91"),
        "flash_fwd_wgmma": ("src/repro_torch/kernels/flash_attention/csrc/flash_fwd_wgmma.cu",
                            "src/repro/kernels/flash_attention/kernel.py:117"),
        "flash_fwd": ("src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
                      "src/repro/kernels/flash_attention/kernel.py:117"),
        "rglru_fwd": ("src/repro_torch/kernels/rglru/csrc/rglru_fwd.cu",
                      "src/repro/kernels/rglru/kernel.py:75"),
    }
    entries = []
    for name, results in checks.items():
        main_path = next(c for c in results if c["case"] == main_case[name])
        errs = [max(v for k, v in c.items() if k in ("err", "err_y", "err_h", "err_state"))
                for c in results]
        entries.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "serve_4e": serve_4e[name],
            "max_abs_err": max(errs),
            "ms": main_path["ms"], "call_ms": main_path["call_ms"],
            "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
            "library_ms": main_path.get("library_ms"),
            "library_call": main_path.get("library_call"),
            "shape": main_path["shape"], "dtype": main_path["dtype"],
            "checks": {c["case"]: c["ok"] for c in results},
        })
    log(json.dumps({"kernels": entries}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

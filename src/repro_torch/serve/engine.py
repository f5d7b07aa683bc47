"""Batched serving engine: request queue -> padded prefill waves -> decode.

Port of ``repro.serve.engine``.  Up to ``max_batch`` queued requests form a
wave, are LEFT-padded to the wave's longest prompt with ``pad_id``, prefilled
together (pads carry segment 0 and content segment 1, so content never
attends a pad) and then decoded in lock-step; every decode step gets each
row's first valid position, ``context_start``, so that it never attends the
pads' K/V in the caches.  Finished sequences (EOS or per-request
``max_new_tokens``) are masked out; the wave ends when all finish.

Stateful families (SSM, RG-LRU) would ingest pads into their recurrence, so
their waves hold only prompts of one length, and are never padded.  MoE
families are attention-only and take padded waves; under capacity drops a
row's prefill depends on the other rows of its wave (the reference's
``moe_apply`` groups tokens across rows), as in the reference's engine.  An
encoder-decoder cannot be served here: its prefill needs encoder frames,
which a request does not carry (nor does one of the reference's engine), so
the engine refuses it when it is built.

Everything runs under ``torch.inference_mode()`` on the model's device.
Greedy decoding takes ``argmax`` (the first index on ties, as JAX does);
temperature sampling draws from the engine's own ``torch.Generator``.
``wave_stats`` keeps, per wave, on the host's ``perf_counter`` clock: the
batch, the padded prompt length, each row's prompt length and request id
(``prompt_lens``, ``req_ids``), each row's wait in the queue from its
submission to the wave's prefill (``queue_s``), the time to the first
sampled token (``prefill_s``), and the decode time, steps and the tokens
those steps gave to requests still running, with the part of the decode
time spent waiting for each step's tokens (``decode_wait_s``).  Only a wave
served under ``torch.profiler.profile`` also gets the device seconds of the
model's timed spans (:mod:`repro_torch.spans`), ``prefill_device_s`` and
``decode_device_s`` (``model.step``, ``model.norm``, ``model.attn`` and
``model.moe`` or ``model.mlp``), and the MoE capacity counters of its prefill,
``moe_slots`` (expert slots computed) and ``moe_kept`` (routed token-expert
pairs the dispatch kept).  Its host spans are ``engine.wave``,
``engine.prefill`` and, per step, ``engine.decode_step`` holding
``engine.decode.rows`` (the rows' bookkeeping), ``engine.decode.launch``
(the model's step and the sampling) and ``engine.decode.wait`` (reading
the tokens).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import spans

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    done: bool = False
    wave: int = -1
    enqueued_at: float = 0.0           # time.perf_counter() at submission


class ServeEngine:
    def __init__(self, model, *, max_batch: int = 8, pad_id: int = 0,
                 seed: int = 0):
        if model.cfg.is_encoder_decoder:
            raise ValueError(
                f"ServeEngine serves decoder-only models; {model.cfg.name} is an "
                "encoder-decoder, whose prefill needs encoder frames that a "
                "request does not carry: call its prefill(frames, tokens) and "
                "decode_step directly")
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.pad_id = pad_id
        self._queue: List[Request] = []
        self._done: Dict[int, Request] = {}
        self._ids = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._waves = 0
        self.wave_stats: List[Dict] = []

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               temperature: float = 0.0) -> int:
        req = Request(next(self._ids), np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      temperature=temperature)
        req.enqueued_at = time.perf_counter()
        self._queue.append(req)
        return req.req_id

    def pending(self) -> int:
        return len(self._queue)

    def result(self, req_id: int) -> Request:
        return self._done[req_id]

    def run(self) -> List[Request]:
        """Drain the queue; returns all completed requests."""
        with torch.inference_mode():
            while self._queue:
                self._run_wave()
        return sorted(self._done.values(), key=lambda r: r.req_id)

    # ------------------------------------------------------------------ wave

    def _stateful(self) -> bool:
        return any(k in ("ssm", "rec") for k in self.model.cfg.pattern)

    def _take_wave(self) -> List[Request]:
        """The next wave: the first ``max_batch`` queued requests, whatever
        their lengths; for stateful families, up to ``max_batch`` queued
        prompts of the first one's length."""
        if not self._stateful():
            wave = self._queue[:self.max_batch]
            self._queue = self._queue[self.max_batch:]
            return wave
        L0 = len(self._queue[0].prompt)
        wave, rest = [], []
        for r in self._queue:
            if len(r.prompt) == L0 and len(wave) < self.max_batch:
                wave.append(r)
            else:
                rest.append(r)
        self._queue = rest
        return wave

    def _run_wave(self) -> None:
        wave = self._take_wave()
        with spans.recording(self.device) as rec, spans.span("engine.wave"):
            stats = self._serve(wave, rec)
            stats.update(rec.totals())
        self.wave_stats.append(stats)
        self._waves += 1

    def _serve(self, wave: List[Request], rec: spans.Recorder) -> Dict:
        """Prefill ``wave`` and decode it to its end; its ``wave_stats``
        entry, but for what ``rec`` holds."""
        B = len(wave)
        lens = [len(r.prompt) for r in wave]
        S = max(lens)
        tokens = np.full((B, S), self.pad_id, np.int32)
        segments = np.zeros((B, S), np.int32)           # 0 = pad
        for i, r in enumerate(wave):
            tokens[i, S - lens[i]:] = r.prompt          # LEFT padding
            segments[i, S - lens[i]:] = 1
        # Positions are the wave's global padded coordinates for every row:
        # RoPE is shift-equivariant, so content starting at S - L scores as
        # it would from 0, and decode uses the shared position S + step.
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        with spans.span("engine.prefill"):
            logits, cache, _ = self.model.prefill(
                torch.as_tensor(tokens, device=self.device),
                positions=positions.expand(B, S),
                segments=torch.as_tensor(segments, device=self.device))
            context_start = torch.as_tensor([S - n for n in lens], dtype=torch.int32,
                                            device=self.device)
            tok = self._sample(logits[:, -1, :], wave)
            host_tok = tok[:, 0].tolist()               # waits for the device
        t1 = time.perf_counter()
        rec.phase = "decode"
        max_new = max(r.max_new_tokens for r in wave)
        active = np.ones((B,), bool)
        n_steps, wait_s = 0, 0.0
        for step in range(max_new):
            with spans.span("engine.decode_step"):
                with spans.span("engine.decode.rows"):
                    for i, r in enumerate(wave):
                        if not active[i]:
                            continue
                        t = host_tok[i]
                        r.output.append(t)
                        if (r.eos_id is not None and t == r.eos_id) or \
                                len(r.output) >= r.max_new_tokens:
                            active[i] = False
                            r.done = True
                            r.wave = self._waves
                if not active.any():
                    break
                finished = rec.marked()         # the tokens read last waited for them
                with spans.span("engine.decode.launch"):
                    logits, cache = self.model.decode_step(cache, tok, S + step,
                                                           context_start)
                    tok = self._sample(logits[:, -1, :], wave)
                rec.read(finished)              # while the device runs this step
                with spans.span("engine.decode.wait"):
                    t_wait = time.perf_counter()
                    host_tok = tok[:, 0].tolist()
                    wait_s += time.perf_counter() - t_wait
                n_steps += 1
        decode_s = time.perf_counter() - t1
        for r in wave:
            r.done = True
            self._done[r.req_id] = r
        return {
            "batch": B, "prompt_len": S, "prompt_lens": lens,
            "req_ids": [r.req_id for r in wave],
            "queue_s": [t0 - r.enqueued_at for r in wave], "prefill_s": t1 - t0,
            "decode_s": decode_s, "decode_steps": n_steps, "decode_wait_s": wait_s,
            "decode_tokens": sum(len(r.output) for r in wave) - B}

    def _sample(self, logits: torch.Tensor, wave) -> torch.Tensor:
        """(B, V) logits -> (B, 1) int32 tokens on the device."""
        greedy = torch.argmax(logits, dim=-1)
        temps = [r.temperature for r in wave]
        if all(t == 0 for t in temps):
            return greedy[:, None].to(torch.int32)
        t = torch.tensor(temps, dtype=logits.dtype, device=logits.device)
        probs = torch.softmax(logits / torch.clamp(t, min=1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        out = torch.where(t > 0, sampled, greedy)
        return out[:, None].to(torch.int32)

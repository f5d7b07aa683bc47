"""Batched serving engine: request queue -> prefill waves -> decode.

Port of ``repro.serve.engine``.  Up to ``max_batch`` queued requests form a
wave, are prefilled together and then decoded in lock-step.  Finished
sequences (EOS or per-request ``max_new_tokens``) are masked out; the wave
ends when all finish.

Everything runs under ``torch.inference_mode()`` on the model's device.
Greedy decoding takes ``argmax`` (the first index on ties, as JAX does);
temperature sampling draws from the engine's own ``torch.Generator``.
``wave_stats`` keeps, per wave, the batch, the prompt length, the time to the
first sampled token (prefill), and the decode time, steps and the tokens
those steps gave to requests still running.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

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
    enqueued_at: float = 0.0
    finished_at: float = 0.0


class ServeEngine:
    def __init__(self, model, *, max_batch: int = 8, seed: int = 0):
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
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
        req.enqueued_at = time.time()
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

    def _take_wave(self) -> List[Request]:
        """Up to ``max_batch`` queued prompts of the first one's length.

        Every family ported so far is stateful (SSM, or RG-LRU beside local
        attention): its recurrence would ingest pad tokens before the
        content, so a wave holds only equal-length prompts and is never
        padded, as in the reference.  (The reference pads the waves of
        attention-only families and masks the pads by segment; those
        families are not ported yet.)
        """
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
        B = len(wave)
        S = len(wave[0].prompt)
        tokens = np.stack([r.prompt for r in wave])

        # As the reference: positions in the wave's coordinates, segment 1
        # for content (0 would mark pads; equal-length waves have none).
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        logits, cache, _ = self.model.prefill(
            torch.as_tensor(tokens, device=self.device),
            positions=positions.expand(B, S),
            segments=torch.ones((B, S), dtype=torch.int32, device=self.device))
        max_new = max(r.max_new_tokens for r in wave)
        tok = self._sample(logits[:, -1, :], wave)
        host_tok = tok[:, 0].tolist()                   # waits for the device
        t1 = time.perf_counter()
        active = np.ones((B,), bool)
        n_steps = 0
        for step in range(max_new):
            for i, r in enumerate(wave):
                if not active[i]:
                    continue
                t = host_tok[i]
                r.output.append(t)
                if (r.eos_id is not None and t == r.eos_id) or \
                        len(r.output) >= r.max_new_tokens:
                    active[i] = False
                    r.done = True
                    r.finished_at = time.time()
                    r.wave = self._waves
            if not active.any():
                break
            logits, cache = self.model.decode_step(cache, tok, S + step)
            tok = self._sample(logits[:, -1, :], wave)
            host_tok = tok[:, 0].tolist()
            n_steps += 1
        for r in wave:
            if not r.done:
                r.done = True
                r.finished_at = time.time()
            self._done[r.req_id] = r
        self.wave_stats.append({
            "batch": B, "prompt_len": S, "prefill_s": t1 - t0,
            "decode_s": time.perf_counter() - t1, "decode_steps": n_steps,
            "decode_tokens": sum(len(r.output) for r in wave) - B})
        self._waves += 1

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

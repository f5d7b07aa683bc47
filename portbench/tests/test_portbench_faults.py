"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped (the CPU), everything else as a run
drives it.  Faults a serving cell on one chip can have: a token altered
where it is produced, one slot of an eight-row wave serving wrong logits,
half of the wave's rows left out (their logits the mean of the rest), and a
decode step that returns its state (the KV cache) unchanged.  (No exchange
between chips: every cell runs on one.)"""

import pytest
import torch

from portbench import run
from portbench.tests.smoke import smoke_cell

CELLS = ["mixtral-8x22b-d8.eval_score", "mixtral-8x22b-d8.gen_long"]


def _result(workload):
    from repro_torch.configs import get_smoke_config
    cell = smoke_cell(workload, clients=16 if "eval" in workload else 8, judge=64,
                      max_batch=8)
    return run.run_cell(cell, 123, 0.0, False, device="cpu", base_config=get_smoke_config)


def _altered_token(monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    sample = ServeEngine._sample

    def altered(self, logits, wave):
        """each request's first token (the prefill's) one past the best"""
        tok = sample(self, logits, wave)
        if getattr(self, "altered_wave", None) == self._waves:
            return tok
        self.altered_wave = self._waves
        return (tok + 1) % logits.shape[-1]
    monkeypatch.setattr(ServeEngine, "_sample", altered)


def _altered_answer(monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    sample = ServeEngine._sample

    def altered(self, logits, wave):
        """every token one past the best"""
        return (sample(self, logits, wave) + 1) % logits.shape[-1]
    monkeypatch.setattr(ServeEngine, "_sample", altered)


def _one_slot(monkeypatch):
    from repro_torch.models.decoder import DecoderLM
    prefill, step = DecoderLM.prefill, DecoderLM.decode_step

    def wrong(logits):
        """the first row's logits moved one token along"""
        logits = logits.clone()
        logits[0] = logits[0].roll(1, -1)
        return logits

    def one_prefill(self, *args, **kwargs):
        logits, cache, n = prefill(self, *args, **kwargs)
        return wrong(logits), cache, n

    def one_step(self, *args, **kwargs):
        logits, cache = step(self, *args, **kwargs)
        return wrong(logits), cache
    monkeypatch.setattr(DecoderLM, "prefill", one_prefill)
    monkeypatch.setattr(DecoderLM, "decode_step", one_step)


def _half_the_rows(monkeypatch):
    from repro_torch.models.decoder import DecoderLM
    prefill = DecoderLM.prefill

    def half(self, tokens, *args, **kwargs):
        logits, cache, n = prefill(self, tokens, *args, **kwargs)
        keep = max(1, logits.shape[0] // 2)
        logits = logits.clone()
        logits[keep:] = logits[:keep].mean(0)
        return logits, cache, n
    monkeypatch.setattr(DecoderLM, "prefill", half)


def _state_unchanged(monkeypatch):
    from repro_torch.models.decoder import DecoderLM
    step = DecoderLM.decode_step

    def unchanged(self, cache, *args, **kwargs):
        kept = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        logits, new = step(self, cache, *args, **kwargs)
        with torch.inference_mode():
            for layer, old in zip(new, kept):
                for k in layer:
                    layer[k].copy_(old[k])
        return logits, new
    monkeypatch.setattr(DecoderLM, "decode_step", unchanged)


FAULTS = {"altered_token": _altered_token, "altered_answer": _altered_answer,
          "one_slot": _one_slot, "half_the_rows": _half_the_rows,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert _result(workload)["correct"]


# a one-token answer runs no decode step: its state is the prefill's
CASES = [(w, f) for w in CELLS for f in sorted(FAULTS)
         if f != "state_unchanged" or "gen" in w]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _result(workload)
    assert not result["correct"], result["checks"]

"""Percent of the chip's bf16 peak (989 TFLOP/s) in the window's prefills:
the operations the requests' own tokens need (portbench/counts.py) over the
engine's prefill seconds."""

from portbench import counts


def read(rec):
    seconds = sum(w["prefill_s"] for w in rec["waves"])
    flops = sum(counts.prefill_flops(rec["config"], w["prompt_lens"]) for w in rec["waves"])
    return 100.0 * flops / (seconds * counts.PEAK_BF16_FLOPS) if seconds else None

"""Percent of flash_fwd_wgmma's device time (the traced window's kernels of
that name) that its least time would take: per layer and wave, the larger
of the operations over the bf16 peak and the bytes over HBM bandwidth, for
the requests' own tokens (valid pairs only; portbench/counts.py)."""

from portbench import counts
from portbench.trace import kernel_seconds


def read(rec):
    trace = rec.get("trace")
    if not trace:
        return None
    seconds = kernel_seconds(trace, "flash_fwd_wgmma")
    if not seconds:
        return None
    cfg = rec["config"]
    bound = sum(cfg["num_hidden_layers"] * counts.flash_call(cfg, w["prompt_lens"])["seconds"]
                for w in rec["waves"])
    return 100.0 * bound / seconds

"""Percent of the measured decode time that the least time of its steps
would take: per step, the larger of its operations over the bf16 peak and
its bytes over HBM bandwidth (each weight once, the looked-up embedding
rows, the K/V of each serving row's valid positions; portbench/counts.py),
summed over the window's steps, over the engine's decode seconds."""

from portbench import counts


def read(rec):
    cfg = rec["config"]
    seconds = sum(w["decode_s"] for w in rec["waves"])
    if not seconds:
        return None
    weights = counts.weight_bytes(cfg)
    bound = 0.0
    for w in rec["waves"]:
        rows = list(zip(w["prompt_lens"], w["output_lens"]))
        for s in range(w["decode_steps"]):
            ctx = [n + s + 1 for n, m in rows if m - 1 > s]
            if ctx:
                bound += counts.decode_step(cfg, ctx, weights)["seconds"]
    return 100.0 * bound / seconds

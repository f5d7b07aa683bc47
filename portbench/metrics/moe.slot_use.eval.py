"""Percent of the expert slots the prefills' MoE dispatch computed that
hold a routed token: the (token, expert) pairs kept over the slots, G x E x
C a layer (``wave_stats`` ``moe_kept`` and ``moe_slots``, counted under the
profiler)."""


def read(rec):
    waves = rec["waves"]
    if not waves or not all("moe_slots" in w and "moe_kept" in w for w in waves):
        return None
    slots = sum(w["moe_slots"] for w in waves)
    return 100.0 * sum(w["moe_kept"] for w in waves) / slots if slots else None

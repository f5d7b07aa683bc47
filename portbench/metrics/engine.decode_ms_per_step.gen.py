"""Milliseconds a decode step of the window's waves: the engine's decode
seconds over its decode steps (its own host-clock span)."""


def read(rec):
    steps = sum(w["decode_steps"] for w in rec["waves"])
    return 1e3 * sum(w["decode_s"] for w in rec["waves"]) / steps if steps else None

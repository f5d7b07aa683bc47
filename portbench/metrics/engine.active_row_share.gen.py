"""Percent of the rows of the window's decode steps that still served a
request: the tokens the steps gave over batch x steps (the engine decodes
a wave in lock step until its longest answer ends)."""


def read(rec):
    slots = sum(w["batch"] * w["decode_steps"] for w in rec["waves"])
    return 100.0 * sum(w["decode_tokens"] for w in rec["waves"]) / slots if slots else None

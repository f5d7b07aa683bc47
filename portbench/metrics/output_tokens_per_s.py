"""Tokens generated for every request finished in the window, over the
window's whole length; host clock."""


def read(rec):
    return sum(len(r["output"]) for r in rec["requests"]) / rec["window_s"]

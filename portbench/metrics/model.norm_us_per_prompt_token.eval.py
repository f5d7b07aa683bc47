"""Microseconds of device time a prompt token in the prefills' norms (two a
layer and the final one): the ``model.norm`` span's device seconds in the
window's prefills (``wave_stats`` ``prefill_device_s``, filled under the
profiler) over the waves' unpadded prompt tokens."""

SPAN = "model.norm"


def read(rec):
    waves = rec["waves"]
    tokens = sum(sum(w["prompt_lens"]) for w in waves)
    if not tokens or not all(SPAN in w.get("prefill_device_s", {}) for w in waves):
        return None
    return 1e6 * sum(w["prefill_device_s"][SPAN] for w in waves) / tokens

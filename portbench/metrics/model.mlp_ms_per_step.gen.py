"""Milliseconds of device time a decode step in the dense MLP sublayers: the
``model.mlp`` span's device seconds in the window's decodes (``wave_stats``
``decode_device_s``, filled under the profiler) over the decode steps."""

SPAN = "model.mlp"


def read(rec):
    waves = [w for w in rec["waves"] if w["decode_steps"]]
    if not waves or not all(SPAN in w.get("decode_device_s", {}) for w in waves):
        return None
    return 1e3 * sum(w["decode_device_s"][SPAN] for w in waves) / sum(
        w["decode_steps"] for w in waves)

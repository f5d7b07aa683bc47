"""Percent of the prefilled positions that were pads: the waves' padded
positions (batch x longest prompt) less their requests' prompt tokens, from
the engine's wave records (a count)."""


def read(rec):
    padded = sum(w["batch"] * w["prompt_len"] for w in rec["waves"])
    useful = sum(sum(w["prompt_lens"]) for w in rec["waves"])
    return 100.0 * (padded - useful) / padded if padded else None

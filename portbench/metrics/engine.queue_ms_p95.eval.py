"""95th percentile of the requests' time in the engine's queue, over every
row of the window's waves: from the request's submission to its wave's
prefill (the engine's ``wave_stats`` ``queue_s``, host clock), ms; the
inclusive method, as ``ttft_p95_ms``'s."""

import statistics


def read(rec):
    if not all("queue_s" in w for w in rec["waves"]):
        return None
    queue = [q for w in rec["waves"] for q in w["queue_s"]]
    if len(queue) < 2:
        return None
    return 1e3 * statistics.quantiles(queue, n=100, method="inclusive")[94]

"""95th percentile of the time to first token, over every request finished
in the window: from the job's submission of the request to the end of its
wave's prefill (the engine's ``wave_stats``: its first token is on the host
then); host clock, ms."""

import statistics


def read(rec):
    ttft = [r["ttft_s"] for r in rec["requests"]]
    if len(ttft) < 2:
        return None
    return 1e3 * statistics.quantiles(ttft, n=100, method="inclusive")[94]

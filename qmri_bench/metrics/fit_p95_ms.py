"""fit_p95_ms: the 95th percentile of the latencies of all the window's
requests, from the call into the program to the answer on the host."""

import statistics


def read(ctx):
    lat = ctx["latencies"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3

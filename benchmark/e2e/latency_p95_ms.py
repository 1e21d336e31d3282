"""``latency_p95_ms``: the 95th percentile (nearest rank) of the latency of
every request due in the window, from its due time to the client's receipt
of the whole response.  A request that failed or never came counts as
infinitely late; where that reaches the percentile, nothing is reported."""

import math


def read(run):
    lat = sorted(run.latencies_ms or [])
    if not lat:
        return None
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return p95 if math.isfinite(p95) else None

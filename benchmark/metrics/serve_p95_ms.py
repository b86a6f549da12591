"""95th percentile of the latency of every request due in the window,
from when it was due to when its detections were on the host (host
clock), nearest rank; a failed request counts as missing (infinite)."""

import math


def read(run):
    if run.kind != "serve" or not run.latencies_s:
        return None
    lat = sorted(run.latencies_s)
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return p95 * 1e3 if math.isfinite(p95) else None

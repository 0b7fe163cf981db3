"""dec_call_p95_ms: the 95th percentile of the latency of every decode
call of the window (nearest rank over all calls, never over chunks)."""

import math


def read(rec):
    if rec.direction != "read" or not rec.calls:
        return None
    lat = sorted(c.t1 - c.t0 for c in rec.calls)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]

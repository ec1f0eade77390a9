"""``latency_ms_p95.query`` (ms): the 95th percentile (nearest rank) of the
queries' latencies, each timed from when it was due, a failed query counting
as inf; in the traced run over the queries due before the traced span (the
window's first 40%), since the profiler's start stalls the loop. The open
loop's tail: it follows the queue, so a stall of the host weighs in it far
more than in the median that it moves. Layer: serving."""

import math


def read(run, info):
    lat = sorted(info.get("latency_s") or ())
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else None

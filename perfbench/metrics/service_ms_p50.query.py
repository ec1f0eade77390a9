"""``service_ms_p50.query`` (ms): the median time inside
``RetrievalIndex.query`` over the window, without the queue's wait, from the
harness's span around each call. Layer: serving."""

import statistics


def read(run, info):
    service = info.get("service_s")
    return 1e3 * statistics.median(service) if service else None

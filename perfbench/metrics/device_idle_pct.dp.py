"""``device_idle_pct.dp`` (%): the share of rank 0's traced span of
data-parallel micro-steps in which no operation (kernel, copy, set) runs on
its card. Layer: device."""


def read(run, info):
    if run is None or run.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)

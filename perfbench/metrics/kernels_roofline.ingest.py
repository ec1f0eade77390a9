"""``kernels_roofline.ingest`` (%): over the port's own kernels in the traced
span (``counts/kernels.py::PORT_KERNELS``, matched by name), the sum of their
least times at the calls' shapes (``ingest_call_bound_s``: K2, K1 and K3 in
each block) over the sum of their device times. Layer: kernels
(``ops/*.py``, ``csrc/*.cu``)."""

from perfbench.counts.kernels import PORT_KERNELS, ingest_call_bound_s


def read(run, info):
    if run is None:
        return None
    device = run.device_seconds(PORT_KERNELS)
    if device <= 0.0:
        return None
    bound = ingest_call_bound_s(info["clips_per_call"], info["frames"]) * info["calls_traced"]
    return 100.0 * bound / device
